"""The four reference examples of the port (``normflows_tpu_torch.examples``
``circular_nsf``, ``neural_spline_twomoons``, ``augmented_flow`` and
``image_density``) against the JAX package's scripts of the same names, on
the CPU, cut to 2 layers of hidden width 16:

* each model, its weights perturbed from the example's init, against the
  JAX script's model holding the same weights (:func:`jax_model_of`):
  ``log_prob``, the draws and log q of the same base noise, and the
  gradient of every leaf of the example's loss;
* 20 steps of each example's training on its host inputs (``--host-inputs``)
  against the JAX package's replay of them with the JAX script's optimizer
  (:func:`replay`), every loss, and the example's reported numbers;
* the circular target's sampler against the JAX script's on the JAX
  script's own normals and uniforms, passed in;
* the augmented flow's beta, computed on the device inside a
  ``make_step_chunk`` step, against the JAX script's host formula;
* ``torch.save(model.state_dict())`` after a chunk (its parameters views of
  the chunk's flat buffer) writes what it wrote before, the optimizer's
  state dict holds no parameter, both load bit-equal, and a chunk run after
  a load equals the same steps taken eagerly.

Bars: 1e-5 on draws, 1e-4 on log-densities and losses, gradients atol 1e-4
and rtol 1e-3 (tests/test_torch_conditional.py's); a replay's losses 1e-4.

The JAX replay at full size, one JSON line a seed (the bars of
``chip_smoke.py`` phase ``reference_examples``):

    JAX_PLATFORMS=cpu python -m tests.test_torch_reference_examples
        --example circular_nsf [--seeds 0-2] [--iters 500]
"""

import argparse
import copy
import io
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
from examples import augmented_flow as jaug
from examples import circular_nsf as jcirc
from examples import image_density as jimg
from examples import neural_spline_twomoons as jnsf
from normflows_tpu_torch import training
from normflows_tpu_torch.examples import augmented_flow, circular_nsf, image_density
from normflows_tpu_torch.examples import neural_spline_twomoons
from normflows_tpu_torch.interop import _torch_name
from normflows_tpu_torch.nets.mlp import Linear
from tests.helpers import assert_close
from tests.test_torch_conditional import jax_model_of

torch.set_num_threads(2)

Y_TOL, LD_TOL = 1e-5, 1e-4
G_ATOL, G_RTOL = 1e-4, 1e-3
K, HIDDEN, B, STEPS = 2, 16, 128, 20


# ---- the examples' models and losses on both sides ---------------------------

def ported_models(example, k=K, hidden=HIDDEN, seed=0):
    """``(port model, JAX template)`` of ``example`` at ``k`` layers."""
    if example == "circular_nsf":
        return (circular_nsf.build_model("cpu", k, hidden, seed),
                jcirc.build_model(jax.random.key(0), k, hidden))
    if example == "neural_spline_twomoons":
        return (neural_spline_twomoons.build_model("cpu", k, hidden, seed),
                jnsf.build_model(k, hidden))
    if example == "augmented_flow":
        return augmented_flow.initialised_model("cpu", k, seed), jaug.build_model(k)
    return image_density.build_model("cpu", k, seed), jimg.build_model(k, jax.random.key(0))


def perturb(model, seed, std=0.1):
    """Every float parameter of two or more axes plus noise of ``std``, so
    that the zero-initialised last layers do work."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                p.add_(torch.from_numpy(rng.normal(0, std, p.shape).astype(np.float32)))
    return model


def torch_layout(tmodel, jtree):
    """The leaves of a JAX tree of ``tmodel``'s structure by the port's
    names, in the port's layout (a ``Linear``'s weight as (out, in))."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        name = _torch_name(jax.tree_util.keystr(path))
        value = np.asarray(leaf)
        owner, _, attr = name.rpartition(".")
        if attr in ("weight", "mask") and isinstance(tmodel.get_submodule(owner), Linear):
            value = value.T
        out[name] = value
    return out


def port_base(tm, eps):
    """The port base's ``(z, log q)`` of the noise ``eps``, as JAX arrays:
    what the JAX flows take where the JAX base draws its noise inside (the
    circular model's ``UniformGaussian``, which holds no trainable leaf)."""
    with torch.no_grad():
        z0, log_q0 = tm.q0.from_noise(torch.from_numpy(np.asarray(eps)))
    return jnp.asarray(z0.numpy()), jnp.asarray(log_q0.numpy())


@jax.jit
def jax_from_noise(jm, eps, base=None):
    """The JAX model's ``(x, log q)`` of base noise ``eps``: a
    ``DiagGaussian`` base maps it as its ``sample_and_log_prob`` does; for
    another base ``base`` (:func:`port_base`) is the mapped noise."""
    if isinstance(jm.q0, jnf.distributions.DiagGaussian):
        z0 = jm.q0.loc + jnp.exp(jm.q0.log_scale) * eps
        log_q0 = -0.5 * eps.shape[1] * math.log(2 * math.pi) - jnp.sum(
            jm.q0.log_scale + 0.5 * eps**2, axis=1)
    else:
        z0, log_q0 = base
    x, ld = jm.forward_and_log_det(z0)
    return x, log_q0 - ld


def torch_loss(example, model, batch):
    if example == "augmented_flow":
        return augmented_flow.annealed_reverse_kld(model, batch[1], batch[0])
    return model.forward_kld(batch)


def jax_loss(example, jm, batch):
    if example == "augmented_flow":
        beta, eps = batch
        x, log_q = jax_from_noise(jm, eps)
        return jnp.mean(log_q) - beta * jnp.mean(jm.p.log_prob(x))
    return jm.forward_kld(batch)


def eval_inputs(example, seed):
    """``(x, eps)`` of the example's evaluation (x None where it has none)."""
    if example == "augmented_flow":
        return None, augmented_flow.host_normal(seed + 1, 512, 4)
    if example == "image_density":
        return image_density.held_out(image_density.smiley_image(), seed)
    return getattr({"circular_nsf": circular_nsf,
                    "neural_spline_twomoons": neural_spline_twomoons}[example],
                   "held_out")(seed)


def loss_batch(example, seed):
    """A batch of the example's loss on the CPU."""
    if example == "augmented_flow":
        return torch.tensor(0.5), augmented_flow.host_normal(seed, B, 4)
    x, _ = eval_inputs(example, seed)
    return x[:B]


EXAMPLES = ("circular_nsf", "neural_spline_twomoons", "augmented_flow", "image_density")


@pytest.mark.parametrize("example", EXAMPLES)
def test_model_matches_jax(example):
    """log q, draws of the same noise and the loss's gradients."""
    tm, template = ported_models(example)
    perturb(tm, 5)
    jm = jax_model_of(tm, template)
    x, eps = eval_inputs(example, 3)
    eps = eps[:B]
    if x is not None:
        x = x[:B]
        with torch.no_grad():
            got = tm.log_prob(x).numpy()
        want = jax.jit(lambda m, x: m.log_prob(x))(jm, jnp.asarray(x.numpy()))
        assert_close(got, want, atol=LD_TOL, rtol=LD_TOL)
    with torch.no_grad():
        xt, lqt = tm.from_noise(eps)
    xj, lqj = jax_from_noise(jm, jnp.asarray(eps.numpy()), port_base(tm, eps))
    assert_close(xt.numpy(), xj, atol=Y_TOL, rtol=Y_TOL)
    assert_close(lqt.numpy(), lqj, atol=LD_TOL, rtol=LD_TOL)

    batch = loss_batch(example, 4)
    jbatch = jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), batch)
    diff, rest = jnf.partition(jm)
    vj, gj = jax.jit(jax.value_and_grad(
        lambda d, b: jax_loss(example, jnf.combine(d, rest), b)))(diff, jbatch)
    loss = torch_loss(example, tm, batch)
    loss.backward()
    assert_close(float(loss.detach()), float(vj), atol=LD_TOL, rtol=LD_TOL)
    want = torch_layout(tm, gj)
    named = dict(tm.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        assert_close(p.grad.numpy(), want[name], atol=G_ATOL, rtol=G_RTOL, msg=name)


# ---- training against the JAX package's replay ---------------------------------

def jax_optimizer(example, lr):
    """The JAX script's optimizer."""
    if example == "circular_nsf":
        return optax.adamw(lr, weight_decay=1e-4)
    if example == "image_density":
        return optax.adamw(lr, weight_decay=1e-4)
    decay = 1e-5 if example == "neural_spline_twomoons" else 1e-6
    return optax.chain(optax.add_decayed_weights(decay), optax.adam(lr))


LR = {"circular_nsf": 1e-4, "neural_spline_twomoons": 1e-3, "augmented_flow": 1e-4,
      "image_density": 1e-4}
BATCH = {"circular_nsf": 1024, "neural_spline_twomoons": 512, "augmented_flow": 1024,
         "image_density": 512}


def host_steps(example, iters, batch, seed):
    """The example's ``--host-inputs`` draws as one numpy batch a step."""
    if example == "circular_nsf":
        return list(circular_nsf.host_inputs(iters, batch, seed).numpy())
    if example == "neural_spline_twomoons":
        pool = neural_spline_twomoons.pool(seed).numpy()
        return [pool[i] for i in neural_spline_twomoons.host_inputs(iters, batch, seed).numpy()]
    if example == "augmented_flow":
        eps = augmented_flow.host_inputs(iters, batch, seed).numpy()
        return [(np.float32(min(1.0, 0.01 + i / 1000)), eps[i]) for i in range(iters)]
    data = image_density.training_pool(image_density.smiley_image(), seed, "cpu", True).numpy()
    n = data.shape[0]
    return [data[(i * batch) % (n - batch + 1):][:batch] for i in range(iters)]


def jax_metrics(example, jm, tm, seed):
    """The example's ``evaluate`` numbers for the JAX model ``jm`` (``tm``
    a port model of its structure, whose base maps circular noise)."""
    if example == "augmented_flow":
        eps = augmented_flow.host_normal(seed + 1, augmented_flow.DRAWS, 4).numpy()
        z, _ = jax_from_noise(jm, jnp.asarray(eps))
        return {"standard_mean_radius": float(jnp.mean(jnp.linalg.norm(z[:, :2], axis=1))),
                "augmented_std": float(jnp.std(z[:, 2:]))}
    if example == "image_density":
        image = image_density.smiley_image()
        x, eps = image_density.held_out(image, seed)
    else:
        x, eps = eval_inputs(example, seed)
    x = jnp.asarray(x.numpy())
    z, _ = jax_from_noise(jm, jnp.asarray(eps.numpy()), port_base(tm, eps))
    log_q = jax.jit(lambda m, x: m.log_prob(x))(jm, x)
    if example == "circular_nsf":
        return {"held_out_forward_kld": float(-jnp.mean(log_q)),
                "in_range": float(jnp.mean(jnp.abs(z[:, 1]) <= np.pi + 1e-4))}
    if example == "neural_spline_twomoons":
        return {"held_out_nll": float(-jnp.mean(log_q)),
                "mean_radius": float(jnp.mean(jnp.linalg.norm(z, axis=1)))}
    target = image_density.distributions.ImagePrior.create(image, device="cpu")
    return {"held_out_log_q": float(jnp.mean(log_q)),
            "bright_share": image_density.bright_share(target, torch.from_numpy(np.array(z)))}


def replay(example, seed, iters, k=None, hidden=128, batch=None, lr=None):
    """The JAX package trains the port example's model (its initial weights
    from ``seed``) on the example's host inputs at ``seed``, with the JAX
    script's optimizer and its non-finite guard; returns the losses and
    the example's numbers for the trained model."""
    k = k or {"circular_nsf": 20, "neural_spline_twomoons": 16}.get(example, 32)
    batch, lr = batch or BATCH[example], lr or LR[example]
    tm, template = ported_models(example, k, hidden, seed)
    jm = jax_model_of(tm, template)
    opt = jax_optimizer(example, lr)
    diff, rest = jnf.partition(jm)
    opt_state = opt.init(diff)

    @jax.jit
    def step(diff, opt_state, batch):
        loss, grads = jax.value_and_grad(
            lambda d: jax_loss(example, jnf.combine(d, rest), batch))(diff)
        finite = jnp.isfinite(loss)
        grads = jax.tree.map(lambda g: jnp.where(finite, g, 0.0), grads)
        updates, opt_state = opt.update(grads, opt_state, diff)
        return optax.apply_updates(diff, updates), opt_state, loss

    losses = []
    t0 = time.time()
    for b in host_steps(example, iters, batch, seed):
        diff, opt_state, loss = step(diff, opt_state, b)
        losses.append(loss)
    losses = np.asarray(jnp.stack(losses))
    jm = jnf.combine(diff, rest)
    record = {"example": example, "final_loss": float(losses[-1]),
              "non_finite_steps": int((~np.isfinite(losses)).sum()),
              "seconds": time.time() - t0, "seed": seed, "iters": iters, "k": k,
              "hidden": hidden, "batch": batch, **jax_metrics(example, jm, tm, seed)}
    return losses, record


MODULES = {"circular_nsf": circular_nsf, "neural_spline_twomoons": neural_spline_twomoons,
           "augmented_flow": augmented_flow, "image_density": image_density}


@pytest.mark.parametrize("example", EXAMPLES)
def test_training_replays_through_jax(example, capsys, monkeypatch):
    """20 host-input steps of the example's ``main`` on the CPU at 2 layers
    of width 16 against the JAX package's replay: every loss, and the
    example's numbers."""
    module, seen = MODULES[example], []

    def run_chunks(*args, **kw):
        seen.append(module_run_chunks(*args, **kw))
        return seen[-1]

    module_run_chunks = module.run_chunks
    monkeypatch.setattr(module, "run_chunks", run_chunks)
    argv = ["--device", "cpu", "--iters", str(STEPS), "--chunk", "10", "--k", str(K),
            "--host-inputs"]
    if example in ("circular_nsf", "neural_spline_twomoons"):
        argv += ["--hidden", str(HIDDEN)]
    got = module.main(argv)[1]
    want_losses, want = replay(example, 0, STEPS, k=K, hidden=HIDDEN)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert got["non_finite_steps"] == 0 == want["non_finite_steps"]
    assert_close(seen[0][0].numpy(), want_losses, atol=LD_TOL, rtol=LD_TOL)
    for key in want:
        if key not in ("example", "non_finite_steps", "seconds", "seed", "iters", "k",
                       "hidden", "batch"):
            assert_close(got[key], want[key], atol=LD_TOL, rtol=LD_TOL, msg=key)


# ---- the circular target and the annealed beta ------------------------------------

def test_circular_target_matches_jax_on_its_draws():
    """The torch ``sample_target`` on the JAX script's own draws (its four
    keys split as it splits them) against the JAX script's output."""
    key, n = jax.random.key(11), 4096
    want = np.asarray(jcirc.sample_target(key, n))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    noise = (jax.random.normal(k1, (n, 2)), jax.random.uniform(k2, (n, 2)),
             jax.random.uniform(k3, (n, 1)), jax.random.uniform(k4, (n, 1)))
    got = circular_nsf.sample_target(n, noise=tuple(torch.from_numpy(np.array(a))
                                                     for a in noise))
    assert_close(got.numpy(), want, atol=Y_TOL, rtol=Y_TOL)
    assert np.all(np.abs(want[:, 1]) <= np.pi)


@pytest.mark.parametrize("step", [0, 500, 999, 1000, 1500])
def test_beta_inside_a_chunk_is_the_scripts(step):
    """The beta a chunk's step takes at step count ``step``, computed on
    the device from the count, bit-equal to the JAX script's
    ``min(1.0, 0.01 + i / anneal_iters)`` in float32."""
    model = augmented_flow.initialised_model("cpu", 1)
    state, chunk = augmented_flow.make_chunk(model, 1e-4, 8, 1000, 1)
    seen = []
    batch_fn = chunk.batch_fn
    chunk.batch_fn = lambda s, g: seen.append(batch_fn(s, g)) or seen[-1]
    state.step.fill_(step)
    chunk(state, torch.Generator().manual_seed(0))
    assert seen[0].dtype == torch.float32
    assert float(seen[0]) == float(np.float32(min(1.0, 0.01 + step / 1000)))
    assert int(state.step) == step + 1


# ---- torch.save of a chunk's model (its parameters views of a flat buffer) -----

def saved_bytes(obj):
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def test_state_dicts_after_a_chunk_hold_their_own_bytes():
    model = circular_nsf.build_model("cpu", K, HIDDEN, 2)
    perturb(model, 6)
    eager = copy.deepcopy(model)
    before = saved_bytes(model.state_dict())
    inputs = circular_nsf.host_inputs(4, 64, 2)
    state, chunk = circular_nsf.make_chunk(model, 1e-3, 64, 2, inputs)
    chunk(state)
    assert all(p.untyped_storage().nbytes() > p.numel() * 4 for p in model.parameters())
    saved = saved_bytes(model.state_dict())
    assert len(saved) == len(before)
    opt_saved = saved_bytes(state.optimizer.state_dict())
    opt_state = torch.load(io.BytesIO(opt_saved))["state"]
    assert all(t.untyped_storage().nbytes() == t.numel() * t.element_size()
               for s in opt_state.values() for t in s.values())
    # the eager steps' optimizer and model: the same values, the same bytes
    opt = torch.optim.AdamW(eager.parameters(), lr=1e-3, weight_decay=1e-4)
    estate, step = training.make_train_step(eager, opt, lambda m, b, g: m.forward_kld(b))
    for i in range(2):
        step(estate, inputs[i])
    assert len(opt_saved) == len(saved_bytes(opt.state_dict()))
    for s, e in zip(opt_state.values(), opt.state_dict()["state"].values()):
        assert all(torch.equal(s[k], e[k]) for k in e)
    loaded = circular_nsf.build_model("cpu", K, HIDDEN, 3)
    loaded.load_state_dict(torch.load(io.BytesIO(saved)))
    for (n, a), b in zip(loaded.named_parameters(), eager.parameters()):
        assert torch.equal(a, b), n
    # a load into the chunk's model copies in place: the chunk goes on, and
    # equals the eager steps
    model.load_state_dict(loaded.state_dict())
    got = chunk(state)[1]["loss"]
    want = [float(step(estate, inputs[i])[1]["loss"]) for i in (2, 3)]
    assert got.tolist() == want
    for (n, a), b in zip(model.named_parameters(), eager.parameters()):
        assert torch.equal(a, b), n


# ---- the JAX replay at full size -----------------------------------------------

def _seeds(text):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--example", choices=EXAMPLES, required=True)
    ap.add_argument("--seeds", default="0-2", help="a seed or a range, e.g. 0-2")
    ap.add_argument("--iters", type=int, default=500)
    args = ap.parse_args(argv)
    for seed in _seeds(args.seeds):
        losses, record = replay(args.example, seed, args.iters)
        record["losses_every_100"] = losses[::100].tolist()
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
