"""The bases ``GaussianMixture``, ``GaussianPCA`` and ``AffineGaussian`` in the
port (``distributions.base``) and the example ``change_base`` against the
JAX package on the CPU, from the same weights:

* each base's ``log_prob``, its draws (``from_noise`` on the noise JAX draws
  from its key, where JAX's draw is a transform of normals) and the
  gradients of its log-density (1e-5 of their norms);
* the mixture's draw law (its inverse-CDF mode draw, where JAX draws the
  mode with ``jax.random.categorical``): mode shares and moments over 2^14
  draws, within 4 standard errors;
* ``AffineGaussian`` with labels, drawing its labels, and its temperature
  set through ``MultiscaleFlow.set_temperature``;
* a mixture-based model's serving bundle (the sampler's noise is the base's
  ``noise_shape``, dim + 1);
* 20 steps of ``change_base``'s model (cut to 4 coupling blocks) from each
  base, on host-drawn batches, against the JAX package's steps;
* :func:`replay`, the example through the JAX package on the port
  example's initial weights and host-drawn inputs, which sets the card's
  bars: ``JAX_PLATFORMS=cpu python -m tests.test_torch_bases --seeds 0-2``.

Bars: 1e-5 (atol and rtol) on values, 1e-4 on the training losses.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu.nets import MLP as JMLP
import normflows_tpu_torch as nft
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import serving
from normflows_tpu_torch.distributions.base import draw_labels, draw_noise
from normflows_tpu_torch.examples import change_base
from tests.helpers import assert_close
from tests.test_torch_stochastic import (jax_grads_by_tensor, jax_model_of, normal, ported,
                                         relative_gaps, t)

torch.set_num_threads(2)

TOL, G_TOL, LOSS_TOL, B = 1e-5, 1e-5, 1e-4, 32
LOC = [[-2.0, 0.0], [2.0, 0.5], [0.0, 3.0]]
SCALE = [[0.3, 0.5], [0.6, 0.2], [0.4, 0.4]]
WEIGHTS = [0.2, 0.5, 0.3]


def close(a, b, tol=TOL, msg=""):
    assert_close(a.detach().numpy(), np.asarray(b), atol=tol, rtol=tol, msg=msg)


def grads_against_jax(jbase, tbase, z, context=None):
    """sum(log_prob(z)) differentiated in both packages: the port's leaves'
    relative gaps to JAX's."""
    diff, rest = jnf.partition(jbase)
    jgrads = jax.jit(jax.grad(lambda d: jnp.sum(jnf.combine(d, rest).log_prob(
        jnp.asarray(z), None if context is None else jnp.asarray(context)))))(diff)
    tbase.zero_grad()
    tbase.log_prob(t(z), None if context is None else t(context)).sum().backward()
    return relative_gaps(tbase, jax_grads_by_tensor(jgrads, tbase))


def test_mixture_matches_jax():
    jm = jdist.GaussianMixture.create(3, 2, loc=np.asarray(LOC), scale=np.asarray(SCALE),
                                      weights=np.asarray(WEIGHTS))
    tm = ported(jm, tdist.GaussianMixture(3, 2, device="cpu"))
    z = normal(1, B, 2, scale=2.0)
    close(tm.log_prob(t(z)), jax.jit(lambda m, z: m.log_prob(z))(jm, jnp.asarray(z)))
    gaps = grads_against_jax(jm, tm, z)
    assert set(gaps) == {"loc", "log_scale", "weight_scores"} and max(gaps.values()) <= G_TOL
    # from_noise: the mode at u by the cumulative weights, z = eps scale + loc
    u = np.asarray([0.05, 0.19, 0.21, 0.69, 0.71, 0.999], np.float32)
    eps = normal(2, u.size, 2)
    z, log_p = tm.from_noise(t(np.concatenate([u[:, None], eps], 1)))
    mode = np.asarray([0, 0, 1, 1, 2, 2])
    close(z, eps * np.asarray(SCALE)[mode] + np.asarray(LOC)[mode])
    close(log_p, jax.jit(lambda m, z: m.log_prob(z))(jm, jnp.asarray(z.detach().numpy())))
    fixed = tdist.GaussianMixture(3, 2, LOC, SCALE, WEIGHTS, trainable=False, device="cpu")
    assert not list(fixed.parameters())
    assert {n for n, _ in fixed.named_buffers()} == {"loc", "log_scale", "weight_scores"}
    assert torch.equal(fixed.log_prob(t(z.detach().numpy())), tm.log_prob(z).detach())
    assert tm.noise_shape == (3,) and tm.noise_spec == ("uniform", "normal", "normal")


def test_mixture_draw_law():
    """2^14 draws: each mode's share of the draws (the modes lie apart, each
    draw assigned to its nearest centre in units of its scale) and the
    mixture's mean and variance, within 4 standard errors."""
    n = 2**14
    tm = tdist.GaussianMixture(3, 2, LOC, [[0.1, 0.1]] * 3, WEIGHTS, device="cpu")
    with torch.no_grad():
        z, log_p = tm.sample_and_log_prob(n, generator=torch.Generator().manual_seed(3))
    z = z.double().numpy()
    loc, w = np.asarray(LOC), np.asarray(WEIGHTS)
    nearest = np.argmin(((z[:, None] - loc) ** 2).sum(-1), 1)
    share = np.bincount(nearest, minlength=3) / n
    assert np.all(np.abs(share - w) <= 4 * np.sqrt(w * (1 - w) / n)), share
    mean = w @ loc
    var = w @ (0.01 + loc**2) - mean**2
    assert np.all(np.abs(z.mean(0) - mean) <= 4 * np.sqrt(var / n)), z.mean(0)
    assert np.all(np.abs(z.var(0) - var) <= 4 * var * np.sqrt(2 / n) + 0.01 * var), z.var(0)
    assert torch.isfinite(log_p).all()


def test_pca_matches_jax():
    jp = jdist.GaussianPCA.create(3, 2, sigma=0.3, key=jax.random.key(4))
    jp = jp.replace(loc=jnp.asarray(normal(5, 1, 3)))
    tp = ported(jp, tdist.GaussianPCA(3, 2, sigma=0.3, device="cpu"))
    key = jax.random.key(6)
    (jz, jlp), eps, jlq = jax.jit(lambda m, x: (m.sample_and_log_prob(key, B), jax.random.normal(
        key, (B, 2)), m.log_prob(x)))(jp, jnp.asarray(normal(7, B, 3)))
    tz, tlp = tp.from_noise(t(eps))
    close(tz, jz)
    close(tlp, jlp)
    close(tp.log_prob(t(normal(7, B, 3))), jlq)
    gaps = grads_against_jax(jp, tp, normal(8, B, 3))
    assert set(gaps) == {"loc", "W", "log_sigma"} and max(gaps.values()) <= G_TOL
    assert tp.noise_shape == (2,) and tp.event_shape == (3,)


def affine_pair(num_classes=None, temperature=None):
    jg = jdist.AffineGaussian.create((2, 3), (2, 3), num_classes)
    tg = tdist.AffineGaussian((2, 3), (2, 3), num_classes, device="cpu")
    leaves = {"s": normal(9, 1, 2, 3, scale=0.3), "t": normal(10, 1, 2, 3)}
    if num_classes is not None:
        leaves.update(s_cc=normal(11, num_classes, 6, scale=0.3), t_cc=normal(12, num_classes, 6))
    transform = jg.transform.replace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    jg = jg.replace(transform=transform, temperature=temperature)
    tg = ported(jg, tg)
    tg.temperature = temperature
    return jg, tg


@pytest.mark.parametrize("num_classes,temperature", [(None, None), (None, 0.7), (4, None),
                                                     (4, 0.7)])
def test_affine_gaussian_matches_jax(num_classes, temperature):
    jg, tg = affine_pair(num_classes, temperature)
    y = np.asarray([0, 3, 1, 2] * (B // 4)) if num_classes else None
    key = jax.random.key(13)
    x = normal(14, B, 2, 3)

    @jax.jit
    def jax_side(m, x, y):
        return (m.sample_and_log_prob(key, B, y), jax.random.normal(key, (B, 2, 3)),
                m.log_prob(x, y))

    (jz, jlp), eps, jlq = jax_side(jg, jnp.asarray(x), None if y is None else jnp.asarray(y))
    ty = None if y is None else torch.from_numpy(y)
    tz, tlp = tg.from_noise(t(eps), ty)
    close(tz, jz)
    close(tlp, jlp)
    close(tg.log_prob(t(x), ty), jlq)
    gaps = grads_against_jax(jg, tg, x, y)
    assert max(gaps.values()) <= G_TOL, gaps


def test_affine_gaussian_draws_labels_and_takes_the_temperature():
    _, tg = affine_pair(4)
    g, h = torch.Generator().manual_seed(15), torch.Generator().manual_seed(15)
    z, log_p = tg.sample_and_log_prob(B, generator=g)
    y = draw_labels(B, 4, generator=h)
    want = tg.from_noise(draw_noise(tg.noise_spec, (2, 3), B, generator=h), y)
    assert torch.equal(z, want[0]) and torch.equal(log_p, want[1])
    model = nft.MultiscaleFlow.create([tg], [[]], [], class_cond=True)
    eps = draw_noise(tg.noise_spec, (2, 3), B, generator=torch.Generator().manual_seed(16))
    y = torch.arange(B) % 4
    cold = tg.from_noise(0.5 * eps, y)[0]  # temperature 0.5 scales the unit draws
    assert model.set_temperature(0.5) is model and tg.temperature == 0.5
    x, _ = model.from_noise([eps], y)
    close(x, cold.detach().numpy())
    x, _ = model.sample(B, temperature=0.25, generator=torch.Generator().manual_seed(17))
    assert tg.temperature == 0.5 and x.shape == (B, 2, 3)
    model.reset_temperature()
    assert tg.temperature is None


def test_a_mixture_based_model_serves(tmp_path):
    """The sampler's noise is the mixture's (n, dim + 1); the bundle draws
    what the live model's ``sample`` draws from the same seed."""
    model = change_base.build_model("mixture", 0, "cpu", num_layers=2)
    manifest = serving.save_bundle(model, str(tmp_path / "b"), 64, (2,))
    assert manifest["noise_spec"] == ["uniform", "normal", "normal"]
    assert manifest["noise_shape"] == [3]
    bundle = serving.load_bundle(str(tmp_path / "b"))
    x, log_q = bundle.sample(5)
    with torch.no_grad():
        want = model.sample(64, generator=torch.Generator().manual_seed(5))
    assert torch.equal(x, want[0]) and torch.equal(log_q, want[1])


# ---- change_base's training --------------------------------------------------------

def jax_model_like(tmodel, base, layers):
    """The JAX script's model (``build_flows``; the base of ``base``) holding
    the port model's tensors."""
    flows = []
    for i in range(layers):
        flows.append(jflows.AffineCouplingBlock.create(
            JMLP.create(jax.random.key(i), [1, 64, 64, 2], init_zeros=True)))
        flows.append(jflows.Permute.create(2, mode="swap"))
    q0 = jdist.DiagGaussian.create(2) if base == "gaussian" else jdist.GaussianMixture.create(
        2, 2, loc=jnp.asarray([[-2.0, 0.0], [2.0, 0.0]]), scale=jnp.full((2, 2), 0.3))
    return jax_model_of(tmodel, jnf.NormalizingFlow.create(q0, flows, p=jdist.TwoMoons()))


def jax_trainer(jm):
    opt = optax.adam(change_base.LR)
    diff, rest = jnf.partition(jm)

    @jax.jit
    def step(diff, ostate, x):
        loss, g = jax.value_and_grad(lambda d: jnf.combine(d, rest).forward_kld(x))(diff)
        updates, ostate = opt.update(g, ostate, diff)
        return optax.apply_updates(diff, updates), ostate, loss

    return step, diff, rest, opt.init(diff)


@pytest.mark.parametrize("base", change_base.BASES)
def test_change_base_steps_match_jax(base):
    steps, layers, seed = 20, 4, 0
    model = change_base.build_model(base, seed, "cpu", layers)
    step, diff, rest, ostate = jax_trainer(jax_model_like(model, base, layers))
    x_train = change_base.draws(change_base.N_TRAIN, 100 + seed, "cpu")
    batches = change_base.host_batches(x_train, steps, seed)
    state, chunk = change_base.make_trainer(model, x_train, steps, batches)
    losses = chunk(state)[1]["loss"]
    bs = change_base.BATCH
    for i in range(steps):
        diff, ostate, jloss = step(diff, ostate, jnp.asarray(batches[i * bs:(i + 1) * bs].numpy()))
        assert_close(float(losses[i]), float(jloss), atol=LOSS_TOL, rtol=LOSS_TOL, msg=f"step {i}")
    assert float(losses[-1]) < float(losses[0])


def test_example_runs_on_the_cpu():
    record = change_base.main(["--device", "cpu", "--iters", "20", "--chunk", "10",
                               "--layers", "2", "--host-inputs"])
    assert [r["base"] for r in record["runs"]] == list(change_base.BASES)
    assert all(r["non_finite_steps"] == 0 and np.isfinite(r["held_out_nll"])
               for r in record["runs"])


# ---- the example replayed through the JAX package ----------------------------
#
# ``replay`` trains the JAX package's model holding the port example's
# initial weights for one base at a seed, on the data and batches
# ``change_base --host-inputs`` draws from that seed, and reports the
# held-out NLL on the example's 4,096 held-out draws.  One JSON line a seed
# and base:
#
#     JAX_PLATFORMS=cpu python -m tests.test_torch_bases [--seeds 0-2] [--iters 2000]
#         [--base gaussian mixture]


def replay(seed, base, iters=2000, layers=32):
    seed = seed + change_base.BASES.index(base)  # as change_base.run offsets it
    model = change_base.build_model(base, seed, "cpu", layers)
    step, diff, rest, ostate = jax_trainer(jax_model_like(model, base, layers))
    x_train = change_base.draws(change_base.N_TRAIN, 100 + seed, "cpu").numpy()
    x_test = change_base.draws(change_base.N_TEST, 999 + seed, "cpu").numpy()
    idx = np.random.default_rng(seed).integers(0, x_train.shape[0], iters * change_base.BATCH)
    losses = []
    for i in range(iters):
        rows = idx[i * change_base.BATCH:(i + 1) * change_base.BATCH]
        diff, ostate, loss = step(diff, ostate, jnp.asarray(x_train[rows]))
        losses.append(float(loss))
    nll = float(jax.jit(lambda d, x: -jnp.mean(jnf.combine(d, rest).log_prob(x)))(
        diff, jnp.asarray(x_test)))
    return {"seed": seed, "base": base, "first": losses[0], "last": losses[-1],
            "held_out_nll": nll, "non_finite_steps": int(sum(not np.isfinite(v) for v in losses)),
            "iters": iters, "layers": layers, "side": "jax-cpu"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-2")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--base", nargs="+", default=list(change_base.BASES),
                    choices=change_base.BASES)
    args = ap.parse_args()
    lo, _, hi = args.seeds.partition("-")
    for seed in range(int(lo), int(hi or lo) + 1):
        for base in args.base:
            print(json.dumps(replay(seed, base, args.iters)), flush=True)


if __name__ == "__main__":
    main()
