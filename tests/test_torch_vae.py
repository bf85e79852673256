"""The flow-VAE in the port (``distributions.encoder``,
``distributions.decoder``, ``NormalizingFlowVAE``, the examples
``vae_flow`` and ``plain_vae``) against the JAX package on the CPU, from the
same weights and the same encoder noise:

* every encoder's draws and ``log_prob``, JAX's reshapes of a 1-D and a 2-D
  ``z`` included; both decoders, x tiled to z's batch;
* ``NormalizingFlowVAE`` with planar flows and without a decoder, on the
  noise JAX's encoder draws from its key;
* 20 steps of the example's training on host-drawn rows and encoder noise
  against the JAX package's steps on the same inputs;
* the examples' wiring on a small local ``--data-npz`` file;
* :func:`replay`, the example's training through the JAX package on the
  port example's initial weights and host-drawn inputs, which sets the
  card's bars: ``JAX_PLATFORMS=cpu python -m tests.test_torch_vae --seeds 0-2``.

Bars: 1e-5 (atol and rtol) on draws and log-densities of a few nats, 1e-5
relative on log-densities of hundreds of nats; 1e-4 relative on the losses
of the training steps (-ELBO ~ 550 nats).
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
from normflows_tpu_torch import NormalizingFlowVAE
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.examples import plain_vae, vae_flow
from normflows_tpu_torch.nets import MLP
from tests.helpers import assert_close
from tests.test_torch_stochastic import jax_model_of, normal, ported, t

torch.set_num_threads(2)

TOL, LOSS_TOL = 1e-5, 1e-4
B, S, D, LATENT = 8, 3, 12, 4


def jmlp(seed, sizes):
    return JMLP.create(jax.random.key(seed), sizes)


def tmlp(sizes):
    return MLP.create(None, sizes, device="cpu")


def close(a, b, tol=TOL, msg=""):
    assert_close(a.detach().numpy(), np.asarray(b), atol=tol, rtol=tol, msg=msg)


SHAPES = ((B, S, LATENT), (B, LATENT), (LATENT,))


def test_encoders_match_jax():
    """Every encoder's draws, on JAX's draws from its key, and ``log_prob``
    on z of 3, 2 and 1 dims; the JAX side in one compiled function."""
    x = normal(1, B, D)
    key = jax.random.key(2)
    ju = jdist.UniformEncoder(zmin=-1.0, zmax=2.0)
    jc = jdist.ConstDiagGaussian.create(normal(3, LATENT), np.exp(normal(4, LATENT, scale=0.3)))
    jn = jdist.NNDiagGaussian(net=jmlp(5, [D, 16, 2 * LATENT]))
    tc = ported(jc, tdist.ConstDiagGaussian(np.zeros(LATENT), np.ones(LATENT), device="cpu"))
    tn = ported(jn, tdist.NNDiagGaussian(tmlp([D, 16, 2 * LATENT])))
    zs = [normal(7, *shape) for shape in SHAPES]

    @jax.jit
    def jax_side(jc, jn, x, zs):
        out = {"dirac": jdist.Dirac().sample_and_log_prob(key, x, S),
               "uniform": ju.sample_and_log_prob(key, x, S),
               "uniform_eps": jax.random.uniform(key, (B, S, D)),
               "eps": jax.random.normal(key, (B, S, LATENT)),
               "const": jc.sample_and_log_prob(key, x, S),
               "nn": jn.sample_and_log_prob(key, x, S)}
        for i, z in enumerate(zs):
            out[f"const_lp{i}"] = jc.log_prob(z, x)
            out[f"nn_lp{i}"] = jn.log_prob(z, x[:1] if z.ndim < 3 else x)
        return out

    want = jax_side(jc, jn, jnp.asarray(x), [jnp.asarray(z) for z in zs])
    tz, tlq = tdist.Dirac()(t(x), S)
    assert torch.equal(tz, t(want["dirac"][0])) and torch.equal(tlq, t(want["dirac"][1]))
    assert torch.equal(tdist.Dirac().from_noise(torch.zeros(B, S, D), t(x))[0], tz)
    got = {"uniform": tdist.UniformEncoder(-1.0, 2.0).from_noise(t(want["uniform_eps"]), t(x)),
           "const": tc.from_noise(t(want["eps"]), t(x)),
           "nn": tn.from_noise(t(want["eps"]), t(x))}
    for name, (z, log_q) in got.items():
        close(z, want[name][0], msg=name)
        close(log_q, want[name][1], msg=name)
    g = torch.Generator().manual_seed(6)
    z1, lq1 = tn(t(x), S, generator=g)
    assert z1.shape == (B, S, LATENT) and lq1.shape == (B, S)
    close(tn.log_prob(z1, t(x)), lq1.detach())
    # log_prob, with JAX's reshapes of a 1-D and a 2-D z
    for i, z in enumerate(zs):
        for name, te, xs in (("const", tc, x), ("nn", tn, x[:1] if z.ndim < 3 else x)):
            got, w = te.log_prob(t(z), t(xs)), want[f"{name}_lp{i}"]
            assert got.shape == w.shape, (name, z.shape, got.shape, w.shape)
            close(got, w, msg=f"{name} {z.shape}")


def test_decoders_match_jax():
    z = normal(8, 2 * B, LATENT)  # two samples a row of x
    x = normal(9, B, D)
    xb = (normal(11, B, D) > 0).astype(np.float32)
    jg = jdist.NNDiagGaussianDecoder(net=jmlp(10, [LATENT, 16, 2 * D]))
    jb = jdist.NNBernoulliDecoder(net=jmlp(12, [LATENT, 16, D]))
    tg = ported(jg, tdist.NNDiagGaussianDecoder(tmlp([LATENT, 16, 2 * D])))
    tb = ported(jb, tdist.NNBernoulliDecoder(tmlp([LATENT, 16, D])))
    want = jax.jit(lambda jg, jb, x, xb, z: (jg(z), jg.log_prob(x, z), jb(z), jb.log_prob(xb, z)))(
        jg, jb, jnp.asarray(x), jnp.asarray(xb), jnp.asarray(z))
    for got, w in zip(tg(t(z)), want[0]):
        close(got, w)
    close(tg.log_prob(t(x), t(z)), want[1])
    close(tb(t(z)), want[2])
    lp = tb.log_prob(t(xb), t(z))
    assert lp.shape == (2 * B,) and bool((lp <= 0).all())
    close(lp, want[3])
    far = t(100.0 * normal(13, B, LATENT))  # saturated logits: the stable form stays finite
    assert torch.isfinite(tb.log_prob(t(xb), far)).all()


def vae_pair(k=2, decoder=True):
    """A flow-VAE (k planar layers, a Bernoulli decoder or none): JAX's and the
    port's holding its weights."""
    keys = jax.random.split(jax.random.key(14), 3 + k)
    jm = jnf.NormalizingFlowVAE.create(
        jdist.DiagGaussian.create(LATENT).replace(loc=jnp.asarray(normal(15, 1, LATENT))),
        jdist.NNDiagGaussian(net=JMLP.create(keys[0], [D, 16, 2 * LATENT])),
        [jflows.Planar.create((LATENT,), key=keys[3 + i]) for i in range(k)],
        jdist.NNBernoulliDecoder(net=JMLP.create(keys[1], [LATENT, 16, D])) if decoder else None)
    tm = NormalizingFlowVAE.create(
        tdist.DiagGaussian(LATENT, device="cpu"), tdist.NNDiagGaussian(tmlp([D, 16, 2 * LATENT])),
        [tflows.Planar((LATENT,), device="cpu") for _ in range(k)],
        tdist.NNBernoulliDecoder(tmlp([LATENT, 16, D])) if decoder else None)
    return jm, ported(jm, tm)


@pytest.mark.parametrize("k,decoder", [(2, True), (0, True), (2, False)])
def test_flow_vae_matches_jax_on_its_encoder_noise(k, decoder):
    jm, tm = vae_pair(k, decoder)
    x = (normal(16, B, D) > 0).astype(np.float32)
    key = jax.random.key(17)
    (jz, jlq, jlp), eps = jax.jit(lambda m, x: (m(key, x, S), jax.random.normal(
        key, (B, S, LATENT))))(jm, jnp.asarray(x))  # eps: what JAX's encoder draws
    eps = t(eps)
    tz, tlq, tlp = tm(t(x), S, noise=eps)
    assert tz.shape == (B, S, LATENT) and tlq.shape == tlp.shape == (B, S)
    close(tz, jz)
    close(tlq, jlq)
    close(tlp, jlp)
    tz2, _, _ = tm(t(x), S, generator=torch.Generator().manual_seed(18))
    assert tz2.shape == (B, S, LATENT) and not torch.equal(tz2, tz)


# ---- the example's training --------------------------------------------------------

def jax_neg_elbo(m, x, eps):
    """``NormalizingFlowVAE.__call__`` of the JAX package on given encoder
    noise ``eps`` (B, S, latent), line by line, then -mean(log p - log q)."""
    mean_std = m.q0.net(x)
    n = mean_std.shape[1] // 2
    mean, std = mean_std[:, :n][:, None], jnp.exp(0.5 * mean_std[:, n:2 * n][:, None])
    z = mean + std * eps
    log_q = -0.5 * n * np.log(2 * np.pi) - jnp.sum(jnp.log(std) + 0.5 * eps**2, axis=2)
    samples = z.shape[1]
    z, log_q = z.reshape(-1, n), log_q.reshape(-1)
    for flow in m.flows:
        z, ld = flow.forward(z)
        log_q = log_q - ld
    log_p = m.prior.log_prob(z) + m.decoder.log_prob(jnp.repeat(x, samples, axis=0), z)
    return -jnp.mean(log_p - log_q)


def jax_vae_of(tmodel, k, d, latent):
    """The JAX script's flow-VAE holding the port model's weights."""
    keys = jax.random.split(jax.random.key(0), 2 + max(k, 1))
    jm = jnf.NormalizingFlowVAE.create(
        jdist.DiagGaussian.create(latent),
        jdist.NNDiagGaussian(net=JMLP.create(keys[0], [d, 512, 256, 2 * latent])),
        [jflows.Planar.create((latent,), key=keys[2 + i]) for i in range(k)],
        jdist.NNBernoulliDecoder(net=JMLP.create(keys[1], [latent, 256, 512, d])))
    return jax_model_of(tmodel, jm)


def jax_trainer(jm, lr):
    opt = optax.adam(lr)
    diff, rest = jnf.partition(jm)

    @jax.jit
    def step(diff, ostate, x, eps):
        loss, g = jax.value_and_grad(lambda d: jax_neg_elbo(jnf.combine(d, rest), x, eps))(diff)
        updates, ostate = opt.update(g, ostate, diff)
        return optax.apply_updates(diff, updates), ostate, loss

    return step, diff, rest, opt.init(diff)


def test_training_steps_match_jax():
    """20 Adam(1e-3) steps of the example (K = 10, latent 40, 784 -> 512 ->
    256) on its host-drawn rows and encoder noise: every loss."""
    steps, batch, seed = 20, 256, 0
    x_all = torch.from_numpy(vae_flow.synthetic_digits(vae_flow.N_DIGITS, seed))
    x_train = x_all[:-vae_flow.HELD_OUT]
    model = vae_flow.build_vae(784, 40, 10, seed, "cpu")
    jstep, diff, rest, ostate = jax_trainer(jax_vae_of(model, 10, 784, 40), 1e-3)
    inputs = vae_flow.host_inputs(x_train, steps, batch, 40, seed + 1)
    state, chunk = vae_flow.make_trainer(model, x_train, batch, 1e-3, steps, inputs)
    losses = chunk(state)[1]["loss"]
    for i in range(steps):
        rows = slice(i * batch, (i + 1) * batch)
        diff, ostate, jloss = jstep(diff, ostate, jnp.asarray(inputs[0][rows].numpy()),
                                    jnp.asarray(inputs[1][rows].numpy()))
        assert_close(float(losses[i]), float(jloss), atol=0, rtol=LOSS_TOL, msg=f"step {i}")
    assert float(losses[-1]) < float(losses[0])


def test_examples_run_on_a_local_file(tmp_path):
    """Both examples on a ``--data-npz`` file of 1,536 rows (512 to train,
    2 steps an epoch at batch 256), with and without host inputs."""
    path = tmp_path / "digits.npz"
    np.savez(path, x=vae_flow.synthetic_digits(1536, 3))
    _, flow = vae_flow.main(["--device", "cpu", "--epochs", "2", "--data-npz", str(path),
                             "--k", "2"])
    _, plain = plain_vae.main(["--device", "cpu", "--epochs", "2", "--data-npz", str(path),
                               "--host-inputs"])
    assert flow["k"] == 2 and plain["k"] == 0 and flow["steps"] == plain["steps"] == 12
    for r in (flow, plain):
        assert r["non_finite_steps"] == 0 and np.isfinite(r["held_out_neg_elbo"])
        assert r["data"] == str(path)


def test_held_out_rows_stay_out_of_training(monkeypatch, tmp_path):
    """A deviation from the JAX script, which trains on every row and holds
    none out: the example trains on all rows but the last HELD_OUT and
    reports the -ELBO of those on one fixed draw of the encoder's noise."""
    x = vae_flow.synthetic_digits(vae_flow.HELD_OUT + 512, 4)
    np.savez(tmp_path / "d.npz", x=x)
    seen = {}
    make = vae_flow.make_trainer

    def recorded(model, x_train, *args):
        seen["x_train"] = x_train
        return make(model, x_train, *args)

    monkeypatch.setattr(vae_flow, "make_trainer", recorded)
    model, record = vae_flow.main(["--device", "cpu", "--epochs", "1", "--k", "0",
                                   "--data-npz", str(tmp_path / "d.npz")])
    assert np.array_equal(seen["x_train"].numpy(), x[:512])
    held = vae_flow.held_out_neg_elbo(model, torch.from_numpy(x[512:]), 40, 0)
    assert record["held_out_neg_elbo"] == held


# ---- the example replayed through the JAX package ----------------------------
#
# ``replay`` trains the JAX package's flow-VAE holding the port example's
# initial weights at a seed, on the inputs ``vae_flow --host-inputs`` draws
# from that seed (960 steps: 15 epochs of 64), and reports the held-out
# -ELBO on the example's held-out rows and fixed evaluation noise.  One JSON
# line a seed and model:
#
#     JAX_PLATFORMS=cpu python -m tests.test_torch_vae [--seeds 0-2] [--epochs 15]


def replay(seed, k, epochs=15, batch=256, latent=40, lr=1e-3):
    x_all = vae_flow.synthetic_digits(vae_flow.N_DIGITS, seed)
    x_train, x_held = x_all[:-vae_flow.HELD_OUT], x_all[-vae_flow.HELD_OUT:]
    steps = epochs * (x_all.shape[0] // batch)
    model = vae_flow.build_vae(784, latent, k, seed, "cpu")
    step, diff, rest, ostate = jax_trainer(jax_vae_of(model, k, 784, latent), lr)
    # vae_flow.host_inputs's draws, gathered a step at a time
    rng = np.random.default_rng(seed + 1)
    idx = rng.integers(0, x_train.shape[0], (steps, batch))
    eps = rng.normal(size=(steps * batch, vae_flow.NUM_SAMPLES, latent)).astype(np.float32)
    losses = []
    for i in range(steps):
        diff, ostate, loss = step(diff, ostate, jnp.asarray(x_train[idx[i]]),
                                  jnp.asarray(eps[i * batch:(i + 1) * batch]))
        losses.append(float(loss))
    held = float(jax.jit(jax_neg_elbo)(jnf.combine(diff, rest), jnp.asarray(x_held),
                                       jnp.asarray(vae_flow.eval_noise(latent, seed).numpy())))
    return {"seed": seed, "k": k, "first": losses[0], "last_epoch": float(np.mean(
        losses[-steps // epochs:])), "held_out_neg_elbo": held,
        "non_finite_steps": int(sum(not np.isfinite(v) for v in losses)), "steps": steps,
        "side": "jax-cpu"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-2")
    ap.add_argument("--epochs", type=int, default=15)
    args = ap.parse_args()
    lo, _, hi = args.seeds.partition("-")
    for seed in range(int(lo), int(hi or lo) + 1):
        for k in (10, 0):
            print(json.dumps(replay(seed, k, args.epochs)), flush=True)


if __name__ == "__main__":
    main()
