"""The port's samplers (``normflows_tpu_torch.sampling``: dual-averaging
adaptation, annealed SMC, NeuTra HMC) against the JAX package's on the
CPU, from the same weights (``load_jax_leaves``) and on JAX's own draws,
re-derived from its keys by repeating its splits (``adaptation.py:58-59,
:98-104``, ``smc.py:99-106``, ``neutra.py:76-84``) and fed through the
port's ``noise=`` hooks:

* ``dual_averaging_update`` and ``hmc_accept_prob`` on the same inputs;
* ``adapt_step_size``: the accept rates, the tuned step size;
* ``systematic_resample`` on JAX's ``u`` (equal indices) and
  ``effective_sample_size``;
* ``AnnealedSMC`` with a DiagGaussian proposal (and, in
  tests/test_torch_smc_flow.py, with a 2-layer circular AR spline flow at
  hidden 8: JAX's default CPU path, the jnp spline): particles, ``log_w``,
  ``log_z`` and the resampling decisions (JAX's read from its ESS at each
  temperature); the truncated-ladder ``ValueError``;
* ``NeuTraHMC.sample`` with a small flow;
* for each sampler, a generator against the noise drawn from it.

Bars: TOL on values (float32 on two sides, the HMC moves' leapfrog steps
compounding), LOGZ_TOL on the accumulated log Z.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normflows_tpu as jnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu.sampling import adaptation as jadapt
from normflows_tpu.sampling import smc as jsmc
from normflows_tpu.nets import MLP as JMLP
from normflows_tpu.sampling import AnnealedSMC as JSMC, NeuTraHMC as JNeuTra
import normflows_tpu_torch as nft
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.interop import load_jax_leaves
from normflows_tpu_torch.nets import MLP
from normflows_tpu_torch.sampling import (AnnealedSMC, NeuTraHMC, adapt_step_size,
                                          dual_averaging_init, dual_averaging_update,
                                          effective_sample_size, hmc_accept_prob,
                                          systematic_resample)

torch.set_num_threads(2)

TOL = 1e-4
LOGZ_TOL = 1e-4
# NeuTra's pushed-forward draws: HMC moves through a flow in two float32
# implementations (a 4-move, 3-step run through a spline flow had 1
# element of 512 at 3.4e-4)
X_TOL = 1e-3


def t(a):
    return torch.from_numpy(np.array(a))


def leaves_of(jmodel):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(jmodel)[0]}


def jhmc(target, dim=2, step=0.3, steps=4):
    return jflows.HamiltonianMonteCarlo.create(target, steps, jnp.full(dim, np.log(step)),
                                               jnp.zeros(dim))


def thmc(target, dim=2, step=0.3, steps=4):
    return tflows.HamiltonianMonteCarlo(target, steps, np.full(dim, np.log(step), np.float32),
                                        np.zeros(dim, np.float32), device="cpu")


def two_moons():
    return jdist.TwoMoons(), tdist.TwoMoons(device="cpu")


def hmc_draws(key, shape):
    """JAX's HamiltonianMonteCarlo.forward draws from ``key``."""
    kp, ka = jax.random.split(key)
    return (np.array(jax.random.normal(kp, shape, jnp.float32)),
            np.array(jax.random.uniform(ka, (shape[0],), jnp.float32)))


def adapt_draws(key, num_adapt, shape):
    """JAX's adapt_step_size draws (adaptation.py:58-59, :98-104)."""
    p_acc, p_move, u_move = [], [], []
    for step_key in jax.random.split(key, num_adapt):
        k1, k2 = jax.random.split(step_key)
        kp, _ = jax.random.split(k1)
        p_acc.append(np.array(jax.random.normal(kp, shape, jnp.float32)))
        p, u = hmc_draws(k2, shape)
        p_move.append(p)
        u_move.append(u)
    return np.stack(p_acc), np.stack(p_move), np.stack(u_move)


def test_dual_averaging_update_matches_jax():
    js, ts = jadapt.dual_averaging_init(0.3), dual_averaging_init(0.3)
    for a in (0.2, 0.95, 0.5, 0.81, 0.0, 1.0):
        js = jadapt.dual_averaging_update(js, jnp.float32(a), target=0.8)
        ts = dual_averaging_update(ts, torch.tensor(a), target=0.8)
        for x, y in zip(ts, js):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)


def test_hmc_accept_prob_matches_jax():
    jt, tt = two_moons()
    z = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32)
    key = jax.random.key(3)
    kp, _ = jax.random.split(key)
    want = jadapt.hmc_accept_prob(jhmc(jt), jnp.asarray(z), key)
    got = hmc_accept_prob(thmc(tt), t(z), noise=np.array(jax.random.normal(kp, z.shape)))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-6)


def test_adapt_step_size_matches_jax():
    jt, tt = two_moons()
    z = (1.5 * np.random.default_rng(1).normal(size=(128, 2))).astype(np.float32)
    key, n = jax.random.key(7), 12
    jtuned, jinfo = jax.jit(lambda k, z: jadapt.adapt_step_size(
        jhmc(jt, step=1.0), k, z, num_adapt=n))(key, jnp.asarray(z))
    hmc = thmc(tt, step=1.0)
    tuned, info = adapt_step_size(hmc, t(z), n, noise=adapt_draws(key, n, z.shape))
    np.testing.assert_allclose(info["accept_rate"].numpy(), np.asarray(jinfo["accept_rate"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tuned.log_step_size.detach().numpy(),
                               np.asarray(jtuned.log_step_size), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(info["final_step_size"].numpy(),
                               np.asarray(jinfo["final_step_size"]), atol=TOL, rtol=TOL)
    assert tuned.target is hmc.target  # shared, not copied
    # a generator is the noise drawn from it: per iteration p_accept, p_move, u_move
    g = torch.Generator().manual_seed(2)
    a, ia = adapt_step_size(hmc, t(z), 3, generator=torch.Generator().manual_seed(2))
    draws = [(torch.randn(z.shape, generator=g), torch.randn(z.shape, generator=g),
              torch.rand(z.shape[0], generator=g)) for _ in range(3)]
    b, ib = adapt_step_size(hmc, t(z), 3, noise=[torch.stack(d) for d in zip(*draws)])
    assert torch.equal(a.log_step_size, b.log_step_size)
    assert torch.equal(ia["accept_rate"], ib["accept_rate"])


@pytest.mark.parametrize("weights", ["uniform", "skewed", "degenerate"])
def test_systematic_resample_matches_jax(weights):
    n = 257
    rng = np.random.default_rng(4)
    log_w = {"uniform": np.zeros(n), "skewed": 3.0 * rng.normal(size=n),
             "degenerate": np.where(np.arange(n) == 7, 0.0, -np.inf)}[weights]
    log_w = log_w.astype(np.float32)
    particles = np.arange(n, dtype=np.float32)[:, None]
    key = jax.random.key(9)
    want, _ = jsmc.systematic_resample(key, jnp.asarray(log_w), jnp.asarray(particles))
    u = np.array(jax.random.uniform(key, ()))
    got, reset = systematic_resample(t(log_w), t(particles), u=t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(reset, torch.zeros(n))
    np.testing.assert_allclose(float(effective_sample_size(t(log_w))),
                               float(jsmc.effective_sample_size(jnp.asarray(log_w))),
                               rtol=1e-5)
    g = torch.Generator().manual_seed(1)
    a, _ = systematic_resample(t(log_w), t(particles), generator=torch.Generator().manual_seed(1))
    b, _ = systematic_resample(t(log_w), t(particles), u=torch.rand((), generator=g))
    assert torch.equal(a, b)


SCALE = np.array([1.0, 2 * np.pi], np.float32)
TAIL_BOUND = np.array([5.0, np.pi], np.float32)


def spline_flows(layers=2, hidden=8):
    """The flagship cut to ``layers`` circular AR spline layers of hidden
    ``hidden``, random weights: (JAX model, port model)."""
    jbase = jdist.UniformGaussian.create(2, [1], jnp.asarray(SCALE))
    jl = [jflows.CircularAutoregressiveRationalQuadraticSpline.create(
        jax.random.key(i), 2, 1, hidden, ind_circ=[1], num_bins=6,
        tail_bound=jnp.asarray(TAIL_BOUND), permute_mask=True, rng_seed=i,
        init_identity=False) for i in range(layers)]
    jm = jnf.NormalizingFlow.create(jbase, jl, p=jdist.GaussianVonMises())
    tbase = tdist.UniformGaussian.create(2, [1], SCALE, device="cpu")
    tl = [tflows.CircularAutoregressiveRationalQuadraticSpline.create(
        None, 2, 1, hidden, ind_circ=[1], num_bins=6, tail_bound=TAIL_BOUND,
        permute_mask=True, rng_seed=i, init_identity=False, device="cpu")
        for i in range(layers)]
    tm = nft.NormalizingFlow.create(tbase, tl, p=tdist.GaussianVonMises(device="cpu"),
                                    device="cpu")
    return jm, load_jax_leaves(tm, leaves_of(jm))


def smc_pair(kind):
    if kind == "diag":
        jp, tp = jdist.DiagGaussian.create(2), tdist.DiagGaussian(2, device="cpu")
        jt, tt = two_moons()
        return jp, tp, jt, tt
    jm, tm = spline_flows()
    return jm, tm, jdist.GaussianVonMises(), tdist.GaussianVonMises(device="cpu")


def smc_draws(key, kind, n, temps):
    """JAX's AnnealedSMC.sample draws (smc.py:99-106) in the port's layout."""
    k0, key = jax.random.split(key)
    if kind == "diag":
        eps0 = np.array(jax.random.normal(k0, (n, 2), jnp.float32))
    else:  # NormalizingFlow.sample -> UniformGaussian.sample (ind = [1])
        kq, _ = jax.random.split(k0)
        ku, kg = jax.random.split(kq)
        u = np.array(jax.random.uniform(ku, (n, 1)))
        eps0 = np.concatenate([np.array(jax.random.normal(kg, (n, 1))), u], 1)
    noises = []
    for _ in range(1, temps):
        key, kr, km = jax.random.split(key, 3)
        noises.append((np.array(jax.random.uniform(kr, ())), *hmc_draws(km, (n, 2))))
    return eps0, noises


def test_annealed_smc_matches_jax(monkeypatch):
    check_annealed_smc("diag", monkeypatch)


def check_annealed_smc(kind, monkeypatch):
    """AnnealedSMC against JAX's on JAX's draws (``kind``: the DiagGaussian
    proposal or the spline flow, whose case lives in
    tests/test_torch_smc_flow.py to share the JAX compile time out)."""
    n, betas = 256, (0.0, 0.02, 1.0)  # a short rung, then a long one
    temps = len(betas)
    jp, tp, jt, tt = smc_pair(kind)
    essj = []
    real_ess = jsmc.effective_sample_size
    monkeypatch.setattr(jsmc, "effective_sample_size",
                        lambda lw: essj.append(real_ess(lw)) or essj[-1])
    jsampler = JSMC.create(jp, jt, betas=betas, num_leapfrog=2, step_size=0.2,
                           ess_threshold=0.9)
    key = jax.random.key(5)

    def run(k):  # the ESS at each temperature comes out of the jitted ladder
        essj.clear()
        return jsampler.sample(k, n), list(essj)

    (zj, lwj, lzj), essj = jax.jit(run)(key)
    sampler = AnnealedSMC.create(tp, tt, betas=betas, num_leapfrog=2, step_size=0.2,
                                 ess_threshold=0.9)
    zt, lwt, lzt = sampler.from_noise(*smc_draws(key, kind, n, temps))
    want_flags = np.array([float(e) < 0.9 * n for e in essj])
    np.testing.assert_array_equal(sampler.last_resampled.numpy(), want_flags)
    assert want_flags.any() and not want_flags.all()  # both branches ran
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lwt.numpy(), np.asarray(lwj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(lzt), float(lzj), atol=LOGZ_TOL, rtol=0)
    # a generator is the noise drawn from it: the proposal's, then per
    # temperature the resampling uniform, the momentum normals, the accept uniforms
    a = sampler.sample(64, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    noise_spec = tp.q0.noise_spec if kind == "flow" else tp.noise_spec
    eps0 = tdist.base.draw_noise(noise_spec, (2,), 64, generator=g)
    noises = [(torch.rand((), generator=g), torch.randn(64, 2, generator=g),
               torch.rand(64, generator=g)) for _ in range(temps - 1)]
    b = sampler.from_noise(eps0, noises)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_truncated_ladder_raises():
    jp, tp, jt, tt = smc_pair("diag")
    for betas in ([0.1, 0.5, 1.0], [0.0, 0.5, 0.9]):
        with pytest.raises(ValueError, match="betas must run 0.0 -> 1.0"):
            JSMC.create(jp, jt, betas=betas)
        with pytest.raises(ValueError, match="betas must run 0.0 -> 1.0"):
            AnnealedSMC.create(tp, tt, betas=betas)


def neutra_pair():
    """A small flow: DiagGaussian base, two masked affine couplings on MLP
    [2, 8, 2] nets (JAX's random init), a shifted DiagGaussian target."""
    masks = [np.array([1.0, 0.0], np.float32), np.array([0.0, 1.0], np.float32)]
    jl = [jflows.MaskedAffineFlow.create(
        jnp.asarray(b), t=JMLP.create(jax.random.key(10 + 2 * i), [2, 8, 2]),
        s=JMLP.create(jax.random.key(11 + 2 * i), [2, 8, 2])) for i, b in enumerate(masks)]
    jtarget = jdist.DiagGaussian.create(2).replace(loc=jnp.array([[0.5, -0.3]]))
    jm = jnf.NormalizingFlow.create(jdist.DiagGaussian.create(2), jl, p=jtarget)
    tl = [tflows.MaskedAffineFlow.create(b, t=MLP([2, 8, 2], device="cpu"),
                                         s=MLP([2, 8, 2], device="cpu"), device="cpu")
          for b in masks]
    tm = nft.NormalizingFlow.create(tdist.DiagGaussian(2, device="cpu"), tl,
                                    p=tdist.DiagGaussian(2, device="cpu"), device="cpu")
    return jm, load_jax_leaves(tm, leaves_of(jm))


def test_neutra_matches_jax():
    chains, steps, adapt = 64, 4, 6
    jm, tm = neutra_pair()
    key = jax.random.key(13)
    xj, infoj = jax.jit(lambda k: JNeuTra.create(jm, num_leapfrog=3).sample(
        k, chains, steps, num_adapt=adapt))(key)
    k_init, k_adapt, k_run = jax.random.split(key, 3)
    eps0 = np.array(jax.random.normal(k_init, (chains, 2)))
    run = [hmc_draws(k, (chains, 2)) for k in jax.random.split(k_run, steps)]
    noise = (eps0, adapt_draws(k_adapt, adapt, (chains, 2)),
             (np.stack([r[0] for r in run]), np.stack([r[1] for r in run])))
    sampler = NeuTraHMC.create(tm, num_leapfrog=3)
    xt, infot = sampler.sample(chains, steps, num_adapt=adapt, noise=noise)
    assert xt.shape == (steps, chains, 2)
    np.testing.assert_allclose(infot["accept_rate"].numpy(), np.asarray(infoj["accept_rate"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=X_TOL, rtol=X_TOL)
    # a generator is the noise drawn from it: the base's, the adaptation's,
    # then each move's
    a, _ = sampler.sample(16, 2, num_adapt=2, generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    eps = torch.randn(16, 2, generator=g)
    ad = [(torch.randn(16, 2, generator=g), torch.randn(16, 2, generator=g),
           torch.rand(16, generator=g)) for _ in range(2)]
    mv = [(torch.randn(16, 2, generator=g), torch.rand(16, generator=g)) for _ in range(2)]
    b, _ = sampler.sample(16, 2, num_adapt=2, noise=(
        eps, [torch.stack(d) for d in zip(*ad)], [torch.stack(d) for d in zip(*mv)]))
    assert torch.equal(a, b)
