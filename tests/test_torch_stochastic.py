"""Stochastic flows and HAIS in the port (``flows.stochastic``,
``distributions.mh_proposal``, ``distributions.linear_interpolation``,
``sampling.hais``, the facades' draws for MCMC layers) against the JAX
package on the CPU, from the same weights (``load_jax_leaves``) and the
same draws (both packages' ``noise=`` hooks):

* the proposal and the interpolation; MH and HMC on replayed noise (values
  and z within 1e-6, the log-det within 1e-6 of the largest |log p| it
  subtracts: float32 resolves a TwoMoons log-density of -30 to ~2e-6),
  HMC with ``max_abs_grad``;
* HMC's gradients w.r.t. ``log_step_size``, ``log_mass``, an upstream
  ``MaskedAffineFlow``'s weights and a trainable target against ``jax.grad``
  (1e-5 of their norms), and that a detached ``z`` in the target's gradient
  breaks them while the values stay (trap 1);
* HAIS through ``from_noise`` against the same ladder of JAX's layers;
* a generator against the noise drawn from it in the documented order
  (trap 3); the identity ``data_dep_init``; stationarity of both moves;
* the facade handing MCMC layers a generator, the detached pass of
  ``reverse_kld(score_fn=False)`` seeing each layer's first-pass draws, and
  ``from_noise`` replaying every draw of ``sample`` (the layers' too);
* ``load_jax_leaves`` on an SNF whose trainable target its MH layers and
  ``p`` share, and one Adam update a step of that shared target.

Run as a script, it gives the JAX package's own estimates for
``examples/snf_hais.py``'s ladder (4,096 chains, 30 rungs, the script's
key), jitted on the CPU, beside TwoMoons' quadrature log normaliser: the
reference figure for the card's HAIS.

    JAX_PLATFORMS=cpu python -m tests.test_torch_stochastic [--chains 4096] [--keys 1-3]
"""

import argparse
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normflows_tpu as jnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu.nets import MLP as JMLP
from normflows_tpu.sampling import HAIS as JHAIS
import normflows_tpu_torch as nft
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.examples import snf_hais
from normflows_tpu_torch.flows import stochastic
from normflows_tpu_torch.interop import _torch_name, load_jax_leaves
from normflows_tpu_torch.nets import MLP
from normflows_tpu_torch.nets.mlp import Linear
from normflows_tpu_torch.sampling import HAIS
from tests.helpers import assert_close

torch.set_num_threads(2)

TOL, G_TOL, B = 1e-6, 1e-5, 32


def leaves_of(jmodel):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(jmodel)[0]}


def ported(jmodel, tmodel):
    return load_jax_leaves(tmodel, leaves_of(jmodel))


def jax_model_of(tmodel, jmodel):
    """``jmodel`` holding the port model's tensors (the inverse of
    ``load_jax_leaves``; a tensor shared at several paths fills each)."""
    tensors = {**dict(tmodel.named_parameters(remove_duplicate=False)),
               **dict(tmodel.named_buffers(remove_duplicate=False))}
    paths, treedef = jax.tree_util.tree_flatten_with_path(jmodel)
    leaves = []
    for path, leaf in paths:
        name = _torch_name(jax.tree_util.keystr(path))
        value = np.array(tensors[name].detach().cpu())  # a copy: jnp.asarray may alias it
        owner, _, attr = name.rpartition(".")
        if attr in ("weight", "mask") and isinstance(tmodel.get_submodule(owner), Linear):
            value = value.T
        leaves.append(jnp.asarray(value, leaf.dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def uniform(seed, *shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def jax_grads_by_tensor(jgrads, tmodel):
    """JAX's gradient leaves summed onto the port's tensors (a module shared
    at several paths is one tensor in the port, whose gradient is the sum
    of the paths'), a ``Linear``'s (in, out) weight transposed; keyed by the
    port's first name of each tensor."""
    tensors = dict(tmodel.named_parameters(remove_duplicate=False))
    first = {id(p): n for n, p in reversed(list(tensors.items()))}
    out = {}
    for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        name = _torch_name(jax.tree_util.keystr(path))
        owner, _, attr = name.rpartition(".")
        g = np.asarray(g)
        if attr == "weight" and isinstance(tmodel.get_submodule(owner), Linear):
            g = g.T
        key = first[id(tensors[name])]
        out[key] = out.get(key, 0.0) + g
    return out


def relative_gaps(tmodel, want):
    return {n: float(np.linalg.norm(p.grad.numpy() - want[n]) / np.linalg.norm(want[n]))
            for n, p in tmodel.named_parameters()}


def jtwo_moons():
    return jdist.TwoMoons()


def ttwo_moons():
    return tdist.TwoMoons(device="cpu")


def jdiag_target(seed=3):
    """A trainable JAX DiagGaussian(2) off the origin."""
    return jdist.DiagGaussian.create(2).replace(
        loc=jnp.asarray(normal(seed, 1, 2)),
        log_scale=jnp.asarray(normal(seed + 1, 1, 2, scale=0.3)))


def mh_noise(seed, steps, n=B):
    return normal(seed, steps, n, 2), uniform(seed + 1, steps, n)


def hmc_noise(seed, n=B):
    return normal(seed, n, 2), uniform(seed + 1, n)


def ld_tol(target, *zs):
    """1e-6 of the largest |log p| a log-det subtracts."""
    with torch.no_grad():
        return TOL * max(float(target.log_prob(z).abs().max()) for z in zs)


def jcall(layer, z, noise):
    return jax.jit(lambda m, z, n: m.forward(z, noise=n))(layer, jnp.asarray(z), noise)


def test_proposal_and_interpolation_match_jax():
    jp = jdist.DiagGaussianProposal.create((2,), 0.3)
    tp = ported(jp, tdist.DiagGaussianProposal((2,), 0.3, device="cpu"))
    z, eps, z_ = normal(0, B, 2), normal(1, B, 2), normal(2, B, 2)
    jz, jr = jp.propose_from_noise(jnp.asarray(z), jnp.asarray(eps))
    tz, tr = tp.propose_from_noise(t(z), t(eps))
    assert_close(tz.numpy(), np.asarray(jz), atol=TOL, rtol=TOL)
    assert np.array_equal(tr.numpy(), np.asarray(jr)) and tr.shape == (B,)
    g, h = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    drawn = tp.propose_from_noise(t(z), torch.randn(B, 2, generator=h))[0]
    assert torch.equal(tp.sample(t(z), g), drawn)
    assert_close(tp.log_prob(t(z_), t(z)).numpy(),
                 np.asarray(jp.log_prob(jnp.asarray(z_), jnp.asarray(z))), atol=TOL, rtol=TOL)
    ji = jdist.LinearInterpolation(dist1=jtwo_moons(), dist2=jdiag_target(), alpha=0.3)
    ti = ported(ji, tdist.LinearInterpolation(ttwo_moons(), tdist.DiagGaussian(2, device="cpu"),
                                              0.3))
    assert_close(ti.log_prob(t(z)).detach().numpy(), np.asarray(ji.log_prob(jnp.asarray(z))),
                 atol=TOL, rtol=TOL)


@pytest.mark.parametrize("target", ["two_moons", "diag"])
def test_mh_matches_jax_on_replayed_noise(target):
    jt = jtwo_moons() if target == "two_moons" else jdiag_target()
    tt = ttwo_moons() if target == "two_moons" else tdist.DiagGaussian(2, device="cpu")
    jm = jflows.MetropolisHastings(target=jt, proposal=jdist.DiagGaussianProposal.create((2,), 0.5),
                                   steps=3)
    tm = ported(jm, tflows.MetropolisHastings(tt, tdist.DiagGaussianProposal((2,), 0.5,
                                                                             device="cpu"), 3))
    z, noise = normal(4, B, 2, scale=1.5), mh_noise(5, 3)
    jz, jld = jcall(jm, z, noise)
    with torch.no_grad():
        tz, tld = tm(t(z), noise=tuple(map(t, noise)))
        tz_inv, tld_inv = tm.inverse(t(z), noise=tuple(map(t, noise)))
    assert_close(tz.numpy(), np.asarray(jz), atol=TOL, rtol=TOL)
    assert_close(tld.numpy(), np.asarray(jld), atol=ld_tol(tt, t(z), tz), rtol=TOL)
    assert torch.equal(tz, tz_inv) and torch.equal(tld, tld_inv)  # inverse == forward
    moved = (tz != t(z)).any(dim=1)
    assert 0 < int(moved.sum()) < B  # some chains accept, some reject
    with pytest.raises(ValueError, match="leading dim must equal steps=3"):
        tm(t(z), noise=mh_noise(5, 2))
    with pytest.raises(ValueError, match="stochastic flow layer"):
        tm(t(z))


@pytest.mark.parametrize("max_abs_grad", [None, 1.0])
def test_hmc_matches_jax_on_replayed_noise(max_abs_grad):
    jh = jflows.HamiltonianMonteCarlo.create(jtwo_moons(), 3, jnp.full(2, np.log(0.2)),
                                             jnp.full(2, 0.1), max_abs_grad=max_abs_grad)
    th = ported(jh, tflows.HamiltonianMonteCarlo(ttwo_moons(), 3, np.full(2, np.log(0.2)),
                                                 np.full(2, 0.1), max_abs_grad, device="cpu"))
    z, noise = normal(6, B, 2, scale=1.5), hmc_noise(7)
    jz, jld = jcall(jh, z, noise)
    tz, tld = th(t(z), noise=tuple(map(t, noise)))
    assert_close(tz.detach().numpy(), np.asarray(jz), atol=TOL, rtol=TOL)
    assert_close(tld.detach().numpy(), np.asarray(jld), atol=ld_tol(th.target, t(z), tz),
                 rtol=TOL)
    far = np.full((4, 2), 100.0, np.float32)
    assert_close(th.grad_log_p(t(far)).detach().numpy(),
                 np.asarray(jh.grad_log_p(jnp.asarray(far))),
                 atol=TOL, rtol=TOL)
    if max_abs_grad is not None:
        assert float(th.grad_log_p(t(far)).detach().abs().max()) <= max_abs_grad
    with torch.no_grad():  # sampling: the gradient taken with no graph kept
        tz_ng, tld_ng = th(t(z), noise=tuple(map(t, noise)))
    assert torch.equal(tz_ng, tz.detach()) and torch.equal(tld_ng, tld.detach())
    with torch.inference_mode(), pytest.raises(RuntimeError, match="inference_mode"):
        th(t(z), noise=tuple(map(t, noise)))


# ---- HMC's gradients: the double backward (trap 1) ---------------------------------

def hmc_pair():
    """A MaskedAffineFlow (random nets) before an HMC layer whose target is a
    trainable DiagGaussian: JAX's, and the port's holding its weights."""
    k1, k2 = jax.random.split(jax.random.key(8))
    b = jnp.asarray([1.0, 0.0])
    jmaf = jflows.MaskedAffineFlow.create(b, t=JMLP.create(k1, [2, 16, 2]),
                                          s=JMLP.create(k2, [2, 16, 2]))
    jh = jflows.HamiltonianMonteCarlo.create(jdiag_target(), 3, jnp.full(2, np.log(0.3)),
                                             jnp.asarray([0.1, -0.2]))
    g = torch.Generator().manual_seed(0)
    tmaf = tflows.MaskedAffineFlow(torch.tensor([1.0, 0.0]),
                                   t=MLP.create(g, [2, 16, 2], device="cpu"),
                                   s=MLP.create(g, [2, 16, 2], device="cpu"), device="cpu")
    th = tflows.HamiltonianMonteCarlo(tdist.DiagGaussian(2, device="cpu"), 3, np.zeros(2),
                                      np.zeros(2), device="cpu")
    jpair = (jmaf, jh)
    tpair = torch.nn.ModuleList([tmaf, th])
    load_jax_leaves(tpair, leaves_of(list(jpair)))
    return jpair, tpair


def pair_loss(layers, z0, noise, fns):
    """sum(z^2) + sum(log-dets) + sum(log p_target(z)) through both layers."""
    maf, hmc = layers
    z, ld0 = maf.forward(z0)
    z, ld1 = hmc.forward(z, noise=noise)
    return fns.sum(z**2) + fns.sum(ld0 + ld1) + fns.sum(hmc.target.log_prob(z))


def jax_pair_grads(jpair, z0, noise):
    diff, rest = jnf.partition(list(jpair))
    loss = lambda d: pair_loss(jnf.combine(d, rest), jnp.asarray(z0), noise, jnp)  # noqa: E731
    value, grads = jax.jit(jax.value_and_grad(loss))(diff)
    return float(value), grads


def test_hmc_gradients_match_jax_grad():
    jpair, tpair = hmc_pair()
    z0, noise = normal(9, B, 2), hmc_noise(10)
    jvalue, jgrads = jax_pair_grads(jpair, z0, noise)
    loss = pair_loss(tpair, t(z0), tuple(map(t, noise)), torch)
    loss.backward()
    assert_close(float(loss.detach()), jvalue, atol=1e-4, rtol=1e-5)
    gaps = relative_gaps(tpair, jax_grads_by_tensor(jgrads, tpair))
    assert {"1.log_step_size", "1.log_mass", "1.target.loc", "1.target.log_scale",
            "0.s_net.linears.0.weight"} <= set(gaps)
    assert max(gaps.values()) <= G_TOL, gaps


def test_detached_z_breaks_the_gradients(monkeypatch):
    """Trap 1: the target's gradient taken at a detached copy of a ``z`` that
    requires grad gives the same values, but gradients that miss JAX's."""
    jpair, tpair = hmc_pair()
    z0, noise = normal(9, B, 2), hmc_noise(10)
    jvalue, jgrads = jax_pair_grads(jpair, z0, noise)
    target = tpair[1].target

    def detached(z):
        z_ = z.detach().requires_grad_(True)
        return torch.autograd.grad(target.log_prob(z_).sum(), z_, create_graph=True)[0]

    monkeypatch.setattr(tpair[1], "grad_log_p", detached)
    loss = pair_loss(tpair, t(z0), tuple(map(t, noise)), torch)
    loss.backward()
    assert_close(float(loss.detach()), jvalue, atol=1e-4, rtol=1e-5)
    gaps = relative_gaps(tpair, jax_grads_by_tensor(jgrads, tpair))
    assert max(gaps.values()) > 100 * G_TOL, gaps


# ---- HAIS --------------------------------------------------------------------------

def hais_pair(betas=6, leapfrog=3):
    jprior, jtarget = jdist.DiagGaussian.create(2), jdiag_target(11)
    jh = JHAIS.create(np.linspace(1.0, 0.0, betas), jprior, jtarget, num_leapfrog=leapfrog,
                      step_size=jnp.full(2, 0.25), log_mass=jnp.zeros(2))
    th = HAIS.create(np.linspace(1.0, 0.0, betas), tdist.DiagGaussian(2, device="cpu"),
                     tdist.DiagGaussian(2, device="cpu"), leapfrog, np.full(2, 0.25),
                     np.zeros(2), device="cpu")
    return jh, ported(jh, th)


def test_hais_from_noise_matches_the_jax_ladder():
    """4 rungs of 3 leapfrog steps: the port's ``from_noise`` against the JAX
    ladder composed from its prior, layers and target on the same draws."""
    jh, th = hais_pair()
    eps0 = normal(12, B, 2)
    noise = [hmc_noise(13 + 2 * i) for i in range(len(th.layers))]

    @jax.jit
    def jladder(h, eps0, noise):
        z = h.prior.loc + jnp.exp(h.prior.log_scale) * eps0
        log_w = -h.prior.log_prob(z)
        for layer, n in zip(h.layers, noise):
            z, ld = layer.forward(z, noise=n)
            log_w = log_w + ld
        return z, log_w + h.target.log_prob(z)

    jz, jlw = jladder(jh, jnp.asarray(eps0), noise)
    with torch.no_grad():
        tz, tlw = th.from_noise(t(eps0), [tuple(map(t, n)) for n in noise])
    assert len(th.layers) == 4 and all(layer.target.dist1 is th.target for layer in th.layers)
    assert [layer.target.alpha for layer in th.layers] == pytest.approx([0.2, 0.4, 0.6, 0.8])
    assert_close(tz.numpy(), np.asarray(jz), atol=TOL, rtol=TOL)
    assert_close(tlw.numpy(), np.asarray(jlw), atol=1e-5, rtol=1e-5)


# ---- draws (trap 3) and the facade (module 4) ---------------------------------------

def test_generator_equals_the_noise_drawn_from_it():
    """MH: each step eps (B, 2) then w (B,); HMC: p_eps then u; HAIS: the
    prior's eps, then each rung's pair."""
    z = t(normal(14, B, 2))
    mh = tflows.MetropolisHastings(ttwo_moons(), tdist.DiagGaussianProposal((2,), 0.4,
                                                                            device="cpu"), 3)
    hmc = tflows.HamiltonianMonteCarlo(ttwo_moons(), 2, np.full(2, np.log(0.2)), np.zeros(2),
                                       device="cpu")
    _, hais = hais_pair(betas=4, leapfrog=2)
    g, h = torch.Generator().manual_seed(15), torch.Generator().manual_seed(15)
    with torch.no_grad():
        got_mh = mh(z, generator=g)
        draws = [(torch.randn(B, 2, generator=h), torch.rand(B, generator=h)) for _ in range(3)]
        want_mh = mh(z, noise=(torch.stack([d[0] for d in draws]),
                               torch.stack([d[1] for d in draws])))
        got_hmc = hmc(z, generator=g)
        want_hmc = hmc(z, noise=(torch.randn(B, 2, generator=h), torch.rand(B, generator=h)))
        got_hais = hais.sample(B, generator=g)
        eps0 = torch.randn(B, 2, generator=h)
        want_hais = hais.from_noise(eps0, [(torch.randn(B, 2, generator=h),
                                            torch.rand(B, generator=h)) for _ in hais.layers])
    for got, want in ((got_mh, want_mh), (got_hmc, want_hmc), (got_hais, want_hais)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(g.get_state(), h.get_state())


def snf(target=None, mcmc="mh", layers=2):
    model = snf_hais.build_snf("cpu", 0, mcmc, target)
    model.flows = torch.nn.ModuleList(list(model.flows)[:2 * layers])
    gen = torch.Generator().manual_seed(16)
    with torch.no_grad():  # the couplings' last layers drawn, so that they do work
        for m in model.modules():
            if isinstance(m, MLP):
                w = m.linears[-1].weight
                w.copy_(0.3 / np.sqrt(w.shape[1]) * torch.randn(w.shape, generator=gen))
    return model


def test_facade_hands_mcmc_layers_a_generator():
    model = snf()
    assert model._draws()
    torch.manual_seed(17)
    x, log_q = model.sample(B)  # no generator: the device's default one
    assert x.shape == (B, 2) and torch.isfinite(log_q).all()
    x2, _ = model.sample(B, generator=torch.Generator().manual_seed(18))
    x3, _ = model.sample(B, generator=torch.Generator().manual_seed(18))
    assert torch.equal(x2, x3)
    with pytest.raises(ValueError, match="stochastic flow layer"):
        model.log_prob(x)  # as the JAX layers raise without a key
    assert torch.isfinite(model.log_prob(x, generator=torch.Generator().manual_seed(19))).all()


def test_score_fn_false_sees_the_first_pass_draws(monkeypatch):
    """``reverse_kld(score_fn=False)``: each MH layer's call in the detached
    pass starts from the generator state of its call in the first pass, and
    the loss is the one computed from those draws by hand."""
    model = snf()
    calls = []
    forward = stochastic.MetropolisHastings.forward

    def recorded(self, z, context=None, *, generator=None, noise=None):
        calls.append((id(self), generator.get_state().clone()))
        return forward(self, z, context, generator=generator, noise=noise)

    monkeypatch.setattr(stochastic.MetropolisHastings, "forward", recorded)
    g = torch.Generator().manual_seed(20)
    loss = model.reverse_kld(B, score_fn=False, generator=g)
    mh = [id(f) for f in model.flows if isinstance(f, tflows.MetropolisHastings)]
    assert [c[0] for c in calls] == mh + mh[::-1]
    first, second = calls[:len(mh)], calls[len(mh):][::-1]
    assert all(torch.equal(a[1], b[1]) for a, b in zip(first, second))
    # by hand: the sample pass, then the detached inverse pass on the same draws
    h = torch.Generator().manual_seed(20)
    with torch.no_grad():
        z, _ = model.q0.sample_and_log_prob(B, generator=h)
        states = []
        for f in model.flows:
            states.append(h.get_state())
            z, _ = f.forward(z, generator=h)
        x, log_q = z, torch.zeros(B)
        for f, s in zip(reversed(model.flows), reversed(states)):
            h.set_state(s)
            x, ld = f.inverse(x, generator=h)
            log_q = log_q + ld
        want = torch.mean(log_q + model.q0.log_prob(x)) - torch.mean(model.p.log_prob(z))
    assert_close(float(loss.detach()), float(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mcmc", ["mh", "hmc"])
def test_from_noise_replays_every_draw_of_sample(mcmc):
    """``from_noise(eps, layer_noise=...)`` on ``draw_noise``'s draws is
    ``sample`` on the same generator, bit for bit: the base's noise, then
    each MCMC layer's draws in its order (what a serving bundle's sampler
    takes); without the layers' draws it raises."""
    model = snf(mcmc=mcmc)
    assert [i for i, _ in model.drawing_flows(B)] == [1, 3]
    with torch.no_grad():
        want = model.sample(B, generator=torch.Generator().manual_seed(17))
        eps, noise = model.draw_noise(B, generator=torch.Generator().manual_seed(17))
        got = model.from_noise(eps, layer_noise=noise)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="layer_noise"):
        model.from_noise(eps)


def test_identity_data_dep_init():
    """MCMC layers transport ActNorm's initialisation data unchanged, in
    both directions."""
    z = t(normal(21, B, 2))
    for layer in (snf().flows[1], tflows.HamiltonianMonteCarlo(
            ttwo_moons(), 2, np.zeros(2), np.zeros(2), device="cpu")):
        assert layer.data_dep_init(z) is z and layer.data_dep_init_forward(z) is z
    model = nft.NormalizingFlow.create(tdist.DiagGaussian(2, device="cpu"),
                                       [tflows.ActNorm((2,), device="cpu"), snf().flows[1]],
                                       device="cpu")
    x = 3.0 + 2.0 * z
    model.init_actnorm(x)
    y, _ = model.flows[0].inverse(x)
    assert_close(y.mean(0).detach().numpy(), np.zeros(2), atol=1e-5)
    assert_close(y.std(0).detach().numpy(), np.ones(2), atol=1e-4)


def test_mcmc_moves_keep_the_target_stationary():
    """The JAX package's statistical checks: 512 chains from an offset start
    reach N(0, I) (|mean| < 0.15, |std - 1| < 0.1)."""
    target = tdist.DiagGaussian(2, device="cpu")
    g = torch.Generator().manual_seed(22)
    mh = tflows.MetropolisHastings(target, tdist.DiagGaussianProposal((2,), 1.0, device="cpu"),
                                   200)
    hmc = tflows.HamiltonianMonteCarlo(target, 5, np.full(2, np.log(0.4)), np.zeros(2),
                                       device="cpu")
    with torch.no_grad():
        z_mh, _ = mh(5.0 + torch.randn(512, 2, generator=g), generator=g)
        z_hmc = 4.0 + torch.randn(512, 2, generator=g)
        for _ in range(50):
            z_hmc, _ = hmc(z_hmc, generator=g)
    for z in (z_mh, z_hmc):
        assert abs(float(z.mean())) < 0.15 and abs(float(z.std()) - 1.0) < 0.1


# ---- shared modules (trap 5) -------------------------------------------------------

def jsnf(jtarget):
    """The JAX example's SNF at 2 blocks with ``jtarget`` shared by its MH
    layers and ``p``."""
    layers = []
    b = jnp.asarray([1.0, 0.0])
    for i in range(2):
        k1, k2 = jax.random.split(jax.random.key(i))
        layers.append(jflows.MaskedAffineFlow.create(
            b if i % 2 == 0 else 1 - b, t=JMLP.create(k2, [2, 64, 2]),
            s=JMLP.create(k1, [2, 64, 2])))
        layers.append(jflows.MetropolisHastings(
            target=jtarget, proposal=jdist.DiagGaussianProposal.create((2,), 0.3), steps=5))
    return jnf.NormalizingFlow.create(jdist.DiagGaussian.create(2), layers, p=jtarget)


def test_load_jax_leaves_carries_a_shared_target_across():
    jmodel = jsnf(jdiag_target(23))
    tmodel = snf(tdist.DiagGaussian(2, device="cpu"))
    assert tmodel.flows[1].target is tmodel.p is tmodel.flows[3].target
    ported(jmodel, tmodel)
    assert np.array_equal(tmodel.p.loc.detach().numpy(), np.asarray(jmodel.p.loc))
    assert np.array_equal(tmodel.flows[0].s_net.linears[0].weight.detach().numpy(),
                          np.asarray(jmodel.flows[0].s_net.linears[0].weight).T)
    # the same path's log_prob in both packages
    x = normal(24, B, 2)
    noise = [mh_noise(25 + 2 * i, 5) for i in range(2)]
    jx, tx = jnp.asarray(x), t(x)
    jld, tld = 0.0, torch.zeros(B)
    for i in (3, 2, 1, 0):
        n = noise[i // 2]
        jx, jl = jax.jit(lambda f, x, n: f.inverse(x, noise=n))(jmodel.flows[i], jx, n) \
            if i % 2 else jmodel.flows[i].inverse(jx)
        with torch.no_grad():
            tx, tl = tmodel.flows[i].inverse(tx, noise=tuple(map(t, n))) if i % 2 \
                else tmodel.flows[i].inverse(tx)
        jld, tld = jld + jl, tld + tl
    assert_close(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)
    assert_close(tld.numpy(), np.asarray(jld), atol=1e-5, rtol=1e-5)
    # copies that differ are refused, naming both paths
    bad = leaves_of(jmodel)
    bad[".p.loc"] = bad[".p.loc"] + 1.0
    with pytest.raises(ValueError, match=r"\.p\.loc differs from \.flows\[1\]\.target\.loc"):
        load_jax_leaves(snf(tdist.DiagGaussian(2, device="cpu")), bad)


def test_a_shared_target_is_updated_once_a_step():
    model = snf(tdist.DiagGaussian(2, device="cpu"))
    names = [n for n, _ in model.named_parameters()]
    assert names.count("flows.1.target.loc") == 1 and "p.loc" not in names
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    before = model.p.loc.detach().clone()
    loss = model.reverse_kld(B, generator=torch.Generator().manual_seed(26))
    loss.backward()
    opt.step()
    # Adam's first step moves each entry by lr (|g| >> eps): once, not twice
    step = (model.p.loc.detach() - before).abs()
    assert_close(step.numpy(), np.full((1, 2), 1e-2), atol=1e-6, rtol=1e-4)


# ---- the JAX package's HAIS on the example's ladder ---------------------------------

def jax_hais(seed, chains=4096):
    """``examples/snf_hais.py``'s ladder through the JAX package, one jitted
    ``sample`` on ``jax.random.key(seed)`` (the script's key is 1)."""
    hais = JHAIS.create(np.linspace(1.0, 0.0, 32), jdist.DiagGaussian.create(2), jtwo_moons(),
                        num_leapfrog=10, step_size=jnp.full(2, 0.2), log_mass=jnp.zeros(2))
    samples, log_w = jax.jit(lambda h, k: h.sample(k, chains))(hais, jax.random.key(seed))
    log_w = np.asarray(log_w, np.float64)
    u = np.exp(log_w - log_w.max())
    w = u / u.sum()
    return {"key": seed, "chains": chains,
            "log_z": float(np.log(u.mean()) + log_w.max()), "ess": float(1.0 / np.sum(w**2)),
            "log_z_se": float(u.std(ddof=1) / (u.mean() * math.sqrt(chains))),
            "posterior_mean": [float(v) for v in w @ np.asarray(samples, np.float64)],
            "quadrature_log_z": snf_hais.two_moons_log_z(), "side": "jax-cpu"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=4096)
    ap.add_argument("--keys", default="1-3")
    args = ap.parse_args()
    lo, _, hi = args.keys.partition("-")
    for seed in range(int(lo), int(hi or lo) + 1):
        print(json.dumps(jax_hais(seed, args.chains)), flush=True)


if __name__ == "__main__":
    main()
