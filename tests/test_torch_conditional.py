"""Conditional flows of the port against the JAX package on the CPU: the
conditional MADE (``forward`` and ``apply_t`` with the context cache, the
unbatched-context trap at B == H), the conditional AR spline (planar at
D = 2, the sliced inverse at D = 16 against JAX and against the naive
recursion), the conditional MAF at D = 12, the conditional coupled spline,
``ConditionalNormalizingFlow`` with both conditional distributions,
``reverse_alpha_div``, the targets ``TwoIndependent``,
``CircularGaussianMixture``, ``RingMixture`` and the base ``Uniform``, and 20
steps of ``normflows_tpu_torch.examples.conditional_flow`` against the JAX
package's replay of them.  Bars: the JAX package's own, values 1e-5,
log-dets 1e-4, gradients atol 1e-4 / rtol 1e-3.

Run as a script, it trains the JAX package's ``examples/conditional_flow.py``
as published at the given seeds on the CPU and reports, one JSON line a
seed, the held-out KL(p||q) on the port example's 2^16 held-out pairs of
that seed and the moments of 4,096 draws at the example's context:

    JAX_PLATFORMS=cpu python -m tests.test_torch_conditional [--seeds 0-2]
        [--iters 5000] [--replay]

``--replay`` trains, in place of the JAX example's own model and draws, the
port example's model and ``--host-inputs`` draws of each seed through the
JAX package (``replay``), the same numbers reported.
"""

import argparse
import functools
import importlib.util
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normflows_tpu as jnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu.nets.made import MADE as JMADE
from normflows_tpu.nets.resnet import ResidualNet as JResidualNet
import normflows_tpu_torch as nft
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.examples import conditional_flow
from normflows_tpu_torch.interop import _torch_name, load_jax_leaves
from normflows_tpu_torch.nets import MLP
from normflows_tpu_torch.nets.made import MADE
from normflows_tpu_torch.nets.mlp import Linear
from normflows_tpu_torch.nets.resnet import ResidualNet
from tests.helpers import assert_close

torch.set_num_threads(2)

Y_TOL, LD_TOL = 1e-5, 1e-4
G_ATOL, G_RTOL = 1e-4, 1e-3
REPO = Path(__file__).resolve().parents[1]


def leaves_of(jmodel):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(jmodel)[0]}


def ported(jmodel, tmodel):
    return load_jax_leaves(tmodel, leaves_of(jmodel))


def normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def jcall(fn, *args):
    """``fn(*args)`` through ``jax.jit``: one compile of the whole function,
    where eager dispatch compiles each primitive of a spline on its own
    (several times slower at these sizes)."""
    return jax.jit(fn)(*args)


def jdirection(j, direction, x, c=None):
    """A JAX layer's ``forward`` or ``inverse`` on numpy inputs, jitted."""
    if c is None:
        return jcall(lambda m, x: getattr(m, direction)(x), j, jnp.asarray(x))
    return jcall(lambda m, x, c: getattr(m, direction)(x, c), j, jnp.asarray(x),
                 jnp.asarray(c))


def jax_model_of(tmodel, jmodel):
    """``jmodel`` holding the port model's tensors: the inverse of
    ``load_jax_leaves`` (a ``Linear``'s (out, in) weight and mask
    transposed back to (in, out))."""
    tensors = {**dict(tmodel.named_parameters()), **dict(tmodel.named_buffers())}
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


# ---- MADE ----------------------------------------------------------------

def made_pair(features=5, hidden=32, context=3, num_blocks=2, seed=3, **kw):
    jm = JMADE.create(jax.random.key(seed), features, hidden, context_features=context,
                      num_blocks=num_blocks, output_multiplier=3, rng_seed=seed, **kw)
    tm = MADE(features, hidden, context_features=context, num_blocks=num_blocks,
              output_multiplier=3, rng_seed=seed, device="cpu", **kw)
    return jm, ported(jm, tm)


@pytest.mark.parametrize("permute_mask", [False, True], ids=["ordered", "permuted"])
def test_conditional_made_matches_jax(permute_mask):
    jm, tm = made_pair(permute_mask=permute_mask)
    x, c = normal(0, 17, 5), normal(1, 17, 3)
    want = np.asarray(jcall(lambda m, x, c: m(x, c), jm, jnp.asarray(x), jnp.asarray(c)))
    with torch.no_grad():
        got = tm(t(x), t(c)).numpy()
        cache = tm.context_cache_t(t(c))
        got_t = tm.apply_t(t(x.T), cache).numpy()
    want_t = np.asarray(jcall(lambda m, x, c: m.apply_t(x, m.context_cache_t(c)), jm,
                              jnp.asarray(x.T), jnp.asarray(c)))
    assert_close(got, want, atol=Y_TOL, rtol=Y_TOL)
    assert_close(got_t, want_t, atol=Y_TOL, rtol=Y_TOL)
    assert_close(got_t.T, got, atol=Y_TOL, rtol=Y_TOL)
    # the context changes the output
    with torch.no_grad():
        assert not np.allclose(tm(t(x), t(c) + 1.0).numpy(), got)


def test_conditional_made_bf16_matches_jax():
    """``set_compute_dtype`` reaches the context layers as the JAX package's
    does; the cache holds its terms in the compute dtype.  bf16 rounds at
    each matmul: the bar of the bf16 MADE test, 2e-2 absolute."""
    from normflows_tpu.utils import set_compute_dtype as jset
    from normflows_tpu_torch.utils import set_compute_dtype

    jm, tm = made_pair()
    jm, tm = jset(jm, "bfloat16"), set_compute_dtype(tm, "bfloat16")
    assert tm.context_layer.compute_dtype == torch.bfloat16
    assert all(b.context_layer.compute_dtype == torch.bfloat16 for b in tm.blocks)
    x, c = normal(0, 17, 5), normal(1, 17, 3)
    want = np.asarray(jcall(lambda m, x, c: m(x, c), jm, jnp.asarray(x), jnp.asarray(c)))
    want_t = np.asarray(jcall(lambda m, x, c: m.apply_t(x, m.context_cache_t(c)), jm,
                              jnp.asarray(x.T), jnp.asarray(c)))
    with torch.no_grad():
        got = tm(t(x), t(c))
        cache = tm.context_cache_t(t(c))
        got_t = tm.apply_t(t(x.T), cache)
    assert cache[0].dtype == torch.bfloat16 and got_t.dtype == torch.float32
    assert_close(got.numpy(), want, atol=2e-2, rtol=0)
    assert_close(got_t.numpy(), want_t, atol=2e-2, rtol=0)


def test_unbatched_context_at_batch_equal_to_hidden():
    """Trap 1: a 1-D context broadcasts over the batch; the transposed
    cache must hold it as an (H, 1) column, or at B == H the add broadcasts
    along the wrong axis without an error (JAX
    tests/test_autoregressive_nsf.py:372-395)."""
    H = 32
    j = jflows.MaskedAffineAutoregressive.create(
        jax.random.key(20), features=12, hidden_features=H, context_features=4,
        num_blocks=1)
    tl = ported(j, tflows.MaskedAffineAutoregressive.create(
        None, features=12, hidden_features=H, context_features=4, num_blocks=1,
        device="cpu"))
    ctx1d = normal(21, 4)

    def naive(layer, x, c):
        outputs = jnp.zeros_like(x)
        for _ in range(12):
            params = layer.autoregressive_net(outputs, c)
            outputs, ld = layer._elementwise_inverse(x, params)
        return outputs, ld

    for B in (5, H):
        x = normal(22, B, 12)
        outputs, ld_naive = jcall(naive, j, jnp.asarray(x), jnp.asarray(ctx1d))
        with torch.no_grad():
            z, ld = tl.inverse(t(x), t(ctx1d))
            # the density direction takes the cache too
            x2, ld2 = tl.forward(z, t(ctx1d))
        assert_close(z.numpy(), np.asarray(outputs), atol=Y_TOL, rtol=Y_TOL)
        assert_close(ld.numpy(), np.asarray(ld_naive), atol=LD_TOL, rtol=LD_TOL)
        assert_close(x2.numpy(), x, atol=1e-4, rtol=1e-4)
        assert_close((ld + ld2).numpy(), np.zeros(B), atol=1e-3, rtol=0)
        with torch.no_grad():
            cache = tl.autoregressive_net.context_cache_t(t(ctx1d))
        assert cache[0].shape == (H, 1) and cache[1][0].shape == (H, 1)


# ---- autoregressive flows with a context -----------------------------------

def ar_pair(features, hidden=32, context=3, seed=5, **kw):
    j = jflows.AutoregressiveRationalQuadraticSpline.create(
        jax.random.key(seed), features, 2, hidden, num_context_channels=context,
        num_bins=4, init_identity=False, permute_mask=True, rng_seed=seed, **kw)
    tl = tflows.AutoregressiveRationalQuadraticSpline.create(
        None, features, 2, hidden, num_context_channels=context, num_bins=4,
        init_identity=False, permute_mask=True, rng_seed=seed, device="cpu", **kw)
    return j, ported(j, tl)


def naive_inverse(layer, x, c):
    """The plain D-pass recursion of the port's layer on the (B, F) MADE."""
    m = layer.mprqat
    x_t = x.T.contiguous()
    out = torch.zeros_like(x)
    for _ in range(x.shape[1]):
        out_t, ld_t = m._elementwise_t(x_t, m.autoregressive_net(out, c).T.contiguous(),
                                       inverse=True)
        out = out_t.T
    return out, ld_t.sum(0)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("features", [2, 16], ids=["D2-planar", "D16-sliced"])
def test_conditional_ar_spline_matches_jax(features, direction):
    j, tl = ar_pair(features)
    x, c = normal(1, 33, features) * 2.0, normal(2, 33, 3)
    yj, ldj = jdirection(j, direction, x, c)
    with torch.no_grad():
        yt, ldt = getattr(tl, direction)(t(x), t(c))
        yc, _ = getattr(tl, direction)(t(x), t(c) + 1.0)
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)
    assert not np.allclose(yc.numpy(), yt.numpy())  # the context matters
    if direction == "forward":  # wrapper forward: the recursion
        with torch.no_grad():
            yn, ldn = naive_inverse(tl, t(x), t(c))
        assert_close(yt.numpy(), yn.numpy(), atol=Y_TOL, rtol=Y_TOL)
        assert_close(ldt.numpy(), ldn.numpy(), atol=LD_TOL, rtol=LD_TOL)


def test_conditional_sliced_inverse_gradients_match_naive():
    _, tl = ar_pair(16)
    x, c = t(normal(3, 9, 16)), t(normal(4, 9, 3))
    params = list(tl.parameters())

    def grads(fn):
        z, ld = fn()
        return torch.autograd.grad((z**2).sum() + ld.sum(), params)

    for a, b in zip(grads(lambda: tl.forward(x, c)),
                    grads(lambda: naive_inverse(tl, x, c))):
        assert_close(a.numpy(), b.numpy(), atol=G_ATOL, rtol=G_RTOL)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_conditional_maf_matches_jax(direction):
    j = jflows.MaskedAffineAutoregressive.create(
        jax.random.key(12), features=12, hidden_features=32, context_features=4,
        num_blocks=1)
    tl = ported(j, tflows.MaskedAffineAutoregressive.create(
        None, features=12, hidden_features=32, context_features=4, num_blocks=1,
        device="cpu"))
    x, c = normal(13, 9, 12), normal(14, 9, 4)
    yj, ldj = jdirection(j, direction, x, c)
    with torch.no_grad():
        yt, ldt = getattr(tl, direction)(t(x), t(c))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_conditional_coupled_spline_matches_jax(direction):
    j = jflows.CoupledRationalQuadraticSpline.create(
        jax.random.key(7), 4, 2, 16, num_context_channels=3, num_bins=4,
        init_identity=False)
    tl = ported(j, tflows.CoupledRationalQuadraticSpline.create(
        None, 4, 2, 16, num_context_channels=3, num_bins=4, init_identity=False,
        device="cpu"))
    x, c = normal(8, 17, 4), normal(9, 17, 3)
    yj, ldj = jdirection(j, direction, x, c)
    with torch.no_grad():
        yt, ldt = getattr(tl, direction)(t(x), t(c))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)


def test_conditional_residual_net_matches_jax():
    j = JResidualNet.create(jax.random.key(3), 3, 5, 16, context_features=2, num_blocks=2)
    tn = ported(j, ResidualNet(3, 5, 16, context_features=2, num_blocks=2, device="cpu"))
    x, c = normal(1, 11, 3), normal(2, 11, 2)
    with torch.no_grad():
        got = tn(t(x), t(c)).numpy()
    assert_close(got, np.asarray(jcall(lambda m, x, c: m(x, c), j, jnp.asarray(x),
                                       jnp.asarray(c))), atol=Y_TOL, rtol=Y_TOL)


def test_conditional_fused_gate_stays_off():
    from normflows_tpu.ops import made_pallas
    from normflows_tpu_torch.ops import backend, made_fused

    jm = JMADE.create(jax.random.key(0), 12, 128, context_features=3, num_blocks=1,
                      output_multiplier=3)
    tm = ported(jm, MADE(12, 128, context_features=3, num_blocks=1, output_multiplier=3,
                         device="cpu"))
    x = normal(0, 300, 12)
    for c in (None, normal(1, 300, 3)):
        tc = None if c is None else t(c)
        jc = None if c is None else jnp.asarray(c)
        # a MADE with a context layer never fuses, even on a call without one
        assert not made_fused.fusable(tm, t(x), tc)
        assert not made_pallas.fusable(jm, jnp.asarray(x), jc)
    backend.set_made_fusion(True)
    try:
        assert not tm.fuses(t(x), t(normal(1, 300, 3)))
        plain = MADE(12, 128, num_blocks=1, output_multiplier=3, device="cpu")
        assert plain.fuses(t(x))
        # dropout on (a generator passed) takes the unfused pass, as JAX's key
        drop = MADE(12, 128, num_blocks=1, output_multiplier=3, dropout_probability=0.5,
                    device="cpu")
        with torch.no_grad():
            a = drop(t(x), generator=torch.Generator().manual_seed(0))
            b = drop(t(x), generator=torch.Generator().manual_seed(1))
        assert not torch.equal(a, b)
    finally:
        backend.set_made_fusion(False)


# ---- ConditionalNormalizingFlow ---------------------------------------------

@functools.lru_cache(maxsize=None)
def conditional_pair(base):
    """A conditional flow of an AR spline and an LU permute on 2 features,
    context 4, with a fixed or a context-encoded base, in both packages."""
    jlayers, tlayers = [], []
    for i in range(1):
        jlayers.append(jflows.AutoregressiveRationalQuadraticSpline.create(
            jax.random.key(i), 2, 1, 16, num_context_channels=4, num_bins=4,
            init_identity=False))
        tlayers.append(tflows.AutoregressiveRationalQuadraticSpline.create(
            None, 2, 1, 16, num_context_channels=4, num_bins=4, init_identity=False,
            device="cpu"))
        jlayers.append(jflows.LULinearPermute.create(2, seed=i))
        tlayers.append(tflows.LULinearPermute.create(2, device="cpu"))
    if base == "conditional":
        jq0 = jdist.ConditionalDiagGaussian.create(
            2, jnf.nets.MLP.create(jax.random.key(9), [4, 8, 4]))
        tq0 = tdist.ConditionalDiagGaussian.create(2, MLP.create(None, [4, 8, 4],
                                                                 device="cpu"))
    else:
        jq0 = jdist.DiagGaussian.create(2, trainable=False)
        tq0 = tdist.DiagGaussian.create(2, trainable=False, device="cpu")
    jm = jnf.ConditionalNormalizingFlow.create(jq0, jlayers,
                                               p=jdist.ConditionalDiagGaussianTarget())
    tm = nft.ConditionalNormalizingFlow.create(
        tq0, tlayers, p=tdist.ConditionalDiagGaussianTarget(device="cpu"), device="cpu")
    return jm, ported(jm, tm)


def context_batch(seed, n):
    ctx = normal(seed, n, 4)
    ctx[:, 2:] = 0.5 + 0.5 * np.random.default_rng(seed + 1).uniform(size=(n, 2))
    return ctx


@pytest.mark.parametrize("base", ["fixed", "conditional"])
def test_conditional_flow_log_prob_and_forward_kld(base):
    jm, tm = conditional_pair(base)
    x, c = normal(3, 33, 2), context_batch(4, 33)
    want = np.asarray(jcall(lambda m, x, c: m.log_prob(x, c), jm, jnp.asarray(x),
                            jnp.asarray(c)))
    with torch.no_grad():
        got = tm.log_prob(t(x), t(c)).numpy()
    assert_close(got, want, atol=LD_TOL, rtol=LD_TOL)
    diff, rest = jnf.partition(jm)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda d: jnf.combine(d, rest).forward_kld(jnp.asarray(x), jnp.asarray(c))))(diff)
    loss = tm.forward_kld(t(x), t(c))
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    assert_close(float(loss.detach()), float(jloss), atol=LD_TOL, rtol=LD_TOL)
    want_g = {_torch_name(jax.tree_util.keystr(p)): np.asarray(g)
              for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for (name, _), g in zip(tm.named_parameters(), grads):
        g = g.numpy()
        w = want_g[name]
        owner = name.rpartition(".")[0]
        if name.endswith("weight") and isinstance(tm.get_submodule(owner), Linear):
            w = w.T
        assert_close(g, w, atol=G_ATOL, rtol=G_RTOL, msg=name)


@pytest.mark.parametrize("base", ["fixed", "conditional"])
def test_conditional_flow_sample_from_noise_and_reverse_kld(base):
    jm, tm = conditional_pair(base)
    n = 33
    c = context_batch(5, n)
    eps = normal(6, n, 2)
    with torch.no_grad():
        z0, lp0 = tm.q0.from_noise(t(eps), t(c))
        x, log_q = tm.from_noise(t(eps), t(c))
    # the JAX base's draw on the same noise, then the JAX flows
    if base == "conditional":
        mean, log_scale = jm.q0._params(jnp.asarray(c))
    else:
        mean, log_scale = jm.q0.loc, jm.q0.log_scale
    jz = mean + jnp.exp(log_scale) * jnp.asarray(eps)
    assert_close(z0.numpy(), np.asarray(jz), atol=Y_TOL, rtol=Y_TOL)
    jlog_q = np.asarray(jm.q0.log_prob(jz, jnp.asarray(c)))
    assert_close(lp0.numpy(), jlog_q, atol=LD_TOL, rtol=LD_TOL)
    jx, jld = jcall(lambda m, z, c: m.forward_and_log_det(z, c), jm, jz, jnp.asarray(c))
    assert_close(x.numpy(), np.asarray(jx), atol=Y_TOL, rtol=Y_TOL)
    assert_close(log_q.numpy(), jlog_q - np.asarray(jld), atol=LD_TOL, rtol=LD_TOL)
    # sample draws the same noise as from_noise
    with torch.no_grad():
        xs, lqs = tm.sample(n, t(c), generator=torch.Generator().manual_seed(1))
        eps_t = torch.randn(n, 2, generator=torch.Generator().manual_seed(1))
        xf, lqf = tm.from_noise(eps_t, t(c))
    assert torch.equal(xs, xf) and torch.equal(lqs, lqf)
    # reverse KL: E_q[log q] - E_q[log p(x | c)] on these draws
    loss = tm.reverse_kld(n, t(c), generator=torch.Generator().manual_seed(1))
    want = float(torch.mean(lqf) - torch.mean(tm.p.log_prob(xf, t(c))))
    assert_close(float(loss.detach()), want, atol=LD_TOL, rtol=LD_TOL)


# ---- reverse_alpha_div, the targets and Uniform -----------------------------

ALPHA_DRAWS = 33


@functools.lru_cache(maxsize=None)
def alpha_pair():
    """An unconditional flow of an AR spline on 2 features and a TwoMoons
    target, in both packages; the JAX base draws ``noise`` whatever its key,
    as the port's base draws it from ``torch.Generator().manual_seed(1)``."""
    noise = torch.randn(ALPHA_DRAWS, 2, generator=torch.Generator().manual_seed(1)).numpy()

    class FixedDraws(jdist.DiagGaussian):
        def sample_and_log_prob(self, key, num_samples=1, context=None):
            eps = jnp.asarray(noise)
            return self.loc + jnp.exp(self.log_scale) * eps, self.log_prob(
                self.loc + jnp.exp(self.log_scale) * eps)

    jlayers = [jflows.AutoregressiveRationalQuadraticSpline.create(
        jax.random.key(0), 2, 1, 16, num_bins=4, init_identity=False)]
    tlayers = [tflows.AutoregressiveRationalQuadraticSpline.create(
        None, 2, 1, 16, num_bins=4, init_identity=False, device="cpu")]
    jq0 = FixedDraws(loc=jnp.zeros((1, 2)), log_scale=jnp.zeros((1, 2)), shape=(2,))
    jm = jnf.NormalizingFlow.create(jq0, jlayers, p=jdist.TwoMoons())
    tm = nft.NormalizingFlow.create(tdist.DiagGaussian.create(2, device="cpu"), tlayers,
                                    p=tdist.TwoMoons(device="cpu"), device="cpu")
    return jm, ported(jm, tm)


@pytest.mark.parametrize("alpha,dreg", [(0.5, False), (0.5, True), (2.0, True)],
                         ids=["plain", "dreg", "dreg-alpha2"])
def test_reverse_alpha_div_matches_jax(alpha, dreg):
    n = ALPHA_DRAWS
    jm, tm = alpha_pair()
    diff, rest = jnf.partition(jm)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda d: jnf.combine(d, rest).reverse_alpha_div(
        jax.random.key(0), n, alpha=alpha, dreg=dreg)))(diff)
    loss = tm.reverse_alpha_div(n, alpha=alpha, dreg=dreg,
                                generator=torch.Generator().manual_seed(1))
    assert_close(float(loss.detach()), float(jloss), atol=LD_TOL, rtol=LD_TOL)
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    want_g = {_torch_name(jax.tree_util.keystr(p)): np.asarray(g)
              for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for (name, _), g in zip(tm.named_parameters(), grads):
        w = want_g[name]
        if name.endswith("weight") and isinstance(tm.get_submodule(name[:-7]), Linear):
            w = w.T
        assert_close(g.numpy(), w, atol=G_ATOL, rtol=G_RTOL, msg=name)


def test_targets_and_uniform_match_jax():
    z = normal(3, 65, 2) * 2.0
    jz, tz = jnp.asarray(z), t(z)
    for jtarget, ttarget in [
        (jdist.CircularGaussianMixture(n_modes=6),
         tdist.CircularGaussianMixture(n_modes=6, device="cpu")),
        (jdist.RingMixture(n_rings=3), tdist.RingMixture(n_rings=3, device="cpu")),
    ]:
        assert_close(ttarget.log_prob(tz).numpy(),
                     np.asarray(jcall(lambda m, z: m.log_prob(z), jtarget, jz)),
                     atol=Y_TOL, rtol=Y_TOL)
    z4 = normal(4, 65, 4) * 2.0
    two_j = jdist.TwoIndependent(target1=jdist.TwoMoons(), target2=jdist.RingMixture())
    two_t = tdist.TwoIndependent(tdist.TwoMoons(device="cpu"),
                                 tdist.RingMixture(device="cpu"), device="cpu")
    assert two_t.n_dims == two_j.n_dims == 4
    assert_close(two_t.log_prob(t(z4)).numpy(),
                 np.asarray(jcall(lambda m, z: m.log_prob(z), two_j, jnp.asarray(z4))),
                 atol=Y_TOL, rtol=Y_TOL)
    gen = torch.Generator().manual_seed(0)
    draws = two_t.sample(256, generator=gen)
    assert draws.shape == (256, 4) and bool(torch.isfinite(two_t.log_prob(draws)).all())
    cgm = tdist.CircularGaussianMixture(n_modes=6, device="cpu")
    radius = torch.linalg.vector_norm(cgm.sample(4096, generator=gen), dim=1).mean()
    assert abs(float(radius) - 2.0) < 0.05
    ju = jdist.Uniform.create(3, low=-2.0, high=1.0)
    tu = tdist.Uniform.create(3, low=-2.0, high=1.0, device="cpu")
    u = normal(5, 65, 3)
    assert_close(tu.log_prob(t(u)).numpy(),
                 np.asarray(jcall(lambda m, u: m.log_prob(u), ju, jnp.asarray(u))),
                 atol=Y_TOL, rtol=Y_TOL)
    us, lp = tu.sample_and_log_prob(512, generator=gen)
    assert float(us.min()) >= -2.0 and float(us.max()) <= 1.0
    assert torch.equal(lp, tu.log_prob(us)) and abs(float(lp[0]) + 3 * np.log(3.0)) < 1e-6


# ---- the example against the JAX package's replay ---------------------------

def jax_example_module():
    spec = importlib.util.spec_from_file_location("jax_conditional_flow_example",
                                                  REPO / "examples" / "conditional_flow.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_twin(tmodel, hidden):
    """The JAX example's model at ``hidden`` holding ``tmodel``'s tensors."""
    return jax_model_of(tmodel, jax_example_module().build_model(hidden=hidden))


def jax_optimizer(lr):
    return optax.chain(optax.add_decayed_weights(1e-5), optax.adam(lr))


def replay(seed, iters, hidden=128, batch=128, lr=3e-4):
    """The JAX package trains the port example's model (its weights drawn
    from ``seed``) on the port example's host-drawn inputs of ``seed``
    (``conditional_flow.host_inputs``), with the JAX script's optimizer;
    returns the losses."""
    tmodel = conditional_flow.build_model("cpu", hidden=hidden, seed=seed)
    jmodel = jax_twin(tmodel, hidden)
    context_all, x_all = (a.numpy() for a in conditional_flow.host_inputs(iters, batch, seed))
    opt = jax_optimizer(lr)
    diff, rest = jnf.partition(jmodel)
    opt_state = opt.init(diff)

    @jax.jit
    def step(diff, opt_state, x, context):
        loss, grads = jax.value_and_grad(
            lambda d: jnf.combine(d, rest).forward_kld(x, context))(diff)
        updates, opt_state = opt.update(grads, opt_state, diff)
        return optax.apply_updates(diff, updates), opt_state, loss

    losses = []
    for i in range(iters):
        diff, opt_state, loss = step(diff, opt_state, x_all[i], context_all[i])
        losses.append(float(loss))
    return np.array(losses), jnf.combine(diff, rest)


def test_example_training_replays_through_jax():
    """20 host-input steps of the example at hidden 16 on the CPU against the
    JAX package's replay of them: every loss within 1e-4, and the held-out
    log q of the trained models."""
    iters, hidden, seed = 20, 16, 0
    want, jmodel = replay(seed, iters, hidden)
    model = conditional_flow.build_model("cpu", hidden=hidden, seed=seed)
    state, chunk = conditional_flow.make_chunk(
        model, 3e-4, 128, 10, conditional_flow.host_inputs(iters, 128, seed))
    losses = torch.cat([chunk(state)[1]["loss"] for _ in range(2)])
    assert_close(losses.numpy(), want, atol=LD_TOL, rtol=LD_TOL)
    c, x = (a[:512] for a in conditional_flow.held_out_pairs(seed))
    with torch.no_grad():
        got = model.log_prob(x, c).numpy()
    assert_close(got, np.asarray(jcall(lambda m, x, c: m.log_prob(x, c), jmodel,
                                       jnp.asarray(x.numpy()), jnp.asarray(c.numpy()))),
                 atol=LD_TOL, rtol=LD_TOL)


def jax_metrics(model, seed):
    """The example's held-out KL(p||q) on ``conditional_flow.held_out_pairs(seed)``
    and the moments of 4,096 draws at its context, for a JAX model."""
    c, x = (jnp.asarray(a.numpy()) for a in conditional_flow.held_out_pairs(seed))
    kl = float(jnp.mean(model.p.log_prob(x, c) - model.log_prob(x, c)))
    ctx = jnp.tile(jnp.asarray([conditional_flow.SAMPLE_CONTEXT]), (4096, 1))
    z, _ = model.sample(jax.random.key(1), 4096, context=ctx)
    return {"held_out_kl": kl, "sample_mean": np.asarray(jnp.mean(z, 0)).tolist(),
            "sample_std": np.asarray(jnp.std(z, 0)).tolist()}


def jax_example(seed, iters=5000, batch=128, lr=3e-4):
    """``examples/conditional_flow.py`` of the JAX package as published,
    its model and its training keys from ``seed``; then the held-out
    KL(p||q) on ``conditional_flow.held_out_pairs(seed)`` and the moments of
    its 4,096 draws at the example's context."""
    ex = jax_example_module()
    model = ex.build_model(key=jax.random.key(seed))
    opt = jax_optimizer(lr)
    diff, rest = jnf.partition(model)
    opt_state = opt.init(diff)

    @jax.jit
    def step(diff, opt_state, key):
        kc, kx = jax.random.split(key)
        context = ex.sample_context(kc, batch)
        x = jnf.combine(diff, rest).p.sample(kx, batch, context)
        loss, grads = jax.value_and_grad(
            lambda d: jnf.combine(d, rest).forward_kld(x, context))(diff)
        finite = jnp.isfinite(loss)
        grads = jax.tree.map(lambda g: jnp.where(finite, g, 0.0), grads)
        updates, opt_state = opt.update(grads, opt_state, diff)
        return optax.apply_updates(diff, updates), opt_state, loss

    key = jax.random.key(seed)
    losses = []
    t0 = time.time()
    for _ in range(iters):
        key, sub = jax.random.split(key)
        diff, opt_state, loss = step(diff, opt_state, sub)
        losses.append(loss)
    losses = np.asarray(jnp.stack(losses))
    seconds = time.time() - t0
    return {**jax_metrics(jnf.combine(diff, rest), seed), "final_kld": float(losses[-1]),
            "non_finite_steps": int((~np.isfinite(losses)).sum()),
            "seconds": seconds, "seed": seed, "iters": iters, "batch": batch,
            "device": "jax " + jax.default_backend()}


def _seeds(text):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-2", help="a seed or a range, e.g. 0-2")
    ap.add_argument("--iters", type=int, default=5000)
    ap.add_argument("--replay", action="store_true",
                    help="train the port example's model and host inputs of each seed "
                         "(``replay``) instead of the JAX example's own")
    args = ap.parse_args(argv)
    for seed in _seeds(args.seeds):
        if args.replay:
            losses, model = replay(seed, args.iters)
            record = {**jax_metrics(model, seed), "final_kld": float(losses[-1]),
                      "seed": seed, "iters": args.iters, "replay": True}
        else:
            record = jax_example(seed, args.iters)
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
