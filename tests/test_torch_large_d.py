"""The large-D autoregressive path of the port against the JAX package's, cut
from ``examples/ar_large_d_bench.py`` (D = 64, hidden 256, 8 bins, 4 layers)
to D = 12, hidden 32, 4 bins and batch 64, with the same weights
(``load_jax_leaves``) and the same numpy inputs:

* ``LULinearPermute`` both ways, with log-dets, at ``identity_init=False``;
* the sliced sequential inverse of the AR RQ-spline layer and of
  ``MaskedAffineAutoregressive`` (D = 12 > 8) and their density direction,
  against the JAX layers on their default CPU path (the jnp spline) and
  against a naive full-width D-pass recursion written here;
* a 2 x (AR-RQS + LULinearPermute) model with DiagGaussian base and target:
  ``log_prob``, transport of injected base draws, and the loss and every
  gradient leaf of ``reverse_kld`` and ``forward_kld``.

Bars: 1e-5 on values and 1e-4 on log-dets for a layer (the JAX package's
kernel bars, tests/test_pallas.py), 1e-4 on the model's values, losses and
gradients (f32).  bf16 is held on the card only (chip_smoke.py): XLA on the
CPU lacks the bf16 x bf16 -> f32 dot of JAX's sliced inverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normflows_tpu as jnf
import normflows_tpu_torch as tnf
from normflows_tpu import distributions as jdist
from normflows_tpu import flows as jflows
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.interop import load_jax_leaves
from normflows_tpu_torch.ops import splines
from normflows_tpu_torch.utils import set_compute_dtype
from tests.helpers import assert_close
from tests.test_torch_training import jax_draw

torch.set_num_threads(2)

D, HIDDEN, BINS, B = 12, 32, 4, 64
Y_TOL, LD_TOL = 1e-5, 1e-4
TOL = 1e-4


def leaves_of(jmodel):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(jmodel)[0]}


def layer_pair(kind, features=D, seed=3):
    """The JAX layer and the port's with its weights: the inner MAF-style
    transform (forward = density, inverse = the recursion)."""
    if kind == "rqs":
        j = jflows.AutoregressiveRationalQuadraticSpline.create(
            jax.random.key(seed), features, 1, HIDDEN, num_bins=BINS, permute_mask=True,
            rng_seed=seed, init_identity=False)
        t = tflows.AutoregressiveRationalQuadraticSpline.create(
            None, features, 1, HIDDEN, num_bins=BINS, permute_mask=True, rng_seed=seed,
            init_identity=False, device="cpu")
    else:
        j = jflows.MaskedAffineAutoregressive.create(jax.random.key(seed), features,
                                                     HIDDEN, rng_seed=seed)
        t = tflows.MaskedAffineAutoregressive.create(None, features, HIDDEN, rng_seed=seed,
                                                     device="cpu")
    load_jax_leaves(t, leaves_of(j))
    return (j.mprqat, t.mprqat) if kind == "rqs" else (j, t)


def inputs(features=D, seed=1):
    return (np.random.default_rng(seed).normal(size=(B, features)) * 2.0).astype(np.float32)


def naive_inverse(layer, x):
    """The reference's inverse: D full-width passes of the MADE, each followed
    by the elementwise inverse of every feature (plain spline or MAF)."""
    net = layer.autoregressive_net
    x_t = x.T.contiguous()
    out_t = torch.zeros_like(x_t)
    for _ in range(x.shape[1]):
        params_t = net.apply_t(out_t)
        if isinstance(layer, tflows.MaskedAffineAutoregressive):
            out_t, ld_t = layer._elementwise_t(x_t, params_t, inverse=True)
            continue
        K = layer.num_bins
        p = params_t.T.reshape(x.shape[0], x.shape[1], 3 * K + 1)
        y, ld = splines.unconstrained_rational_quadratic_spline(
            x, p[..., :K], p[..., K:2 * K], p[..., 2 * K:], inverse=True,
            tail_codes=torch.tensor(layer.tail_codes), tail_bound=torch.tensor(layer.tail_bound))
        out_t, ld_t = y.T, ld.T
    return out_t.T, ld_t.sum(0)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("kind,features", [("rqs", D), ("maf", D), ("maf", 3)],
                         ids=["rqs-D12", "maf-D12", "maf-D3"])
def test_layer_matches_jax(kind, features, direction):
    j, t = layer_pair(kind, features)
    x = inputs(features)
    yj, ldj = getattr(j, direction)(jnp.asarray(x))
    with torch.no_grad():
        yt, ldt = getattr(t, direction)(torch.from_numpy(x))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)


@pytest.mark.parametrize("kind", ["rqs", "maf"])
def test_sliced_inverse_matches_naive_recursion(kind):
    _, t = layer_pair(kind)
    x = torch.from_numpy(inputs(seed=2))
    with torch.no_grad():
        y, ld = t.inverse(x)
        yn, ldn = naive_inverse(t, x)
        # and it inverts the density direction
        x2, ld_f = t.forward(y)
    assert_close(y.numpy(), yn.numpy(), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ld.numpy(), ldn.numpy(), atol=LD_TOL, rtol=LD_TOL)
    inside = (x.abs() < 3.0).all(1)  # linear tails beyond +-3 are the identity
    assert_close(x2[inside].numpy(), x[inside].numpy(), atol=1e-4, rtol=1e-4)
    assert_close((ld + ld_f).numpy(), np.zeros(B), atol=1e-3, rtol=0)


def test_sliced_inverse_gradients_match_naive_recursion():
    """Autograd through the recursion (the carry's rows replaced out of
    place) gives the naive recursion's gradients."""
    _, t = layer_pair("rqs")
    x = torch.from_numpy(inputs(seed=4))
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(B, D)).astype(np.float32))
    grads = []
    for fn in (t.inverse, lambda x_: naive_inverse(t, x_)):
        t.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_()
        y, ld = fn(xg)
        ((y * w).sum() + ld.sum()).backward()
        grads.append([xg.grad] + [p.grad for p in t.parameters()])
    for a, b in zip(*grads):
        assert_close(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)


def test_one_feature_inverses_match_jax():
    """MAF's one-feature inverses, in the natural layout (``_single``) and in
    the transposed one (``_row``, the sliced inverse's step), against JAX's
    ``_elementwise_inverse_single``; the base class's row form bridges to the
    single one."""
    j, t = layer_pair("maf")
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, 1)).astype(np.float32)
    p = rng.normal(size=(B, 2)).astype(np.float32)
    yj, ldj = j._elementwise_inverse_single(jnp.asarray(x), jnp.asarray(p), 3)
    ys, lds = t._elementwise_inverse_single(torch.from_numpy(x), torch.from_numpy(p), 3)
    yr, ldr = t._elementwise_inverse_row(torch.from_numpy(x[:, 0]), torch.from_numpy(p.T), 3)
    yb, ldb = tflows.Autoregressive._elementwise_inverse_row(
        t, torch.from_numpy(x[:, 0]), torch.from_numpy(p.T), 3)
    assert_close(ys.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(lds.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)
    for y, ld in ((yr, ldr), (yb, ldb)):
        assert_close(y.numpy(), ys[:, 0].numpy(), atol=1e-7, rtol=1e-6)
        assert_close(ld.numpy(), lds.numpy(), atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_lu_linear_permute_matches_jax(direction):
    j = jflows.LULinearPermute.create(D, identity_init=False, key=jax.random.key(7))
    t = tflows.LULinearPermute.create(D, identity_init=False, device="cpu")
    assert not torch.equal(t.permutation.permutation,
                           torch.from_numpy(np.array(j.permutation.permutation)).long())
    load_jax_leaves(t, leaves_of(j))  # the permutation is copied, not held equal
    x = inputs(seed=6)
    yj, ldj = getattr(j, direction)(jnp.asarray(x))
    with torch.no_grad():
        yt, ldt = getattr(t, direction)(torch.from_numpy(x))
        back, ld_back = getattr(t, "inverse" if direction == "forward" else "forward")(yt)
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)
    assert_close(back.numpy(), x, atol=1e-4, rtol=1e-4)
    assert_close((ldt + ld_back).numpy(), np.zeros(B), atol=1e-5, rtol=0)


def jax_model():
    layers = []
    for i in range(2):
        layers.append(jflows.AutoregressiveRationalQuadraticSpline.create(
            jax.random.key(i), D, 1, HIDDEN, num_bins=BINS, permute_mask=True, rng_seed=i,
            init_identity=False))
        layers.append(jflows.LULinearPermute.create(D, identity_init=False,
                                                    key=jax.random.key(100 + i)))
    target = jdist.DiagGaussian.create(D).replace(
        loc=jnp.full((1, D), 0.5), log_scale=jnp.full((1, D), -0.2))
    return jnf.NormalizingFlow.create(jdist.DiagGaussian.create(D), layers, p=target)


def torch_model():
    layers = []
    for i in range(2):
        layers.append(tflows.AutoregressiveRationalQuadraticSpline.create(
            None, D, 1, HIDDEN, num_bins=BINS, permute_mask=True, rng_seed=i,
            init_identity=False, device="cpu"))
        layers.append(tflows.LULinearPermute.create(D, identity_init=False, device="cpu"))
    return tnf.NormalizingFlow.create(tdist.DiagGaussian.create(D, device="cpu"), layers,
                                      p=tdist.DiagGaussian.create(D, device="cpu"),
                                      device="cpu")


@pytest.fixture(scope="module")
def jm():
    return jax_model()


class NoiseBase(torch.nn.Module):
    """Test-only ``q0``: the real DiagGaussian's reparameterised draw
    loc + exp(log_scale) * eps on the given noise ``eps``, so that the base's
    gradients flow as in JAX's draw."""

    def __init__(self, base, eps):
        super().__init__()
        self.base = base
        self.eps = torch.from_numpy(eps)

    def sample_and_log_prob(self, num_samples, context=None, *, generator=None):
        assert self.eps.shape[0] == num_samples
        z = self.base.loc + torch.exp(self.base.log_scale) * self.eps
        return z, self.base.log_prob(z)

    def log_prob(self, z, context=None):
        return self.base.log_prob(z, context)


def port_of(jm, eps=np.zeros((B, D), np.float32)):
    tm = load_jax_leaves(torch_model(), leaves_of(jm))
    tm.q0 = NoiseBase(tm.q0, eps)
    return tm


def test_transport_and_log_prob_match_jax(jm):
    tm = port_of(jm)
    z = np.random.default_rng(8).normal(size=(B, D)).astype(np.float32)
    xj, ldj = jm.forward_and_log_det(jnp.asarray(z))
    x = np.array(xj)
    with torch.no_grad():
        xt, ldt = tm.forward_and_log_det(torch.from_numpy(z))
        lpt = tm.log_prob(torch.from_numpy(x))
        zt = tm.inverse(torch.from_numpy(x))
    assert_close(xt.numpy(), x, atol=TOL, rtol=TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=TOL, rtol=TOL)
    assert_close(lpt.numpy(), np.asarray(jm.log_prob(jnp.asarray(x))), atol=TOL, rtol=TOL)
    assert_close(zt.numpy(), z, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("what", ["reverse_kld", "forward_kld"])
def test_loss_and_gradients_match_jax(jm, what):
    key = jax.random.key(9)
    x = (np.random.default_rng(10).normal(size=(B, D)) * 1.5).astype(np.float32)
    if what == "reverse_kld":
        # JAX's base starts at loc 0, log_scale 0: its draw is its noise
        tm = port_of(jm, jax_draw(jm, key, B)[0])
        jax_loss, port_loss = (lambda m: m.reverse_kld(key, B)), (lambda m: m.reverse_kld(B))
    else:
        tm = port_of(jm)
        jax_loss = lambda m: m.forward_kld(jnp.asarray(x))  # noqa: E731
        port_loss = lambda m: m.forward_kld(torch.from_numpy(x))  # noqa: E731
    diff, rest = jnf.partition(jm)
    vj, gj = jax.value_and_grad(lambda d: jax_loss(jnf.combine(d, rest)))(diff)
    gj = dict(load_jax_leaves(torch_model(), leaves_of(jnf.combine(gj, rest)))
              .named_parameters())
    loss = port_loss(tm)
    loss.backward()
    assert_close(float(loss.detach()), float(vj), atol=TOL, rtol=TOL)
    # the stub q0 holds the real base as q0.base
    gt = {n.replace("q0.base.", "q0."): p.grad for n, p in tm.named_parameters()}
    # 2 x (MADE 8 + LU 4) + base 2 + target 2
    assert gt.keys() == gj.keys() and len(gt) == 28
    for name, g in gt.items():
        want = gj[name].detach()
        if g is None:  # a leaf the loss does not reach: the target in forward_kld
            assert what == "forward_kld" and name.startswith("p.") and not want.any()
            continue
        assert torch.isfinite(g).all(), name
        assert_close(g.numpy(), want.numpy(), atol=TOL, rtol=TOL, msg=name)


def test_bf16_sample_is_self_consistent(jm):
    """bf16 MADE matmuls on the CPU, port only: sample's log_q against
    log_prob of the samples (the two directions round apart; the card's bar,
    chip_smoke.py)."""
    tm = set_compute_dtype(load_jax_leaves(torch_model(), leaves_of(jm)), "bfloat16")
    with torch.no_grad():
        x, log_q = tm.sample(B, generator=torch.Generator().manual_seed(0))
        lp = tm.log_prob(x)
    assert x.dtype == torch.float32 and torch.isfinite(x).all()
    assert float((lp - log_q).abs().median()) <= 2e-2
