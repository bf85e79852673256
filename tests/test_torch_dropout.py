"""Dropout, feedforward MADE blocks with random masks, and constrained
splines (``tails=None``) of the port against the JAX package on the CPU.

Dropout draws its masks from a torch generator where the JAX package draws
from a key, so the two packages' masks differ; each test here records the
masks the JAX package draws and feeds them to the port through its one mask
function, ``nets.resnet._dropout_keep``: values and gradients must then be
equal.  Bars: the JAX package's own, values 1e-5, log-dets 1e-4, gradients
atol 1e-4 / rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normflows_tpu.nets.made as jmade_module
import normflows_tpu.nets.resnet as jresnet_module
from normflows_tpu import flows as jflows
from normflows_tpu.flows.neural_spline import coupling as jcoupling
from normflows_tpu.nets.made import MADE as JMADE
from normflows_tpu.nets.resnet import ResidualNet as JResidualNet
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.flows.neural_spline import coupling as tcoupling
from normflows_tpu_torch.nets import resnet as tresnet
from normflows_tpu_torch.nets.made import MADE
from normflows_tpu_torch.nets.resnet import ResidualNet
from tests.helpers import assert_close
from tests.test_torch_conditional import (G_ATOL, G_RTOL, LD_TOL, Y_TOL, jcall, jdirection,
                                          leaves_of, normal, ported, t)

torch.set_num_threads(2)


@pytest.fixture
def jax_masks(monkeypatch):
    """Record every dropout mask the JAX package draws, in order, and hand
    them to the port's ``_dropout_keep`` in the same order."""
    recorded, fed = [], []

    def recording(x, p, key, train):
        if not train or key is None or p == 0.0:
            return x
        keep = 1.0 - p
        mask = jax.random.bernoulli(key, keep, x.shape)
        recorded.append(np.asarray(mask))
        return jnp.where(mask, x / keep, 0.0)

    def feeding(shape, p, generator, device):
        mask = fed.pop(0)
        assert tuple(mask.shape) == tuple(shape)
        return torch.from_numpy(mask.copy()).to(device)

    monkeypatch.setattr(jresnet_module, "_dropout", recording)
    monkeypatch.setattr(jmade_module, "_dropout", recording)
    monkeypatch.setattr(tresnet, "_dropout_keep", feeding)

    def feed():
        fed[:] = list(recorded)
        return fed

    return recorded, feed


def param_grads(model, loss):
    return dict(zip([n for n, _ in model.named_parameters()],
                    torch.autograd.grad(loss, list(model.parameters()))))


def check_grads(tmodel, tgrads, jgrads):
    from normflows_tpu_torch.interop import _torch_name
    from normflows_tpu_torch.nets.mlp import Linear

    want = {_torch_name(jax.tree_util.keystr(p)): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for name, g in tgrads.items():
        w = want[name]
        owner = name.rpartition(".")[0]
        if name.endswith("weight") and isinstance(tmodel.get_submodule(owner), Linear):
            w = w.T
        assert_close(g.numpy(), w, atol=G_ATOL, rtol=G_RTOL, msg=name)


@pytest.mark.parametrize("net", ["made", "made_context", "resnet_context"])
def test_dropout_with_jax_masks_matches_values_and_gradients(net, jax_masks):
    recorded, feed = jax_masks
    x, c = normal(0, 17, 5), normal(1, 17, 3)
    ctx = 3 if net != "made" else None
    if net.startswith("made"):
        jm = JMADE.create(jax.random.key(2), 5, 32, context_features=ctx, num_blocks=2,
                          output_multiplier=3, dropout_probability=0.3)
        tm = ported(jm, MADE(5, 32, context_features=ctx, num_blocks=2, output_multiplier=3,
                             dropout_probability=0.3, device="cpu"))
    else:
        jm = JResidualNet.create(jax.random.key(2), 5, 4, 32, context_features=ctx,
                                 dropout_probability=0.3)
        tm = ported(jm, ResidualNet(5, 4, 32, context_features=ctx, dropout_probability=0.3,
                                    device="cpu"))
    jc, tc = (jnp.asarray(c), t(c)) if ctx else (None, None)
    key = jax.random.key(7)
    want = np.asarray(jm(jnp.asarray(x), jc, key=key, train=True))
    assert len(recorded) == 2 and not all(m.all() for m in recorded)
    feed()
    got = tm(t(x), tc, generator=torch.Generator())
    assert_close(got.detach().numpy(), want, atol=Y_TOL, rtol=Y_TOL)

    def jloss(m):
        return jnp.sum(m(jnp.asarray(x), jc, key=key, train=True) ** 2)

    import normflows_tpu as jnf
    diff, rest = jnf.partition(jm)
    jgrads = jax.grad(lambda d: jloss(jnf.combine(d, rest)))(diff)
    feed()
    out = tm(t(x), tc, generator=torch.Generator())
    check_grads(tm, param_grads(tm, (out**2).sum()), jgrads)


def test_dropout_recursion_draws_fresh_masks_each_pass(jax_masks):
    """The MAF's inverse with a key (JAX) / a generator (port) runs D passes
    of the (B, F) MADE with fresh masks each: D x blocks masks, and the same
    values when the port gets JAX's masks."""
    recorded, feed = jax_masks
    j = jflows.MaskedAffineAutoregressive.create(
        jax.random.key(0), features=4, hidden_features=32, num_blocks=2,
        dropout_probability=0.4)
    tl = ported(j, tflows.MaskedAffineAutoregressive.create(
        None, features=4, hidden_features=32, num_blocks=2, dropout_probability=0.4,
        device="cpu"))
    z = normal(1, 16, 4)
    yj, ldj = j.inverse(jnp.asarray(z), key=jax.random.key(10))
    assert len(recorded) == 4 * 2
    fed = feed()
    with torch.no_grad():
        yt, ldt = tl.inverse(t(z), generator=torch.Generator())
    assert not fed  # every mask used
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)
    # the density direction: one pass
    recorded.clear()
    yj, ldj = j.forward(jnp.asarray(z), key=jax.random.key(11))
    feed()
    with torch.no_grad():
        yt, ldt = tl.forward(t(z), generator=torch.Generator())
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)


@pytest.mark.parametrize("kind", ["maf", "coupled", "ar_spline"])
def test_dropout_invariants(kind):
    """JAX tests/test_autoregressive_nsf.py:422-460: stochastic with
    randomness, deterministic without; a zero probability ignores it."""
    def make(p):
        if kind == "maf":
            return tflows.MaskedAffineAutoregressive.create(
                None, features=4, hidden_features=32, dropout_probability=p, device="cpu")
        if kind == "coupled":
            return tflows.CoupledRationalQuadraticSpline.create(
                None, 4, 2, 32, num_bins=4, dropout_probability=p, init_identity=False,
                device="cpu")
        return tflows.AutoregressiveRationalQuadraticSpline.create(
            None, 4, 2, 32, num_bins=4, dropout_probability=p, init_identity=False,
            device="cpu")

    torch.manual_seed(0)
    layer = make(0.4)
    z = t(normal(1, 16, 4))
    with torch.no_grad():
        for direction in ("forward", "inverse"):
            f = getattr(layer, direction)
            y1, _ = f(z, generator=torch.Generator().manual_seed(10))
            y2, _ = f(z, generator=torch.Generator().manual_seed(11))
            y3, _ = f(z)
            y4, _ = f(z)
            assert not torch.allclose(y1, y2), direction
            assert torch.equal(y3, y4), direction
    torch.manual_seed(0)
    plain = make(0.0)
    with torch.no_grad():
        y1, _ = plain.forward(z, generator=torch.Generator().manual_seed(10))
        y2, _ = plain.forward(z)
    assert torch.equal(y1, y2)


def test_facade_dropout_follows_jax_rules():
    """log_prob draws only with a generator; sample always draws."""
    from normflows_tpu_torch import NormalizingFlow, distributions

    torch.manual_seed(0)
    layers = [tflows.MaskedAffineAutoregressive.create(
        None, features=4, hidden_features=32, dropout_probability=0.4, device="cpu")]
    model = NormalizingFlow.create(distributions.DiagGaussian.create(4, device="cpu"),
                                   layers, device="cpu")
    x = t(normal(2, 16, 4))
    with torch.no_grad():
        assert torch.equal(model.log_prob(x), model.log_prob(x))
        assert not torch.equal(model.log_prob(x, generator=torch.Generator().manual_seed(1)),
                               model.log_prob(x))
        # sample: the same noise, different masks than a model without dropout
        a, _ = model.sample(16, generator=torch.Generator().manual_seed(3))
        eps = torch.randn(16, 4, generator=torch.Generator().manual_seed(3))
        b, _ = model.from_noise(eps)
    assert not torch.allclose(a, b)


def test_facade_reads_dropout_settings_at_every_call():
    """A probability changed, or a flow with dropout added, after the first
    call takes effect at the next one."""
    from normflows_tpu_torch import NormalizingFlow, distributions

    torch.manual_seed(0)
    make = lambda p: tflows.MaskedAffineAutoregressive.create(  # noqa: E731
        None, features=4, hidden_features=32, dropout_probability=p, device="cpu")
    model = NormalizingFlow.create(distributions.DiagGaussian.create(4, device="cpu"),
                                   [make(0.4)], device="cpu")
    eps = torch.randn(16, 4, generator=torch.Generator().manual_seed(3))

    def draws_masks():
        with torch.no_grad():
            a, _ = model.sample(16, generator=torch.Generator().manual_seed(3))
            b, _ = model.from_noise(eps)
        return not torch.allclose(a, b)

    assert draws_masks()
    for m in model.modules():
        if hasattr(m, "dropout_probability"):
            m.dropout_probability = 0.0
    assert not draws_masks()
    model.flows.append(make(0.4))
    assert draws_masks()


# ---- feedforward MADE blocks, random masks ----------------------------------

@pytest.mark.parametrize("random_mask", [False, True], ids=["cyclic", "random"])
def test_feedforward_made_matches_jax(random_mask):
    jm = JMADE.create(jax.random.key(4), 6, 32, num_blocks=2, output_multiplier=3,
                      use_residual_blocks=False, random_mask=random_mask, rng_seed=7)
    tm = MADE(6, 32, num_blocks=2, output_multiplier=3, use_residual_blocks=False,
              random_mask=random_mask, rng_seed=7, device="cpu")
    # load_jax_leaves holds the masks and degrees for equality, bit for bit
    ported(jm, tm)
    for jl, tl in [(jm.initial_layer, tm.initial_layer), (jm.final_layer, tm.final_layer),
                   *[(jb.linear, tb.linear) for jb, tb in zip(jm.blocks, tm.blocks)]]:
        np.testing.assert_array_equal(tl.mask.numpy(), np.asarray(jl.mask).T)
    x = normal(0, 17, 6)
    with torch.no_grad():
        got = tm(t(x)).numpy()
        got_t = tm.apply_t(t(x.T)).numpy()
    assert_close(got, np.asarray(jcall(lambda m, x: m(x), jm, jnp.asarray(x))),
                 atol=Y_TOL, rtol=Y_TOL)
    assert_close(got_t, np.asarray(jcall(lambda m, x: m.apply_t(x), jm, jnp.asarray(x.T))),
                 atol=Y_TOL, rtol=Y_TOL)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_feedforward_maf_with_random_masks_matches_jax(direction):
    j = jflows.MaskedAffineAutoregressive.create(
        jax.random.key(5), features=6, hidden_features=32, context_features=2,
        use_residual_blocks=False, random_mask=True, rng_seed=3)
    tl = ported(j, tflows.MaskedAffineAutoregressive.create(
        None, features=6, hidden_features=32, context_features=2,
        use_residual_blocks=False, random_mask=True, rng_seed=3, device="cpu"))
    x, c = normal(6, 17, 6), normal(7, 17, 2)
    yj, ldj = jdirection(j, direction, x, c)
    with torch.no_grad():
        yt, ldt = getattr(tl, direction)(t(x), t(c))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)


# ---- constrained splines (tails=None) ----------------------------------------

def unit_inputs(seed, *shape):
    return np.random.default_rng(seed).uniform(0.02, 0.98, size=shape).astype(np.float32)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("features", [2, 12], ids=["D2", "D12"])
def test_constrained_ar_spline_matches_jax(features, direction):
    common = dict(num_bins=4, tails=None, init_identity=False, permute_mask=True,
                  rng_seed=1, num_blocks=1)
    j = jflows.MaskedPiecewiseRationalQuadraticAutoregressive.create(
        jax.random.key(1), features, 16, **common)
    tl = ported(j, tflows.MaskedPiecewiseRationalQuadraticAutoregressive.create(
        None, features, 16, device="cpu", **common))
    assert tl.constrained and tl.tail_codes is None
    x = unit_inputs(2, 33, features)
    yj, ldj = jdirection(j, direction, x)
    with torch.no_grad():
        yt, ldt = getattr(tl, direction)(t(x))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)
    assert float(yt.min()) >= 0.0 and float(yt.max()) <= 1.0


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_constrained_coupling_and_cdf_match_jax(direction):
    j = jflows.CoupledRationalQuadraticSpline.create(
        jax.random.key(3), 4, 1, 16, num_bins=4, tails=None, init_identity=False)
    tl = ported(j, tflows.CoupledRationalQuadraticSpline.create(
        None, 4, 1, 16, num_bins=4, tails=None, init_identity=False, device="cpu"))
    assert tl.prqct.constrained and tl.prqct.unconditional_transform.constrained
    x = unit_inputs(4, 17, 4)
    yj, ldj = jdirection(j, direction, x)
    with torch.no_grad():
        yt, ldt = getattr(tl, direction)(t(x))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)
    jc = jcoupling.PiecewiseRationalQuadraticCDF.create(
        3, num_bins=4, tails=None, identity_init=False, key=jax.random.key(5))
    tc = ported(jc, tcoupling.PiecewiseRationalQuadraticCDF.create(
        3, num_bins=4, tails=None, identity_init=False, device="cpu"))
    y = unit_inputs(6, 9, 3)
    yj, ldj = jdirection(jc, direction, y)
    with torch.no_grad():
        yt, ldt = getattr(tc, direction)(t(y))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=LD_TOL, rtol=LD_TOL)


def test_detached_second_pass_reuses_each_layers_masks():
    """``reverse_kld(score_fn=False)`` recomputes log q at the draws through
    a detached copy; each layer's dropout then draws the masks of its first
    pass (the JAX package reuses each layer's key), so a coupled model gives
    the loss of ``score_fn=True`` up to rounding.  Drawn afresh, the masks
    would move it."""
    from normflows_tpu_torch import NormalizingFlow, distributions

    torch.manual_seed(0)
    layers = [tflows.CoupledRationalQuadraticSpline.create(
        None, 2, 1, 16, num_bins=4, dropout_probability=0.5, init_identity=False,
        reverse_mask=bool(i % 2), device="cpu") for i in range(2)]
    model = NormalizingFlow.create(distributions.DiagGaussian.create(2, device="cpu"), layers,
                                   p=distributions.TwoMoons(device="cpu"), device="cpu")
    with torch.no_grad():
        # the blocks' second linears start within 1e-3: widen them, so that
        # what dropout drops moves the splines
        for layer in layers:
            for block in layer.prqct.transform_net.blocks:
                block.linear_1.weight.normal_(0.0, 0.5)
        a = model.reverse_kld(64, generator=torch.Generator().manual_seed(4))
        b = model.reverse_kld(64, score_fn=False, generator=torch.Generator().manual_seed(4))
        x, _ = model.sample(64, generator=torch.Generator().manual_seed(4))
        fresh = model.log_prob(x, generator=torch.Generator().manual_seed(9))
    assert_close(float(b), float(a), atol=1e-4, rtol=1e-4)
    lp = float(torch.mean(model.p.log_prob(x)))
    assert abs(float(torch.mean(fresh)) - lp - float(a)) > 1e-3
