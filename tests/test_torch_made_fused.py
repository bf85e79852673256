"""The port's fused MADE (normflows_tpu_torch/ops/made_fused.py) against the
JAX package's (normflows_tpu/ops/made_pallas.py), on the CPU, where the
port's entry point runs the kernels' plain versions and JAX's runs its
Pallas kernels in interpret mode; the same weights (``load_jax_leaves``) and
the same numpy inputs.

* The plain versions against ``made_apply_fused(..., interpret=True)`` at
  the JAX package's test shapes (F = 2, H = 512, R in {1, 2}, output
  multiplier 31, B = 300; tests/test_pallas.py:90-201): forward 1e-5, input
  and weight gradients of ``(o**2).sum() + sin(o).sum()`` 2e-4; bf16 at
  JAX's bars (0.15 / 0.05 against float32, 5e-2 on gradients); one case
  with tanh.
* ``fusable`` against JAX's on the cases of ``test_fusable_gates``.
* ``MADE.forward`` with fusion on against fusion off; ``apply_t`` ignores
  the flag.
* A D = 12, hidden 128, B = 256 model of 2 x (AR RQ-spline +
  ``LULinearPermute``) and a D = 12 MAF layer with fusion on, against the
  JAX package's default path: ``log_prob``, the loss and every gradient of
  ``forward_kld``, 1e-4; the plain versions run and no kernel launches.

The fusion flag is set and restored by the ``fusion`` fixture.
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
from normflows_tpu.nets.made import MADE as JMADE
from normflows_tpu.ops import made_pallas
from normflows_tpu.utils import set_compute_dtype as jset_compute_dtype
from normflows_tpu_torch import distributions as tdist
from normflows_tpu_torch import flows as tflows
from normflows_tpu_torch.interop import load_jax_leaves
from normflows_tpu_torch.nets.made import MADE
from normflows_tpu_torch.ops import backend, made_fused
from normflows_tpu_torch.utils import set_compute_dtype
from tests.helpers import assert_close

torch.set_num_threads(2)

Y_TOL, G_TOL = 1e-5, 2e-4  # tests/test_pallas.py:111, :129
BF16_F32_ATOL, BF16_F32_RTOL = 0.15, 0.05  # :177
BF16_G_TOL = 5e-2  # :201
MODEL_TOL = 1e-4  # the model's bars, as tests/test_torch_large_d.py


@pytest.fixture
def fusion():
    before = backend.made_fusion_enabled()
    backend.set_made_fusion(True)
    yield
    backend.set_made_fusion(before)


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of the two plain versions (they still run)."""
    calls = {"forward": 0, "backward": 0}
    for key, name in (("forward", "fused_resmade_reference"),
                      ("backward", "fused_resmade_backward_reference")):
        fn = getattr(made_fused, name)

        def spy(*args, _fn=fn, _key=key, **kwargs):
            calls[_key] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(made_fused, name, spy)
    return calls


def leaves_of(jmodel):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(jmodel)[0]}


def made_pair(blocks=1, hidden=512, mult=31, activation="relu", seed=7, features=2,
              **kwargs):
    """The JAX package's test MADE and the port's with its weights."""
    jm = JMADE.create(jax.random.key(seed), features=features, hidden_features=hidden,
                      num_blocks=blocks, output_multiplier=mult, permute_mask=True,
                      rng_seed=3, activation=activation, **kwargs)
    tm = MADE(features, hidden, num_blocks=blocks, output_multiplier=mult,
              permute_mask=True, rng_seed=3, activation=activation, device="cpu", **kwargs)
    return jm, load_jax_leaves(tm, leaves_of(jm))


def grads_in_port_names(jm, gd, blocks, activation="relu"):
    """JAX's gradient pytree as the port's named (out, in) tensors."""
    _, rest = jnf.partition(jm)
    _, holder = made_pair(blocks, activation=activation)
    load_jax_leaves(holder, leaves_of(jnf.combine(gd, rest)))
    return {n: p.detach() for n, p in holder.named_parameters()}


def inputs(seed=8, B=300, F=2):
    return np.random.default_rng(seed).normal(size=(B, F)).astype(np.float32)


@pytest.mark.parametrize("blocks,activation", [(1, "relu"), (2, "relu"), (1, "tanh")])
def test_forward_and_gradients_match_jax(blocks, activation, plain_calls):
    jm, tm = made_pair(blocks, activation=activation)
    x = inputs()
    diff, rest = jnf.partition(jm)

    def loss(d, x_):
        o = made_pallas.made_apply_fused(jnf.combine(d, rest), x_, interpret=True)
        return (o ** 2).sum() + jnp.sin(o).sum(), o

    (_, jo), (gd, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        diff, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    assert made_fused.fusable(tm, xt, None)
    o = made_fused.made_apply_fused(tm, xt)
    assert o.dtype == torch.float32 and o.shape == (300, 62)
    assert_close(o.detach().numpy(), np.asarray(jo), atol=Y_TOL, rtol=Y_TOL)
    ((o ** 2).sum() + torch.sin(o).sum()).backward()
    assert plain_calls == {"forward": 1, "backward": 1}
    assert_close(xt.grad.numpy(), np.asarray(gx), atol=G_TOL, rtol=G_TOL)
    want = grads_in_port_names(jm, gd, blocks, activation)
    for name, p in tm.named_parameters():
        assert_close(p.grad.numpy(), want[name].numpy(), atol=G_TOL, rtol=G_TOL, msg=name)


@pytest.mark.parametrize("blocks", [1, 2])
def test_bf16_matches_jax(blocks):
    """bf16 weights: the forward within JAX's bar of the float32 MADE and
    close to JAX's bf16 kernel; the gradients of mean(o**2) within 5e-2 of
    JAX's bf16 kernel's, and finite."""
    jm, tm = made_pair(blocks, seed=13)
    jm = jset_compute_dtype(jm, "bfloat16")
    set_compute_dtype(tm, "bfloat16")
    x = inputs(seed=14)
    f32 = np.asarray(jset_compute_dtype(jm, None)(jnp.asarray(x)))
    diff, rest = jnf.partition(jm)

    def loss(d):
        o = made_pallas.made_apply_fused(jnf.combine(d, rest), jnp.asarray(x), interpret=True)
        return (o ** 2).mean(), o

    (_, jo), gd = jax.value_and_grad(loss, has_aux=True)(diff)
    assert made_fused.fusable(tm, torch.from_numpy(x), None)
    o = made_fused.made_apply_fused(tm, torch.from_numpy(x))
    assert o.dtype == torch.float32
    assert_close(o.detach().numpy(), f32, atol=BF16_F32_ATOL, rtol=BF16_F32_RTOL)
    assert_close(o.detach().numpy(), np.asarray(jo), atol=BF16_G_TOL, rtol=BF16_G_TOL)
    (o ** 2).mean().backward()
    want = grads_in_port_names(jm, gd, blocks)
    for name, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        assert_close(p.grad.numpy(), want[name].numpy(), atol=BF16_G_TOL, rtol=BF16_G_TOL,
                     msg=name)


def test_bf16_backward_rounds_weight_gradients_once():
    """With bf16 weights each weight gradient is summed over the whole batch
    in float32 and cast to bf16 once, not per 512-row tile as in the JAX
    package (see ops/made_fused.py): at B = 1100 the final layer's equals
    bf16(g^T bf16(h)) exactly; the input cotangents round per product."""
    rng = np.random.default_rng(20)
    B, F, H, R, P = 1100, 3, 128, 1, 5
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    x, g = t(B, F), t(B, P)
    w = [t(H, F).bfloat16(), (t(R, H, H) * 0.1).bfloat16(), (t(R, H, H) * 0.1).bfloat16(),
         (t(P, H) * 0.1).bfloat16()]
    b = [t(H), t(R, H), t(R, H), t(P)]
    grads = made_fused.fused_resmade_backward_reference(
        x, w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3], g)
    assert grads[7].dtype == torch.bfloat16 and grads[8].dtype == torch.float32
    assert grads[0].dtype == torch.float32
    rnd = lambda a: a.bfloat16().float()  # noqa: E731
    h = rnd(x) @ w[0].float().T + b[0]
    z = rnd(torch.relu(h)) @ w[1][0].float().T + b[1][0]
    h = h + (rnd(torch.relu(z)) @ w[2][0].float().T + b[2][0])
    assert torch.equal(grads[7], (g.T @ rnd(h)).bfloat16())
    # the first input cotangent, dh = bf16(g Wf), is bf16-valued
    dh = rnd(g @ w[3].float())
    assert torch.equal(grads[8], g.sum(0)) and torch.equal(rnd(dh), dh)


def test_backward_reference_takes_given_kinks():
    """``kinks=`` sets only the side of relu's step: the plain version's own
    pre-activations give its own numbers; one pre-activation moved across 0
    moves that row's inner cotangent, db1 by exactly its value."""
    rng = np.random.default_rng(21)
    B, F, H, R, P = 40, 3, 128, 2, 7
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    x, g = t(B, F), t(B, P)
    ops = [t(H, F), t(H), t(R, H, H) * 0.1, t(R, H), t(R, H, H) * 0.1, t(R, H), t(P, H), t(P)]
    hs, zs = made_fused.preactivations_reference(x, *ops)
    assert hs.shape == zs.shape == (R, B, H)
    own = made_fused.fused_resmade_backward_reference(x, *ops, g)
    same = made_fused.fused_resmade_backward_reference(x, *ops, g, kinks=(hs, zs))
    for a, b in zip(own, same):
        assert_close(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)
    r, m, n = R - 1, 5, int(zs[R - 1, 5].abs().argmin())
    flipped = zs.clone()
    flipped[r, m, n] = -flipped[r, m, n]
    moved = made_fused.fused_resmade_backward_reference(x, *ops, g, kinks=(hs, flipped))
    dz1 = g @ ops[6] @ ops[4][r]  # the inner product's output cotangent of the last block
    sign = 1.0 if flipped[r, m, n] > 0 else -1.0
    assert_close((moved[4][r] - own[4][r]).numpy(), (sign * dz1[m, n] * torch.eye(H)[n]).numpy(),
                 atol=1e-5, rtol=1e-5)


def test_fusable_agrees_with_jax():
    """The cases of tests/test_pallas.py::test_fusable_gates the port can
    build, and a few that pass; the port refuses the MADEs it cannot build
    and, beyond JAX's gate, hidden widths above 768 (shared memory)."""
    jm, tm = made_pair()
    x = inputs(seed=10)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    cases = [(jx, tx, None, None), (jx, tx, jnp.ones((300, 3)), torch.ones(300, 3)),
             (jx[:16], tx[:16], None, None), (jx[None], tx[None], None, None),
             (jx[:256], tx[:256], None, None), (jx[:, :1], tx[:, :1], None, None)]
    for jxx, txx, jc, tc in cases:
        assert made_fused.fusable(tm, txx, tc) == made_pallas.fusable(jm, jxx, jc)
    assert made_fused.fusable(tm, tx, None) and not made_fused.fusable(tm, tx[:255], None)
    assert not made_fused.fusable(tm, tx.double(), None)
    odd_j, odd_t = made_pair(hidden=100, mult=3, seed=11)
    assert not made_fused.fusable(odd_t, tx, None) and not made_pallas.fusable(odd_j, jx, None)
    # feedforward blocks and a context layer are built, and neither fuses, as
    # in the JAX package
    ff = MADE(2, 512, output_multiplier=3, use_residual_blocks=False, device="cpu")
    assert not made_fused.fusable(ff, tx, None)
    ctx = MADE(2, 512, output_multiplier=3, context_features=3, device="cpu")
    assert ctx.context_layer is not None and not made_fused.fusable(ctx, tx, None)
    # compute dtypes: bf16 fuses, "float32" does not, in both packages
    for dtype in ("bfloat16", "float32"):
        assert made_fused.fusable(set_compute_dtype(made_pair()[1], dtype), tx, None) == \
            made_pallas.fusable(jset_compute_dtype(jm, dtype), jx, None) == (dtype == "bfloat16")
    # the weight budget R * 2 * H^2 * 4 <= 8 MiB: H = 512 fuses 4 blocks, not 5
    for blocks in (4, 5):
        bj, bt = made_pair(blocks=blocks, mult=3, seed=12)
        assert made_fused.fusable(bt, tx, None) == made_pallas.fusable(bj, jx, None) \
            == (blocks == 4)
    # the port's own limit: H = 896 passes JAX's gate, not the port's
    wj, wt = made_pair(hidden=896, mult=3, seed=12)
    assert made_pallas.fusable(wj, jx, None) and not made_fused.fusable(wt, tx, None)


def test_made_forward_fusion_on_equals_off(fusion, plain_calls):
    """``MADE.forward`` with fusion on takes the fused plain version (no
    kernel launch on the CPU) and equals the unfused pass; ``apply_t`` does
    not change with the flag."""
    _, tm = made_pair(blocks=2, hidden=128)
    x = torch.from_numpy(inputs(seed=16))
    before = made_fused.LAUNCHES
    with torch.no_grad():
        on, on_t = tm(x), tm.apply_t(x.T.contiguous())
        assert plain_calls["forward"] == 1
        backend.set_made_fusion(False)
        off, off_t = tm(x), tm.apply_t(x.T.contiguous())
    assert plain_calls["forward"] == 1 and made_fused.LAUNCHES == before
    assert_close(on.numpy(), off.numpy(), atol=Y_TOL, rtol=Y_TOL)
    assert torch.equal(on_t, off_t)
    # a batch the gate refuses takes the unfused pass
    backend.set_made_fusion(True)
    with torch.no_grad():
        tm(x[:100])
    assert plain_calls["forward"] == 1


D, HIDDEN, BINS, B = 12, 128, 4, 256


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


def test_large_d_model_matches_jax_with_fusion(fusion, plain_calls):
    """log_prob, and the loss and all 28 gradient leaves of forward_kld, of
    the D = 12 model with fusion on against JAX's default (unfused) path:
    one fused forward per AR layer and log_prob, one backward per layer and
    step, no kernel launch."""
    jm = jax_model()
    tm = load_jax_leaves(torch_model(), leaves_of(jm))
    x = (np.random.default_rng(10).normal(size=(B, D)) * 1.5).astype(np.float32)
    launches = (made_fused.LAUNCHES, made_fused.BACKWARD_LAUNCHES)
    with torch.no_grad():
        lp = tm.log_prob(torch.from_numpy(x))
    assert plain_calls == {"forward": 2, "backward": 0}
    assert_close(lp.numpy(), np.asarray(jm.log_prob(jnp.asarray(x))), atol=MODEL_TOL,
                 rtol=MODEL_TOL)
    diff, rest = jnf.partition(jm)
    vj, gj = jax.value_and_grad(
        lambda d: jnf.combine(d, rest).forward_kld(jnp.asarray(x)))(diff)
    gj = dict(load_jax_leaves(torch_model(), leaves_of(jnf.combine(gj, rest)))
              .named_parameters())
    loss = tm.forward_kld(torch.from_numpy(x))
    loss.backward()
    assert plain_calls == {"forward": 4, "backward": 2}
    assert (made_fused.LAUNCHES, made_fused.BACKWARD_LAUNCHES) == launches
    assert_close(float(loss.detach()), float(vj), atol=MODEL_TOL, rtol=MODEL_TOL)
    named = dict(tm.named_parameters())
    assert named.keys() == gj.keys() and len(named) == 28
    for name, p in named.items():
        want = gj[name].detach()
        if p.grad is None:  # the target: forward_kld does not reach it
            assert name.startswith("p.") and not want.any()
            continue
        assert_close(p.grad.numpy(), want.numpy(), atol=MODEL_TOL, rtol=MODEL_TOL, msg=name)


def test_maf_layer_matches_jax_with_fusion(fusion, plain_calls):
    """A D = 12 MAF layer's density direction with fusion on: the fused
    (B, 2D) output goes to the affine transform as a transposed view."""
    j = jflows.MaskedAffineAutoregressive.create(jax.random.key(3), D, HIDDEN, rng_seed=3)
    t = tflows.MaskedAffineAutoregressive.create(None, D, HIDDEN, rng_seed=3, device="cpu")
    load_jax_leaves(t, leaves_of(j))
    x = (np.random.default_rng(1).normal(size=(B, D)) * 2.0).astype(np.float32)
    yj, ldj = j.forward(jnp.asarray(x))
    with torch.no_grad():
        yt, ldt = t.forward(torch.from_numpy(x))
        assert plain_calls["forward"] == 1
        backend.set_made_fusion(False)
        yu, ldu = t.forward(torch.from_numpy(x))
    assert_close(yt.numpy(), np.asarray(yj), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=MODEL_TOL, rtol=MODEL_TOL)
    assert_close(yt.numpy(), yu.numpy(), atol=Y_TOL, rtol=Y_TOL)
    assert_close(ldt.numpy(), ldu.numpy(), atol=Y_TOL, rtol=Y_TOL)


# ---- the kernels' split products (ops/made_fused.py, plain models) ----

def _float32_from_bits(bits):
    return torch.from_numpy(np.asarray(bits, np.uint32).view(np.float32).copy())


def _assert_split_exact(bits):
    """Each of the three terms of the float32 values ``bits`` (and of 0) is
    bfloat16-representable, and the terms sum back to the value exactly."""
    c = torch.cat([_float32_from_bits(bits), torch.zeros(1)])
    terms = made_fused.split_bf16(c)
    for t in terms:
        assert torch.equal(t, t.bfloat16().float())
    assert torch.equal(terms[0].double() + terms[1].double() + terms[2].double(), c.double())


def test_split_terms_cover_every_exponent():
    """Every biased exponent 17 ... 253 (2^-110 <= |c| < 2^127), 64 seeded
    random mantissas and signs each, and the extreme mantissas."""
    rng = np.random.default_rng(20)
    e = np.repeat(np.arange(17, 254, dtype=np.uint64), 66)
    m = rng.integers(0, 2**23, size=e.size, dtype=np.uint64)
    m[0::66], m[1::66] = 0, 2**23 - 1
    s = rng.integers(0, 2, size=e.size, dtype=np.uint64)
    _assert_split_exact((s << 31) | (e << 23) | m)


def test_split_terms_are_bf16_and_sum_back_exactly():
    """The same property on values hypothesis draws across the exponent
    range, where hypothesis is installed."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=200, deadline=None)
    @hypothesis.given(st.lists(st.tuples(st.integers(0, 1), st.integers(17, 253),
                                         st.integers(0, 2**23 - 1)), min_size=1, max_size=64))
    def check(values):
        _assert_split_exact([(s << 31) | (e << 23) | m for s, e, m in values])

    check()


def test_split_matmul_matches_the_product():
    """With a bf16 right operand the three terms' products are exact: the
    float64 product up to float64 rounding; with both operands float32, the
    6 partial products of the float32 route within 2^-22 of |a| |b|."""
    rng = np.random.default_rng(30)
    a = torch.from_numpy(rng.normal(size=(40, 300)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(300, 24)).astype(np.float32))
    bb = b.bfloat16().float()
    exact = a.double() @ bb.double()
    assert_close(made_fused.split_matmul(a, bb, 3, 1).numpy(), exact.numpy(), atol=1e-12,
                 rtol=1e-12)
    six = made_fused.split_matmul(a, b, 3, 3)
    scale = a.double().abs() @ b.double().abs()
    assert float(((six - a.double() @ b.double()).abs() / scale).max()) <= 2.0 ** -22


def _split_case(R, activation, bf16, seed):
    B, F, H, mult = 300, 2, 512, 31
    _, tm = made_pair(R, activation=activation, seed=seed)
    with torch.no_grad():
        for blk in tm.blocks:  # the second linear drawn like the others, not near zero
            blk.linear_1.weight.uniform_(-H ** -0.5, H ** -0.5,
                                         generator=torch.Generator().manual_seed(seed))
    if bf16:
        set_compute_dtype(tm, "bfloat16")
    x = torch.from_numpy(inputs(seed=seed + 1, B=B, F=F))
    g = torch.from_numpy(np.random.default_rng(seed + 2).normal(size=(B, F * mult))
                         .astype(np.float32))
    return x, [t.detach() for t in made_fused.pack(tm)], g


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("R,activation", [(1, "relu"), (2, "relu"), (1, "tanh"),
                                          (1, "leaky_relu")])
def test_split_backward_matches_float64(R, activation, bf16):
    """The pull-back with every product split as the kernels split it
    (float32 values, partial products summed in float64) against the plain
    version in float64, on the same side of each activation's kink: within
    the kernels' bars, 2e-4 in f32 and 5e-2 in bf16 (where each input
    cotangent rounds to bf16 at another point of its float32 sum)."""
    x, ops, g = _split_case(R, activation, bf16, seed=40 + R)
    kinks = made_fused.preactivations_reference(x, *ops, activation=activation)
    got = made_fused.fused_resmade_backward_split(x, *ops, g, activation, kinks=kinks)
    want = made_fused.fused_resmade_backward_reference(
        *[t.double() if t.dtype == torch.float32 else t for t in (x, *ops, g)], activation,
        kinks=kinks)
    tol = BF16_G_TOL if bf16 else G_TOL
    for a, b in zip(got, want):
        assert_close(a.double().numpy(), b.double().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("R,activation", [(1, "relu"), (2, "relu"), (1, "tanh"),
                                          (1, "leaky_relu")])
def test_split_forward_matches_plain(R, activation, bf16):
    """The forward with every product split as the kernels split it
    (``fused_resmade_split``: f32 both operands in three terms, 6 partial
    products; bf16 the rounded operand and the weight one term each)
    against the plain version: f32 against it in float64 within 1e-5, bf16
    against the bf16 plain version within 5e-2 (the kernels' bars)."""
    x, ops, _ = _split_case(R, activation, bf16, seed=60 + R)
    got = made_fused.fused_resmade_split(x, *ops, activation)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], ops[6].shape[0])
    if bf16:
        want, tol = made_fused.fused_resmade_reference(x, *ops, activation), BF16_G_TOL
    else:
        want, tol = made_fused.fused_resmade_reference(
            *[t.double() for t in (x, *ops)], activation), Y_TOL
    assert_close(got.double().numpy(), want.double().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("activation", ["relu", "tanh", "leaky_relu"])
def test_split_skips_terms_only_of_bf16_cotangents(activation):
    """With bf16 weights the kernels split two cotangents into one term:
    the last block's dh = bf16(g Wf), and dz1 = bf16(dh W2) act'(z) under
    relu, whose derivative is 0 or 1.  Under tanh and leaky_relu dz1 is a
    general float32 value and takes all three."""
    x, ops, g = _split_case(1, activation, True, seed=50)
    rnd = lambda a: a.bfloat16().float()  # noqa: E731
    hs, zs = made_fused.preactivations_reference(x, *ops, activation=activation)
    dh = rnd(g @ ops[6].float())
    dz1 = rnd(dh @ ops[4][0].float()) * made_fused._act_grad(activation, zs[0])
    assert torch.equal(dh, rnd(dh))
    assert torch.equal(dz1, rnd(dz1)) == (activation == "relu")
