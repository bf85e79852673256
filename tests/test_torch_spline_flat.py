"""The flat spline of the port (normflows_tpu_torch/ops/spline_flat.py), both
entry points, against the JAX package's flat Pallas kernels in interpret mode
(``_fwd_kernel`` / ``_bwd_kernel``):

* ``unconstrained_rqs_dyncodes`` and its plain version against
  ``unconstrained_rqs_pallas_dyncodes`` at N = 640 with mixed per-element
  codes, both directions (tests/test_pallas.py's bars: 1e-5 on outputs, 1e-4
  on log-dets), the same at K = 2 and K = 20 (N = 96), and its plain
  backward against ``jax.vjp`` through the kernel at N = 256 and K = 2, 8
  and 20 (1e-3);
* ``unconstrained_rational_quadratic_spline_flat`` against
  ``unconstrained_rational_quadratic_spline_pallas`` with static mixed tails
  at (B = 17, D = 3, K = 5), and along ``event_axis = 1`` (2e-5 / 2e-4), and
  its VJP (1e-3);
* the wrapper's checks, its CPU dispatch and the gradients it gives.

Each JAX function below is compiled once for both directions and each
shape: eight compiles in all.  The CUDA kernels are held against the plain versions on the card,
in tests/test_torch_gpu.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflows_tpu.ops import spline_pallas as jpl
from normflows_tpu_torch.ops import spline_flat
from tests.helpers import assert_close

torch.set_num_threads(2)

PARAM_STD = 0.5  # see tests/test_torch_spline_kernel.py
DIRECTIONS = pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
TAILS = ((1, 2, 1), (5.0, float(np.pi), 3.0))
DEFAULTS = (1e-3, 1e-3, 1e-3)  # min bin width, min bin height, min derivative


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def flat_inputs(N, K, seed=0):
    """x (N,) with ~20% outside +-bound, uw_t, uh_t (K, N), ud_t (K+1, N),
    codes (N,) int32 mixing linear and circular tails, bounds (N,)."""
    rng = np.random.default_rng(seed)
    codes = rng.choice([1, 2], size=N).astype(np.int32)
    bounds = np.where(codes == 1, 4.0, np.pi).astype(np.float32)
    x = (rng.uniform(-1.25, 1.25, N) * bounds).astype(np.float32)
    uw, uh = (PARAM_STD * rng.normal(size=(2, K, N))).astype(np.float32)
    ud = (PARAM_STD * rng.normal(size=(K + 1, N))).astype(np.float32)
    return x, uw, uh, ud, codes, bounds


@functools.lru_cache(maxsize=None)
def jax_dyncodes():
    """Both directions of the interpret-mode kernel, compiled once."""
    return jax.jit(lambda *a: tuple(
        jpl.unconstrained_rqs_pallas_dyncodes(*a, inverse, interpret=True)
        for inverse in (False, True)))


@functools.lru_cache(maxsize=None)
def jax_dyncodes_vjp():
    def vjp(x, uw, uh, ud, codes, bounds, ybar, lbar):
        return tuple(jax.vjp(lambda *p: jpl.unconstrained_rqs_pallas_dyncodes(
            *p, codes, bounds, inverse, interpret=True), x, uw, uh, ud)[1]((ybar, lbar))
            for inverse in (False, True))

    return jax.jit(vjp)


@DIRECTIONS
def test_plain_matches_jax_dyncodes_kernel(inverse):
    x, uw, uh, ud, codes, bounds = flat_inputs(640, 8)
    yj, ldj = jax_dyncodes()(*map(jnp.asarray, (x, uw, uh, ud, codes, bounds)))[inverse]
    yt, ldt = spline_flat.unconstrained_rqs_dyncodes_reference(
        *map(t, (x, uw, uh, ud, codes, bounds)), inverse)
    assert_close(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=1e-4, rtol=1e-4)
    # the wrapper on a CPU tensor is the plain version, and counts no launch
    before = spline_flat.LAUNCHES
    yw, ldw = spline_flat.unconstrained_rqs_dyncodes(
        *map(t, (x, uw, uh, ud, codes, bounds)), inverse)
    assert torch.equal(yw, yt) and torch.equal(ldw, ldt)
    assert spline_flat.LAUNCHES == before


@DIRECTIONS
@pytest.mark.parametrize("K", [2, 20])
def test_plain_matches_jax_dyncodes_kernel_bins(K, inverse):
    """The bin counts at the ends of the card's sweep: 2, and 20, above the
    register path's 16 (the card's bin sweep is held against this plain
    version)."""
    x, uw, uh, ud, codes, bounds = flat_inputs(96, K, seed=K)
    yj, ldj = jax_dyncodes()(*map(jnp.asarray, (x, uw, uh, ud, codes, bounds)))[inverse]
    yt, ldt = spline_flat.unconstrained_rqs_dyncodes_reference(
        *map(t, (x, uw, uh, ud, codes, bounds)), inverse)
    assert_close(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    assert_close(ldt.numpy(), np.asarray(ldj), atol=1e-4, rtol=1e-4)


@DIRECTIONS
@pytest.mark.parametrize("K", [2, 8, 20])
def test_plain_backward_matches_jax_backward_kernel(K, inverse):
    """K = 8 (the large-D model) and the bin sweep's ends, 2 (the card's
    masked instantiation) and 20 (its loops over a runtime K)."""
    x, uw, uh, ud, codes, bounds = flat_inputs(256, K, seed=1)
    ybar, lbar = np.random.default_rng(2).normal(size=(2, 256)).astype(np.float32)
    gj = jax_dyncodes_vjp()(*map(jnp.asarray, (x, uw, uh, ud, codes, bounds, ybar, lbar)))
    gt = spline_flat.unconstrained_rqs_dyncodes_backward_reference(
        *map(t, (x, uw, uh, ud, codes, bounds, ybar, lbar)), inverse)
    for name, a, b in zip(("dx", "duw", "duh", "dud"), gt, gj[inverse]):
        assert torch.isfinite(a).all(), name
        assert_close(a.numpy(), np.asarray(b), atol=1e-3, rtol=1e-3, msg=name)


@functools.lru_cache(maxsize=None)
def jax_natural():
    """Both directions of the static-tail entry point, on a (B, D) input
    with tails along the last axis and on a (B, C, L) input with tails along
    axis 1, with their VJPs; compiled once each."""
    def run(args, args_c):
        out = []
        for inverse in (False, True):
            out.append(jpl.unconstrained_rqs_interpret(*args, *TAILS, inverse))
            out.append(jpl.unconstrained_rational_quadratic_spline_pallas(
                *args_c, *TAILS, inverse, *DEFAULTS, True, 1))
        return out

    def vjp(args, cts):
        return [jax.vjp(lambda *p: jpl.unconstrained_rational_quadratic_spline_pallas(
            *p, *TAILS, inverse, *DEFAULTS, True, -1), *args)[1](cts)
            for inverse in (False, True)]

    return jax.jit(run), jax.jit(vjp)


def natural_inputs(shape, K, event_axis, seed):
    rng = np.random.default_rng(seed)
    view = [1] * len(shape)
    view[event_axis] = 3
    bounds = np.asarray(TAILS[1], np.float32).reshape(view)
    x = (rng.uniform(-1.25, 1.25, shape) * bounds).astype(np.float32)
    uw, uh = (PARAM_STD * rng.normal(size=(2, *shape, K))).astype(np.float32)
    ud = (PARAM_STD * rng.normal(size=(*shape, K + 1))).astype(np.float32)
    return x, uw, uh, ud


@DIRECTIONS
def test_natural_layout_matches_jax(inverse):
    args = natural_inputs((17, 3), 5, 1, seed=3)
    args_c = natural_inputs((5, 3, 4), 5, 1, seed=4)
    run, _ = jax_natural()
    out = run(tuple(map(jnp.asarray, args)), tuple(map(jnp.asarray, args_c)))
    for a, axis, (yj, ldj) in ((args, -1, out[2 * inverse]), (args_c, 1, out[2 * inverse + 1])):
        yt, ldt = spline_flat.unconstrained_rational_quadratic_spline_flat(
            *map(t, a), *TAILS, inverse, event_axis=axis)
        assert yt.shape == a[0].shape and ldt.shape == a[0].shape
        assert_close(yt.numpy(), np.asarray(yj), atol=2e-5, rtol=2e-5)
        assert_close(ldt.numpy(), np.asarray(ldj), atol=2e-4, rtol=2e-4)


@DIRECTIONS
def test_natural_layout_vjp_matches_jax(inverse):
    """Autograd through the relayout and the Function, on parameters that
    are views of one (B, D, 3K+1) tensor, as the AR layer hands them over."""
    K = 5
    x, uw, uh, ud = natural_inputs((17, 3), K, 1, seed=5)
    ybar, lbar = np.random.default_rng(6).normal(size=(2, 17, 3)).astype(np.float32)
    _, vjp = jax_natural()
    gj = vjp(tuple(map(jnp.asarray, (x, uw, uh, ud))),
             (jnp.asarray(ybar), jnp.asarray(lbar)))[inverse]
    xt = t(x).requires_grad_()
    p = t(np.concatenate([uw, uh, ud], axis=-1)).requires_grad_()
    y, ld = spline_flat.unconstrained_rational_quadratic_spline_flat(
        xt, p[..., :K], p[..., K:2 * K], p[..., 2 * K:], *TAILS, inverse)
    torch.autograd.backward((y, ld), (t(ybar), t(lbar)))
    dp = p.grad.numpy()
    for name, a, b in (("dx", xt.grad.numpy(), gj[0]), ("duw", dp[..., :K], gj[1]),
                       ("duh", dp[..., K:2 * K], gj[2]), ("dud", dp[..., 2 * K:], gj[3])):
        assert_close(a, np.asarray(b), atol=1e-3, rtol=1e-3, msg=name)


def test_function_gradients_and_slab_rows(monkeypatch):
    """On the CPU the Function's backward is the plain backward; the
    parameters may be row slices of a larger tensor (the AR layer's slab),
    whose gradient lands in those rows only; codes get none, bounds a zero
    one."""
    monkeypatch.setattr(spline_flat, "BACKWARD_LAUNCHES", 0)
    K, N = 4, 300
    x, uw, uh, ud, codes, bounds = flat_inputs(N, K, seed=7)
    big = torch.zeros(2 + 3 * K + 1 + 3, N)
    big[2:2 + 3 * K + 1] = t(np.concatenate([uw, uh, ud]))
    big.requires_grad_()
    slab = big[2:2 + 3 * K + 1]
    xt, bt = t(x).requires_grad_(), t(bounds).requires_grad_()
    w = t(np.random.default_rng(8).normal(size=N).astype(np.float32))
    y, ld = spline_flat.unconstrained_rqs_dyncodes(
        xt, slab[:K], slab[K:2 * K], slab[2 * K:], t(codes), bt, True)
    ((y * w).sum() + 0.5 * ld.sum()).backward()
    dx, duw, duh, dud = spline_flat.unconstrained_rqs_dyncodes_backward_reference(
        *map(t, (x, uw, uh, ud, codes, bounds)), w, torch.full((N,), 0.5), True)
    assert torch.equal(xt.grad, dx)
    assert torch.equal(big.grad[2:2 + 3 * K + 1], torch.cat([duw, duh, dud]))
    assert not big.grad[:2].any() and not big.grad[2 + 3 * K + 1:].any()
    assert torch.equal(bt.grad, torch.zeros(N))
    assert spline_flat.BACKWARD_LAUNCHES == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    K, N = 4, 64
    x, uw, uh, ud, codes, bounds = map(t, flat_inputs(N, K))
    f = spline_flat.unconstrained_rqs_dyncodes
    with pytest.raises(TypeError, match="float32"):
        f(x.double(), uw, uh, ud, codes, bounds, False)
    with pytest.raises(TypeError, match="int32"):
        f(x, uw, uh, ud, codes.long(), bounds, False)
    with pytest.raises(ValueError, match="do not fit"):
        f(x, uw, uh, ud[:-1], codes, bounds, False)
    with pytest.raises(ValueError, match="contiguous rows"):
        f(x, uw.T.contiguous().T, uh, ud, codes, bounds, False)
    with pytest.raises(ValueError, match="contiguous"):
        f(x, uw, uh, ud, codes, torch.stack([bounds, bounds], 1)[:, 0], False)
    with pytest.raises(ValueError, match="1-D"):
        f(x[None], uw, uh, ud, codes, bounds, False)
    with pytest.raises(ValueError, match="lbar must be"):
        spline_flat.unconstrained_rqs_dyncodes_backward(
            x, uw, uh, ud, codes, bounds, x, x[:32], False)
