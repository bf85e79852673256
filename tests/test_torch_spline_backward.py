"""The backward of the port's planar spline (normflows_tpu_torch/ops/spline_cuda.py).

Its plain version ``rqs_transposed_backward_reference`` against ``jax.vjp`` of
the JAX package's planar kernel ``rqs_transposed_pallas`` in interpret mode,
which runs ``_t_bwd_kernel``, at the JAX package's gradient bars
(tests/test_pallas.py: atol = rtol = 2e-3); and the ``autograd.Function``
that carries it, with the cotangents autograd really hands over.  The CUDA
backward kernel is held against the plain version on the card, in
tests/test_torch_gpu.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normflows_tpu.ops import spline_pallas as jpl
from normflows_tpu_torch.ops import spline_cuda
from tests.helpers import assert_close

torch.set_num_threads(2)

G_TOL = 2e-3
K = 10
# std 0.5, as the forward tests (tests/test_torch_spline_kernel.py)
PARAM_STD = 0.5
TAILS = {2: ((1, 2), (5.0, float(np.pi))), 3: ((1, 2, 1), (5.0, float(np.pi), 3.0))}


def inputs(F, B, seed=0, zero_slopes=False, K=K):
    """x_t (F, B) with ~20% outside +-bound, params_t (F(3K+1), B) and the
    cotangents (ybar, lbar), all from one numpy generator.  ``zero_slopes``
    sets every derivative logit to exactly 0, where softplus' gradient is
    sigmoid(0) = 0.5."""
    rng = np.random.default_rng(seed)
    bounds = np.asarray(TAILS[F][1], np.float32)[:, None]
    x_t = (rng.uniform(-1.25, 1.25, (F, B)) * bounds).astype(np.float32)
    p_t = (PARAM_STD * rng.normal(size=(F, 3 * K + 1, B))).astype(np.float32)
    if zero_slopes:
        p_t[:, 2 * K:] = 0.0
    ybar, lbar = rng.normal(size=(2, F, B)).astype(np.float32)
    return x_t, p_t.reshape(F * (3 * K + 1), B), ybar, lbar


@functools.lru_cache(maxsize=None)
def jax_backward(F, B, inverse):
    """``jax.vjp`` of the interpret-mode kernel, compiled once for a shape:
    compiling takes 5-15 s here, running it milliseconds."""
    codes, bounds = TAILS[F]

    def vjp(x, p, ybar, lbar):
        _, pull = jax.vjp(lambda x, p: jpl.rqs_transposed_pallas(
            x, p, codes, bounds, inverse, interpret=True), x, p)
        return pull((ybar, lbar))

    return jax.jit(vjp)


# F = 2 on a ragged batch (B = 1061 pads to two (8, 128) tiles of the TPU
# kernel), F = 3 with its 93 parameter rows on a whole one, and the large-D
# model's K = 8 (the other bin count the CUDA kernel takes exactly); each
# compile of the interpret-mode kernel costs seconds, so not every pairing
# is run.
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("F,B,zero_slopes,bins", [(2, 1061, False, K), (2, 1061, True, K),
                                                  (3, 1024, False, K), (2, 1061, False, 8)],
                         ids=["F2-B1061", "F2-B1061-zero-slopes", "F3-B1024", "F2-B1061-K8"])
def test_plain_backward_matches_jax_backward_kernel(F, B, zero_slopes, bins, inverse):
    codes, bounds = TAILS[F]
    x_t, p_t, ybar, lbar = inputs(F, B, zero_slopes=zero_slopes, K=bins)
    dxj, dpj = jax_backward(F, B, inverse)(*map(jnp.asarray, (x_t, p_t, ybar, lbar)))
    t = torch.from_numpy
    dx, dp = spline_cuda.rqs_transposed_backward_reference(
        t(x_t), t(p_t), t(ybar), t(lbar), codes, bounds, inverse)
    assert torch.isfinite(dx).all() and torch.isfinite(dp).all()
    assert_close(dx.numpy(), np.asarray(dxj), atol=G_TOL, rtol=G_TOL)
    assert_close(dp.numpy(), np.asarray(dpj), atol=G_TOL, rtol=G_TOL)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_function_takes_the_cotangents_autograd_hands_over(inverse, monkeypatch):
    """Through the layer's own reshapes, ``ybar`` arrives as a transposed view
    and ``lbar`` as a stride-0 expansion; on the CPU the Function's backward
    is the plain backward, and no kernel is counted."""
    monkeypatch.setattr(spline_cuda, "LAUNCHES", 0)
    monkeypatch.setattr(spline_cuda, "BACKWARD_LAUNCHES", 0)
    codes, bounds = TAILS[2]
    x_t, p_t, _, _ = inputs(2, 300, seed=1)
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(300, 2)).astype(np.float32))
    x = torch.from_numpy(x_t).requires_grad_()
    p = torch.from_numpy(p_t).requires_grad_()
    y_t, ld_t = spline_cuda.rqs_transposed(x, p, codes, bounds, inverse)
    loss = (y_t.T * w).sum() + 0.5 * ld_t.sum(dim=0).sum()
    loss.backward()
    dx, dp = spline_cuda.rqs_transposed_backward_reference(
        x.detach(), p.detach(), w.T.contiguous(), torch.full((2, 300), 0.5),
        codes, bounds, inverse)
    assert torch.equal(x.grad, dx) and torch.equal(p.grad, dp)
    assert spline_cuda.LAUNCHES == 0 and spline_cuda.BACKWARD_LAUNCHES == 0
    # an input autograd does not ask about gets no gradient
    p2 = torch.from_numpy(p_t).requires_grad_()
    y2, _ = spline_cuda.rqs_transposed(torch.from_numpy(x_t), p2, codes, bounds, inverse)
    x_only = torch.from_numpy(x_t).requires_grad_()
    y3, _ = spline_cuda.rqs_transposed(x_only, torch.from_numpy(p_t), codes, bounds,
                                       inverse)
    (y2.sum() + y3.sum()).backward()
    assert p2.grad is not None and x_only.grad is not None


def test_backward_rejects_what_the_kernel_does_not_take():
    codes, bounds = TAILS[2]
    x, p, yb, lb = (torch.from_numpy(a) for a in inputs(2, 64))
    with pytest.raises(ValueError, match="ybar must be a contiguous"):
        spline_cuda.rqs_transposed_backward(x, p, yb.T.contiguous().T, lb, codes,
                                            bounds, False)
    with pytest.raises(ValueError, match="lbar must be a contiguous"):
        spline_cuda.rqs_transposed_backward(x, p, yb, lb[:, :32], codes, bounds, False)
    with pytest.raises(ValueError, match="does not fit"):
        spline_cuda.rqs_transposed_backward(x, p[:-1], yb, lb, codes, bounds, False)
