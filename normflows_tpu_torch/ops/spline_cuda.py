"""Planar rational-quadratic spline: the CUDA kernels, their wrapper, their
launch counts and their plain PyTorch versions.

Port of ``rqs_transposed_pallas`` (``normflows_tpu/ops/spline_pallas.py:726``)
with its custom-vjp backward: ``csrc/rqs_transposed.cu`` holds the kernel of
each direction (counterpart of ``_t_fwd_kernel``) and the backward kernel
(counterpart of ``_t_bwd_kernel``), built with ``nvcc`` for ``sm_90a`` at
first use and loaded with ``ctypes`` (``ops/cuda_build.py``).

Each direction is an operator (``backend.kernel_op``):
``normflows_tpu_torch::rqs_transposed`` (:data:`OP`) and
``normflows_tpu_torch::rqs_transposed_backward`` (:data:`BACKWARD_OP`), the
second registered as the first's autograd.  On a CUDA tensor each launches
its kernel, on a CPU tensor it calls its plain version,
:func:`rqs_transposed_reference` or :func:`rqs_transposed_backward_reference`
(``ops/backend.py``).  :func:`rqs_transposed` and
:func:`rqs_transposed_backward` check their operands and call the operators;
under ``torch.export`` the checks become guards and each launch one node.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import backend, cuda_build, splines

SOURCE = cuda_build.CSRC / "rqs_transposed.cu"
MAX_FEATURES = 8  # kMaxFeatures in the kernel

# Kernel launches made by rqs_transposed since the count was last set to 0:
# forward kernels (either direction) and backward kernels.
LAUNCHES = 0
BACKWARD_LAUNCHES = 0
# The same launches counted on the card, by [backward][inverse], when set to
# an int64 (2, 2) tensor there (see backend.count_launch); None: off.
DEVICE_LAUNCHES = None

_SIGNATURES = {
    name: [ctypes.c_void_p] * pointers + [ctypes.c_int] * 4 + [ctypes.c_double] * 3
    + [ctypes.c_void_p]
    for name, pointers in (("rqs_transposed_forward", 6), ("rqs_transposed_backward", 8))
}


def _library():
    return cuda_build.library(SOURCE, _SIGNATURES)


def _check(x_t, params_t, tail_codes, tail_bound):
    """Raise on anything the kernel does not take."""
    for name, t in (("x_t", x_t), ("params_t", params_t)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"rqs_transposed: {name} must be a 2-D tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"rqs_transposed: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rqs_transposed: {name} must be contiguous")
    if x_t.device != params_t.device:
        raise ValueError("rqs_transposed: x_t and params_t lie on different devices")
    F, B = x_t.shape
    P, Bp = params_t.shape
    if Bp != B or F < 1 or B < 1 or P % F or (P // F - 1) % 3 or P // F < 4:
        raise ValueError(
            f"rqs_transposed: params_t {tuple(params_t.shape)} does not fit x_t "
            f"{tuple(x_t.shape)}: need (F*(3K+1), B) with K >= 1")
    if F > MAX_FEATURES:
        raise ValueError(f"rqs_transposed: at most {MAX_FEATURES} features, got {F}")
    if len(tail_codes) != F or len(tail_bound) != F:
        raise ValueError("rqs_transposed: need one tail code and one bound per feature")


def _launch(fn, pointers, x_t, codes, bounds, K, inverse, mbw, mbh, md):
    """Launch ``fn`` of the library on ``pointers`` on the current stream."""
    F, B = x_t.shape
    codes_c = (ctypes.c_int * F)(*codes)
    bounds_c = (ctypes.c_float * F)(*bounds)
    with torch.cuda.device(x_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in pointers), codes_c, bounds_c, F, B, K,
                int(inverse), mbw, mbh, md, stream)
    if rc != 0:
        raise RuntimeError(f"rqs_transposed kernel launch failed: CUDA error {rc}")


def _forward_cuda(x_t, params_t, codes, bounds, inverse, mbw, mbh, md):
    global LAUNCHES
    # an exported program's views can differ from the traced ones at another
    # batch: the kernels' layout is made here (no copy when it holds)
    x_t, params_t = x_t.contiguous(), params_t.contiguous()
    K = (params_t.shape[0] // x_t.shape[0] - 1) // 3
    y_t = torch.empty_like(x_t)
    ld_t = torch.empty_like(x_t)
    _launch(_library().rqs_transposed_forward, (x_t, params_t, y_t, ld_t), x_t,
            codes, bounds, K, inverse, mbw, mbh, md)
    LAUNCHES += 1
    backend.count_launch(DEVICE_LAUNCHES, False, inverse)
    return y_t, ld_t


def _forward_cpu(x_t, params_t, codes, bounds, inverse, mbw, mbh, md):
    y_t, ld_t = rqs_transposed_reference(x_t, params_t, codes, bounds, inverse,
                                         mbw, mbh, md)
    return y_t.contiguous(), ld_t.contiguous()


def _backward_cuda(x_t, params_t, ybar, lbar, codes, bounds, inverse, mbw, mbh, md):
    global BACKWARD_LAUNCHES
    x_t, params_t, ybar, lbar = (t.contiguous() for t in (x_t, params_t, ybar, lbar))
    K = (params_t.shape[0] // x_t.shape[0] - 1) // 3
    dx = torch.empty_like(x_t)
    dp = torch.empty_like(params_t)
    _launch(_library().rqs_transposed_backward, (x_t, params_t, ybar, lbar, dx, dp),
            x_t, codes, bounds, K, inverse, mbw, mbh, md)
    BACKWARD_LAUNCHES += 1
    backend.count_launch(DEVICE_LAUNCHES, True, inverse)
    return dx, dp


def _backward_cpu(x_t, params_t, ybar, lbar, codes, bounds, inverse, mbw, mbh, md):
    with backend.autograd_inside_op():
        dx, dp = rqs_transposed_backward_reference(x_t, params_t, ybar, lbar, codes,
                                                   bounds, inverse, mbw, mbh, md)
    # fresh tensors: autograd may hand a cotangent itself back as a gradient
    return (dx.clone(memory_format=torch.contiguous_format),
            dp.clone(memory_format=torch.contiguous_format))


_CONFIG = "int[] codes, float[] bounds, bool inverse, float mbw, float mbh, float md"

BACKWARD_OP = backend.kernel_op(
    "rqs_transposed_backward",
    f"(Tensor x_t, Tensor params_t, Tensor ybar, Tensor lbar, {_CONFIG}) -> (Tensor, Tensor)",
    cpu=_backward_cpu, cuda=_backward_cuda,
    fake=lambda x_t, params_t, *_: (torch.empty_like(x_t), torch.empty_like(params_t)))


def _setup_context(ctx, inputs, output):
    x_t, params_t, *config = inputs
    ctx.save_for_backward(x_t, params_t)
    ctx.config = config


def _backward(ctx, ybar, lbar):
    x_t, params_t = ctx.saved_tensors
    want_x, want_p = ctx.needs_input_grad[:2]
    # autograd hands over the layer's y_t.T as a transposed view and the
    # sum over features of ld_t as a stride-0 expansion
    dx, dp = BACKWARD_OP(x_t, params_t, ybar.contiguous(), lbar.contiguous(), *ctx.config)
    return (dx if want_x else None, dp if want_p else None) + (None,) * 6


OP = backend.kernel_op(
    "rqs_transposed", f"(Tensor x_t, Tensor params_t, {_CONFIG}) -> (Tensor, Tensor)",
    cpu=_forward_cpu, cuda=_forward_cuda,
    fake=lambda x_t, *_: (torch.empty_like(x_t), torch.empty_like(x_t)),
    backward=_backward, setup_context=_setup_context)


def _config(tail_codes, tail_bound, inverse, mbw, mbh, md):
    return ([int(c) for c in tail_codes], [float(b) for b in tail_bound], bool(inverse),
            float(mbw), float(mbh), float(md))


def rqs_transposed_backward(x_t, params_t, ybar, lbar, tail_codes, tail_bound,
                            inverse, min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
                            min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
                            min_derivative=splines.DEFAULT_MIN_DERIVATIVE):
    """Backward of :func:`rqs_transposed`: the cotangents ``ybar``, ``lbar``
    (F, B) of ``(y_t, ld_t)`` -> ``(dx (F, B), dparams (P, B))``, through the
    operator :data:`BACKWARD_OP`.

    A CPU tensor takes :func:`rqs_transposed_backward_reference`; a CUDA
    tensor launches the backward kernel or raises."""
    _check(x_t, params_t, tail_codes, tail_bound)
    for name, t in (("ybar", ybar), ("lbar", lbar)):
        if t.shape != x_t.shape or t.dtype != x_t.dtype or t.device != x_t.device \
                or not t.is_contiguous():
            raise ValueError(f"rqs_transposed_backward: {name} must be a contiguous "
                             f"float32 tensor like x_t {tuple(x_t.shape)} on {x_t.device}")
    return BACKWARD_OP(x_t, params_t, ybar, lbar, *_config(
        tail_codes, tail_bound, inverse, min_bin_width, min_bin_height, min_derivative))


def rqs_transposed(x_t, params_t, tail_codes, tail_bound, inverse,
                   min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
                   min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
                   min_derivative=splines.DEFAULT_MIN_DERIVATIVE):
    """Planar RQS: x_t (F, B), params_t (F*(3K+1), B) -> (y_t, ld_t), both (F, B),
    through the operator :data:`OP`.

    ``tail_codes`` / ``tail_bound`` hold one entry per feature; row
    ``f*(3K+1) + s`` of ``params_t`` holds widths | heights | slopes of feature f.
    A CPU tensor takes :func:`rqs_transposed_reference`; a CUDA tensor launches
    the kernel or raises; either way the backward follows the same rule
    (:func:`rqs_transposed_backward`)."""
    _check(x_t, params_t, tail_codes, tail_bound)
    return OP(x_t, params_t, *_config(tail_codes, tail_bound, inverse, min_bin_width,
                                      min_bin_height, min_derivative))


def rqs_transposed_reference(x_t, params_t, tail_codes, tail_bound, inverse,
                             min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
                             min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
                             min_derivative=splines.DEFAULT_MIN_DERIVATIVE):
    """Plain PyTorch version of the kernel, from ``ops/splines.py``: the same
    function on any device, differentiable.  Its bin search adds ``eps`` to the
    last knot (``splines.searchsorted``) where the kernel lets its last bin
    catch what is left; both stay within the JAX package's bars."""
    F, B = x_t.shape
    K = (params_t.shape[0] // F - 1) // 3
    p = params_t.reshape(F, 3 * K + 1, B).permute(2, 0, 1)  # (B, F, S)
    codes = torch.as_tensor(np.asarray(tail_codes, np.int64), device=x_t.device)
    bounds = torch.as_tensor(np.asarray(tail_bound, np.float32), device=x_t.device)
    y, ld = splines.unconstrained_rational_quadratic_spline(
        x_t.T, p[..., :K], p[..., K:2 * K], p[..., 2 * K:], inverse=inverse,
        tail_codes=codes, tail_bound=bounds, min_bin_width=min_bin_width,
        min_bin_height=min_bin_height, min_derivative=min_derivative)
    return y.T, ld.T


def rqs_transposed_backward_reference(x_t, params_t, ybar, lbar, tail_codes,
                                      tail_bound, inverse,
                                      min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
                                      min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
                                      min_derivative=splines.DEFAULT_MIN_DERIVATIVE):
    """Plain PyTorch version of the backward kernel: ``torch.autograd.grad``
    of :func:`rqs_transposed_reference` with cotangents ``(ybar, lbar)``.
    Returns ``(dx (F, B), dparams (P, B))``."""
    with torch.enable_grad():
        x = x_t.detach().requires_grad_()
        p = params_t.detach().requires_grad_()
        y, ld = rqs_transposed_reference(x, p, tail_codes, tail_bound, inverse,
                                         min_bin_width, min_bin_height, min_derivative)
        dx, dp = torch.autograd.grad((y, ld), (x, p), (ybar, lbar))
    return dx, dp
