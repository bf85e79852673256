"""Flat rational-quadratic spline: the CUDA kernels, their two entry points,
their launch counts and their plain PyTorch versions.

``csrc/rqs_flat.cu`` holds the counterparts of the TPU kernels ``_fwd_kernel``
and ``_bwd_kernel`` (``normflows_tpu/ops/spline_pallas.py:303``, ``:313``),
built with ``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``
(``ops/cuda_build.py``).  Two entry points of the JAX package reach them,
and both are here:

* :func:`unconstrained_rqs_dyncodes`, the port of
  ``unconstrained_rqs_pallas_dyncodes`` (:636): N elements with runtime
  per-element tail codes and bounds and parameters already laid out as rows,
  ``uw_t``/``uh_t`` (K, N) and ``ud_t`` (K+1, N).  The sliced inverse of the
  large-D autoregressive spline calls it once per step on one feature's
  (3K+1, B) slab of the net's output, which takes no copy.
* :func:`unconstrained_rational_quadratic_spline_flat`, the port of
  ``unconstrained_rational_quadratic_spline_pallas`` (:444): the natural
  (..., S) layout with static per-dim tails along ``event_axis``.  It lays
  the operands out as ``_prepare`` (:408) does, the parameters (..., S) ->
  (S, N), and calls the first.

Each kernel is an operator (``backend.kernel_op``):
``normflows_tpu_torch::rqs_flat`` (:data:`OP`) and
``normflows_tpu_torch::rqs_flat_backward`` (:data:`BACKWARD_OP`), the second
registered as the first's autograd.  On a CUDA tensor each launches its
kernel, on a CPU tensor it calls its plain version,
:func:`unconstrained_rqs_dyncodes_reference` or
:func:`unconstrained_rqs_dyncodes_backward_reference` (``ops/backend.py``).
No gradient goes to the codes, a zero one to the bounds, as in the JAX
package (:701-704).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily

from . import backend, cuda_build, splines

SOURCE = cuda_build.CSRC / "rqs_flat.cu"

# Kernel launches made by this module since the count was last set to 0:
# forward kernels (either direction) and backward kernels.
LAUNCHES = 0
BACKWARD_LAUNCHES = 0
# The same launches counted on the card, by [backward][inverse], when set to
# an int64 (2, 2) tensor there (see backend.count_launch); None: off.
DEVICE_LAUNCHES = None

_TAIL = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
_SIGNATURES = {"rqs_flat_forward": [ctypes.c_void_p] * 8 + _TAIL,
               "rqs_flat_backward": [ctypes.c_void_p] * 10 + _TAIL}


def _library():
    return cuda_build.library(SOURCE, _SIGNATURES)


def _check(x, uw_t, uh_t, ud_t, codes, bounds):
    """Raise on anything the kernel does not take."""
    if not isinstance(x, torch.Tensor) or x.dim() != 1 or x.numel() < 1:
        raise ValueError("rqs_flat: x must be a non-empty 1-D tensor")
    N = x.shape[0]
    K = uw_t.shape[0] if uw_t.dim() == 2 else 0
    want = (("uw_t", uw_t, (K, N)), ("uh_t", uh_t, (K, N)), ("ud_t", ud_t, (K + 1, N)))
    if K < 1 or any(tuple(t.shape) != s for _, t, s in want):
        raise ValueError(
            f"rqs_flat: uw_t {tuple(uw_t.shape)}, uh_t {tuple(uh_t.shape)}, ud_t "
            f"{tuple(ud_t.shape)} do not fit x ({N},): need (K, N), (K, N), (K+1, N)")
    stride = ud_t.stride(0)
    for name, t in (("x", x), *((n, t) for n, t, _ in want), ("bounds", bounds)):
        if t.dtype != torch.float32:
            raise TypeError(f"rqs_flat: {name} must be float32, got {t.dtype}")
    for name, t, _ in want:
        if (N > 1 and t.stride(-1) != 1) or (t.shape[0] > 1 and t.stride(0) != stride) \
                or stride < N:
            raise ValueError(f"rqs_flat: {name} must hold contiguous rows, all "
                             f"three parameter tensors {stride} >= N floats apart")
    if codes.dtype != torch.int32:
        raise TypeError(f"rqs_flat: codes must be int32, got {codes.dtype}")
    for name, t in (("x", x), ("codes", codes), ("bounds", bounds)):
        if tuple(t.shape) != (N,) or not t.is_contiguous():
            raise ValueError(f"rqs_flat: {name} must be a contiguous ({N},) tensor")
    if any(t.device != x.device for t in (uw_t, uh_t, ud_t, codes, bounds)):
        raise ValueError("rqs_flat: the operands lie on different devices")


def _launch(name, pointers, x, K, stride, config):
    inverse, mbw, mbh, md = config
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(_library(), name)(*(t.data_ptr() for t in pointers), x.shape[0], K,
                                       stride, int(inverse), mbw, mbh, md, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _config(inverse, mbw, mbh, md):
    return bool(inverse), float(mbw), float(mbh), float(md)


def _rows(uw_t, uh_t, ud_t):
    """The parameters as the kernels take them: rows of unit stride, one
    stride >= N apart, and that stride.  An exported program's views can
    differ from the traced ones at another batch (a reshape that copied at
    the traced batch may give a view at batch 1): rows that do not fit are
    packed into one (3K+1, N) tensor, and the layout holds with no copy
    otherwise."""
    K, N = uw_t.shape
    stride = ud_t.stride(0)
    # ud_t has K + 1 >= 2 rows, so its stride is the rows' one; a row's
    # own stride counts only where N > 1, and uw_t's and uh_t's row strides
    # only where K > 1
    if stride >= N and (N == 1 or uw_t.stride(1) == uh_t.stride(1) == ud_t.stride(1) == 1) \
            and (K == 1 or uw_t.stride(0) == uh_t.stride(0) == stride):
        return uw_t, uh_t, ud_t, stride
    packed = torch.cat((uw_t, uh_t, ud_t))
    return packed[:K], packed[K:2 * K], packed[2 * K:], N


def _forward_cuda(x, uw_t, uh_t, ud_t, codes, bounds, inverse, mbw, mbh, md):
    global LAUNCHES
    x, codes, bounds = x.contiguous(), codes.contiguous(), bounds.contiguous()
    uw_t, uh_t, ud_t, stride = _rows(uw_t, uh_t, ud_t)
    y = torch.empty_like(x)
    ld = torch.empty_like(x)
    _launch("rqs_flat_forward", (x, uw_t, uh_t, ud_t, codes, bounds, y, ld), x,
            uw_t.shape[0], stride, (inverse, mbw, mbh, md))
    LAUNCHES += 1
    backend.count_launch(DEVICE_LAUNCHES, False, inverse)
    return y, ld


def _forward_cpu(x, uw_t, uh_t, ud_t, codes, bounds, inverse, mbw, mbh, md):
    y, ld = unconstrained_rqs_dyncodes_reference(x, uw_t, uh_t, ud_t, codes, bounds,
                                                 inverse, mbw, mbh, md)
    return y.contiguous(), ld.contiguous()


def _backward_cuda(x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar, inverse, mbw, mbh, md):
    global BACKWARD_LAUNCHES
    x, codes, bounds, ybar, lbar = (t.contiguous() for t in (x, codes, bounds, ybar, lbar))
    uw_t, uh_t, ud_t, stride = _rows(uw_t, uh_t, ud_t)
    K, N = uw_t.shape
    dx = torch.empty_like(x)
    dp = torch.empty(3 * K + 1, N, dtype=x.dtype, device=x.device)
    _launch("rqs_flat_backward", (x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar, dx, dp),
            x, K, stride, (inverse, mbw, mbh, md))
    BACKWARD_LAUNCHES += 1
    backend.count_launch(DEVICE_LAUNCHES, True, inverse)
    return dx, dp


def _backward_cpu(x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar, inverse, mbw, mbh, md):
    with backend.autograd_inside_op():
        dx, duw, duh, dud = unconstrained_rqs_dyncodes_backward_reference(
            x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar, inverse, mbw, mbh, md)
    # fresh tensors: autograd may hand a cotangent itself back as a gradient
    return dx.clone(memory_format=torch.contiguous_format), torch.cat((duw, duh, dud))


_OPERANDS = "Tensor x, Tensor uw_t, Tensor uh_t, Tensor ud_t, Tensor codes, Tensor bounds"
_CONFIG = "bool inverse, float mbw, float mbh, float md"

BACKWARD_OP = backend.kernel_op(
    "rqs_flat_backward",
    f"({_OPERANDS}, Tensor ybar, Tensor lbar, {_CONFIG}) -> (Tensor, Tensor)",
    cpu=_backward_cpu, cuda=_backward_cuda,
    fake=lambda x, uw_t, *_: (torch.empty_like(x),
                              x.new_empty((3 * uw_t.shape[0] + 1, x.shape[0]))))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:6])
    ctx.config = inputs[6:]


def _backward(ctx, ybar, lbar):
    x, uw_t, uh_t, ud_t, codes, bounds = ctx.saved_tensors
    K = uw_t.shape[0]
    # the sum of the log-dets hands over a stride-0 expansion
    dx, dp = BACKWARD_OP(x, uw_t, uh_t, ud_t, codes, bounds, ybar.contiguous(),
                         lbar.contiguous(), *ctx.config)
    grads = (dx, dp[:K], dp[K:2 * K], dp[2 * K:])
    grads = tuple(g if want else None for g, want in zip(grads, ctx.needs_input_grad))
    dbounds = torch.zeros_like(bounds) if ctx.needs_input_grad[5] else None
    return (*grads, None, dbounds, None, None, None, None)


OP = backend.kernel_op(
    "rqs_flat", f"({_OPERANDS}, {_CONFIG}) -> (Tensor, Tensor)",
    cpu=_forward_cpu, cuda=_forward_cuda,
    fake=lambda x, *_: (torch.empty_like(x), torch.empty_like(x)),
    backward=_backward, setup_context=_setup_context)


def unconstrained_rqs_dyncodes(x, uw_t, uh_t, ud_t, codes, bounds, inverse,
                               min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
                               min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
                               min_derivative=splines.DEFAULT_MIN_DERIVATIVE):
    """Flat RQS with runtime tails: x (N,), uw_t / uh_t (K, N), ud_t (K+1, N),
    codes (N,) int32, bounds (N,) float32 -> (y (N,), ld (N,)), through the
    operator :data:`OP`.

    The parameter tensors may be row slices of a larger tensor (their rows
    contiguous and one stride apart).  A CPU tensor takes
    :func:`unconstrained_rqs_dyncodes_reference`; a CUDA tensor launches the
    kernel or raises; the backward follows the same rule."""
    _check(x, uw_t, uh_t, ud_t, codes, bounds)
    return OP(x, uw_t, uh_t, ud_t, codes, bounds,
              *_config(inverse, min_bin_width, min_bin_height, min_derivative))


def unconstrained_rqs_dyncodes_backward(x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar,
                                        inverse,
                                        min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
                                        min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
                                        min_derivative=splines.DEFAULT_MIN_DERIVATIVE):
    """Backward of :func:`unconstrained_rqs_dyncodes`: the cotangents
    ``ybar``, ``lbar`` (N,) -> ``(dx (N,), duw_t (K, N), duh_t (K, N),
    dud_t (K+1, N))``, the three rows of one (3K+1, N) tensor, through the
    operator :data:`BACKWARD_OP`.  A CPU tensor takes
    :func:`unconstrained_rqs_dyncodes_backward_reference`; a CUDA tensor
    launches the backward kernel or raises."""
    _check(x, uw_t, uh_t, ud_t, codes, bounds)
    for name, t in (("ybar", ybar), ("lbar", lbar)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"rqs_flat backward: {name} must be a contiguous float32 "
                             f"tensor like x {tuple(x.shape)} on {x.device}")
    K = uw_t.shape[0]
    dx, dp = BACKWARD_OP(x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar,
                         *_config(inverse, min_bin_width, min_bin_height, min_derivative))
    return dx, dp[:K], dp[K:2 * K], dp[2 * K:]


@functools.lru_cache(maxsize=None)
def per_dim(values: tuple, dtype, device) -> torch.Tensor:
    """A static per-dim tuple as a tensor on ``device``, copied there once:
    later calls take no host-to-device copy.  Made outside inference mode,
    so that any caller may use it, and outside ``torch.export``'s fake
    tensors, so that an exported program holds it as a constant."""
    with torch.inference_mode(False), unset_fake_temporarily():
        return torch.tensor(values, dtype=dtype, device=device)


def _align(v, shape, event_axis, dtype, device) -> torch.Tensor:
    """A static scalar or per-dim tuple spread over ``shape``, the per-dim
    axis at ``event_axis`` (``_align`` of the JAX package), flattened."""
    arr = np.asarray(v)
    if arr.ndim == 0:
        return torch.full(shape, arr.item(), dtype=dtype, device=device).reshape(-1)
    view = [1] * len(shape)
    view[event_axis % len(shape)] = arr.shape[0]
    # contiguous: a one-entry tuple expands to a stride-0 view, which the
    # reshape would keep
    return per_dim(tuple(arr.tolist()), dtype, device).view(view).expand(shape) \
        .reshape(-1).contiguous()


def unconstrained_rational_quadratic_spline_flat(
        x, uw, uh, ud, tail_codes=splines.TAIL_LINEAR, tail_bound=1.0, inverse=False,
        min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=splines.DEFAULT_MIN_DERIVATIVE, event_axis=-1):
    """RQS in the natural layout: x (...), uw / uh (..., K), ud (..., K+1) ->
    (y, ld), both shaped like x.

    ``tail_codes`` / ``tail_bound`` are static: a scalar, or one entry per
    index of ``x``'s axis ``event_axis``.  The parameters are laid out as
    the rows of one (3K+1, N) tensor (one copy, ``torch.cat`` of the three
    moved to the front), then :func:`unconstrained_rqs_dyncodes` runs on
    the flat N = x.numel() elements: the kernel on the card, the plain
    version on the CPU."""
    shape = x.shape
    codes = _align(tail_codes, shape, event_axis, torch.int32, x.device)
    bounds = _align(tail_bound, shape, event_axis, x.dtype, x.device)
    K = uw.shape[-1]
    rows = torch.cat([p.movedim(-1, 0) for p in (uw, uh, ud)])
    rows = rows.view(rows.shape[0], -1)  # (3K+1, N): cat's output is contiguous
    y, ld = unconstrained_rqs_dyncodes(
        x.reshape(-1), rows[:K], rows[K:2 * K], rows[2 * K:], codes, bounds, inverse,
        min_bin_width, min_bin_height, min_derivative)
    return y.view(shape), ld.view(shape)


def unconstrained_rqs_dyncodes_reference(x, uw_t, uh_t, ud_t, codes, bounds, inverse,
                                         min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
                                         min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
                                         min_derivative=splines.DEFAULT_MIN_DERIVATIVE):
    """Plain PyTorch version of the kernel, from ``ops/splines.py``: the same
    function on any device, differentiable.  Its bin search adds ``eps`` to
    the last knot (``splines.searchsorted``) where the kernel lets its last
    bin catch what is left; both stay within the JAX package's bars."""
    return splines.unconstrained_rational_quadratic_spline(
        x, uw_t.T, uh_t.T, ud_t.T, inverse=inverse, tail_codes=codes, tail_bound=bounds,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height,
        min_derivative=min_derivative)


def unconstrained_rqs_dyncodes_backward_reference(
        x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar, inverse,
        min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=splines.DEFAULT_MIN_DERIVATIVE):
    """Plain PyTorch version of the backward kernel: ``torch.autograd.grad``
    of :func:`unconstrained_rqs_dyncodes_reference` with cotangents
    ``(ybar, lbar)``.  Returns ``(dx, duw_t, duh_t, dud_t)``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, uw_t, uh_t, ud_t)]
        y, ld = unconstrained_rqs_dyncodes_reference(
            *leaves, codes, bounds, inverse, min_bin_width, min_bin_height,
            min_derivative)
        return torch.autograd.grad((y, ld), leaves, (ybar, lbar))
