"""The flat spline backward's ablation: the CUDA kernel of its four variants,
their launch counts and their plain PyTorch versions.

``csrc/rqs_flat_ablate.cu`` holds the counterpart of the TPU kernel
``variant_kernel`` (``examples/spline_bwd_ablate.py:51``), which
``run_variant`` (:101) launches: four variants of the flat backward that
split its cost into the bin search (``sel_only``), the pull-back of the
rational-quadratic map (``sel_post``), the gradient scatter (``full``, the
shipped backward) and a pull-back of the whole block that keeps every bin's
residuals (``vjp_all``).  It is built with ``nvcc`` for ``sm_90a`` at first
use and loaded with ``ctypes`` (``ops/cuda_build.py``).

:func:`run_variant` takes the flat layout of ``ops/spline_flat.py``: x,
codes, bounds, ybar, lbar (N,), uw_t / uh_t (K, N), ud_t (K+1, N).  A CPU
tensor takes the variant's plain version, a CUDA tensor launches the kernel
or raises (``ops/backend.py``):

* :func:`sel_only_reference` and :func:`sel_post_reference` repeat
  ``_selection(collect=True)`` and ``_post_math``
  (``normflows_tpu/ops/spline_pallas.py:89``, :50) step by step, the
  pull-back by ``torch.autograd`` with JAX's tie rules (``torch.maximum`` /
  ``torch.minimum`` split a tie evenly, as ``jnp.maximum`` and ``jnp.clip``
  do).  ``sel_post`` pulls back the map of the search's direction, where
  the TPU kernel pulls back the inverse map in either direction; its
  script runs the inverse direction only, where the two agree;
* ``full`` and ``vjp_all`` compute one function, the gradients of the
  spline, and share one plain version:
  ``spline_flat.unconstrained_rqs_dyncodes_backward_reference``, which is
  ``torch.autograd`` through the whole plain forward block.
"""

from __future__ import annotations

import ctypes

import torch

from . import backend, cuda_build, spline_flat, splines

SOURCE = cuda_build.CSRC / "rqs_flat_ablate.cu"
VARIANTS = ("sel_only", "sel_post", "full", "vjp_all")
# kMaxBins of the source: the size of vjp_all's per-thread residual arrays
MAX_BINS = 16

# Kernel launches of each variant since the count was last set to 0.
LAUNCHES = dict.fromkeys(VARIANTS, 0)

_SIGNATURES = {"rqs_flat_ablate": [ctypes.c_int] + [ctypes.c_void_p] * 10 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
    ctypes.c_double, ctypes.c_double, ctypes.c_void_p]}


def _library():
    return cuda_build.library(SOURCE, _SIGNATURES)


def run_variant(mode, x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar, *, inverse):
    """Variant ``mode`` of the flat backward: ``(xg (N,), uwg (K, N),
    uhg (K, N), udg (K+1, N))``.  For ``sel_only`` and ``sel_post`` the
    three planes are the parameters copied through; for ``full`` and
    ``vjp_all`` they are the gradients, and ``xg`` is dx.  On the card the
    planes are rows of one (3K+1, N) tensor.  The minimum bin width, height
    and derivative are the package's defaults, as in the TPU kernel."""
    if mode not in VARIANTS:
        raise ValueError(f"run_variant: mode must be one of {VARIANTS}, not {mode!r}")
    spline_flat._check(x, uw_t, uh_t, ud_t, codes, bounds)
    for name, t in (("ybar", ybar), ("lbar", lbar)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"run_variant: {name} must be a contiguous float32 tensor "
                             f"like x {tuple(x.shape)} on {x.device}")
    if not backend.use_kernel(x):
        return REFERENCES[mode](x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar,
                                bool(inverse))
    K, N = uw_t.shape
    if mode == "vjp_all" and K > MAX_BINS:
        raise ValueError(f"run_variant: vjp_all takes at most {MAX_BINS} bins, not {K}")
    xg = torch.empty_like(x)
    dp = torch.empty(3 * K + 1, N, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().rqs_flat_ablate(
            VARIANTS.index(mode), *(t.data_ptr() for t in (
                x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar, xg, dp)),
            N, K, ud_t.stride(0), int(bool(inverse)), splines.DEFAULT_MIN_BIN_WIDTH,
            splines.DEFAULT_MIN_BIN_HEIGHT, splines.DEFAULT_MIN_DERIVATIVE, stream)
    if rc != 0:
        raise RuntimeError(f"rqs_flat_ablate ({mode}) kernel launch failed: CUDA error {rc}")
    LAUNCHES[mode] += 1
    return xg, dp[:K], dp[K:2 * K], dp[2 * K:]


def selection(x, uw_t, uh_t, ud_t, codes, bounds, inverse):
    """``_selection(collect=True)`` of the JAX package on the flat layout:
    ``(xs, sel, hits, stats)`` with ``sel`` the selected (cw, w, ch, h, dk,
    dk1), ``hits`` the K hit masks and ``stats`` (wmax, wsum, hmax, hsum).
    The K-step accumulate-and-select search lets the last bin catch every
    element the others leave."""
    K = uw_t.shape[0]
    min_bin_width = splines.DEFAULT_MIN_BIN_WIDTH
    min_bin_height = splines.DEFAULT_MIN_BIN_HEIGHT
    min_derivative = splines.DEFAULT_MIN_DERIVATIVE
    left = -bounds
    span = 2.0 * bounds
    is_circ = codes == splines.TAIL_CIRCULAR
    is_lin = codes == splines.TAIL_LINEAR
    wrapped = left + torch.remainder(x - left, span)
    xs = torch.where(is_circ, wrapped, torch.clamp(x, left, -left))

    wmax, hmax = uw_t[0], uh_t[0]
    for k in range(1, K):
        wmax = torch.maximum(wmax, uw_t[k])
        hmax = torch.maximum(hmax, uh_t[k])
    wsum = torch.zeros_like(x)
    hsum = torch.zeros_like(x)
    for k in range(K):
        wsum = wsum + torch.exp(uw_t[k] - wmax)
        hsum = hsum + torch.exp(uh_t[k] - hmax)
    fw = 1.0 - min_bin_width * K
    fh = 1.0 - min_bin_height * K

    d0_raw = min_derivative + splines.softplus(ud_t[0])
    one = torch.ones_like(x)

    def deriv(k):
        raw = min_derivative + splines.softplus(ud_t[k])
        if k == 0:
            return torch.where(is_lin, one, raw)
        if k == K:
            return torch.where(is_lin, one, torch.where(is_circ, d0_raw, raw))
        return raw

    cw, ch = left, left
    found = torch.zeros_like(x, dtype=torch.bool)
    sel = [torch.zeros_like(x), one, torch.zeros_like(x), one, one, one]
    hits = []
    for k in range(K):
        w_k = (min_bin_width + fw * (torch.exp(uw_t[k] - wmax) / wsum)) * span
        h_k = (min_bin_height + fh * (torch.exp(uh_t[k] - hmax) / hsum)) * span
        cw_next, ch_next = cw + w_k, ch + h_k
        cond = torch.ones_like(found) if k == K - 1 else xs < (ch_next if inverse else cw_next)
        hit = ~found & cond
        sel = [torch.where(hit, v, s) for v, s in
               zip((cw, w_k, ch, h_k, deriv(k), deriv(k + 1)), sel)]
        found = found | hit
        hits.append(hit)
        cw, ch = cw_next, ch_next
    return xs, tuple(sel), hits, (wmax, wsum, hmax, hsum)


def post_math(xs, cw, w, ch, h, dk, dk1, inverse):
    """``_post_math`` of the JAX package: the rational-quadratic map of the
    selected bin and its log|det|, with JAX's tie rules under autograd."""
    zero, one = xs.new_zeros(()), xs.new_ones(())
    delta = h / w
    s = dk + dk1 - 2.0 * delta
    if inverse:
        y_rel = xs - ch
        a = h * (delta - dk) + y_rel * s
        b = h * dk - y_rel * s
        c = -delta * y_rel
        disc = torch.maximum(b * b - 4.0 * a * c, zero)
        denom_root = -b - torch.sqrt(disc)
        theta = (2.0 * c) / torch.where(denom_root == 0.0,
                                        torch.full_like(denom_root, 1e-38), denom_root)
        theta = torch.minimum(torch.maximum(theta, zero), one)
        out = theta * w + cw
    else:
        theta = torch.minimum(torch.maximum((xs - cw) / w, zero), one)
    om = 1.0 - theta
    tom = theta * om
    denom = delta + s * tom
    dnum = (delta * delta) * (dk1 * theta * theta + 2.0 * delta * tom + dk * om * om)
    if inverse:
        return out, -(torch.log(dnum) - 2.0 * torch.log(denom))
    num = h * (delta * theta * theta + dk * tom)
    return ch + num / denom, torch.log(dnum) - 2.0 * torch.log(denom)


def _copies(uw_t, uh_t, ud_t):
    return uw_t.clone(), uh_t.clone(), ud_t.clone()


def sel_only_reference(x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar, inverse):
    """Plain version of ``sel_only``: xs + sum(sel) + sum(stats) + sum(hits),
    summed in the JAX kernel's order; the parameters copied through."""
    xs, sel, hits, stats = selection(x, uw_t, uh_t, ud_t, codes, bounds, inverse)
    acc = xs + sum(sel) + sum(stats)
    for hit in hits:
        acc = acc + hit.to(x.dtype)
    return (acc, *_copies(uw_t, uh_t, ud_t))


def sel_post_reference(x, uw_t, uh_t, ud_t, codes, bounds, ybar, lbar, inverse):
    """Plain version of ``sel_post``: the sum of the 7 cotangents of
    :func:`post_math` at (ybar, lbar), unmasked, plus sum(hits); the
    parameters copied through."""
    xs, sel, hits, _ = selection(x, uw_t, uh_t, ud_t, codes, bounds, inverse)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (xs, *sel)]
        grads = torch.autograd.grad(post_math(*leaves, inverse), leaves, (ybar, lbar))
    acc = sum(grads)
    for hit in hits:
        acc = acc + hit.to(x.dtype)
    return (acc, *_copies(uw_t, uh_t, ud_t))


REFERENCES = {
    "sel_only": sel_only_reference,
    "sel_post": sel_post_reference,
    "full": spline_flat.unconstrained_rqs_dyncodes_backward_reference,
    "vjp_all": spline_flat.unconstrained_rqs_dyncodes_backward_reference,
}
