"""Monotonic rational-quadratic splines, dense formulation (PyTorch).

Port of ``normflows_tpu/ops/splines.py``, the semantic source for every
spline path of this package: the CUDA kernel in ``ops/spline_cuda.py`` is held
against :func:`unconstrained_rational_quadratic_spline` through
``rqs_transposed_reference``.

The spline is evaluated densely on clamped (or, for circular dims, wrapped)
inputs and combined with the identity tails by ``torch.where``; no boolean
gather.  Bin lookup is a vectorised comparison-sum, not ``torch.searchsorted``,
because every element carries its own knots.

Parameter layout: every dim takes ``3*num_bins + 1`` raw parameters
``[widths (K) | heights (K) | derivatives (K+1)]``.  'linear' tails use the
K-1 interior derivatives with boundary slope 1; 'circular' tails use K with
the periodic closure ``d[K] = d[0]``; ``None`` (constrained) uses all K+1.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3

# Tail modes: small ints so per-dim tuples of modes stay hashable.
TAIL_NONE = 0
TAIL_LINEAR = 1
TAIL_CIRCULAR = 2

_TAIL_CODES = {None: TAIL_NONE, "linear": TAIL_LINEAR, "circular": TAIL_CIRCULAR}


def tail_code(tail) -> int:
    if isinstance(tail, (int, np.integer)):
        return int(tail)
    return _TAIL_CODES[tail]


def softplus(x):
    """``max(x, 0) + log1p(exp(-|x|))``: the form ``jax.nn.softplus`` takes.

    ``torch.nn.functional.softplus`` returns ``x`` itself above its threshold
    of 20, which differs from this form in the last bits; the CUDA kernel uses
    this form too.  ``torch.maximum`` splits the gradient of a tie evenly, as
    ``jnp.maximum`` does, so the gradient is ``sigmoid(x)`` at ``x = 0`` too
    (``clamp_min`` would pass all of it there: 1, not 0.5).  That tie is
    common: a degree-1 MADE output is its bias alone, and biases start at 0."""
    return torch.maximum(x, x.new_zeros(())) + torch.log1p(torch.exp(-x.abs()))


def searchsorted(bin_locations, inputs, eps: float = 1e-6):
    """Vectorised per-element bin lookup."""
    bin_locations = bin_locations.clone()
    bin_locations[..., -1] += eps
    return (inputs[..., None] >= bin_locations).sum(dim=-1) - 1


def _normalize_bins(unnormalized, num_bins, min_size, left, right):
    """Softmax bin sizes with a floor, cumulative positions in [left, right]."""
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_size + (1.0 - min_size * num_bins) * sizes
    cum = torch.cumsum(sizes, dim=-1)
    cum = torch.nn.functional.pad(cum, (1, 0))
    span = right - left
    cum = left[..., None] + span[..., None] * cum
    # pin the exact endpoints (float cumsum drift)
    cum[..., 0] = left
    cum[..., -1] = right
    sizes = cum[..., 1:] - cum[..., :-1]
    return sizes, cum


def rational_quadratic_spline(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    derivatives,
    inverse: bool = False,
    left=0.0,
    right=1.0,
    bottom=0.0,
    top=1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
):
    """Constrained RQ spline on [left, right] -> [bottom, top].

    ``derivatives`` are the positive knot slopes, shape (..., K+1).
    ``left/right/bottom/top`` broadcast against ``inputs``.  Returns
    ``(outputs, logabsdet)`` elementwise."""
    num_bins = unnormalized_widths.shape[-1]

    def full(v):
        return torch.as_tensor(v, dtype=inputs.dtype, device=inputs.device).expand(
            inputs.shape)

    left, right, bottom, top = full(left), full(right), full(bottom), full(top)

    widths, cumwidths = _normalize_bins(
        unnormalized_widths, num_bins, min_bin_width, left, right)
    heights, cumheights = _normalize_bins(
        unnormalized_heights, num_bins, min_bin_height, bottom, top)
    delta = heights / widths

    bin_locations = cumheights if inverse else cumwidths
    idx = searchsorted(bin_locations, inputs).clamp(0, num_bins - 1)[..., None]

    def take(arr, i=idx):
        return torch.gather(arr, -1, i)[..., 0]

    in_cumwidths = take(cumwidths)
    in_widths = take(widths)
    in_cumheights = take(cumheights)
    in_heights = take(heights)
    in_delta = take(delta)
    d_k = take(derivatives)
    d_k1 = take(derivatives, idx + 1)

    if inverse:
        y_rel = inputs - in_cumheights
        s = d_k + d_k1 - 2.0 * in_delta
        a = in_heights * (in_delta - d_k) + y_rel * s
        b = in_heights * d_k - y_rel * s
        c = -in_delta * y_rel
        # a tie at 0 (where jnp.maximum would split the gradient) needs
        # b^2 == 4ac exactly: a set of measure zero
        discriminant = torch.clamp_min(b * b - 4.0 * a * c, 0.0)
        denom_root = -b - torch.sqrt(discriminant)
        # 2c / (-b - sqrt(disc)): the stable root in [0, 1].  1e-38 is a
        # float32 subnormal; it guards the 0/0 case.
        theta = (2.0 * c) / torch.where(
            denom_root == 0.0, torch.full_like(denom_root, 1e-38), denom_root)
        # ties at 0 or 1 (jnp.clip splits them, clamp does not) need the
        # input exactly on a knot, a set of measure zero; where the input
        # was clamped to the bounds, the outputs are not used
        theta = theta.clamp(0.0, 1.0)
        outputs = theta * in_widths + in_cumwidths
        one_m_theta = 1.0 - theta
        theta_om = theta * one_m_theta
        denominator = in_delta + s * theta_om
        derivative_numerator = (in_delta * in_delta) * (
            d_k1 * theta * theta + 2.0 * in_delta * theta_om
            + d_k * one_m_theta * one_m_theta)
        logabsdet = -(torch.log(derivative_numerator) - 2.0 * torch.log(denominator))
        return outputs, logabsdet

    theta = ((inputs - in_cumwidths) / in_widths).clamp(0.0, 1.0)  # ties: as above
    one_m_theta = 1.0 - theta
    theta_om = theta * one_m_theta
    s = d_k + d_k1 - 2.0 * in_delta
    numerator = in_heights * (in_delta * theta * theta + d_k * theta_om)
    denominator = in_delta + s * theta_om
    outputs = in_cumheights + numerator / denominator
    derivative_numerator = (in_delta * in_delta) * (
        d_k1 * theta * theta + 2.0 * in_delta * theta_om
        + d_k * one_m_theta * one_m_theta)
    logabsdet = torch.log(derivative_numerator) - 2.0 * torch.log(denominator)
    return outputs, logabsdet


def constrained_rational_quadratic_spline(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    unnormalized_derivatives,
    inverse: bool = False,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
):
    """The constrained spline (``tails=None``) on [0, 1] from raw
    parameters: all K+1 slopes learned (:func:`make_knot_derivatives` with
    ``TAIL_NONE``), no tails.  The JAX package's splines with
    ``tails=None`` run this on the jnp path, never a kernel."""
    derivatives = make_knot_derivatives(unnormalized_derivatives, TAIL_NONE, min_derivative)
    return rational_quadratic_spline(inputs, unnormalized_widths, unnormalized_heights,
                                     derivatives, inverse=inverse,
                                     min_bin_width=min_bin_width,
                                     min_bin_height=min_bin_height)


def make_knot_derivatives(
    unnormalized_derivatives,
    tail_codes,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
):
    """Positive knot slopes (..., K+1) from raw slots per tail mode.

    ``tail_codes``: int tensor broadcastable to the inputs (per-dim mode).
    - TAIL_NONE: all K+1 slots via min_derivative + softplus.
    - TAIL_LINEAR: interior slots 1..K-1 used; boundary slopes fixed to 1.
    - TAIL_CIRCULAR: slots 0..K-1 used; d[K] = d[0] (periodic closure).
    """
    d_all = min_derivative + softplus(unnormalized_derivatives)

    d_lin = d_all.clone()
    d_lin[..., 0] = 1.0
    d_lin[..., -1] = 1.0

    d_circ = d_all.clone()
    d_circ[..., -1] = d_all[..., 0]

    tc = torch.as_tensor(tail_codes, device=d_all.device).expand(
        d_all.shape[:-1])[..., None]
    return torch.where(
        tc == TAIL_LINEAR, d_lin, torch.where(tc == TAIL_CIRCULAR, d_circ, d_all))


def unconstrained_rational_quadratic_spline(
    inputs,
    unnormalized_widths,
    unnormalized_heights,
    unnormalized_derivatives,
    inverse: bool = False,
    tail_codes=TAIL_LINEAR,
    tail_bound=1.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
):
    """RQ spline with tails on [-B, B], dense formulation.

    ``tail_codes``: scalar or per-dim int tensor (TAIL_LINEAR / TAIL_CIRCULAR
    / TAIL_NONE) broadcastable to ``inputs``; mixed per-dim tails supported.
    ``tail_bound``: scalar or per-dim tensor B.
    ``unnormalized_derivatives``: (..., K+1) uniform layout (see module doc).
    """
    tail_bound = torch.as_tensor(
        tail_bound, dtype=inputs.dtype, device=inputs.device).expand(inputs.shape)
    codes = torch.as_tensor(tail_codes, device=inputs.device).expand(inputs.shape)
    left = -tail_bound
    right = tail_bound

    derivatives = make_knot_derivatives(
        unnormalized_derivatives, codes, min_derivative)

    inside = (inputs >= left) & (inputs <= right)
    # circular dims wrap into the interval instead of taking the identity.
    # torch.remainder takes the divisor's sign, as jnp.mod does; torch.fmod
    # truncates and would leave x < -B outside the interval.
    span = right - left
    wrapped = left + torch.remainder(inputs - left, span)
    is_circ = codes == TAIL_CIRCULAR
    # clamp passes the whole gradient at x == +-B, as the JAX package's
    # hand-written backward does (``inside`` includes the bounds); its jnp
    # spline would split that tie, on a set of measure zero
    spline_in = torch.where(is_circ, wrapped, torch.clamp(inputs, left, right))

    outputs_s, logabsdet_s = rational_quadratic_spline(
        spline_in,
        unnormalized_widths,
        unnormalized_heights,
        derivatives,
        inverse=inverse,
        left=left,
        right=right,
        bottom=left,
        top=right,
        min_bin_width=min_bin_width,
        min_bin_height=min_bin_height,
    )

    use_spline = inside | is_circ
    outputs = torch.where(use_spline, outputs_s, inputs)
    logabsdet = torch.where(use_spline, logabsdet_s, torch.zeros_like(inputs))
    return outputs, logabsdet
