"""Neural-spline coupling layers (port of
``normflows_tpu/flows/neural_spline/coupling.py``).

Every transformed dim takes the uniform layout of 3K+1 parameters (widths |
heights | derivative logits), as in the JAX package.  Features are split and
joined with static index buffers made from the mask.  Both spline layers run
the flat spline,
:func:`~normflows_tpu_torch.ops.spline_flat.unconstrained_rational_quadratic_spline_flat`
(the CUDA kernel for a tensor on the card, its plain version for a CPU
tensor), with static per-dim tail tuples, as the JAX package's Pallas path
does:

* ``PiecewiseRationalQuadraticCoupling``: the transform net's (B, D*(3K+1))
  output viewed (B, D, 3K+1), the width and height logits scaled by
  1/sqrt(hidden features), the per-dim tails along ``event_axis = -1``; on
  images (N, C, H, W) the net (a ``ConvResidualNet``) gives (B, C*(3K+1),
  H, W), viewed (B, C, H, W, 3K+1) (the JAX package's ``_reshape_params``),
  and the per-channel tails lie along ``event_axis = 1``, broadcast over H
  and W;
* ``PiecewiseRationalQuadraticCDF``: its own (C, [H, W,] 3K+1) parameters
  broadcast over the batch, the per-dim tails along ``event_axis = 1``.

A context goes to the transform net (``ResidualNet`` concatenates it to its
input and gates its blocks with it); the CDF takes none.  The transform
net's dropout acts where the caller passes a ``torch.Generator`` as
``generator=`` (``utils.nn.net_dropout_active``), as the JAX package's key.

Constrained splines (``tails=None``: all K+1 slopes learned, the spline on
[0, 1] with no tails) run the plain
:func:`~normflows_tpu_torch.ops.splines.constrained_rational_quadratic_spline`
on every device, as the JAX package runs its jnp spline there and no Pallas
kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.flow import Flow, sum_except_batch
from ...ops import spline_flat, splines
from ...ops.backend import resolve_device
from ...utils.nn import net_dropout_active

def _split_indices(mask):
    mask = np.asarray(mask)
    identity = np.nonzero(mask <= 0)[0]
    transform = np.nonzero(mask > 0)[0]
    perm = np.concatenate([identity, transform])
    inv_perm = np.zeros_like(perm)
    inv_perm[perm] = np.arange(len(perm))
    return identity, transform, inv_perm


def _tail_codes_array(tails, indices):
    """Per-dim tail codes of the selected feature indices (None: constrained)."""
    if tails is None:
        return None
    if isinstance(tails, str):
        return np.full(len(indices), splines.tail_code(tails), np.int32)
    tails = list(tails)
    return np.asarray([splines.tail_code(tails[i]) for i in indices], np.int32)


def _apply_net(net, x, context, generator):
    """The transform net, with its dropout on where ``generator`` is given
    and a block has dropout."""
    if net_dropout_active(net, generator):
        return net(x, context, generator=generator)
    return net(x, context)


def _tail_bound_array(tail_bound, indices):
    if np.ndim(tail_bound) == 0:
        return np.full(len(indices), float(tail_bound), np.float32)
    return np.asarray(tail_bound, np.float32)[np.asarray(indices)]


class Coupling(Flow):
    """Mask-indexed coupling: ``forward`` transforms the features where the
    mask is > 0, conditioned on the others (the identity features), and
    runs the optional ``unconditional_transform`` on the identity ones."""

    def __init__(self, mask, transform_net: nn.Module,
                 unconditional_transform: Optional[Flow] = None, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        identity, transform, inv_perm = _split_indices(mask)
        self.transform_net = transform_net
        self.unconditional_transform = unconditional_transform
        self.register_buffer("identity_features", torch.as_tensor(identity, device=device))
        self.register_buffer("transform_features", torch.as_tensor(transform, device=device))
        self.register_buffer("inv_perm", torch.as_tensor(inv_perm, device=device))

    def _split(self, inputs):
        return inputs[:, self.identity_features], inputs[:, self.transform_features]

    def _join(self, id_split, tr_split):
        return torch.cat([id_split, tr_split], dim=1)[:, self.inv_perm]

    def _coupling_transform(self, inputs, params, inverse: bool):
        raise NotImplementedError

    def forward(self, inputs, context=None, *, generator: Optional[torch.Generator] = None):
        id_split, tr_split = self._split(inputs)
        params = _apply_net(self.transform_net, id_split, context, generator)
        tr_split, logabsdet = self._coupling_transform(tr_split, params, inverse=False)
        if self.unconditional_transform is not None:
            id_split, ld_id = self.unconditional_transform.forward(id_split, context)
            logabsdet = logabsdet + ld_id
        return self._join(id_split, tr_split), logabsdet

    def inverse(self, inputs, context=None, *, generator: Optional[torch.Generator] = None):
        id_split, tr_split = self._split(inputs)
        logabsdet = inputs.new_zeros(inputs.shape[0])
        if self.unconditional_transform is not None:
            id_split, logabsdet = self.unconditional_transform.inverse(id_split, context)
        params = _apply_net(self.transform_net, id_split, context, generator)
        tr_split, ld = self._coupling_transform(tr_split, params, inverse=True)
        return self._join(id_split, tr_split), logabsdet + ld


class PiecewiseRationalQuadraticCoupling(Coupling):
    """RQ-spline coupling with the uniform 3K+1 parameter layout and static
    per-dim tails of the transformed features (``tr_tail_codes`` None:
    constrained)."""

    def __init__(self, mask, transform_net, unconditional_transform, tr_tail_codes,
                 tr_tail_bound, num_bins: int = 8, net_hidden: int = 0,
                 min_bin_width: float = splines.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height: float = splines.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative: float = splines.DEFAULT_MIN_DERIVATIVE, *, device="cuda"):
        super().__init__(mask, transform_net, unconditional_transform, device=device)
        self.constrained = tr_tail_codes is None
        self.tr_tail_codes = None if self.constrained else tuple(int(c) for c in tr_tail_codes)
        self.tr_tail_bound = tuple(float(b) for b in tr_tail_bound)
        self.num_bins = num_bins
        self.net_hidden = int(net_hidden)
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.min_derivative = min_derivative

    @classmethod
    def create(cls, mask, transform_net_create_fn, num_bins: int = 8, tails=None,
               tail_bound=1.0, apply_unconditional_transform: bool = False, img_shape=None,
               min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
               min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
               min_derivative=splines.DEFAULT_MIN_DERIVATIVE, *, device="cuda"):
        """``transform_net_create_fn(in_features, out_features)`` makes the
        transform net; a ``hidden_features`` (or, for a convolutional net,
        ``hidden_channels``) attribute on it sets the 1/sqrt scaling of the
        width and height logits.  ``img_shape`` (H, W) gives an image
        model's CDF its per-pixel parameters."""
        mask = np.asarray(mask)
        identity, transform, _ = _split_indices(mask)
        net = transform_net_create_fn(len(identity), len(transform) * (3 * num_bins + 1))
        net_hidden = getattr(net, "hidden_features", 0) or getattr(net, "hidden_channels", 0)
        uncond = None
        if apply_unconditional_transform:
            uncond = PiecewiseRationalQuadraticCDF.create(
                shape=[len(identity), *(img_shape or ())], num_bins=num_bins,
                tails=_tail_codes_array(tails, identity),
                tail_bound=_tail_bound_array(tail_bound, identity),
                min_bin_width=min_bin_width, min_bin_height=min_bin_height,
                min_derivative=min_derivative, device=device)
        return cls(mask, net, uncond, _tail_codes_array(tails, transform),
                   _tail_bound_array(tail_bound, transform), num_bins, net_hidden,
                   min_bin_width, min_bin_height, min_derivative, device=device)

    def _coupling_transform(self, inputs, params, inverse: bool):
        if inputs.dim() == 4:  # (B, C*(3K+1), H, W) -> (B, C, H, W, 3K+1)
            b, c, h, w = inputs.shape
            params = params.reshape(b, c, -1, h, w).permute(0, 1, 3, 4, 2)
        else:
            params = params.reshape(*inputs.shape, -1)
        K = self.num_bins
        uw, uh, ud = params[..., :K], params[..., K:2 * K], params[..., 2 * K:]
        if self.net_hidden:
            scale = 1.0 / np.sqrt(self.net_hidden)
            uw = uw * scale
            uh = uh * scale
        if self.constrained:
            outputs, logabsdet = splines.constrained_rational_quadratic_spline(
                inputs, uw, uh, ud, inverse, self.min_bin_width, self.min_bin_height,
                self.min_derivative)
            return outputs, sum_except_batch(logabsdet)
        outputs, logabsdet = spline_flat.unconstrained_rational_quadratic_spline_flat(
            inputs, uw, uh, ud, self.tr_tail_codes, self.tr_tail_bound, inverse,
            self.min_bin_width, self.min_bin_height, self.min_derivative,
            event_axis=1 if inputs.dim() == 4 else -1)
        return outputs, sum_except_batch(logabsdet)


class PiecewiseRationalQuadraticCDF(Flow):
    """Elementwise learned RQ spline: parameters of shape (*shape, K) /
    (*shape, K) / (*shape, K+1), shared by the batch, the tails one per index
    of ``shape``'s first axis (a channel of an image); ``tails=None`` is the
    constrained spline on [0, 1]."""

    def __init__(self, shape, num_bins: int = 10, tails=None, tail_bound=1.0,
                 identity_init: bool = True, generator: Optional[torch.Generator] = None,
                 min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=splines.DEFAULT_MIN_DERIVATIVE, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        shape = (shape,) if isinstance(shape, int) else tuple(int(s) for s in shape)
        if tails is None:
            codes = None
        elif isinstance(tails, str):
            codes = np.full(shape[0], splines.tail_code(tails), np.int32)
        else:
            codes = np.asarray([splines.tail_code(t) for t in np.asarray(tails)], np.int32)
        bound = (np.full(shape[0], float(tail_bound), np.float32)
                 if np.ndim(tail_bound) == 0 else np.asarray(tail_bound, np.float32))
        if identity_init:
            uw = torch.zeros(*shape, num_bins)
            uh = torch.zeros(*shape, num_bins)
            constant = float(np.log(np.exp(1 - min_derivative) - 1))
            ud = torch.full((*shape, num_bins + 1), constant)
        else:  # U(0, 1), drawn on the CPU from the generator
            uw = torch.rand(*shape, num_bins, generator=generator)
            uh = torch.rand(*shape, num_bins, generator=generator)
            ud = torch.rand(*shape, num_bins + 1, generator=generator)
        self.unnormalized_widths = nn.Parameter(uw.to(device))
        self.unnormalized_heights = nn.Parameter(uh.to(device))
        self.unnormalized_derivatives = nn.Parameter(ud.to(device))
        self.constrained = codes is None
        self.tail_codes = None if codes is None else tuple(int(c) for c in codes)
        self.tail_bound = tuple(float(b) for b in bound)
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.min_derivative = min_derivative

    @classmethod
    def create(cls, shape, num_bins: int = 10, tails=None, tail_bound=1.0,
               identity_init: bool = True, generator: Optional[torch.Generator] = None,
               min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
               min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
               min_derivative=splines.DEFAULT_MIN_DERIVATIVE, *, device="cuda"):
        """``generator`` takes the place of the JAX ``key`` of a random init."""
        return cls(shape, num_bins, tails, tail_bound, identity_init, generator,
                   min_bin_width, min_bin_height, min_derivative, device=device)

    def _spline(self, inputs, inverse: bool):
        b = inputs.shape[0]
        uw, uh, ud = (p.expand(b, *p.shape) for p in (
            self.unnormalized_widths, self.unnormalized_heights,
            self.unnormalized_derivatives))
        if self.constrained:
            outputs, logabsdet = splines.constrained_rational_quadratic_spline(
                inputs, uw, uh, ud, inverse, self.min_bin_width, self.min_bin_height,
                self.min_derivative)
            return outputs, sum_except_batch(logabsdet)
        outputs, logabsdet = spline_flat.unconstrained_rational_quadratic_spline_flat(
            inputs, uw, uh, ud, self.tail_codes, self.tail_bound, inverse,
            self.min_bin_width, self.min_bin_height, self.min_derivative, event_axis=1)
        return outputs, sum_except_batch(logabsdet)

    def forward(self, inputs, context=None, *, generator: Optional[torch.Generator] = None):
        return self._spline(inputs, inverse=False)

    def inverse(self, inputs, context=None, *, generator: Optional[torch.Generator] = None):
        return self._spline(inputs, inverse=True)
