"""Affine coupling flows (port of
``normflows_tpu/flows/affine/coupling.py:15-239``): ``AffineConstFlow``,
``CCAffineConst``, ``AffineCoupling``, ``MaskedAffineFlow`` (the layer of
Real NVP) and ``AffineCouplingBlock``.  The attribute names are the JAX
package's (``s``, ``t``, ``b``, ``t_net``, ``s_net``, ``param_map``,
``split``, ``coupling``, ``merge``), so that ``interop.load_jax_leaves``
copies its weights across.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.flow import Flow, sum_except_batch, zero_log_det_like_z
from ...ops.backend import resolve_device
from ..reshape import Merge, Split


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


class AffineConstFlow(Flow):
    """Learned per-dim scale and shift: z' = z exp(s) + t.  ``s`` / ``t``
    (1, *shape) broadcast against the event, and the log-det counts each
    broadcast (spatial) position."""

    def __init__(self, shape, scale: bool = True, shift: bool = True, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        zeros = lambda: nn.Parameter(torch.zeros(1, *_shape(shape), device=device))  # noqa: E731
        self.s = zeros() if scale else None
        self.t = zeros() if shift else None

    @classmethod
    def create(cls, shape, scale: bool = True, shift: bool = True, *, device="cuda"):
        return cls(shape, scale, shift, device=device)

    def _s(self, z):
        return z.new_zeros((1,) * z.dim()) if self.s is None else self.s

    def _t(self, z):
        return z.new_zeros((1,) * z.dim()) if self.t is None else self.t

    def _n_broadcast(self, z):
        n = 1
        for zi, si in zip(z.shape[1:], self._s(z).shape[1:]):
            if si == 1:
                n *= zi
        return float(n)

    def forward(self, z, context=None, *, generator=None):
        s, t = self._s(z), self._t(z)
        log_det = self._n_broadcast(z) * torch.sum(s) * z.new_ones(z.shape[0])
        return z * torch.exp(s) + t, log_det

    def inverse(self, z, context=None, *, generator=None):
        s, t = self._s(z), self._t(z)
        log_det = -self._n_broadcast(z) * torch.sum(s) * z.new_ones(z.shape[0])
        return (z - t) * torch.exp(-s), log_det


class CCAffineConst(Flow):
    """Class-conditional affine const flow: per-class offsets of scale and
    shift through ``y`` (one-hot, (B, num_classes)) times ``s_cc`` /
    ``t_cc``."""

    def __init__(self, shape, num_classes: int, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.shape = _shape(shape)
        d = int(np.prod(self.shape))
        self.s = nn.Parameter(torch.zeros(1, *self.shape, device=device))
        self.t = nn.Parameter(torch.zeros(1, *self.shape, device=device))
        self.s_cc = nn.Parameter(torch.zeros(num_classes, d, device=device))
        self.t_cc = nn.Parameter(torch.zeros(num_classes, d, device=device))

    @classmethod
    def create(cls, shape, num_classes: int, *, device="cuda"):
        return cls(shape, num_classes, device=device)

    def _st(self, y):
        s = self.s + (y @ self.s_cc).reshape(y.shape[0], *self.shape)
        t = self.t + (y @ self.t_cc).reshape(y.shape[0], *self.shape)
        return s, t

    def forward(self, z, y, *, generator=None):
        s, t = self._st(y)
        return z * torch.exp(s) + t, sum_except_batch(s)

    def inverse(self, z, y, *, generator=None):
        s, t = self._st(y)
        return (z - t) * torch.exp(-s), -sum_except_batch(s)


def _affine_from_params(param, scale: bool, scale_map: str):
    """The param net's output as ``(shift, log_scale, kind)``: shift =
    param[:, 0::2], the scale's logits param[:, 1::2] (axis 1 interleaved);
    ``"exp"`` takes them as the log-scale, ``"sigmoid"`` and
    ``"sigmoid_inv"`` log(sigmoid(logits + 2)).  Without ``scale``: the
    shift alone."""
    if not scale:
        return param, None, "none"
    shift, scale_ = param[:, 0::2, ...], param[:, 1::2, ...]
    if scale_map == "exp":
        return shift, scale_, "exp"
    if scale_map in ("sigmoid", "sigmoid_inv"):
        return shift, torch.log(torch.sigmoid(scale_ + 2.0)), scale_map
    raise NotImplementedError(f"scale map {scale_map}")


class AffineCoupling(Flow):
    """Real NVP coupling on a split pair [z1, z2]: forward z2' = z2 exp(s(z1))
    + t(z1) (``scale_map="exp"``); Glow's ``"sigmoid"`` divides by
    sigmoid(s + 2).  The context is taken and not used, as in the JAX
    package."""

    def __init__(self, param_map: nn.Module, scale: bool = True, scale_map: str = "exp"):
        super().__init__()
        self.param_map = param_map
        self.scale = scale
        self.scale_map = scale_map

    def _params(self, z1):
        return _affine_from_params(self.param_map(z1), self.scale, self.scale_map)

    def forward(self, zpair, context=None, *, generator=None):
        z1, z2 = zpair
        shift, log_scale, kind = self._params(z1)
        if log_scale is None:
            return [z1, z2 + shift], zero_log_det_like_z(z1)
        if kind == "sigmoid":
            return [z1, z2 * torch.exp(-log_scale) + shift], -sum_except_batch(log_scale)
        return [z1, z2 * torch.exp(log_scale) + shift], sum_except_batch(log_scale)

    def inverse(self, zpair, context=None, *, generator=None):
        z1, z2 = zpair
        shift, log_scale, kind = self._params(z1)
        if log_scale is None:
            return [z1, z2 - shift], zero_log_det_like_z(z1)
        if kind == "sigmoid":
            return [z1, (z2 - shift) * torch.exp(log_scale)], sum_except_batch(log_scale)
        return [z1, (z2 - shift) * torch.exp(-log_scale)], -sum_except_batch(log_scale)


class MaskedAffineFlow(Flow):
    """Real NVP's masked layer: f(z) = b z + (1 - b)(z exp(s(b z)) + t(b z)).
    A net's non-finite outputs count as 0 (the JAX package's guard,
    coupling.py:189-197); a missing net gives zeros."""

    def __init__(self, b, t: Optional[nn.Module] = None, s: Optional[nn.Module] = None, *,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("b", torch.as_tensor(np.asarray(b, np.float32), device=device))
        self.t_net = t
        self.s_net = s

    @classmethod
    def create(cls, b, t=None, s=None, *, device="cuda"):
        return cls(b, t, s, device=device)

    def _st(self, z_masked):
        def call(net):
            if net is None:
                return torch.zeros_like(z_masked)
            out = net(z_masked)
            return torch.where(torch.isfinite(out), out, torch.zeros_like(out))

        return call(self.s_net), call(self.t_net)

    def forward(self, z, context=None, *, generator=None):
        z_masked = self.b * z
        scale, trans = self._st(z_masked)
        z_ = z_masked + (1 - self.b) * (z * torch.exp(scale) + trans)
        return z_, sum_except_batch((1 - self.b) * scale)

    def inverse(self, z, context=None, *, generator=None):
        z_masked = self.b * z
        scale, trans = self._st(z_masked)
        z_ = z_masked + (1 - self.b) * (z - trans) * torch.exp(-scale)
        return z_, -sum_except_batch((1 - self.b) * scale)


class AffineCouplingBlock(Flow):
    """``Split`` -> ``AffineCoupling`` -> ``Merge``."""

    def __init__(self, param_map: nn.Module, scale: bool = True, scale_map: str = "exp",
                 split_mode: str = "channel"):
        super().__init__()
        self.split = Split(split_mode)
        self.coupling = AffineCoupling(param_map, scale, scale_map)
        self.merge = Merge(split_mode)

    @classmethod
    def create(cls, param_map, scale=True, scale_map="exp", split_mode="channel"):
        return cls(param_map, scale, scale_map, split_mode)

    def forward(self, z, context=None, *, generator=None):
        zpair, ld0 = self.split.forward(z)
        zpair, ld1 = self.coupling.forward(zpair, context)
        z, ld2 = self.merge.forward(zpair)
        return z, ld0 + ld1 + ld2

    def inverse(self, z, context=None, *, generator=None):
        zpair, ld0 = self.merge.inverse(z)
        zpair, ld1 = self.coupling.inverse(zpair, context)
        z, ld2 = self.split.inverse(zpair)
        return z, ld0 + ld1 + ld2
