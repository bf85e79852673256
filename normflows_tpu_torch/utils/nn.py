"""NN helper layers (port of ``normflows_tpu/utils/nn.py``):
``PeriodicFeaturesElementwise``, which the circular spline's MADE uses as its
preprocessing, ``PeriodicFeaturesCat``, ``ClampExp``, an output function of
``MLP``, ``ConstScaleLayer``, ``ActNorm`` as a net layer, the ``tile`` and
``sum_except_batch`` helpers and ``net_dropout_active``."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.flow import sum_except_batch
from ..ops.backend import resolve_device

__all__ = ["ActNorm", "ClampExp", "ConstScaleLayer", "PeriodicFeaturesCat",
           "PeriodicFeaturesElementwise", "net_dropout_active", "sum_except_batch", "tile"]


def net_dropout_active(net, generator) -> bool:
    """True when a block of the parameter net has dropout and the caller
    passed a generator: dropout acts exactly where randomness is supplied
    (the JAX package's key; the reference's ``model.train()``)."""
    return generator is not None and any(
        getattr(b, "dropout_probability", 0.0) > 0.0 for b in getattr(net, "blocks", ()))


def tile(x, n: int):
    """Element-wise repeat: [x1, x2, ...] -> [x1] * n + [x2] * n + ..."""
    return torch.repeat_interleave(torch.reshape(x, (-1,)), n)


class ConstScaleLayer(nn.Module):
    """Multiply by a fixed constant."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return x * self.scale


class ClampExp(nn.Module):
    """min(exp(lam x), 1) (JAX ``utils/nn.py:64-70``)."""

    def __init__(self, lam: float = 1.0):
        super().__init__()
        self.lam = lam

    def forward(self, x):
        return torch.clamp(torch.exp(self.lam * x), max=1.0)


class ActNorm(nn.Module):
    """The ActNorm flow as a net layer: its ``forward`` transform, without
    the log-det (JAX ``utils/nn.py:33-47``)."""

    def __init__(self, shape, *, device="cuda"):
        super().__init__()
        from ..flows.normalization import ActNorm as ActNormFlow

        self.actnorm = ActNormFlow(shape, device=device)

    @classmethod
    def create(cls, shape, *, device="cuda"):
        return cls(shape, device=device)

    def forward(self, x):
        return self.actnorm.forward(x)[0]


class PeriodicFeaturesElementwise(nn.Module):
    """Map periodic coordinates to w1*sin(s*f) + w2*cos(s*f) in place.

    ``ind`` selects the periodic dims; they are replaced elementwise by the
    learned sin/cos mix, the rest pass through, and ``inv_perm`` restores the
    input order."""

    def __init__(self, ndim: int, ind, scale=1.0, bias: bool = False,
                 activation=None, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        ind = np.asarray(ind, np.int64).reshape(-1)
        rest = np.asarray([i for i in range(ndim) if i not in set(ind.tolist())],
                          np.int64)
        perm = np.concatenate([ind, rest])
        inv_perm = np.zeros(ndim, np.int64)
        inv_perm[perm] = np.arange(ndim)
        n_p = ind.shape[0]
        scale = np.broadcast_to(np.asarray(scale, np.float32), (n_p,)).copy()
        self.register_buffer("ind", torch.as_tensor(ind, device=device))
        self.register_buffer("rest_ind", torch.as_tensor(rest, device=device))
        self.register_buffer("inv_perm", torch.as_tensor(inv_perm, device=device))
        self.weights = nn.Parameter(torch.ones(n_p, 2, device=device))
        self.register_buffer("scale", torch.as_tensor(scale, device=device))
        self.bias = nn.Parameter(torch.zeros(n_p, device=device)) if bias else None
        self.activation = activation

    def forward(self, x):
        f = x[..., self.ind] * self.scale
        feat = self.weights[:, 0] * torch.sin(f) + self.weights[:, 1] * torch.cos(f)
        if self.bias is not None:
            feat = feat + self.bias
        if self.activation == "tanh":
            feat = torch.tanh(feat)
        out = torch.cat([feat, x[..., self.rest_ind]], dim=-1)
        return out[..., self.inv_perm]

    def apply_t(self, x_t):
        """Transposed layout: features on axis 0, batch on axis -1."""
        f = x_t[self.ind, :] * self.scale[:, None]
        feat = self.weights[:, :1] * torch.sin(f) + self.weights[:, 1:2] * torch.cos(f)
        if self.bias is not None:
            feat = feat + self.bias[:, None]
        if self.activation == "tanh":
            feat = torch.tanh(feat)
        out = torch.cat([feat, x_t[self.rest_ind, :]], dim=0)
        return out[self.inv_perm, :]


class PeriodicFeaturesCat(nn.Module):
    """sin and cos of the periodic dims ``ind`` (times ``scale``), then the
    other dims, concatenated on the last axis."""

    def __init__(self, ndim: int, ind, scale=1.0, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        ind = np.asarray(ind, np.int64).reshape(-1)
        rest = np.asarray([i for i in range(ndim) if i not in set(ind.tolist())], np.int64)
        scale = np.broadcast_to(np.asarray(scale, np.float32), (ind.shape[0],)).copy()
        self.register_buffer("ind", torch.as_tensor(ind, device=device))
        self.register_buffer("rest_ind", torch.as_tensor(rest, device=device))
        self.register_buffer("scale", torch.as_tensor(scale, device=device))

    def forward(self, x):
        f = x[..., self.ind] * self.scale
        return torch.cat([torch.sin(f), torch.cos(f), x[..., self.rest_ind]], dim=-1)
