"""Periodic coordinate flows (port of ``normflows_tpu/flows/periodic.py``):
``PeriodicWrap`` wraps the coordinates ``ind`` into [-bound, bound] in the
density direction; ``PeriodicShift`` shifts them by ``shift`` and wraps.
Both have log-det 0."""

from __future__ import annotations

import torch

from ..core.flow import Flow, zero_log_det_like_z
from ..ops.backend import resolve_device


def _wrap(z, ind, shift, bound):
    vals = torch.remainder(z[..., ind] + shift + bound, 2.0 * bound) - bound
    out = z.clone()
    out[..., ind] = vals
    return out


class PeriodicWrap(Flow):
    def __init__(self, ind, bound=1.0, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("ind", torch.as_tensor(ind, device=device))
        self.register_buffer("bound", torch.as_tensor(bound, dtype=torch.float32, device=device))

    @classmethod
    def create(cls, ind, bound=1.0, *, device="cuda"):
        return cls(ind, bound, device=device)

    def forward(self, z, context=None, *, generator=None):
        return z, zero_log_det_like_z(z)

    def inverse(self, z, context=None, *, generator=None):
        return _wrap(z, self.ind, 0.0, self.bound), zero_log_det_like_z(z)


class PeriodicShift(Flow):
    def __init__(self, ind, bound=1.0, shift=0.0, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("ind", torch.as_tensor(ind, device=device))
        self.register_buffer("bound", torch.as_tensor(bound, dtype=torch.float32, device=device))
        self.register_buffer("shift", torch.as_tensor(shift, dtype=torch.float32, device=device))

    @classmethod
    def create(cls, ind, bound=1.0, shift=0.0, *, device="cuda"):
        return cls(ind, bound, shift, device=device)

    def forward(self, z, context=None, *, generator=None):
        return _wrap(z, self.ind, self.shift, self.bound), zero_log_det_like_z(z)

    def inverse(self, z, context=None, *, generator=None):
        return _wrap(z, self.ind, -self.shift, self.bound), zero_log_det_like_z(z)
