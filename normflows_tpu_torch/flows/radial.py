"""Radial flow (port of ``normflows_tpu/flows/radial.py``): f(z) = z +
beta h(alpha, r) (z - z_0), r = |z - z_0|, h = 1 / (|alpha| + r), with beta
reparametrised to softplus(beta) - |alpha| so that f is invertible; forward
only.  The initial values are drawn from a ``torch.Generator`` on the CPU
(the JAX package's key), then placed on ``device``."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..core.flow import Flow
from ..ops.backend import resolve_device


class Radial(Flow):
    def __init__(self, shape, z_0=None, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if isinstance(shape, int):
            shape = (shape,)
        device = resolve_device(device)
        lim = 1.0 / math.prod(shape)
        beta = torch.empty(1).uniform_(-lim - 1.0, lim - 1.0, generator=generator)
        alpha = torch.empty(1).uniform_(-lim, lim, generator=generator)
        z_0 = torch.randn(1, *shape, generator=generator) if z_0 is None \
            else torch.as_tensor(z_0).float()
        self.beta = nn.Parameter(beta.to(device))
        self.alpha = nn.Parameter(alpha.to(device))
        self.z_0 = nn.Parameter(z_0.to(device))

    @classmethod
    def create(cls, shape, z_0=None, *, generator=None, device="cuda"):
        return cls(shape, z_0, generator=generator, device=device)

    def forward(self, z, context=None, *, generator=None):
        d = float(math.prod(self.z_0.shape[1:]))
        beta = F.softplus(self.beta) - torch.abs(self.alpha)
        dz = z - self.z_0
        r = torch.sqrt(torch.sum(dz**2, dim=tuple(range(1, self.z_0.dim())), keepdim=True))
        h = beta / (torch.abs(self.alpha) + r)
        h_prime = -beta * r / (torch.abs(self.alpha) + r) ** 2
        log_det = (d - 1.0) * torch.log(1.0 + h) + torch.log(1.0 + h + h_prime)
        return z + h * dz, log_det.reshape(-1)
