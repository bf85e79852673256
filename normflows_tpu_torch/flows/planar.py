"""Planar flow (port of ``normflows_tpu/flows/planar.py``).

f(z) = z + u h(w . z + b), with u constrained so that w . u > -1 and the map
stays invertible; h is tanh or a leaky ReLU of slope 0.2.  Only the leaky
ReLU has an algebraic inverse.  The initial u and w are drawn from a
``torch.Generator`` on the CPU (the JAX package's key), then placed on
``device``."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..core.flow import Flow
from ..ops.backend import resolve_device


def _uniform(shape, lim, generator):
    return torch.empty(shape).uniform_(-lim, lim, generator=generator)


class Planar(Flow):
    def __init__(self, shape, act: str = "tanh", u=None, w=None, b=None, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        if isinstance(shape, int):
            shape = (shape,)
        if act not in ("tanh", "leaky_relu"):
            raise NotImplementedError("Nonlinearity is not implemented.")
        device = resolve_device(device)
        lim_w, lim_u = math.sqrt(2.0 / math.prod(shape)), math.sqrt(2.0)
        u = _uniform((1, *shape), lim_u, generator) if u is None else torch.as_tensor(u)
        w = _uniform((1, *shape), lim_w, generator) if w is None else torch.as_tensor(w)
        b = torch.zeros(1) if b is None else torch.as_tensor(b)
        self.u = nn.Parameter(u.float().to(device))
        self.w = nn.Parameter(w.float().to(device))
        self.b = nn.Parameter(b.float().to(device))
        self.act = act

    @classmethod
    def create(cls, shape, act="tanh", u=None, w=None, b=None, *, generator=None,
               device="cuda"):
        return cls(shape, act, u, w, b, generator=generator, device=device)

    def _constrained_u(self):
        inner = torch.sum(self.w * self.u)
        return self.u + (F.softplus(inner) - 1.0 - inner) * self.w / torch.sum(self.w**2)

    def forward(self, z, context=None, *, generator=None):
        dims = tuple(range(1, self.w.dim()))
        lin = torch.sum(self.w * z, dim=dims, keepdim=True) + self.b
        u = self._constrained_u()
        if self.act == "tanh":
            h = torch.tanh(lin)
            h_prime = 1.0 / torch.cosh(lin.reshape(-1)) ** 2
        else:
            h = F.leaky_relu(lin, 0.2)
            h_prime = torch.where(lin.reshape(-1) < 0, 0.2, 1.0)
        log_det = torch.log(torch.abs(1.0 + torch.sum(self.w * u) * h_prime))
        return z + u * h, log_det

    def inverse(self, z, context=None, *, generator=None):
        if self.act != "leaky_relu":
            raise NotImplementedError("This flow has no algebraic inverse.")
        dims = tuple(range(1, self.w.dim()))
        lin = torch.sum(self.w * z, dim=dims) + self.b
        a = torch.where(lin < 0, 0.2, 1.0)  # the leaky slope folded into u
        u = self._constrained_u()
        view = (-1,) + (1,) * (u.dim() - 1)
        u = a.reshape(view) * u
        inner_ = torch.sum(self.w * u, dim=dims)
        return z - u * (lin / (1.0 + inner_)).reshape(view), -torch.log(torch.abs(1.0 + inner_))
