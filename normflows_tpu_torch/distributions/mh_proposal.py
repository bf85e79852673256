"""Metropolis–Hastings proposals (port of
``normflows_tpu/distributions/mh_proposal.py``).

A proposal maps the chains' states ``z`` (batch, *event) to candidates and
the log-ratio log p(z | z') - log p(z' | z) of the proposal's densities:
``forward(z, generator) -> (z', log_ratio)``.  ``propose_from_noise(z,
eps)`` is the same move on given standard normals ``eps``, so that a test
or a replay can feed both packages the same draws."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.backend import resolve_device


class MHProposal(nn.Module):
    """Proposal contract: ``forward(z, generator) -> (z', log_ratio)``."""

    def sample(self, z, generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def log_prob(self, z_, z):
        raise NotImplementedError

    def forward(self, z, generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def propose_from_noise(self, z, eps):
        raise NotImplementedError

    def noise_layout(self, num: int) -> list:
        """The draws of one move of ``num`` chains, as
        ``distributions.base.draw_layout`` lists them."""
        raise NotImplementedError


class DiagGaussianProposal(MHProposal):
    """Gaussian random walk z' = z + scale * eps; symmetric, so the log-ratio
    is 0.  ``scale`` is a buffer (the JAX package's ``buffer_field``)."""

    def __init__(self, shape, scale, *, device="cuda"):
        super().__init__()
        self.shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.register_buffer("scale", torch.as_tensor(scale, dtype=torch.float32,
                                                      device=resolve_device(device)))

    @classmethod
    def create(cls, shape, scale, *, device="cuda"):
        return cls(shape, scale, device=device)

    def draw(self, z, generator: Optional[torch.Generator] = None):
        """The standard normals (batch, *shape) of one move."""
        return torch.randn((z.shape[0], *self.shape), generator=generator, dtype=z.dtype,
                           device=z.device)

    def noise_layout(self, num: int) -> list:
        return [["normal", [num, *self.shape]]]

    def sample(self, z, generator: Optional[torch.Generator] = None):
        return self.propose_from_noise(z, self.draw(z, generator))[0]

    def log_prob(self, z_, z):
        d = float(np.prod(self.shape))
        dims = tuple(range(1, z.dim()))
        return -0.5 * d * math.log(2 * math.pi) - torch.sum(
            torch.log(self.scale) + 0.5 * ((z_ - z) / self.scale) ** 2, dim=dims)

    def forward(self, z, generator: Optional[torch.Generator] = None):
        return self.propose_from_noise(z, self.draw(z, generator))

    def propose_from_noise(self, z, eps):
        return eps * self.scale + z, z.new_zeros(z.shape[0])
