"""Data-space preprocessing bijectors (port of ``normflows_tpu/transforms.py``):
``Logit`` and ``Shift``."""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from .core.flow import Flow, zero_log_det_like_z


class Logit(Flow):
    """The dequantisation bijector x = (sigmoid(z) - alpha) / (1 - 2 alpha):
    ``forward`` maps the latent to [0, 1] image space, ``inverse`` maps an
    image to logit(alpha + (1 - 2 alpha) x)."""

    def __init__(self, alpha: float = 0.05):
        super().__init__()
        self.alpha = alpha

    def forward(self, z, context=None, *, generator=None):
        beta = 1.0 - 2.0 * self.alpha
        dims = tuple(range(1, z.dim()))
        n = float(math.prod(z.shape[1:]))
        log_det = (-math.log(beta) * n + torch.sum(F.logsigmoid(z), dim=dims)
                   + torch.sum(F.logsigmoid(-z), dim=dims))
        return (torch.sigmoid(z) - self.alpha) / beta, log_det

    def inverse(self, z, context=None, *, generator=None):
        beta = 1.0 - 2.0 * self.alpha
        z = self.alpha + beta * z
        logz, log1mz = torch.log(z), torch.log1p(-z)
        dims = tuple(range(1, z.dim()))
        n = float(math.prod(z.shape[1:]))
        log_det = (math.log(beta) * n - torch.sum(logz, dim=dims)
                   - torch.sum(log1mz, dim=dims))
        return logz - log1mz, log_det


class Shift(Flow):
    """A constant shift: ``forward`` subtracts ``shift``, ``inverse`` adds it."""

    def __init__(self, shift: float = -0.5):
        super().__init__()
        self.shift = shift

    def forward(self, z, context=None, *, generator=None):
        return z - self.shift, zero_log_det_like_z(z)

    def inverse(self, z, context=None, *, generator=None):
        return z + self.shift, zero_log_det_like_z(z)
