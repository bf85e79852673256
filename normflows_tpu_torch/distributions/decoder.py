"""VAE decoders p(x | z) (port of ``normflows_tpu/distributions/decoder.py``).

``log_prob(x, z)`` tiles ``x`` along the batch to ``z``'s where ``z`` holds
several samples a row (batch * num_samples rows)."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

LOG2PI = math.log(2.0 * math.pi)


def _tile_x_to_z(x, z):
    """Each row of x repeated to z's batch (z = batch * samples)."""
    if z.shape[0] > x.shape[0]:
        x = x.repeat_interleave(z.shape[0] // x.shape[0], dim=0)
    return x


class BaseDecoder(nn.Module):
    def forward(self, z):
        raise NotImplementedError

    def log_prob(self, x, z):
        raise NotImplementedError


class NNDiagGaussianDecoder(BaseDecoder):
    """A diagonal Gaussian p(x | z) whose mean and log-variance are the two
    halves of ``net(z)``'s channels."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def _mean_raw(self, z):
        mean_std = self.net(z)
        n = mean_std.shape[1] // 2
        return mean_std[:, :n], mean_std[:, n:]

    def forward(self, z):
        """``(mean, std)``."""
        mean, raw = self._mean_raw(z)
        return mean, torch.exp(0.5 * raw)

    def log_prob(self, x, z):
        mean, raw = self._mean_raw(z)
        var = torch.exp(raw)
        x = _tile_x_to_z(x, z)
        d = float(np.prod(x.shape[1:]))
        dims = tuple(range(1, x.dim()))
        return -0.5 * d * LOG2PI - 0.5 * torch.sum(torch.log(var) + (x - mean) ** 2 / var,
                                                   dim=dims)


class NNBernoulliDecoder(BaseDecoder):
    """A Bernoulli p(x | z) whose logits are ``net(z)``, its log-density in
    the stable log-sigmoid form."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, z):
        return torch.sigmoid(self.net(z))

    def log_prob(self, x, z):
        score = self.net(z)
        x = _tile_x_to_z(x, z)
        dims = tuple(range(1, x.dim()))
        return torch.sum(x * F.logsigmoid(score) + (1 - x) * F.logsigmoid(-score), dim=dims)
