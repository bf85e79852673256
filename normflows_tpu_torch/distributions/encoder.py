"""VAE encoders q(z | x) (port of ``normflows_tpu/distributions/encoder.py``).

Samples are (batch, num_samples, *event), log q (batch, num_samples).
``sample_and_log_prob(x, num_samples, generator=)`` draws the encoder's
noise from ``generator`` (one tensor of the samples' shape) and maps it
with ``from_noise(eps, x)``, so that a test or a replay can feed both
packages the same draws.  ``log_prob(z, x)`` keeps the JAX package's
reshapes: a 1-D ``z`` gains a leading axis, then a 2-D one another.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.backend import resolve_device

LOG2PI = math.log(2.0 * math.pi)


def _as_batched(z):
    """The JAX package's reshapes of ``log_prob``'s ``z``."""
    if z.dim() == 1:
        z = z[None]
    if z.dim() == 2:
        z = z[None]
    return z


class BaseEncoder(nn.Module):
    """Contract: ``sample_and_log_prob(x, num_samples=1, *, generator=None)
    -> (z, log_q)``, ``from_noise(eps, x)``, ``log_prob(z, x)``; a module's
    ``forward`` is ``sample_and_log_prob``."""

    def sample_and_log_prob(self, x, num_samples: int = 1, *,
                            generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def from_noise(self, eps, x):
        raise NotImplementedError

    def log_prob(self, z, x):
        raise NotImplementedError

    def forward(self, x, num_samples: int = 1, *,
                generator: Optional[torch.Generator] = None):
        return self.sample_and_log_prob(x, num_samples, generator=generator)


class Dirac(BaseEncoder):
    """z = x, each sample the same; log q = 0.  It draws nothing:
    ``from_noise`` reads only the count of samples, ``eps.shape[1]``."""

    def sample_and_log_prob(self, x, num_samples: int = 1, *,
                            generator: Optional[torch.Generator] = None):
        z = x[:, None].repeat_interleave(num_samples, dim=1)
        return z, z.new_zeros(z.shape[:2])

    def from_noise(self, eps, x):
        return self.sample_and_log_prob(x, eps.shape[1])

    def log_prob(self, z, x):
        return z.new_zeros(z.shape[:2])


class Uniform(BaseEncoder):
    """Uniform on [zmin, zmax]^event, independent of x; the noise is
    uniform on [0, 1)."""

    def __init__(self, zmin: float = 0.0, zmax: float = 1.0):
        super().__init__()
        self.zmin, self.zmax = float(zmin), float(zmax)

    def sample_and_log_prob(self, x, num_samples: int = 1, *,
                            generator: Optional[torch.Generator] = None):
        eps = torch.rand((x.shape[0], num_samples, *x.shape[1:]), generator=generator,
                         dtype=x.dtype, device=x.device)
        return self.from_noise(eps, x)

    def from_noise(self, eps, x):
        z = self.zmin + (self.zmax - self.zmin) * eps
        return z, self.log_prob(z, x)

    def log_prob(self, z, x):
        return torch.full(z.shape[:2], -math.log(self.zmax - self.zmin), dtype=z.dtype,
                          device=z.device)


class ConstDiagGaussian(BaseEncoder):
    """A Gaussian whose ``loc`` (1, 1, d) and ``scale`` (d,) do not depend on
    x (both trainable)."""

    def __init__(self, loc, scale, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.loc = nn.Parameter(torch.as_tensor(np.asarray(loc, np.float32)).reshape(1, 1, -1)
                                .to(device))
        self.scale = nn.Parameter(torch.as_tensor(np.asarray(scale, np.float32)).to(device))

    @classmethod
    def create(cls, loc, scale, *, device="cuda"):
        return cls(loc, scale, device=device)

    @property
    def d(self) -> int:
        return self.loc.shape[-1]

    def sample_and_log_prob(self, x=None, num_samples: int = 1, *,
                            generator: Optional[torch.Generator] = None):
        batch = x.shape[0] if x is not None else 1
        eps = torch.randn((batch, num_samples, self.d), generator=generator,
                          dtype=self.loc.dtype, device=self.loc.device)
        return self.from_noise(eps, x)

    def from_noise(self, eps, x=None):
        z = self.loc + self.scale * eps
        log_q = -0.5 * self.d * LOG2PI - torch.sum(torch.log(self.scale) + 0.5 * eps**2, dim=2)
        return z, log_q

    def log_prob(self, z, x):
        z = _as_batched(z)
        return -0.5 * self.d * LOG2PI - torch.sum(
            torch.log(self.scale) + 0.5 * ((z - self.loc) / self.scale) ** 2, dim=2)


class NNDiagGaussian(BaseEncoder):
    """A Gaussian whose mean and log-variance are ``net(x)``'s output
    channels: the first half the mean, the second the log-variance (std =
    exp(0.5 raw))."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def _mean_raw(self, x):
        mean_std = self.net(x)
        n = mean_std.shape[1] // 2
        return mean_std[:, :n][:, None], mean_std[:, n:2 * n][:, None]

    def sample_and_log_prob(self, x, num_samples: int = 1, *,
                            generator: Optional[torch.Generator] = None):
        mean, raw = self._mean_raw(x)
        eps = torch.randn((x.shape[0], num_samples, *mean.shape[2:]), generator=generator,
                          dtype=mean.dtype, device=mean.device)
        return self._sample(mean, raw, eps)

    def from_noise(self, eps, x):
        return self._sample(*self._mean_raw(x), eps)

    def _sample(self, mean, raw, eps):
        std = torch.exp(0.5 * raw)
        z = mean + std * eps
        d = float(np.prod(z.shape[2:]))
        dims = tuple(range(2, z.dim()))
        return z, -0.5 * d * LOG2PI - torch.sum(torch.log(std) + 0.5 * eps**2, dim=dims)

    def log_prob(self, z, x):
        z = _as_batched(z)
        mean, raw = self._mean_raw(x)
        var = torch.exp(raw)
        d = float(np.prod(z.shape[2:]))
        dims = tuple(range(2, z.dim()))
        return -0.5 * d * LOG2PI - 0.5 * torch.sum(torch.log(var) + (z - mean) ** 2 / var,
                                                   dim=dims)
