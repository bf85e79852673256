"""2-D energy landscapes (port of ``normflows_tpu/distributions/prior.py``):
the Rezende & Mohamed planar-flow test suite (``TwoModes``, ``Sinusoidal``,
``Sinusoidal_gap``, ``Sinusoidal_split``, ``Smiley``) and ``ImagePrior``, a
density read off an image's intensities.

The sinusoidal priors and ``Smiley`` move the last axis of their input to
the front before indexing (:func:`_transpose_last_first`), so that they
take points (batch, 2) as the JAX package's do.  ``ImagePrior.sample`` is a
rejection sampler, an eager loop on the device with draws from a
``torch.Generator``: each round proposes ``num_samples`` uniform points and
fills the free slots with the accepted ones, in order, until all are full.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.backend import resolve_device


class PriorDistribution(nn.Module):
    def log_prob(self, z):
        raise NotImplementedError


class ImagePrior(PriorDistribution):
    """Density proportional to an image's intensities on the box ``x_range``
    x ``y_range``."""

    def __init__(self, image, x_range=(-3, 3), y_range=(-3, 3), eps: float = 1e-10, *,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        image_ = np.flip(np.asarray(image), 0).transpose() + eps
        image_ = image_ / np.max(image_)
        density = np.log(image_ / np.sum(image_))
        scale = [[x_range[1] - x_range[0], y_range[1] - y_range[0]]]
        shift = [[x_range[0], y_range[0]]]
        for name, value in (("image", image_), ("density", density), ("scale", scale),
                            ("shift", shift)):
            self.register_buffer(name, torch.as_tensor(np.asarray(value, np.float32),
                                                       device=device))

    @classmethod
    def create(cls, image, x_range=(-3, 3), y_range=(-3, 3), eps=1e-10, *, device="cuda"):
        return cls(image, x_range, y_range, eps, device=device)

    def _size(self):
        return torch.tensor(self.image.shape, dtype=torch.float32, device=self.image.device)

    def log_prob(self, z):
        z_ = torch.clamp((z - self.shift) / self.scale, 0.0, 1.0)
        ind = (z_ * (self._size() - 1)).to(torch.int64)
        return self.density[ind[:, 0], ind[:, 1]]

    def accept_round(self, buf, count, z_, prob):
        """One round on the uniforms ``z_`` (n, 2) and ``prob`` (n,): the
        candidates whose pixel's intensity exceeds ``prob`` fill the free
        slots of ``buf`` from ``count`` on (a device count), in order, the
        rest dropped.  Returns ``(buf, count)``."""
        n = buf.shape[0]
        ind = (z_ * (self._size() - 1)).to(torch.int64)
        accept = self.image[ind[:, 0], ind[:, 1]] > prob
        pos = count + torch.cumsum(accept.to(torch.int64), 0) - 1
        pos = torch.where(accept & (pos < n), pos, n)  # slot n is the drop
        out = torch.cat([buf, buf.new_zeros(1, 2)]).index_copy_(
            0, pos, z_ * self.scale + self.shift)
        return out[:n], torch.clamp(count + accept.sum(), max=n)

    @torch.no_grad()
    def sample(self, num_samples: int = 1, *, generator: Optional[torch.Generator] = None):
        """``num_samples`` draws by rejection; reads the count once a round."""
        device = self.image.device
        buf = torch.zeros(num_samples, 2, device=device)
        count = torch.zeros((), dtype=torch.int64, device=device)
        while int(count) < num_samples:
            z_ = torch.rand(num_samples, 2, generator=generator, device=device)
            prob = torch.rand(num_samples, generator=generator, device=device)
            buf, count = self.accept_round(buf, count, z_, prob)
        return buf


class TwoModes(PriorDistribution):
    """Two modes at z[0] = +-loc."""

    def __init__(self, loc: float = 2.0, scale: float = 0.2):
        super().__init__()
        self.loc, self.scale = loc, scale

    def log_prob(self, z):
        a = torch.abs(z[:, 0])
        eps = abs(self.loc)
        return (-0.5 * ((torch.linalg.vector_norm(z, dim=1) - self.loc) / (2 * self.scale)) ** 2
                - 0.5 * ((a - eps) / (3 * self.scale)) ** 2
                + torch.log1p(torch.exp(-2 * (a * eps) / (3 * self.scale) ** 2)))


def _transpose_last_first(z):
    return torch.movedim(z, -1, 0) if z.dim() > 1 else z


class Sinusoidal(PriorDistribution):
    """A sinusoidal ridge."""

    def __init__(self, scale: float = 0.2, period: float = 4.0):
        super().__init__()
        self.scale, self.period = scale, period

    def log_prob(self, z):
        z_ = _transpose_last_first(z)
        w_1 = torch.sin(2 * math.pi / self.period * z_[0])
        norm4 = torch.sum(torch.abs(z_) ** 4, dim=0) ** 0.25
        return (-0.5 * ((z_[1] - w_1) / self.scale) ** 2
                - 0.5 * (norm4 / (20 * self.scale)) ** 4)


class Sinusoidal_gap(PriorDistribution):
    """A sinusoidal ridge with a gap."""

    def __init__(self, scale: float = 0.35, period: float = 4.0, w2_scale: float = 0.6,
                 w2_amp: float = 3.0, w2_mu: float = 1.0):
        super().__init__()
        self.scale, self.period = scale, period
        self.w2_scale, self.w2_amp, self.w2_mu = w2_scale, w2_amp, w2_mu

    def log_prob(self, z):
        z_ = _transpose_last_first(z)
        w_1 = torch.sin(2 * math.pi / self.period * z_[0])
        w_2 = self.w2_amp * torch.exp(-0.5 * ((z_[0] - self.w2_mu) / self.w2_scale) ** 2)
        eps = torch.abs(w_2 / 2)
        a = torch.abs(z_[1] - w_1 + w_2 / 2)
        norm4 = torch.sum(torch.abs(z_) ** 4, dim=0) ** 0.25
        return (-0.5 * ((a - eps) / self.scale) ** 2
                + torch.log1p(torch.exp(-2 * (eps * a) / self.scale**2))
                - 0.5 * (norm4 / (20 * self.scale)) ** 4)


class Sinusoidal_split(PriorDistribution):
    """A sinusoidal ridge split in two."""

    def __init__(self, scale: float = 0.4, period: float = 4.0, w3_scale: float = 0.3,
                 w3_amp: float = 3.0, w3_mu: float = 1.0):
        super().__init__()
        self.scale, self.period = scale, period
        self.w3_scale, self.w3_amp, self.w3_mu = w3_scale, w3_amp, w3_mu

    def log_prob(self, z):
        z_ = _transpose_last_first(z)
        w_1 = torch.sin(2 * math.pi / self.period * z_[0])
        w_3 = self.w3_amp * torch.sigmoid((z_[0] - self.w3_mu) / self.w3_scale)
        eps = torch.abs(w_3 / 2)
        a = torch.abs(z_[1] - w_1 + w_3 / 2)
        norm4 = torch.sum(torch.abs(z_) ** 4, dim=0) ** 0.25
        return (-0.5 * ((a - eps) / self.scale) ** 2
                + torch.log1p(torch.exp(-2 * (eps * a) / self.scale**2))
                - 0.5 * (norm4 / (20 * self.scale)) ** 4)


class Smiley(PriorDistribution):
    """A smiley face."""

    def __init__(self, scale: float = 0.2, loc: float = 2.0):
        super().__init__()
        self.scale, self.loc = scale, loc

    def log_prob(self, z):
        z_ = _transpose_last_first(z)
        return (-0.5 * ((torch.linalg.vector_norm(z_, dim=0) - self.loc)
                        / (2 * self.scale)) ** 2
                - 0.5 * ((torch.abs(z_[1] + 0.8) - 1.2) / (2 * self.scale)) ** 2)
