"""Target distributions (port of ``normflows_tpu/distributions/target.py``):
the ``Target`` contract with its rejection sampler, ``TwoIndependent``,
``TwoMoons``, ``CircularGaussianMixture``, ``RingMixture``,
``ConditionalDiagGaussian`` and ``GaussianVonMises``.

``Target.sample`` is the JAX package's static-shape sampler: each round
proposes ``num_samples`` uniform candidates on the proposal box, accepts
those with exp(log_prob - max_log_prob) > u, and writes the accepted ones
into a fixed buffer at slots given by a cumulative sum, until the buffer is
full.  The draws come from a ``torch.Generator``; one round is
:meth:`Target.accept_round` on given uniforms, so that a test can replay
JAX's draws and compare buffers."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.backend import resolve_device

_LOG2PI = math.log(2.0 * math.pi)
# log I0(1), the von Mises normaliser at kappa = 1 (np.i0, as the JAX package)
_LOG_I0_1 = math.log(float(np.i0(1.0)))


class Target(nn.Module):
    """Target-distribution contract: ``log_prob(z, context=None)``.  Holds no
    tensors; ``device`` follows the port's device rule all the same."""

    n_dims = None  # override
    max_log_prob = None  # override

    def __init__(self, prop_scale: float = 6.0, prop_shift: float = -3.0, *,
                 device="cuda"):
        super().__init__()
        self.prop_scale = prop_scale
        self.prop_shift = prop_shift
        self.device = resolve_device(device)

    def log_prob(self, z, context=None):
        raise NotImplementedError("The log probability is not implemented yet.")

    def accept_round(self, buf, count: int, eps, u):
        """One round of the rejection sampler on the proposal uniforms
        ``eps`` (n, D) and ``u`` (n,): candidates z = prop_scale * eps +
        prop_shift, accepted where exp(log_prob(z) - max_log_prob) > u, fill
        the free slots of ``buf`` (n, D) from ``count`` on, in order; the
        ones past the end are dropped.  Returns ``(buf, count)``, ``buf`` a
        new tensor and ``count`` the number of filled slots."""
        n = buf.shape[0]
        z = self.prop_scale * eps + self.prop_shift
        accept = torch.exp(self.log_prob(z) - self.max_log_prob) > u
        pos = count + torch.cumsum(accept.to(torch.int64), 0) - 1
        pos = torch.where(accept & (pos < n), pos, n)  # slot n is the drop
        out = torch.cat([buf, buf.new_zeros(1, buf.shape[1])]).index_copy_(0, pos, z)
        return out[:n], min(n, count + int(accept.sum()))

    def sample(self, num_samples: int = 1, context=None, *,
               generator: Optional[torch.Generator] = None):
        """``num_samples`` exact draws by rejection from the uniform
        proposal, on the target's device; ``generator`` (on that device)
        draws the proposals.  Reads the count on the host once a round."""
        buf = torch.zeros(num_samples, self.n_dims, device=self.device)
        count = 0
        while count < num_samples:
            eps = torch.rand(num_samples, self.n_dims, generator=generator, device=self.device)
            u = torch.rand(num_samples, generator=generator, device=self.device)
            buf, count = self.accept_round(buf, count, eps, u)
        return buf


class TwoMoons(Target):
    """2-D bimodal benchmark density (unnormalised), proposal box [-3, 3]^2."""

    n_dims = 2
    max_log_prob = 0.0

    def log_prob(self, z, context=None):
        a = torch.abs(z[:, 0])
        norm = torch.linalg.vector_norm(z, dim=1)
        return (-0.5 * ((norm - 2.0) / 0.2) ** 2 - 0.5 * ((a - 2.0) / 0.3) ** 2
                + torch.log1p(torch.exp(-4.0 * a / 0.09)))


class TwoIndependent(Target):
    """The product of two targets on the two halves of the features."""

    def __init__(self, target1: nn.Module, target2: nn.Module, *, device="cuda"):
        super().__init__(device=device)
        self.target1 = target1
        self.target2 = target2

    @property
    def n_dims(self):
        return self.target1.n_dims + self.target2.n_dims

    def log_prob(self, z, context=None):
        z1, z2 = torch.chunk(z, 2, dim=1)
        return self.target1.log_prob(z1) + self.target2.log_prob(z2)

    def sample(self, num_samples: int = 1, context=None, *,
               generator: Optional[torch.Generator] = None):
        z1 = self.target1.sample(num_samples, generator=generator)
        z2 = self.target2.sample(num_samples, generator=generator)
        return torch.cat([z1, z2], dim=1)


class CircularGaussianMixture(nn.Module):
    """``n_modes`` Gaussians of equal weight on the circle of radius 2,
    each of std 2/3 sin(pi / n_modes); sampled directly, not by
    rejection."""

    def __init__(self, n_modes: int = 8, *, device="cuda"):
        super().__init__()
        self.n_modes = n_modes
        self.device = resolve_device(device)

    @property
    def scale(self):
        return 2.0 / 3.0 * math.sin(math.pi / self.n_modes)

    def _locs(self, angles):
        return torch.stack([2.0 * torch.sin(angles), 2.0 * torch.cos(angles)], dim=1)

    def log_prob(self, z, context=None):
        angles = 2.0 * math.pi / self.n_modes * torch.arange(
            self.n_modes, dtype=z.dtype, device=z.device)
        d = torch.sum((z[:, None, :] - self._locs(angles)[None]) ** 2, dim=-1) / (
            2.0 * self.scale**2)
        return -math.log(2.0 * math.pi * self.scale**2 * self.n_modes) + torch.logsumexp(
            -d, dim=1)

    def sample(self, num_samples: int = 1, context=None, *,
               generator: Optional[torch.Generator] = None):
        eps = torch.randn(num_samples, 2, generator=generator, device=self.device)
        mode = torch.randint(0, self.n_modes, (num_samples,), generator=generator,
                             device=self.device)
        return eps * self.scale + self._locs(2.0 * math.pi / self.n_modes * mode)


class RingMixture(Target):
    """``n_rings`` concentric rings of radii 2 k / n_rings, each of width
    1 / (4 n_rings) (unnormalised), proposal box [-3, 3]^2."""

    n_dims = 2
    max_log_prob = 0.0

    def __init__(self, n_rings: int = 2, *, device="cuda"):
        super().__init__(device=device)
        self.n_rings = n_rings

    @property
    def scale(self):
        return 1.0 / 4.0 / self.n_rings

    def log_prob(self, z, context=None):
        norm = torch.linalg.vector_norm(z, dim=1)
        radii = 2.0 / self.n_rings * (torch.arange(self.n_rings, dtype=z.dtype,
                                                   device=z.device) + 1.0)
        d = (norm[:, None] - radii[None]) ** 2 / (2.0 * self.scale**2)
        return torch.logsumexp(-d, dim=1)


class ConditionalDiagGaussian(Target):
    """Gaussian whose mean and std are the context's two halves: context =
    concat(mean, std), one row a sample (``ConditionalDiagGaussianTarget``
    in the package's ``distributions``)."""

    def log_prob(self, z, context=None):
        d = z.shape[-1]
        loc, scale = context[:, :d], context[:, d:]
        return -0.5 * d * _LOG2PI - torch.sum(
            torch.log(scale) + 0.5 * ((z - loc) / scale) ** 2, dim=-1)

    def sample(self, num_samples: int = 1, context=None, *,
               generator: Optional[torch.Generator] = None):
        d = context.shape[-1] // 2
        eps = torch.randn(num_samples, d, generator=generator, dtype=context.dtype,
                          device=context.device)
        return context[:, :d] + context[:, d:] * eps


class GaussianVonMises(Target):
    """Cylinder target of the NSF paper example:
    p(x, phi) = N(x; 0, 1) * VonMises(phi; mu=3x, kappa=1)."""

    n_dims = 2
    max_log_prob = -1.99

    def __init__(self, prop_scale: float = 2.0 * math.pi,
                 prop_shift: float = -math.pi, *, device="cuda"):
        super().__init__(prop_scale, prop_shift, device=device)

    @property
    def log_const(self):
        return -1.5 * math.log(2.0 * math.pi) - _LOG_I0_1

    def log_prob(self, x, context=None):
        return -0.5 * x[:, 0] ** 2 + torch.cos(x[:, 1] - 3.0 * x[:, 0]) + self.log_const
