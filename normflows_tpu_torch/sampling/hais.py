"""Hamiltonian annealed importance sampling (port of
``normflows_tpu/sampling/hais.py``).

The chains advance in lockstep on the batch axis, each on its own draws, so
that ``parallel.parallel_chain_sample`` can run a block of them a rank.
Every rung of the ladder is an ``HamiltonianMonteCarlo`` layer on the bridge
``LinearInterpolation(target, prior, beta)``; every bridge holds the same
``prior`` and ``target`` modules.  One generator serves the prior's draw
and every rung in turn, where the JAX package splits its key into one a
rung.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.facades import _default_generator
from ..distributions.base import draw_noise
from ..distributions.linear_interpolation import LinearInterpolation
from ..flows.stochastic import HamiltonianMonteCarlo


class HAIS(nn.Module):
    """Annealed importance sampling from ``prior`` to ``target`` with HMC
    transitions (``layers``, the first rung nearest the prior)."""

    def __init__(self, prior: nn.Module, target: nn.Module, layers):
        super().__init__()
        self.prior = prior
        self.target = target
        self.layers = nn.ModuleList(layers)

    @classmethod
    def create(cls, betas, prior, target, num_leapfrog, step_size, log_mass, *,
               device="cuda"):
        """``betas``: 1 = beta_0 > beta_1 > ... > beta_n = 0; one rung for
        each of beta_{n-1}, ..., beta_1, each with ``num_leapfrog`` leapfrog
        steps, ``log_step_size = log(step_size)`` and ``log_mass``."""
        betas = np.asarray(betas)
        n = betas.shape[0] - 1
        log_step = np.log(np.asarray(step_size, np.float32))
        layers = [HamiltonianMonteCarlo(LinearInterpolation(target, prior, float(betas[i])),
                                        num_leapfrog, log_step, log_mass, device=device)
                  for i in range(n - 1, 0, -1)]
        return cls(prior, target, layers)

    def sample(self, num_samples: int, *, generator: Optional[torch.Generator] = None):
        """``(samples, log_w)``: weighted draws of the target, log_w = -log
        q0(z0) + the rungs' log-dets + log p(z_T): :meth:`from_noise` on the
        draws of :meth:`draw_noise`."""
        return self.from_noise(*self.draw_noise(num_samples, generator=generator))

    def draw_noise(self, num_samples: int, *, generator: Optional[torch.Generator] = None):
        """``(eps0, layer_noise)``, every draw of :meth:`sample`, chain by
        chain on the leading axis: ``generator`` (torch's default one of the
        device when None) draws the prior's noise (``draw_noise`` by its
        ``noise_spec``), then each rung's momentum normals ``p_eps`` and
        accept uniforms ``u``, the HMC layer's order."""
        ref = next(iter([*self.prior.parameters(), *self.prior.buffers()]))
        g = generator if generator is not None else _default_generator(ref.device)
        kw = dict(generator=g, dtype=ref.dtype, device=ref.device)
        eps0 = draw_noise(self.prior.noise_spec, self.prior.noise_shape, num_samples, **kw)
        shape = (num_samples, *self.prior.event_shape)
        return eps0, [(torch.randn(shape, **kw), torch.rand(num_samples, **kw))
                      for _ in self.layers]

    def from_noise(self, eps0, layer_noise):
        """:meth:`sample` on given draws: ``eps0`` the prior's noise, and
        ``layer_noise`` one ``(p_eps, u)`` pair a rung."""
        z, log_q = self.prior.from_noise(eps0)
        log_w = -log_q
        for layer, noise in zip(self.layers, layer_noise, strict=True):
            z, ld = layer(z, noise=noise)
            log_w = log_w + ld
        return z, log_w + self.target.log_prob(z)
