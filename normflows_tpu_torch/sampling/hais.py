"""Hamiltonian annealed importance sampling (port of
``normflows_tpu/sampling/hais.py``).

The chains advance in lockstep on the batch axis, each on its own draws, so
that ``parallel.parallel_chain_sample`` can run a block of them a rank.
Every rung of the ladder is an ``HamiltonianMonteCarlo`` layer on the bridge
``LinearInterpolation(target, prior, beta)``; every bridge holds the same
``prior`` and ``target`` modules.  One generator serves the prior's draw
and every rung in turn, where the JAX package splits its key into one a
rung.

:meth:`HAIS.program` is the ladder in the form an exported program takes
(``serving.export_sampler``): the rungs a ``scan`` over their bridges'
coefficients, step sizes, masses and draws, each rung's move
``flows.stochastic.program_move`` over traced graphs of the bridge.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.facades import _default_generator
from ..distributions.base import draw_noise
from ..distributions.linear_interpolation import LinearInterpolation
from ..flows.stochastic import HamiltonianMonteCarlo, program_move, value_and_grad
from ..ops.backend import trace_graph


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

    def noise_layout(self, num_samples: int) -> dict:
        """The rungs' draws after the prior's, as ``distributions.base.
        draw_layout`` lays them out: each rung's momentum normals and accept
        uniforms, stacked over the rungs."""
        shape = [num_samples, *self.prior.event_shape]
        return {"repeat": len(self.layers), "draws": [["normal", shape],
                                                      ["uniform", [num_samples]]]}

    def program(self, num_samples: int) -> "_HAISProgram":
        """The ladder on ``num_samples`` chains in an exported program's
        form: ``(eps0, [(p_eps, u)]) -> (samples, log_w)``, the rungs'
        draws stacked (:meth:`noise_layout`)."""
        return _HAISProgram(self, num_samples)

    def from_noise(self, eps0, layer_noise):
        """:meth:`sample` on given draws: ``eps0`` the prior's noise, and
        ``layer_noise`` one ``(p_eps, u)`` pair a rung."""
        z, log_q = self.prior.from_noise(eps0)
        log_w = -log_q
        for layer, noise in zip(self.layers, layer_noise, strict=True):
            z, ld = layer(z, noise=noise)
            log_w = log_w + ld
        return z, log_w + self.target.log_prob(z)


def _bridge_log_prob(target, prior, coefs, z):
    """``LinearInterpolation(target, prior, alpha).log_prob(z)`` with
    ``coefs = [alpha, 1 - alpha]`` (float32) a tensor."""
    return coefs[0] * target.log_prob(z) + coefs[1] * prior.log_prob(z)


class _HAISProgram(nn.Module):
    """:meth:`HAIS.from_noise` as a program runs it.  Every rung must be an
    HMC layer on a bridge of the HAIS's own target and prior, all with one
    leapfrog count and gradient clamp (as ``HAIS.create`` builds them)."""

    def __init__(self, hais: HAIS, num_samples: int):
        super().__init__()
        layers = list(hais.layers)
        first = layers[0]
        for layer in layers:
            if not (isinstance(layer, HamiltonianMonteCarlo)
                    and isinstance(layer.target, LinearInterpolation)
                    and layer.target.dist1 is hais.target and layer.target.dist2 is hais.prior
                    and layer.steps == first.steps
                    and layer.max_abs_grad == first.max_abs_grad):
                raise ValueError("a HAIS program runs its rungs as one loop: every rung must be "
                                 "an HMC layer on a LinearInterpolation of the HAIS's target and "
                                 "prior, with one leapfrog count and max_abs_grad")
        self.hais = hais
        ref = first.log_step_size
        z = torch.zeros(num_samples, *hais.prior.event_shape, dtype=ref.dtype,
                        device=ref.device)
        c = torch.zeros(2, dtype=torch.float32, device=ref.device)

        self.value_grad = trace_graph(lambda z, c: value_and_grad(
            lambda x: _bridge_log_prob(hais.target, hais.prior, c, x), z, first.max_abs_grad),
            z, c)
        self.register_buffer("coefs", torch.tensor(
            [[layer.target.alpha, 1.0 - layer.target.alpha] for layer in layers],
            dtype=torch.float32, device=ref.device))

    def forward(self, eps0, draws):
        from torch._higher_order_ops.scan import scan

        ((p_eps, u),) = draws
        hais, steps = self.hais, self.hais.layers[0].steps
        log_steps = torch.stack([layer.log_step_size for layer in hais.layers])
        log_masses = torch.stack([layer.log_mass for layer in hais.layers])
        z, log_q = hais.prior.from_noise(eps0)

        def rung(carry, x):
            z, log_w = carry
            c, log_step, log_mass, p, uu = x
            z, ld = program_move(self.value_grad, z, p, uu, log_step, log_mass, steps, c)
            return (z, log_w + ld), []

        (z, log_w), _ = scan(rung, (z, -log_q), (self.coefs, log_steps, log_masses, p_eps, u))
        return z, log_w + hais.target.log_prob(z)
