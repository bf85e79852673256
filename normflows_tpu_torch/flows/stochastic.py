"""Stochastic (MCMC) flow layers of stochastic normalizing flows (port of
``normflows_tpu/flows/stochastic.py``): ``MetropolisHastings`` and
``HamiltonianMonteCarlo``.

Every chain moves in lockstep on the batch axis; the steps are a Python
loop of a fixed count, so that a CUDA graph captures a whole layer.  The
draws come from the ``generator`` a call passes, in a documented order, or
are replayed from ``noise=`` (the JAX package's hook): a call with
``generator=g`` gives what a call with ``noise`` drawn from ``g`` in that
order gives.  A call with neither raises, as the JAX layers raise without a
key.

The accept/reject selects are ``torch.where``, so that a gradient passes
only through the branch chosen, as through ``jnp.where``.  Metropolis–
Hastings accepts where ``w <= min(exp(Δ), 1)``, Hamiltonian Monte Carlo
where ``u < exp(Δ)``, each comparison exactly as in the JAX package.

HMC's gradient of the target's log-density keeps its own graph when grad
mode is on (``torch.autograd.grad(..., create_graph=True)``), so that the
gradient of a loss reaches ``log_step_size``, ``log_mass``, the flows
before the layer and a trainable target through both derivatives of the
leapfrog, as ``jax.grad`` inside the JAX package's ``value_and_grad``
does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.flow import Flow, sum_except_batch
from ..ops.backend import resolve_device


def _require_draws(layer, generator, noise):
    if noise is None and generator is None:
        raise ValueError(f"{layer} is a stochastic flow layer: pass generator= (or its "
                         f"draws as noise=), e.g. model.log_prob(x, generator=g)")


def _rows(mask, z):
    """A (batch,) mask shaped to broadcast over z's event dims."""
    return mask.reshape(-1, *([1] * (z.dim() - 1)))


class _Stochastic(Flow):
    """What the two MCMC layers share: ``inverse`` is ``forward``, and the
    data-dependent initialisations are the identity transport."""

    def log_det_draws(self) -> bool:
        """An MCMC move draws on every call (the facades hand it a
        generator wherever they draw)."""
        return True

    def inverse(self, z, context=None, *, generator=None, noise=None):
        return self.forward(z, context, generator=generator, noise=noise)

    def data_dep_init(self, z, context=None):
        """Identity transport: an MCMC layer targets its own stationary law,
        so skipping the move is a sound draw-free stand-in for the ActNorm
        statistics downstream (the JAX package's choice)."""
        return z

    def data_dep_init_forward(self, z, context=None):
        return z


class MetropolisHastings(_Stochastic):
    """``steps`` Metropolis–Hastings moves toward ``target`` with ``proposal``;
    log_det = log p(z) - log p(z') over the accepted moves."""

    def __init__(self, target: nn.Module, proposal: nn.Module, steps: int = 1):
        super().__init__()
        self.target = target
        self.proposal = proposal
        self.steps = steps

    def forward(self, z, context=None, *, generator: Optional[torch.Generator] = None,
                noise=None):
        """Each step draws the proposal's standard normals ``eps`` (batch,
        *event), then the accept uniforms ``w`` (batch,).  ``noise = (eps,
        w)`` of shapes (steps, batch, *event) and (steps, batch) replays
        them; a leading dim other than ``steps`` raises."""
        _require_draws("MetropolisHastings", generator, noise)
        if noise is not None:
            eps, w = (torch.as_tensor(a, dtype=z.dtype, device=z.device) for a in noise)
            if eps.shape[0] != self.steps or w.shape[0] != self.steps:
                raise ValueError(f"noise leading dim must equal steps={self.steps}; got "
                                 f"eps {eps.shape[0]}, w {w.shape[0]}")
        log_p = self.target.log_prob(z)
        log_det = z.new_zeros(z.shape[0])
        for i in range(self.steps):
            if noise is None:
                z_, log_p_diff = self.proposal(z, generator)
                w_i = torch.rand(z.shape[0], generator=generator, dtype=z.dtype,
                                 device=z.device)
            else:
                z_, log_p_diff = self.proposal.propose_from_noise(z, eps[i])
                w_i = w[i]
            log_p_ = self.target.log_prob(z_)
            accept = w_i <= torch.clamp(torch.exp(log_p_ - log_p + log_p_diff), max=1.0)
            z = torch.where(_rows(accept, z), z_, z)
            log_det = torch.where(accept, log_det + log_p - log_p_, log_det)
            log_p = torch.where(accept, log_p_, log_p)
        return z, log_det


class HamiltonianMonteCarlo(_Stochastic):
    """One HMC move of ``steps`` leapfrog steps toward ``target``, with a
    learnable ``log_step_size`` and ``log_mass`` (float32, one entry a
    feature); ``max_abs_grad`` clamps the target's gradient.  log_det =
    log p(z) - log p(z_out)."""

    def __init__(self, target: nn.Module, steps: int, log_step_size, log_mass,
                 max_abs_grad: Optional[float] = None, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.target = target
        self.steps = steps
        self.max_abs_grad = max_abs_grad
        self.log_step_size = nn.Parameter(
            torch.as_tensor(log_step_size, dtype=torch.float32).clone().to(device))
        self.log_mass = nn.Parameter(
            torch.as_tensor(log_mass, dtype=torch.float32).clone().to(device))

    @classmethod
    def create(cls, target, steps, log_step_size, log_mass, max_abs_grad=None, *,
               device="cuda"):
        return cls(target, steps, log_step_size, log_mass, max_abs_grad, device=device)

    def grad_log_p(self, z):
        """d/dz of sum(target.log_prob(z)), clamped to ``max_abs_grad``.

        With grad mode on it keeps its graph (``create_graph``), on the live
        ``z`` where ``z`` requires grad: a detached copy there would cut the
        path through the earlier leapfrog steps and layers, and only the
        gradients would go wrong.  A ``z`` that requires no grad is taken as
        a leaf.  With grad mode off (sampling) the gradient is taken inside
        ``torch.enable_grad()`` and no graph is kept."""
        if torch.is_inference_mode_enabled():
            raise RuntimeError("HamiltonianMonteCarlo takes a gradient of the target: "
                               "it cannot run under torch.inference_mode()")
        keep = torch.is_grad_enabled()
        live = keep and z.requires_grad
        with torch.enable_grad():
            z_ = z if live else z.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(self.target.log_prob(z_).sum(), z_,
                                          create_graph=keep)
        if self.max_abs_grad is not None:
            grad = torch.clamp(grad, -self.max_abs_grad, self.max_abs_grad)
        return grad

    def forward(self, z, context=None, *, generator: Optional[torch.Generator] = None,
                noise=None):
        """Draws the momentum's standard normals ``p_eps`` (z.shape), then
        the accept uniforms ``u`` (batch,); ``noise = (p_eps, u)`` replays
        them."""
        _require_draws("HamiltonianMonteCarlo", generator, noise)
        if noise is None:
            p_eps = torch.randn(z.shape, generator=generator, dtype=z.dtype, device=z.device)
            u = torch.rand(z.shape[0], generator=generator, dtype=z.dtype, device=z.device)
        else:
            p_eps, u = (torch.as_tensor(a, dtype=z.dtype, device=z.device) for a in noise)
        return self.move(z, p_eps, u)

    def log_accept(self, z, p_eps, log_step_size=None):
        """The leapfrog trajectory from ``z`` with momentum ``p_eps *
        exp(log_mass / 2)``, at ``log_step_size`` (default: the layer's):
        ``(z_new, log_p, log_p_new, log_accept)``."""
        log_step_size = self.log_step_size if log_step_size is None else log_step_size
        p = p_eps * torch.exp(0.5 * self.log_mass)
        step_size = torch.exp(log_step_size)
        mass = torch.exp(self.log_mass)
        z_new, p_new = z, p
        for _ in range(self.steps):
            p_half = p_new + (step_size / 2.0) * self.grad_log_p(z_new)
            z_new = z_new + step_size * (p_half / mass)
            p_new = p_half + (step_size / 2.0) * self.grad_log_p(z_new)
        log_p = self.target.log_prob(z)
        log_p_new = self.target.log_prob(z_new)
        log_accept = (log_p_new - log_p - 0.5 * sum_except_batch(p_new**2 / mass)
                      + 0.5 * sum_except_batch(p**2 / mass))
        return z_new, log_p, log_p_new, log_accept

    def move(self, z, p_eps, u, log_step_size=None):
        """One move on given draws (momentum normals ``p_eps``, accept
        uniforms ``u``), at ``log_step_size`` (default: the layer's)."""
        z_new, log_p, log_p_new, log_accept = self.log_accept(z, p_eps, log_step_size)
        accept = u < torch.exp(log_accept)
        z_out = torch.where(_rows(accept, z), z_new, z)
        # log p(z_out), each row the branch chosen, as the JAX package's
        # target.log_prob(z_out) gives it
        return z_out, log_p - torch.where(accept, log_p_new, log_p)


def mcmc_layers(model: nn.Module):
    """The MCMC layers among ``model``'s modules."""
    return [m for m in model.modules() if isinstance(m, _Stochastic)]
