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

Each layer's draws for a batch of a given shape are a layout
(:meth:`_Stochastic.noise_layout`, ``distributions.base.draw_layout``),
what a serving bundle's manifest records.  :meth:`HamiltonianMonteCarlo.program`
is the move in the form an exported program takes (``torch.export``
cannot trace ``torch.autograd.grad``): its gradient a traced graph;
:func:`program_move` runs the leapfrog steps as a ``scan`` over such a
graph, for the samplers' long ladders.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.flow import Flow, sum_except_batch
from ..distributions.base import draw_layout
from ..ops.backend import resolve_device, trace_graph


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

    def noise_layout(self, shape) -> dict:
        """The layout of a call's draws on a batch ``z`` of ``shape``
        (``distributions.base.draw_layout``): what ``noise=`` takes."""
        raise NotImplementedError

    def draw_noise(self, shape, *, generator=None, dtype=torch.float32, device="cpu"):
        """A call's draws on a batch of ``shape``, in the order a call with
        ``generator`` makes them: its ``noise=``."""
        return draw_layout(self.noise_layout(shape), generator=generator, dtype=dtype,
                           device=device)

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

    def noise_layout(self, shape) -> dict:
        """Each step: the proposal's draws, then the accept uniforms."""
        return {"repeat": self.steps,
                "draws": [*self.proposal.noise_layout(shape[0]), ["uniform", [shape[0]]]]}

    def forward(self, z, context=None, *, generator: Optional[torch.Generator] = None,
                noise=None):
        """Each step draws the proposal's standard normals ``eps`` (batch,
        *event), then the accept uniforms ``w`` (batch,).  ``noise = (eps,
        w)`` of shapes (steps, batch, *event) and (steps, batch) replays
        them; a leading dim other than ``steps`` raises."""
        _require_draws("MetropolisHastings", generator, noise)
        if noise is None:
            noise = self.draw_noise(z.shape, generator=generator, dtype=z.dtype,
                                    device=z.device)
        eps, w = (torch.as_tensor(a, dtype=z.dtype, device=z.device) for a in noise)
        if eps.shape[0] != self.steps or w.shape[0] != self.steps:
            raise ValueError(f"noise leading dim must equal steps={self.steps}; got "
                             f"eps {eps.shape[0]}, w {w.shape[0]}")
        log_p = self.target.log_prob(z)
        log_det = z.new_zeros(z.shape[0])
        for i in range(self.steps):
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
        """d/dz of sum(target.log_prob(z)), clamped to ``max_abs_grad``
        (:func:`value_and_grad`)."""
        return value_and_grad(self.target.log_prob, z, self.max_abs_grad)[1]

    def noise_layout(self, shape) -> dict:
        """The momentum normals, then the accept uniforms."""
        return {"repeat": None, "draws": [["normal", list(shape)], ["uniform", [shape[0]]]]}

    def forward(self, z, context=None, *, generator: Optional[torch.Generator] = None,
                noise=None):
        """Draws the momentum's standard normals ``p_eps`` (z.shape), then
        the accept uniforms ``u`` (batch,); ``noise = (p_eps, u)`` replays
        them."""
        _require_draws("HamiltonianMonteCarlo", generator, noise)
        if noise is None:
            noise = self.draw_noise(z.shape, generator=generator, dtype=z.dtype,
                                    device=z.device)
        p_eps, u = (torch.as_tensor(a, dtype=z.dtype, device=z.device) for a in noise)
        return self.move(z, p_eps, u)

    def log_accept(self, z, p_eps, log_step_size=None, grad=None):
        """The leapfrog trajectory from ``z`` with momentum ``p_eps *
        exp(log_mass / 2)``, at ``log_step_size`` (default: the layer's):
        ``(z_new, log_p, log_p_new, log_accept)``; ``grad`` (default
        :meth:`grad_log_p`) the target's gradient."""
        log_step_size = self.log_step_size if log_step_size is None else log_step_size
        grad = self.grad_log_p if grad is None else grad
        p, step_size, mass = _momentum(p_eps, log_step_size, self.log_mass)
        z_new, p_new = z, p
        for _ in range(self.steps):
            z_new, p_new = _leapfrog(z_new, p_new, step_size, mass, grad)
        log_p = self.target.log_prob(z)
        log_p_new = self.target.log_prob(z_new)
        return z_new, log_p, log_p_new, _log_accept(log_p, log_p_new, p, p_new, mass)

    def move(self, z, p_eps, u, log_step_size=None, grad=None):
        """One move on given draws (momentum normals ``p_eps``, accept
        uniforms ``u``), at ``log_step_size`` (default: the layer's)."""
        return _accept(z, *self.log_accept(z, p_eps, log_step_size, grad), u)

    def program(self, shape, dtype=torch.float32, device="cpu") -> "_HMCProgram":
        """This move on batches of ``shape`` in the form an exported program
        takes: its gradient a traced graph (``torch.export`` cannot trace
        ``torch.autograd.grad``)."""
        return _HMCProgram(self, shape, dtype, device)


def value_and_grad(log_prob, z, max_abs_grad=None):
    """``(log_prob(z), d/dz of sum(log_prob(z)))``, the gradient clamped to
    ``max_abs_grad``; the log-density is the value the gradient's forward
    pass computes.

    With grad mode on the gradient keeps its graph (``create_graph``), on
    the live ``z`` where ``z`` requires grad: a detached copy there would
    cut the path through the earlier leapfrog steps and layers, and only the
    gradients would go wrong.  A ``z`` that requires no grad is taken as a
    leaf.  With grad mode off (sampling) the gradient is taken inside
    ``torch.enable_grad()``, no graph is kept and the value is detached."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("HamiltonianMonteCarlo takes a gradient of the target: "
                           "it cannot run under torch.inference_mode()")
    keep = torch.is_grad_enabled()
    live = keep and z.requires_grad
    with torch.enable_grad():
        z_ = z if live else z.detach().requires_grad_(True)
        value = log_prob(z_)
        (grad,) = torch.autograd.grad(value.sum(), z_, create_graph=keep)
    if max_abs_grad is not None:
        grad = torch.clamp(grad, -max_abs_grad, max_abs_grad)
    return (value if keep else value.detach()), grad


def _momentum(p_eps, log_step_size, log_mass):
    """``(p, step_size, mass)`` of a trajectory: p = p_eps exp(log_mass / 2)."""
    return p_eps * torch.exp(0.5 * log_mass), torch.exp(log_step_size), torch.exp(log_mass)


def _leapfrog(z, p, step_size, mass, grad):
    """One leapfrog step of ``(z, p)``; ``grad(z)`` the target's gradient."""
    p_half = p + (step_size / 2.0) * grad(z)
    z = z + step_size * (p_half / mass)
    return z, p_half + (step_size / 2.0) * grad(z)


def _log_accept(log_p, log_p_new, p, p_new, mass):
    return (log_p_new - log_p - 0.5 * sum_except_batch(p_new**2 / mass)
            + 0.5 * sum_except_batch(p**2 / mass))


def _accept(z, z_new, log_p, log_p_new, log_accept, u):
    """The Metropolis step: ``(z_out, log_det)``."""
    accept = u < torch.exp(log_accept)
    z_out = torch.where(_rows(accept, z), z_new, z)
    # log p(z_out), each row the branch chosen, as the JAX package's
    # target.log_prob(z_out) gives it
    return z_out, log_p - torch.where(accept, log_p_new, log_p)


def program_move(value_grad, z, p_eps, u, log_step_size, log_mass, steps, *args):
    """:meth:`HamiltonianMonteCarlo.move` in an exported program's form, on
    ``value_grad(z, *args) -> (log p(z), its clamped gradient)`` (a traced
    graph of :func:`value_and_grad`, ``ops.backend.trace_graph``).

    The leapfrog steps are a ``scan`` of ``steps + 1`` iterations whose body
    evaluates the graph once: iteration 0 at the start point (its update
    discarded by ``torch.where``, which keeps the start bit for bit), each
    later one at the step's end, whose gradient is the next step's at its
    start.  The eager move evaluates the gradient twice a step and log p at
    both ends apart: the same values, each evaluated once here."""
    from torch._higher_order_ops.scan import scan

    p, step_size, mass = _momentum(p_eps, log_step_size, log_mass)

    def body(carry, k):
        z_k, p_k, g, lp_start, _ = carry
        first = k == 0
        p_half = p_k + (step_size / 2.0) * g
        z_next = torch.where(first, z_k, z_k + step_size * (p_half / mass))
        lp, g = value_grad(z_next, *args)
        p_next = torch.where(first, p_k, p_half + (step_size / 2.0) * g)
        return (z_next, p_next, g, torch.where(first, lp, lp_start), lp), []

    # the carry's tensors are distinct (a scan's carry may not alias itself)
    (z_new, p_new, _, lp, lp_new), _ = scan(
        body, (z, p, torch.zeros_like(z), z.new_zeros(z.shape[0]), z.new_zeros(z.shape[0])),
        torch.arange(steps + 1, device=z.device))
    return _accept(z, z_new, lp, lp_new, _log_accept(lp, lp_new, p, p_new, mass), u)


class _HMCProgram(nn.Module):
    """An HMC layer's move on batches of one shape, as a program runs it:
    the layer's own move, its gradient a graph traced at that shape (a
    layer's few leapfrog steps unrolled, where a sampler's long ladders take
    :func:`program_move`'s loop).  The layer stays a submodule, so its step
    size and mass are the program's parameters."""

    def __init__(self, layer, shape, dtype, device):
        super().__init__()
        self.layer = layer
        self.grad = trace_graph(layer.grad_log_p, torch.zeros(shape, dtype=dtype, device=device))

    def forward(self, z, context=None, *, noise):
        p_eps, u = noise
        return self.layer.move(z, p_eps, u, grad=self.grad)


def mcmc_layers(model: nn.Module):
    """The MCMC layers among ``model``'s modules."""
    return [m for m in model.modules() if isinstance(m, _Stochastic)]
