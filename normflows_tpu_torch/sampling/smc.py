"""Annealed sequential Monte Carlo with flow proposals and HMC moves: port
of ``normflows_tpu/sampling/smc.py``.

Tempered SMC from a proposal (a base distribution or a trained
``NormalizingFlow``) to a target, with importance reweighting, systematic
resampling where the effective sample size collapses, and an HMC move at
every temperature.  Everything is batched on the particle axis, and the
resampling decision is a ``torch.where`` over both branches, so that the
whole ladder runs without a read back to the host and a CUDA graph can hold
it.  A temperature is one body over two tempered densities and their HMC
move, each temperature's coefficients copied in ahead of it, so that on a
card it is captured once (at the first call) and replayed for each
(``_graphs.replay_loop``); the densities and the move are built once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..core.facades import _default_generator
from ..flows.stochastic import HamiltonianMonteCarlo
from ._graphs import replay_loop


def effective_sample_size(log_w):
    w = torch.softmax(log_w, dim=0)
    return 1.0 / torch.sum(w**2)


def systematic_resample(log_w, particles, *, generator: Optional[torch.Generator] = None,
                        u=None):
    """Systematic resampling; returns ``(particles, zero log-weights)``.  One
    cumulative sum and a ``searchsorted`` (left side) of the ``n`` positions
    ``(i + u) / n``, clipped to [0, n - 1]; ``u`` is one uniform draw (drawn
    from ``generator`` when not given).  The sum and the positions are
    float64: a float32 scan sums in another order on a card than on the
    CPU, and a position within rounding of a boundary would then pick
    another index (the JAX package sums in float32)."""
    n = log_w.shape[0]
    if u is None:
        if generator is None:
            raise ValueError("systematic_resample draws: pass generator= (or its draw as u=)")
        u = torch.rand((), generator=generator, dtype=log_w.dtype, device=log_w.device)
    cumw = torch.cumsum(torch.softmax(log_w, dim=0).double(), dim=0)
    positions = (torch.arange(n, dtype=torch.float64, device=log_w.device)
                 + torch.as_tensor(u, device=log_w.device).double()) / n
    idx = torch.clamp(torch.searchsorted(cumw, positions), 0, n - 1)
    return particles[idx], torch.zeros_like(log_w)


class SMCState(NamedTuple):
    particles: torch.Tensor
    log_w: torch.Tensor
    log_z: torch.Tensor  # the accumulated log normalising-constant estimate


class _Tempered(nn.Module):
    """gamma_beta = (1 - beta) log q + beta log p: the reweighting's density
    and the HMC move's target, one source for both.  The two coefficients
    are a float32 buffer (float32(1 - beta), float32(beta), as the JAX
    package's weakly typed floats round), so that a rung captured in a CUDA
    graph can take another rung's by a copy."""

    def __init__(self, proposal: nn.Module, target: nn.Module, beta: float = 1.0, *,
                 device=None):
        super().__init__()
        self.proposal = proposal
        self.target = target
        self.beta = beta
        self.register_buffer("coefs", torch.tensor([1.0 - beta, beta], dtype=torch.float32,
                                                   device=device), persistent=False)

    def log_prob(self, z, context=None):
        c = self.coefs.to(z.dtype)
        return c[0] * self.proposal.log_prob(z) + c[1] * self.target.log_prob(z)


class AnnealedSMC(nn.Module):
    """Tempered SMC sampler.

    ``proposal``: a distribution with ``sample_and_log_prob`` / ``log_prob``
    (and ``from_noise`` for replayed draws), typically a trained
    ``NormalizingFlow`` or a base distribution; ``target``: an unnormalised
    density with ``log_prob``; ``betas``: the ladder 0 = beta_0 < ... <
    beta_M = 1 from proposal to target in log space.
    """

    def __init__(self, proposal: nn.Module, target: nn.Module, betas, num_leapfrog: int = 10,
                 step_size: float = 0.2, ess_threshold: float = 0.5):
        super().__init__()
        self.proposal = proposal
        self.target = target
        self.betas = tuple(float(b) for b in betas)
        self.num_leapfrog = num_leapfrog
        self.step_size = step_size
        self.ess_threshold = ess_threshold
        self.rungs = None  # built at the first call: see _rungs
        self.last_graph = None  # the rung graph the last sample replayed (None: eager)
        self.last_resampled = None  # the last sample's resampling decisions, on its device

    @classmethod
    def create(cls, proposal, target, betas=None, num_temps: int = 16, num_leapfrog: int = 10,
               step_size: float = 0.2, ess_threshold: float = 0.5):
        if betas is None:
            betas = np.linspace(0.0, 1.0, num_temps)
        betas = tuple(float(b) for b in betas)
        # sample() starts from uniform weights and drops the proposal's log q,
        # which is exact only for beta_0 = 0 and beta_M = 1
        if betas[0] != 0.0 or betas[-1] != 1.0:
            raise ValueError(f"betas must run 0.0 -> 1.0, got {betas[0]} -> {betas[-1]}")
        return cls(proposal, target, betas, num_leapfrog, step_size, ess_threshold)

    def _rungs(self, dim: int, device) -> nn.ModuleDict:
        """Built once (for ``dim`` features on ``device``): the ``prev`` /
        ``new`` tempered densities and ``move``, the HMC layer on ``new``;
        ``_coefs`` (temperatures, 2) each ``_Tempered``'s coefficients, which
        a rung copies into ``prev`` and ``new``; and the rung graph's cache."""
        r = self.rungs
        if r is None or r["move"].log_mass.shape[0] != dim \
                or r["move"].log_mass.device != device:
            prev, new = (_Tempered(self.proposal, self.target, device=device) for _ in range(2))
            move = HamiltonianMonteCarlo(
                new, self.num_leapfrog, np.full(dim, np.log(self.step_size), np.float32),
                np.zeros(dim, np.float32), device=device)
            self.rungs = nn.ModuleDict({"prev": prev, "new": new, "move": move})
            self.__dict__["_coefs"] = torch.tensor([[1.0 - b, b] for b in self.betas],
                                                   dtype=torch.float32, device=device)
            self.__dict__["_rung_cache"] = {}
        return self.rungs

    def _rung(self, state, prev, new, move, draws):
        """One temperature: reweight from ``prev`` to ``new``, accumulate
        log Z, resample where the ESS collapsed (a ``torch.where`` over both
        branches), move by ``move``; ``draws = (u_resample, p_eps,
        u_accept)``.  Returns the state and the resampling flag."""
        u, p_eps, u_acc = draws
        n = state.log_w.shape[0]
        inc = new.log_prob(state.particles) - prev.log_prob(state.particles)
        log_w = state.log_w + inc
        # accumulate evidence before normalising
        log_z = state.log_z + (torch.logsumexp(log_w, 0) - torch.logsumexp(state.log_w, 0))
        do_resample = effective_sample_size(log_w) < self.ess_threshold * n
        resampled, reset_w = systematic_resample(log_w, state.particles, u=u)
        particles = torch.where(do_resample, resampled, state.particles)
        log_w = torch.where(do_resample, reset_w, log_w)
        particles, _ = move.move(particles, p_eps, u_acc)
        return SMCState(particles, log_w, log_z), do_resample

    def sample(self, num_particles: int, *, generator: Optional[torch.Generator] = None):
        """Run SMC: ``(particles, log_w, log_z)``.  ``generator`` (the
        device's default one when None) draws the proposal's draws, then at
        each temperature the resampling uniform, the move's momentum normals
        and its accept uniforms.  On a card one temperature is a CUDA graph,
        captured at the first call and replayed for each temperature."""
        with torch.no_grad():
            z, _ = self.proposal.sample_and_log_prob(num_particles, generator=generator)
        g = generator if generator is not None else _default_generator(z.device)

        def draws(_):
            kw = dict(generator=g, dtype=z.dtype, device=z.device)
            return (torch.rand((), **kw), torch.randn(z.shape, **kw),
                    torch.rand(z.shape[0], **kw))

        return self._run(z, draws, g)

    def from_noise(self, eps0, noises):
        """:meth:`sample` on given draws (eagerly): ``eps0`` the proposal's
        noise (its ``from_noise``), ``noises`` one ``(u_resample, p_eps,
        u_accept)`` a temperature after the first."""
        if len(noises) != len(self.betas) - 1:
            raise ValueError(f"noises must hold {len(self.betas) - 1} entries, one a "
                             f"temperature after the first; got {len(noises)}")
        with torch.no_grad():
            z, _ = self.proposal.from_noise(torch.as_tensor(eps0))
        rows = [tuple(torch.as_tensor(a, dtype=z.dtype, device=z.device) for a in noise)
                for noise in noises]
        return self._run(z, lambda rung: rows[rung - 1], None)

    def _run(self, z, draws, generator):
        """The ladder from particles ``z``: rung i (from 1) reweights from
        betas[i - 1] to betas[i] with ``draws(i)``, through ``replay_loop``
        (a graph a rung with ``generator`` on a card, else eager)."""
        r = self._rungs(z.shape[-1], z.device)
        rung = [1]

        def set_rung(i):
            rung[0] = i
            r["prev"].coefs.copy_(self._coefs[i - 1])
            r["new"].coefs.copy_(self._coefs[i])

        def body(state):
            new, flag = self._rung(SMCState(*state), r["prev"], r["new"], r["move"],
                                   draws(rung[0]))
            return tuple(new), flag

        cache = self._rung_cache
        with torch.no_grad():
            state, flags = replay_loop(body, (z, z.new_zeros(z.shape[0]), z.new_zeros(())),
                                       len(self.betas) - 1, generator, before=set_rung,
                                       cache=cache)
        self.last_resampled, self.last_graph = flags, cache["last"]
        return SMCState(*state)
