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

:meth:`AnnealedSMC.program` is the ladder in the form an exported program
takes (``serving.export_sampler``): the temperatures a ``scan`` over their
coefficients (values of the program, where the live sampler copies them
into buffers) and their draws, each rung's tempered density and move
traced graphs (``flows.stochastic.program_move``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..core.facades import _default_generator
from ..flows.stochastic import HamiltonianMonteCarlo, program_move, value_and_grad
from ..ops.backend import trace_graph
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
        return tempered_log_prob(self.proposal, self.target, self.coefs, z)


def tempered_log_prob(proposal, target, coefs, z):
    """coefs[0] log q(z) + coefs[1] log p(z) (coefs float32, cast to z's
    dtype): :class:`_Tempered`'s density at its coefficients."""
    c = coefs.to(z.dtype)
    return c[0] * proposal.log_prob(z) + c[1] * target.log_prob(z)


def _rung(state, log_prob_prev, log_prob_new, move, draws, ess_threshold):
    """One temperature: reweight from ``log_prob_prev`` to ``log_prob_new``,
    accumulate log Z, resample where the ESS collapsed (a ``torch.where``
    over both branches), move by ``move(z, p_eps, u_accept)``; ``draws =
    (u_resample, p_eps, u_accept)``.  Returns the state and the resampling
    flag."""
    u, p_eps, u_acc = draws
    n = state.log_w.shape[0]
    inc = log_prob_new(state.particles) - log_prob_prev(state.particles)
    log_w = state.log_w + inc
    # accumulate evidence before normalising
    log_z = state.log_z + (torch.logsumexp(log_w, 0) - torch.logsumexp(state.log_w, 0))
    do_resample = effective_sample_size(log_w) < ess_threshold * n
    resampled, reset_w = systematic_resample(log_w, state.particles, u=u)
    particles = torch.where(do_resample, resampled, state.particles)
    log_w = torch.where(do_resample, reset_w, log_w)
    particles, _ = move(particles, p_eps, u_acc)
    return SMCState(particles, log_w, log_z), do_resample


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

    def _proposal_noise(self):
        """``(noise_spec, noise_shape)`` of the proposal's draws: a flow's
        base's, or the base distribution's own."""
        base = getattr(self.proposal, "q0", self.proposal)
        return tuple(base.noise_spec), tuple(base.noise_shape)

    def noise_layout(self, num_particles: int) -> dict:
        """The temperatures' draws after the proposal's, as ``distributions.
        base.draw_layout`` lays them out: each temperature's resampling
        uniform, momentum normals and accept uniforms, stacked over the
        temperatures after the first."""
        shape = [num_particles, *self._proposal_noise()[1]]
        return {"repeat": len(self.betas) - 1,
                "draws": [["uniform", []], ["normal", shape], ["uniform", [num_particles]]]}

    def program(self, num_particles: int) -> "_SMCProgram":
        """The ladder on ``num_particles`` particles in an exported
        program's form: ``(eps0, [(u_resample, p_eps, u_accept)]) ->
        (particles, log_w, log_z)``, the temperatures' draws stacked
        (:meth:`noise_layout`)."""
        return _SMCProgram(self, num_particles)

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
            new, flag = _rung(SMCState(*state), r["prev"].log_prob, r["new"].log_prob,
                              r["move"].move, draws(rung[0]), self.ess_threshold)
            return tuple(new), flag

        cache = self._rung_cache
        with torch.no_grad():
            state, flags = replay_loop(body, (z, z.new_zeros(z.shape[0]), z.new_zeros(())),
                                       len(self.betas) - 1, generator, before=set_rung,
                                       cache=cache)
        self.last_resampled, self.last_graph = flags, cache["last"]
        return SMCState(*state)


class _SMCProgram(nn.Module):
    """:meth:`AnnealedSMC.from_noise` as a program runs it: the same values
    on the same draws, each temperature's coefficients a slice of a buffer
    the scan runs over.  The proposal's and target's log-densities at the
    particles are evaluated once for both tempered densities of the
    reweighting (the eager rung evaluates them once each: the same
    values), and the move as :func:`flows.stochastic.program_move` does."""

    def __init__(self, smc: AnnealedSMC, num_particles: int):
        super().__init__()
        ref = next(iter([*smc.proposal.parameters(), *smc.proposal.buffers()]))
        shape = (num_particles, *smc._proposal_noise()[1])
        r = smc._rungs(shape[-1], ref.device)
        self.smc, self.move = smc, r["move"]
        z = torch.zeros(shape, dtype=ref.dtype, device=ref.device)
        c = torch.zeros(2, dtype=torch.float32, device=ref.device)

        self.value_grad = trace_graph(lambda z, c: value_and_grad(
            lambda x: tempered_log_prob(smc.proposal, smc.target, c, x), z,
            self.move.max_abs_grad), z, c)
        self.parts = trace_graph(lambda z: (smc.proposal.log_prob(z), smc.target.log_prob(z)), z)
        self.register_buffer("coefs", smc._coefs.clone())

    def forward(self, eps0, draws):
        from torch._higher_order_ops.scan import scan

        ((u, p_eps, u_acc),) = draws
        move, value_grad = self.move, self.value_grad
        z, _ = self.smc.proposal.from_noise(eps0)

        def rung(state, x):
            c_prev, c_new, draw = x[0], x[1], x[2:]
            parts = self.parts(state[0])

            def tempered(c):  # tempered_log_prob's arithmetic on the parts
                c = c.to(parts[0].dtype)
                return lambda _: c[0] * parts[0] + c[1] * parts[1]

            new, flag = _rung(
                SMCState(*state), tempered(c_prev), tempered(c_new),
                lambda z, p, u: program_move(value_grad, z, p, u, move.log_step_size,
                                             move.log_mass, move.steps, c_new),
                draw, self.smc.ess_threshold)
            return tuple(new), flag

        # the scan's carry keeps its layout: a flow's samples may come transposed
        z = z.contiguous()
        state = (z, z.new_zeros(z.shape[0]), z.new_zeros(()))
        (particles, log_w, log_z), _ = scan(
            rung, state, (self.coefs[:-1], self.coefs[1:], u, p_eps, u_acc))
        return particles, log_w, log_z
