"""Flow-preconditioned HMC (NeuTra; Hoffman et al. 2019): port of
``normflows_tpu/sampling/neutra.py``.

HMC runs in the latent space of a trained flow, on the pullback

    log pi~(u) = log p(f(u)) + log |det df/du|,

which is well conditioned where the flow approximates the target; the
pushed-forward draws f(u) follow the target.  On the flagship, each
pullback evaluation runs the planar spline kernel in the inverse direction
(the flow's sampling pass) and each gradient its backward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..flows.stochastic import HamiltonianMonteCarlo
from ._graphs import replay_loop
from .adaptation import adapt_step_size


class PullbackTarget(nn.Module):
    """The latent-space density of the target pulled back through a flow:
    ``flow_model`` maps latent -> data (its ``forward_and_log_det``);
    ``target`` (default: the flow's own ``p``) is the data-space density."""

    def __init__(self, flow_model: nn.Module, target: Optional[nn.Module] = None):
        super().__init__()
        self.flow_model = flow_model
        self.target = target

    def log_prob(self, u, context=None):
        x, log_det = self.flow_model.forward_and_log_det(u)
        p = self.target if self.target is not None else self.flow_model.p
        return p.log_prob(x) + log_det


class NeuTraHMC(nn.Module):
    """HMC in a flow's latent space, its step size tuned by dual averaging."""

    def __init__(self, flow_model: nn.Module, pullback: PullbackTarget, num_leapfrog: int = 10,
                 init_step_size: float = 0.2):
        super().__init__()
        self.flow_model = flow_model
        self.pullback = pullback
        self.num_leapfrog = num_leapfrog
        self.init_step_size = init_step_size
        self.last_graphs = {}  # the last sample's graphs on a card: "adapt", "move"

    @classmethod
    def create(cls, flow_model, target=None, num_leapfrog: int = 10,
               init_step_size: float = 0.2):
        return cls(flow_model, PullbackTarget(flow_model, target), num_leapfrog, init_step_size)

    def _hmc(self, dim, device) -> HamiltonianMonteCarlo:
        return HamiltonianMonteCarlo(
            self.pullback, self.num_leapfrog,
            np.full(dim, np.log(self.init_step_size), np.float32), np.zeros(dim, np.float32),
            device=device)

    def sample(self, num_chains: int, num_steps: int, num_adapt: int = 50,
               target_accept: float = 0.8, *, generator: Optional[torch.Generator] = None,
               noise=None):
        """``(x, info)``: data-space draws (num_steps, num_chains, dim) and
        the adaptation's ``info``.  The chains start from the flow's base;
        the step size is tuned on the pullback (:func:`adapt_step_size`),
        then ``num_steps`` HMC moves run from the same start, and every
        latent draw goes through the flow's ``forward``.

        ``generator`` draws the base's draws, then the adaptation's (see
        :func:`adapt_step_size`), then each move's momentum normals and
        accept uniforms; ``noise = (eps0, adapt_noise, (p_eps, u))`` (the
        base's noise, the adaptation's ``noise``, and the moves' draws of
        shapes (num_steps, num_chains, dim) and (num_steps, num_chains))
        replays them.  With a generator of a card, one adaptation iteration
        and one move are each a CUDA graph replayed (``last_graphs``)."""
        if noise is None and generator is None:
            raise ValueError("NeuTraHMC.sample draws: pass generator= (or its draws as noise=)")
        q0 = self.flow_model.q0
        with torch.no_grad():
            if noise is None:
                u, _ = q0.sample_and_log_prob(num_chains, generator=generator)
            else:
                u, _ = q0.from_noise(torch.as_tensor(noise[0]))
        hmc = self._hmc(u.shape[-1], u.device)
        adapt, moves = {}, {}
        hmc, info = adapt_step_size(hmc, u, num_adapt, target_accept, generator=generator,
                                    noise=None if noise is None else noise[1], cache=adapt)
        row = [0]  # the move whose replayed draws the body reads
        if noise is None:
            def drawn(z):
                kw = dict(generator=generator, dtype=z.dtype, device=z.device)
                return torch.randn(z.shape, **kw), torch.rand(z.shape[0], **kw)
        else:
            generator = None  # the replayed draws run the eager loop
            rows = [torch.as_tensor(a, dtype=u.dtype, device=u.device) for a in noise[2]]

            def drawn(z):
                return [r[row[0]] for r in rows]

        def before(i):
            row[0] = i - 1

        def body(state):
            z, _ = hmc.move(state[0], *drawn(state[0]))
            return (z,), z

        with torch.no_grad():
            _, us = replay_loop(body, (u,), num_steps, generator, before=before, cache=moves)
            x = self.flow_model.forward(us.reshape(-1, us.shape[-1]))
        self.last_graphs = {"adapt": adapt.get("last"), "move": moves.get("last")}
        return x.reshape(num_steps, num_chains, -1), info
