"""HMC step-size adaptation by dual averaging (Hoffman & Gelman 2014): port
of ``normflows_tpu/sampling/adaptation.py``.

The state is carried explicitly in tensors and the tuned layer is returned.
:func:`adapt_step_size` loops a fixed ``num_adapt`` times and reads nothing
back from the device, so that a CUDA graph can hold it whole; on a card it
captures one iteration and replays it (``_graphs.replay_loop``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..flows.stochastic import HamiltonianMonteCarlo
from ._graphs import replay_loop


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


def dual_averaging_init(init_step_size, *, device=None) -> DualAveragingState:
    """The state at ``init_step_size`` (a float or a tensor, float32)."""
    log_step = torch.log(torch.as_tensor(init_step_size, dtype=torch.float32, device=device))
    return DualAveragingState(log_step=log_step, log_step_avg=log_step,
                              h_bar=torch.zeros_like(log_step), mu=math.log(10.0) + log_step,
                              t=torch.zeros((), dtype=torch.float32, device=log_step.device))


def dual_averaging_update(state: DualAveragingState, accept_prob, target: float = 0.8,
                          gamma: float = 0.05, t0: float = 10.0,
                          kappa: float = 0.75) -> DualAveragingState:
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_prob)
    log_step = state.mu - torch.sqrt(t) / gamma * h_bar
    eta = t**-kappa
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_bar, state.mu, t)


def hmc_accept_prob(hmc: HamiltonianMonteCarlo, z, *,
                    generator: Optional[torch.Generator] = None, noise=None,
                    log_step_size=None):
    """One HMC trajectory's mean acceptance probability over the chains (no
    state update), at ``log_step_size`` (default: the layer's).  It draws
    the momentum's standard normals (z.shape); ``noise`` replays them."""
    if noise is None:
        if generator is None:
            raise ValueError("hmc_accept_prob draws: pass generator= (or its draws as noise=)")
        noise = torch.randn(z.shape, generator=generator, dtype=z.dtype, device=z.device)
    p_eps = torch.as_tensor(noise, dtype=z.dtype, device=z.device)
    log_accept = hmc.log_accept(z, p_eps, log_step_size)[3]
    return torch.mean(torch.clamp(torch.exp(log_accept), max=1.0))


def adapt_step_size(hmc: HamiltonianMonteCarlo, z0, num_adapt: int = 100,
                    target: float = 0.8, *, generator: Optional[torch.Generator] = None,
                    noise=None, cache: Optional[dict] = None):
    """Tune an HMC layer's step size by dual averaging; returns ``(hmc,
    info)``.  The chains ``z0`` advance with the current step size between
    updates, so that the tuning sees the typical set.

    Each of the ``num_adapt`` iterations draws, in this order, the
    acceptance probability's momentum normals (z0.shape), then the move's
    momentum normals and accept uniforms (batch,); ``noise = (p_accept,
    p_move, u_move)`` of shapes (num_adapt, *z0.shape) twice and
    (num_adapt, batch) replays them.  With a generator of the card that
    holds ``z0``, one iteration is a CUDA graph replayed ``num_adapt``
    times; ``cache`` (a dict) keeps it, as ``_graphs.replay_loop`` says.

    The returned layer is a new ``HamiltonianMonteCarlo`` on the caller's
    ``target`` module (shared, not copied) whose ``log_step_size`` is the
    averaged iterate; ``info`` holds ``accept_rate`` (num_adapt,) and
    ``final_step_size``."""
    if noise is None and generator is None:
        raise ValueError("adapt_step_size draws: pass generator= (or its draws as noise=)")
    da = dual_averaging_init(torch.exp(hmc.log_step_size.detach()))
    row = [0]  # the iteration whose replayed draws the body reads
    if noise is not None:
        rows = [torch.as_tensor(a, dtype=z0.dtype, device=z0.device) for a in noise]
        if any(r.shape[0] != num_adapt for r in rows):
            raise ValueError(f"noise leading dim must equal num_adapt={num_adapt}")
        generator = None  # the replayed draws run the eager loop

        def drawn(z):
            return [r[row[0]] for r in rows]
    else:
        def drawn(z):
            kw = dict(generator=generator, dtype=z.dtype, device=z.device)
            return (torch.randn(z.shape, **kw), torch.randn(z.shape, **kw),
                    torch.rand(z.shape[0], **kw))

    def before(i):
        row[0] = i - 1

    def body(state):
        z, *rest = state
        da = DualAveragingState(*rest)
        p_acc, p_move, u_move = drawn(z)
        a = hmc_accept_prob(hmc, z, noise=p_acc, log_step_size=da.log_step)
        new = dual_averaging_update(da, a, target=target)
        z, _ = hmc.move(z, p_move, u_move, log_step_size=da.log_step)
        return (z, *new), a

    with torch.no_grad():
        state, accepts = replay_loop(body, (z0, *da), num_adapt, generator, before=before,
                                     cache=cache)
    da = DualAveragingState(*state[1:])
    if accepts is None:
        accepts = z0.new_zeros((0,))
    tuned = HamiltonianMonteCarlo(hmc.target, hmc.steps, da.log_step_avg,
                                  hmc.log_mass.detach(), hmc.max_abs_grad,
                                  device=z0.device)
    return tuned, {"accept_rate": accepts, "final_step_size": torch.exp(da.log_step_avg)}
