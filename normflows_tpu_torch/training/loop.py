"""Training-step factory (port of ``normflows_tpu/training/loop.py``).

In PyTorch idiom: the model and a ``torch.optim`` optimizer are updated in
place, and the step runs eagerly (there is no ``jit``; the JAX package's
``donate`` has nothing to do here).  ``torch.optim.Adam(params, lr=5e-4)`` is
the counterpart of ``optax.adam(5e-4)``: both default to betas (0.9, 0.999)
and eps 1e-8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

_LATER = "a later slice of the PyTorch port"


@dataclass
class TrainState:
    """The model and optimizer a step updates in place, and the count of
    steps taken (skipped ones included, as in the JAX package)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable, update_lipschitz_iters: Optional[int] = None):
    """Build ``(state, step_fn)``.

    ``loss_fn(model, batch, generator) -> scalar``.  ``step_fn(state, batch,
    generator=None)`` returns ``(state, metrics)`` with metrics ``{"loss",
    "finite"}``.  A non-finite loss skips the whole optimizer step: the
    parameters stay and so does the optimizer's state (Adam's moments and
    step count), as the reference notebooks' ``if not (isnan | isinf)`` loss
    skip does; masking only the gradients would still move Adam.  Deciding
    that reads the loss on the host once a step, after the backward has
    been queued."""
    if update_lipschitz_iters is not None:
        raise NotImplementedError(
            f"update_lipschitz_iters (residual flows) waits for {_LATER}")
    state = TrainState(model, optimizer)

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model, batch, generator)
        loss.backward()
        finite = bool(torch.isfinite(loss))
        if finite:
            state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "finite": finite}

    return state, step_fn


def make_chunked_train_step(*args, **kwargs):
    """Device-resident data, several steps a dispatch: waits for a later
    slice of the PyTorch port."""
    raise NotImplementedError(f"make_chunked_train_step waits for {_LATER}")
