"""Data-parallel training steps (port of ``normflows_tpu/parallel/data_parallel.py``).

The JAX package jits one step over a sharded batch and lets XLA insert the
gradient all-reduce.  Here each rank runs the port's eager step
(``training.make_train_step``: an in-place ``TrainState``, ``loss_fn(model,
batch, generator)``) on its own rows, and after the backward one
``all_reduce`` over the ranks of the ``data`` axis sums a flat buffer that
holds the loss and every gradient, divided by the ranks: the global mean
loss and its gradient, the same on every rank, so that Adam moves every
replica alike.  The non-finite skip reads that averaged loss, so every rank
skips alike.  ``DistributedDataParallel`` is not used: its gradient hooks
need the wrapped module's ``forward`` to run, and the losses call the
facades' other methods (``reverse_kld``, ``forward_kld``).

A step's first argument keeps the JAX package's ``model``: its parameters
and buffers are made rank 0's in place when the step is built, so that the
replicas start equal; the optimizer must be fresh, or hold the same state on
every rank (restored from one checkpoint).
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..training.loop import eager_step
from .mesh import batch_sharding, broadcast_


def average_over(mesh: DeviceMesh, axis: str, params, counts: Optional[Counter] = None
                 ) -> Callable:
    """``reduce(loss)`` for :func:`training.loop.eager_step`: the loss and the
    gradients of ``params`` (those that have one; a DTensor's local block)
    averaged over the ranks of ``axis``, one ``all_reduce`` for each dtype
    and device (one a step when all are float32), the gradients written back
    in place.  ``counts["all_reduce"]`` counts them."""
    group = mesh.get_group(axis)
    ranks = dist.get_world_size(group)

    def reduce(loss: torch.Tensor) -> torch.Tensor:
        grads = [p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
                 for p in params if p.grad is not None]
        kinds = {}
        for t in [loss, *grads]:
            kinds.setdefault((t.dtype, t.device), []).append(t)
        out = loss
        for members in kinds.values():
            flat = torch.cat([t.reshape(-1) for t in members])
            dist.all_reduce(flat, group=group)
            if counts is not None:
                counts["all_reduce"] += 1
            flat /= ranks
            offset = 0
            for t in members:
                part = flat[offset:offset + t.numel()].view_as(t)
                if t is loss:
                    out = part
                else:
                    t.copy_(part)
                offset += t.numel()
        return out

    return reduce


def make_data_parallel_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                            loss_fn: Callable, mesh: DeviceMesh, axis: str = "data"):
    """``(state, step_fn)`` of data-parallel training.

    ``loss_fn(model, batch, generator) -> scalar``, the mean over this rank's
    rows; ``step_fn(state, batch, generator=None) -> (state, metrics)`` as
    ``training.make_train_step``'s, ``batch`` this rank's rows
    (``shard_batch(x, mesh)``, or ``data.prefetch_to_device(..., mesh=mesh)``)
    and ``metrics["loss"]`` the global mean loss."""
    broadcast_([*model.parameters(), *model.buffers()], mesh)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return eager_step(model, optimizer, loss_fn, average_over(mesh, axis, params))


def make_reverse_kld_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                          mesh: DeviceMesh, num_samples: int, axis: str = "data",
                          beta: float = 1.0, score_fn: bool = True):
    """Data-parallel reverse-KL step (the flagship objective): ``(state,
    step_fn)`` with ``step_fn(state, generator=None) -> (state, metrics)``.

    Every rank draws the GLOBAL ``num_samples`` base draws from ``generator``
    (seeded alike on every rank), keeps its own rows
    (``reverse_kld(z_sharding=...)``) and runs its part of the flow, so that
    the step equals the single-process step on the same draws, as the JAX
    package's partitionable threefry makes its sharded step equal.  The
    price is each rank drawing the whole base sample."""
    sharding = batch_sharding(mesh, 1 + len(model.q0.event_shape), axis)

    def loss_fn(m, batch, generator):
        return m.reverse_kld(num_samples, beta=beta, score_fn=score_fn,
                             z_sharding=sharding, generator=generator)

    state, step = make_data_parallel_step(model, optimizer, loss_fn, mesh, axis)

    def step_fn(state, generator: Optional[torch.Generator] = None):
        return step(state, None, generator)

    return state, step_fn


def make_eval_step(model: nn.Module, eval_fn: Callable, mesh: DeviceMesh):
    """``step_fn(batch) -> eval_fn(model, batch)`` without gradients, on this
    rank's rows: a per-row ``eval_fn`` (``log_prob``) gives this rank's block
    of the global result, as the JAX package's sharded output holds it.  The
    model's parameters and buffers are made rank 0's in place first."""
    broadcast_([*model.parameters(), *model.buffers()], mesh)

    @torch.no_grad()
    def step_fn(batch):
        return eval_fn(model, batch)

    return step_fn
