"""Pipeline parallelism over flow layers (port of
``normflows_tpu/parallel/pipeline.py``), GPipe's schedule.

The homogeneous layers split into S stages along the mesh axis
``stage_axis``: stage s holds layers ``[s K/S, (s + 1) K/S)``.  The batch
splits into M microbatches (default 2 S).  Forward, stage 0 runs its layers
on each microbatch in turn and hands ``(z, log_det)`` to stage 1, which runs
its layers on it while stage 0 goes on to the next, and so on; the last
stage hands the whole result to every stage, so that it is replicated on
every stage rank, as the JAX package's final ``psum`` makes it.  A stage
keeps each microbatch's autograd graph; backward, the gradients of the
result (the same on every rank, whose losses are computed alike from the
replicated result) run the schedule in reverse: the last stage takes its
microbatches' gradients from them, and each stage hands the gradient of
its microbatch's input to the one before.  Only ``z``'s gradient hops: the
log-det is a sum, so its gradient is the result's on every stage.  The
gradient of the input reaches every stage from stage 0.  So
:func:`make_pipeline_apply`'s result is differentiable, on each rank, with
respect to the input and to that rank's stage's layers.

A hop is a broadcast in the process group of the two neighbouring stages:
gloo carries broadcasts of CUDA tensors where it cannot send or receive
them, and NCCL carries both.  A per-sample context (ndim >= 2, leading
dim the batch) rides with its microbatch; a 1-D context is always
unbatched, even when its length equals the batch.  A context is not
differentiated (one that requires grad raises).  A stage runs its layers
eagerly (no CUDA graph) and blocks on each hop.
"""

from __future__ import annotations

import copy
import math
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..core.flow import check_homogeneous
from ..training.loop import build_optimizer, eager_step
from .mesh import broadcast_

__all__ = ["make_pipeline_apply", "make_pipeline_train_step"]


class _Stages:
    """This rank's stage of a pipeline over ``mesh``'s ``stage_axis``: its
    layers in the order they run (``reverse``: the stack's last first) and
    their places in the stack (``indices``), its index and the stages'
    count, the process groups of its hops and of the stage axis, and the
    count of its collectives since the step began."""

    def __init__(self, layers, mesh: DeviceMesh, stage_axis: str, num_microbatches, reverse):
        if stage_axis not in mesh.mesh_dim_names:
            raise ValueError(f"mesh axes are {mesh.mesh_dim_names}, not {stage_axis!r}")
        names = list(mesh.mesh_dim_names)
        d = names.index(stage_axis)
        n = mesh.size(d)
        layers = list(layers)
        if len(layers) % n != 0:
            raise ValueError(f"{len(layers)} layers not divisible into {n} stages")
        check_homogeneous(layers, "pipeline")
        self.stages, self.stage = n, mesh.get_local_rank(stage_axis)
        self.microbatches = num_microbatches if num_microbatches is not None else 2 * n
        self.reverse = reverse
        per = len(layers) // n
        order = list(range(len(layers)))[::-1] if reverse else list(range(len(layers)))
        self.indices = order[self.stage * per:(self.stage + 1) * per]
        self.layers = [layers[i] for i in self.indices]
        self.counts = Counter()
        self.group = mesh.get_group(stage_axis)
        # this rank's row of the mesh along the stage axis: the global ranks
        # of its stages
        coords = [mesh.get_local_rank(a) for a in names]
        self.ranks = []
        for s in range(n):
            coords[d] = s
            self.ranks.append(int(mesh.mesh[tuple(coords)]))
        # the groups of neighbouring stages: every rank makes every group, in
        # one order (new_group is collective over the world)
        self.hops = {}
        for row in mesh.mesh.movedim(d, -1).reshape(-1, n).tolist():
            for s in range(n - 1):
                g = dist.new_group([row[s], row[s + 1]])
                if row == self.ranks:
                    self.hops[s] = g

    def _from(self, t: Optional[torch.Tensor], src: int, group, like) -> torch.Tensor:
        """``t`` broadcast from stage ``src`` in ``group``: the sender passes
        it, the others None and get a tensor shaped ``like``."""
        if self.stage == src:
            t = t.contiguous()
        else:
            t = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        self.counts["broadcast"] += 1
        dist.broadcast(t, self.ranks[src], group=group)
        return t

    def hop(self, t: Optional[torch.Tensor], src: int, dst: int, like) -> torch.Tensor:
        """``t`` from stage ``src`` at its neighbour ``dst``."""
        return self._from(t, src, self.hops[min(src, dst)], like)

    def everywhere(self, t: Optional[torch.Tensor], src: int, like) -> torch.Tensor:
        """``t`` from stage ``src`` on every stage."""
        return self._from(t, src, self.group, like)

    def run_layers(self, z, log_det, context):
        for layer in self.layers:
            z, dl = layer.inverse(z, context) if self.reverse else layer.forward(z, context)
            log_det = log_det + dl.to(log_det.dtype)
        return z, log_det


def _pack(z, log_det):
    return torch.cat([z.reshape(z.shape[0], -1), log_det[:, None]], 1)


def _unpack(packed, event):
    return packed[:, :-1].reshape(packed.shape[0], *event), packed[:, -1]


def _contexts(context, batch: int, m: int, mb: int):
    """Microbatch ``m``'s context: its rows of a per-sample one, else the
    whole."""
    if context is not None and context.dim() >= 2 and context.shape[0] == batch:
        return context[m * mb:(m + 1) * mb]
    return context


def _forward(st: _Stages, z, context, keep: bool):
    """The forward schedule: ``(z, log_det)`` replicated on every stage, and
    with ``keep`` each microbatch's ``(input, z, log_det)`` on this stage,
    their graph kept for :func:`_backward`."""
    batch, event = z.shape[0], tuple(z.shape[1:])
    M = st.microbatches
    if batch % M != 0:
        raise ValueError(f"batch {batch} not divisible by {M} microbatches")
    mb = batch // M
    like = z.new_empty(mb, math.prod(event) + 1)
    kept, outs = [], []
    for m in range(M):
        if st.stage == 0:
            x, ld = z[m * mb:(m + 1) * mb], z.new_zeros(mb)
        else:
            x, ld = _unpack(st.hop(None, st.stage - 1, st.stage, like), event)
        with torch.set_grad_enabled(keep):
            x = x.detach().requires_grad_(keep)
            y, l = st.run_layers(x, ld, _contexts(context, batch, m, mb))
        if tuple(y.shape[1:]) != event:
            raise ValueError(f"a pipelined layer changed the event shape {event} to "
                             f"{tuple(y.shape[1:])}")
        if keep:
            kept.append((x, y, l))
        if st.stage < st.stages - 1:
            st.hop(_pack(y.detach(), l.detach()), st.stage, st.stage + 1, like)
        else:
            outs.append(_pack(y.detach(), l.detach()))
    last = st.stages - 1
    whole = st.everywhere(torch.cat(outs) if st.stage == last else None, last,
                          z.new_empty(batch, like.shape[1]))
    out_z, out_ld = _unpack(whole, event)
    return out_z, out_ld, kept


def _backward(st: _Stages, kept, params, g_z, g_ld, input_grad: bool):
    """The backward schedule: the gradients of this stage's ``params`` and,
    with ``input_grad``, of the input on every stage."""
    M = st.microbatches
    mb = g_z.shape[0] // M
    grads = [None] * len(params)
    g_in = [None] * M
    for m in reversed(range(M)):
        x, y, l = kept[m]
        if st.stage == st.stages - 1:
            g_y = g_z[m * mb:(m + 1) * mb]
        else:
            g_y = st.hop(None, st.stage + 1, st.stage, y)
        got = torch.autograd.grad((y, l), (x, *params), (g_y, g_ld[m * mb:(m + 1) * mb]),
                                  allow_unused=True)
        grads = [a if b is None else b if a is None else a + b
                 for a, b in zip(grads, got[1:])]
        g_x = got[0] if got[0] is not None else torch.zeros_like(x)
        if st.stage > 0:
            st.hop(g_x, st.stage, st.stage - 1, x)
        else:
            g_in[m] = g_x
    g_input = None
    if input_grad:
        g_input = st.everywhere(torch.cat(g_in) if st.stage == 0 else None, 0, g_z)
    return g_input, grads


class _Pipelined(torch.autograd.Function):
    """The schedule as one differentiable call: inputs ``z`` and this stage's
    parameters, outputs the replicated ``(z, log_det)``."""

    @staticmethod
    def forward(ctx, st, z, context, *params):
        out_z, out_ld, kept = _forward(st, z, context, keep=True)
        ctx.st, ctx.kept, ctx.params = st, kept, params
        return out_z, out_ld

    @staticmethod
    def backward(ctx, g_z, g_ld):
        g_input, grads = _backward(ctx.st, ctx.kept, ctx.params, g_z.contiguous(),
                                   g_ld.contiguous(), ctx.needs_input_grad[1])
        ctx.kept = None
        return (None, g_input, None, *grads)


def _apply(st: _Stages, z, context=None):
    if context is not None and context.requires_grad:
        raise ValueError("the pipeline does not differentiate its context; detach it")
    params = [p for layer in st.layers for p in layer.parameters() if p.requires_grad]
    if torch.is_grad_enabled() and (z.requires_grad or params):
        return _Pipelined.apply(st, z, context, *params)
    with torch.no_grad():
        out_z, out_ld, _ = _forward(st, z, context, keep=False)
    return out_z, out_ld


def make_pipeline_apply(layers, mesh: DeviceMesh, stage_axis: str = "stage",
                        num_microbatches: Optional[int] = None, reverse: bool = False):
    """``apply(z, context=None) -> (z, log_det)``: the homogeneous ``layers``
    (the caller's modules; each rank runs its stage's) as a pipeline over
    ``mesh``'s ``stage_axis``, the result replicated on every stage rank and
    differentiable (module docstring).  ``reverse=True`` pipelines the
    inverse: the layers' order reversed, each calling ``inverse``.  Layers
    that differ in their tensors or settings raise, and so do a depth the
    stages do not divide and, at the call, a batch the microbatches do not
    divide.  ``apply.stages`` holds this rank's stage (its layers, and
    ``counts``, the broadcasts it took part in)."""
    st = _Stages(layers, mesh, stage_axis, num_microbatches, reverse)

    def apply(z, context=None):
        return _apply(st, z, context)

    apply.stages = st
    return apply


class PipelineModel(nn.Module):
    """A pipeline stage's part of a ``NormalizingFlow``: its stage's layers
    under their names in the flow (``flows.<i>``, in the order they run) and
    the base ``q0`` and target ``p``, replicated.  Where there is more than
    one stage its state differs across the ranks (``differs_across_ranks``),
    and ``training.save_checkpoint`` writes every stage's layers."""

    def __init__(self, flows: dict, q0: nn.Module, p: Optional[nn.Module], stages: int):
        super().__init__()
        self.flows = nn.ModuleDict(flows)
        self.q0 = q0
        self.p = p
        self.differs_across_ranks = stages > 1


def make_pipeline_train_step(model: nn.Module, optimizer, mesh: DeviceMesh,
                             stage_axis: str = "stage",
                             num_microbatches: Optional[int] = None,
                             objective: str = "forward_kld", num_samples: int = 64):
    """Pipelined training step over ``model``'s homogeneous flows:
    ``(state, step_fn)`` with ``step_fn(state, batch=None, generator=None) ->
    (state, metrics)`` as ``training.make_train_step``'s.

    ``objective="forward_kld"``: the density direction (``inverse``) is
    pipelined and the base ``log_prob`` runs on the replicated result;
    ``"reverse_kld"``: ``num_samples`` base draws from ``generator``
    (seeded alike on every rank), the pipelined forward pass and the target's
    ``log_prob`` (pass ``batch=None``).  ``state.model`` is a
    :class:`PipelineModel` holding copies of this stage's layers and of
    ``q0`` and ``p``, with the first rank's values, and the optimizer
    (``optimizer(params)``, a factory) holds the moments of this stage's
    layers and of the replicated ``q0`` and ``p`` only.
    ``metrics["collectives"]`` counts the stage axis' broadcasts of the
    step."""
    if objective not in ("forward_kld", "reverse_kld"):
        raise ValueError(f"unknown objective {objective!r}")
    reverse = objective == "forward_kld"
    model = copy.deepcopy(model)
    broadcast_([*model.parameters(), *model.buffers()], mesh)
    st = _Stages(model.flows, mesh, stage_axis, num_microbatches, reverse)
    part = PipelineModel({str(i): layer for i, layer in zip(st.indices, st.layers)},
                         model.q0, model.p, st.stages)
    opt = build_optimizer(optimizer, list(part.parameters()))

    def loss_fn(m: PipelineModel, batch, generator):
        if objective == "forward_kld":
            z, log_det = _apply(st, batch)
            return -torch.mean(log_det + m.q0.log_prob(z))
        z, log_q = m.q0.sample_and_log_prob(num_samples, generator=generator)
        z, log_det = _apply(st, z)
        return torch.mean(log_q - log_det) - torch.mean(m.p.log_prob(z))

    state, step = eager_step(part, opt, loss_fn, lambda loss: loss)

    def step_fn(state, batch=None, generator: Optional[torch.Generator] = None):
        st.counts.clear()
        state, metrics = step(state, batch, generator)
        metrics["collectives"] = {stage_axis: dict(st.counts)}
        return state, metrics

    return state, step_fn
