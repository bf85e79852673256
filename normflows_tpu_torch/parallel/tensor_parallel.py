"""Tensor (model-axis) and FSDP parameter sharding (port of
``normflows_tpu/parallel/tensor_parallel.py``).

The JAX package annotates parameter placements and lets XLA's partitioner
insert the collectives.  The port places the sharded leaves itself, as
``torch.distributed.tensor.DTensor`` parameters (``Shard(dim)`` along the
sharding axis of the mesh, ``Replicate()`` along the others: a rank holds
its block of the tensor), computes on their local blocks, and writes the
collectives out.  The steps build their optimizer on those parameters, so
Adam's moments are DTensors of the same placements, and
``training.save_checkpoint`` writes such state shard by shard
(``torch.distributed.checkpoint``).

**Tensor parallelism** (:func:`tp_shardings`, :func:`make_tensor_parallel_step`),
the Megatron pattern of the JAX package, per parameter net:

* ``MLP``: ``linears`` alternate column- and row-parallel.
* ``MADE``: ``initial_layer``, ``context_layer`` and the blocks' GLU
  ``context_layer`` replicated; each ``MaskedResidualBlock`` the
  (``linear_0`` column, ``linear_1`` row) pair; ``MaskedFeedforwardBlock``s
  alternate column and row; ``final_layer`` row-parallel.
* ``ConvNet2d``: convolutions alternate out-channel (column) and in-channel
  (row) sharding; its ``NetActNorm``s stay replicated.
* Everything else is replicated.  A dim the axis does not divide, or one
  narrower than ``min_dim``, leaves its layer replicated.

The port stores weights (out, in), so a column-parallel layer splits dim 0
of its weight, its bias and its mask (``MaskedLinear``'s mask is split with
its weight), and a row-parallel one dim 1 of its weight and mask, its bias
replicated; convolutions are OIHW on both sides.  The collectives:

* a column-parallel layer's replicated input passes an identity whose
  backward sums its gradient over the model axis (Megatron's f: each rank's
  rows of the weight saw the whole input);
* a row-parallel layer's partial product is summed over the axis before its
  bias (Megatron's g), so the net's output is a replicated plain tensor and
  no kernel operator sees a DTensor;
* a row-parallel layer whose input is replicated (a MADE's ``final_layer``
  after residual blocks) takes its rank's slice, whose backward all-gathers
  the gradient; a column-parallel layer that ends its net all-gathers its
  output; a replicated ``NetActNorm`` on a sharded activation takes its
  channels' slice of its parameters alike.

A MADE pass of one residual block thus costs two all-reduces forward and an
all-reduce and an all-gather backward.  The fused MADE
(``ops.backend.set_made_fusion``) computes on whole weights: building a
tensor-parallel step with it on and a MADE sharded raises, and so does a
sharded MADE's pass once it is turned on.  Dropout draws a mask a shard,
which no single-process run draws, so a sharded net with dropout raises.

**FSDP** (:func:`fsdp_shardings`, :func:`make_fsdp_step`): every parameter
of at least ``min_size`` elements is split over ``axis`` along its largest
dim the axis divides; buffers and small leaves stay replicated.  A step
gathers each sharded leaf whole when the loss runs (one all-gather a leaf,
all before the loss: ZeRO-3 at the granularity of a step) and calls the
loss on the model with the whole tensors in place
(``torch.func.functional_call``), so that any method of the model
(``reverse_kld``, ``forward_kld``, ``sample``) takes part; the backward
reduce-scatters each leaf's gradient, the sum over the axis' ranks divided
by their number.  Parameters and moments a rank are the sharded leaves'
1/n plus the small ones'.

Both steps keep ``training.make_train_step``'s ``(state, step_fn)`` idiom.
The batch is this rank's rows of the ``data`` axis (``shard_batch``) where
the mesh has one; the loss and every gradient not already averaged over it
are averaged over it (``data_parallel.average_over``).  The step works on a
copy of the caller's model, made rank 0's on every rank, so that the
caller's model stays usable; the optimizer is built on the copy's
parameters by a factory (``params -> optimizer``, given two parameter
groups, the DTensors and the plain tensors).  ``metrics["collectives"]`` counts
each axis' collectives of the step by kind.
"""

from __future__ import annotations

import copy
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..nets.cnn import Conv2d, ConvNet2d, NetActNorm
from ..nets.made import MADE, MaskedLinear, MaskedResidualBlock
from ..nets.mlp import MLP, Linear
from ..ops import backend
from ..training.loop import build_optimizer, eager_step
from .data_parallel import average_over
from .mesh import broadcast_

__all__ = [
    "tp_shardings",
    "fsdp_shardings",
    "make_tensor_parallel_step",
    "make_fsdp_step",
]


@dataclass(eq=False)
class MeshAxis:
    """One axis of a mesh as its collectives see it: the process group, this
    rank's coordinate along it, the ranks along it, and the count of each
    kind of collective issued on it since the step began."""

    group: object
    rank: int
    size: int
    counts: Counter = field(default_factory=Counter)

    @classmethod
    def of(cls, mesh: DeviceMesh, name: str) -> "MeshAxis":
        if name not in mesh.mesh_dim_names:
            raise ValueError(f"mesh axes are {mesh.mesh_dim_names}, not {name!r}")
        return cls(mesh.get_group(name), mesh.get_local_rank(name),
                   mesh.size(mesh.mesh_dim_names.index(name)))


def _all_reduce(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    axis.counts["all_reduce"] += 1
    dist.all_reduce(t, group=axis.group)
    return t


def _all_gather(t: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    axis.counts["all_gather"] += 1
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim)


def _reduce_scatter(t: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    axis.counts["reduce_scatter"] += 1
    parts = [p.contiguous() for p in t.chunk(axis.size, dim)]
    out = torch.empty_like(parts[axis.rank])
    dist.reduce_scatter(out, parts, group=axis.group)
    return out


def _block(t: torch.Tensor, dim: int, axis: MeshAxis) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (a copy)."""
    return t.chunk(axis.size, dim)[axis.rank].contiguous()


class _EnterModel(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the gradient
    over the axis (each rank's block of a column-parallel weight saw the
    whole input)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.axis), None


class _SumOverModel(torch.autograd.Function):
    """Megatron's g: the partial products of a row-parallel layer summed over
    the axis; the identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _BlockOf(torch.autograd.Function):
    """This rank's block of a replicated tensor along ``dim``; the backward
    all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _block(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.axis), None, None


class _Gathered(torch.autograd.Function):
    """The whole tensor from the ranks' blocks along ``dim``; the backward
    keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.axis), None, None


class _GatheredShard(torch.autograd.Function):
    """An FSDP leaf whole from its shards (all-gather); the backward
    reduce-scatters its gradient and divides by the ranks: this rank's block
    of the mean over them."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.axis) / ctx.axis.size, None, None


def _local(t):
    """A DTensor's local block (differentiable); any other tensor as is."""
    return t.to_local() if isinstance(t, DTensor) else t


# ---- the sharded layers: the nets' own classes with the collectives ----

def _local_weight(layer):
    w = _local(layer.weight)
    return w * _local(layer.mask) if isinstance(layer, MaskedLinear) else w


class _ColumnParallel:
    """A column-parallel ``Linear`` / ``MaskedLinear``: this rank's rows of
    its weight, bias and mask, a replicated input, a feature-sharded output
    (all-gathered where ``tp_gather``: the layer ends its net)."""

    def forward(self, x):
        y = self.finish(self.product(_EnterModel.apply(x, self.tp_axis), _local_weight(self)),
                        _local(self.bias), x.dtype)
        return _Gathered.apply(y, -1, self.tp_axis) if self.tp_gather else y

    def apply_t(self, x_t):
        y = self.finish_t(self.product_t(_EnterModel.apply(x_t, self.tp_axis),
                                         _local_weight(self)), _local(self.bias))
        return _Gathered.apply(y, 0, self.tp_axis) if self.tp_gather else y


class _RowParallel:
    """A row-parallel ``Linear`` / ``MaskedLinear``: this rank's columns of
    its weight and mask, its bias replicated and added after the sum over
    the axis; its input feature-sharded, or replicated and sliced where
    ``tp_input_sharded`` is False."""

    def forward(self, x):
        dtype = x.dtype
        if not self.tp_input_sharded:
            x = _BlockOf.apply(x, -1, self.tp_axis)
        y = _SumOverModel.apply(self.product(x, _local_weight(self)), self.tp_axis)
        return self.finish(y, self.bias, dtype)

    def apply_t(self, x_t):
        if not self.tp_input_sharded:
            x_t = _BlockOf.apply(x_t, 0, self.tp_axis)
        y = _SumOverModel.apply(self.product_t(x_t, _local_weight(self)), self.tp_axis)
        return self.finish_t(y, self.bias)


class ColumnParallelLinear(_ColumnParallel, Linear):
    pass


class RowParallelLinear(_RowParallel, Linear):
    pass


class ColumnParallelMaskedLinear(_ColumnParallel, MaskedLinear):
    pass


class RowParallelMaskedLinear(_RowParallel, MaskedLinear):
    pass


class ColumnParallelConv2d(Conv2d):
    """An out-channel-sharded ``Conv2d`` (OIHW dim 0 and its bias)."""

    def forward(self, x):
        y = self.convolve(_EnterModel.apply(x, self.tp_axis), _local(self.weight),
                          _local(self.bias))
        return _Gathered.apply(y, 1, self.tp_axis) if self.tp_gather else y


class RowParallelConv2d(Conv2d):
    """An in-channel-sharded ``Conv2d`` (OIHW dim 1), its bias added after
    the sum over the axis."""

    def forward(self, x):
        if not self.tp_input_sharded:
            x = _BlockOf.apply(x, 1, self.tp_axis)
        y = _SumOverModel.apply(self.convolve(x, _local(self.weight), None), self.tp_axis)
        return y + self.bias[None, :, None, None].to(y.dtype) if self.bias is not None else y


class ShardedInputActNorm(NetActNorm):
    """A replicated ``NetActNorm`` after an out-channel-sharded convolution:
    its channels' slice of ``s`` and ``t`` (whose backward all-gathers the
    gradient, so that the replicated parameters get all of it)."""

    def forward(self, x):
        s = _BlockOf.apply(self.s, 1, self.tp_axis)
        t = _BlockOf.apply(self.t, 1, self.tp_axis)
        return x * torch.exp(s).to(x.dtype) + t.to(x.dtype)


class TensorParallelMADE(MADE):
    """A MADE whose hidden layers are sharded: never fused."""

    def fuses(self, x, context=None) -> bool:
        if backend.made_fusion_enabled():
            raise RuntimeError("the fused MADE computes on whole weights and must stay off "
                               "under a model axis (ops.backend.set_made_fusion(False))")
        return False


_ROLE_CLASSES = {("column", MaskedLinear): ColumnParallelMaskedLinear,
                 ("row", MaskedLinear): RowParallelMaskedLinear,
                 ("column", Linear): ColumnParallelLinear,
                 ("row", Linear): RowParallelLinear,
                 ("column", Conv2d): ColumnParallelConv2d,
                 ("row", Conv2d): RowParallelConv2d,
                 ("actnorm", NetActNorm): ShardedInputActNorm,
                 ("made", MADE): TensorParallelMADE}
# the dim a role splits, by tensor: column-parallel layers their outputs,
# row-parallel ones their inputs
_SPLIT = {("column", "weight"): 0, ("column", "bias"): 0, ("column", "mask"): 0,
          ("row", "weight"): 1, ("row", "mask"): 1}


def _join(*parts) -> str:
    return ".".join(p for p in parts if p)


def _tp_plan(model: nn.Module, size: int, min_dim: int) -> dict:
    """``{module path: (role, flag)}`` of the layers the rules shard: role
    ``column`` (flag: it ends its net, so gathers its output), ``row``
    (flag: its input arrives sharded), ``actnorm`` (a NetActNorm on a
    sharded activation) or ``made`` (a MADE with sharded layers)."""

    def fits(dim: int) -> bool:
        return dim % size == 0 and dim >= min_dim

    plan = {}
    for path, m in model.named_modules():
        if type(m) in (MLP, ConvNet2d):
            layers = list(m.linears if type(m) is MLP else m.convs)
            prefix = _join(path, "linears" if type(m) is MLP else "convs")
            for i, layer in enumerate(layers):
                if i % 2 == 0 and fits(layer.weight.shape[0]):
                    plan[f"{prefix}.{i}"] = ("column", i == len(layers) - 1)
                    if type(m) is ConvNet2d and m.actnorms is not None and i < len(layers) - 1:
                        plan[_join(path, f"actnorms.{i}")] = ("actnorm", None)
                elif i % 2 == 1 and fits(layer.weight.shape[1]):
                    # its input is the column-parallel output before it
                    plan[f"{prefix}.{i}"] = ("row", True)
            if type(m) is MLP and m.dropout_rate is not None and any(
                    f"{prefix}.{i}" in plan for i in range(len(layers))):
                raise ValueError(f"{path or 'the model'}: dropout in a sharded MLP draws a "
                                 f"mask a shard; not under tensor parallelism")
        elif type(m) is MADE and fits(m.hidden_features):
            plan[path] = ("made", None)
            sharded = False  # whether the stream between blocks is sharded
            for i, block in enumerate(m.blocks):
                if block.dropout_probability > 0.0:
                    raise ValueError(f"{path}: dropout in a sharded MADE draws a mask a "
                                     f"shard; not under tensor parallelism")
                b = _join(path, f"blocks.{i}")
                if isinstance(block, MaskedResidualBlock):
                    plan[f"{b}.linear_0"] = ("column", False)
                    plan[f"{b}.linear_1"] = ("row", True)
                else:
                    sharded = i % 2 == 0
                    plan[f"{b}.linear"] = ("column", False) if sharded else ("row", True)
            plan[_join(path, "final_layer")] = ("row", sharded)
    return plan


def _placements(mesh: DeviceMesh, axis: str, dim: Optional[int]) -> tuple:
    """``Shard(dim)`` along ``axis`` (None: replicated), ``Replicate()``
    along the other axes of ``mesh``."""
    return tuple(Shard(dim) if name == axis and dim is not None else Replicate()
                 for name in mesh.mesh_dim_names)


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes are {mesh.mesh_dim_names}, not {axis!r}")
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _tensors(model: nn.Module):
    return [*model.named_parameters(), *model.named_buffers()]


def tp_shardings(model: nn.Module, mesh: DeviceMesh, model_axis: str = "model",
                 min_dim: int = 32) -> dict:
    """The placements of every parameter and buffer of ``model`` under the
    tensor-parallel rules (module docstring): ``{name: placements}``, a
    ``DTensor`` placement a mesh axis, ``Shard(d)`` along ``model_axis``
    for the sharded leaves (the counterpart of the JAX package's
    ``NamedSharding`` tree)."""
    return _tp_placements(model, mesh, model_axis,
                          _tp_plan(model, _axis_size(mesh, model_axis), min_dim))


def _tp_placements(model, mesh, model_axis, plan) -> dict:
    out = {}
    for name, _ in _tensors(model):
        owner, _, attr = name.rpartition(".")
        out[name] = _placements(mesh, model_axis, _SPLIT.get((plan.get(owner, ("",))[0], attr)))
    return out


def fsdp_shardings(model: nn.Module, mesh: DeviceMesh, axis: str = "data",
                   min_size: int = 2 ** 14) -> dict:
    """``{name: placements}``: each parameter of at least ``min_size``
    elements split over ``axis`` along its largest dim that the axis
    divides (the first of equal ones); buffers, small leaves and leaves no
    dim of which the axis divides replicated."""
    size = _axis_size(mesh, axis)
    out = {}
    for name, p in model.named_parameters():
        dim = None
        if p.numel() >= min_size:
            dim = next((d for d in sorted(range(p.dim()), key=lambda d: -p.shape[d])
                        if p.shape[d] % size == 0 and p.shape[d] >= size), None)
        out[name] = _placements(mesh, axis, dim)
    for name, _ in model.named_buffers():
        out[name] = _placements(mesh, axis, None)
    return out


def sharded_dim(placements, mesh: DeviceMesh, axis: str) -> Optional[int]:
    """The tensor dim ``placements`` split along ``axis`` (None: none)."""
    p = placements[mesh.mesh_dim_names.index(axis)]
    return p.dim if isinstance(p, Shard) else None


def _sharded_copy(model: nn.Module, mesh: DeviceMesh, shardings: dict) -> nn.Module:
    """A copy of ``model`` holding rank 0's values, each leaf that
    ``shardings`` splits a DTensor of this rank's block (a parameter stays a
    parameter)."""
    out = copy.deepcopy(model)
    broadcast_([t for _, t in _tensors(out)], mesh)
    coords = {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}
    with torch.no_grad():
        for name, t in _tensors(out):
            placements = shardings[name]
            if not any(isinstance(p, Shard) for p in placements):
                continue
            local = t
            for axis, p in zip(mesh.mesh_dim_names, placements):
                if isinstance(p, Shard):
                    n = mesh.size(mesh.mesh_dim_names.index(axis))
                    local = local.chunk(n, p.dim)[coords[axis]]
            dt = DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                                    shape=t.shape, stride=t.stride())
            owner, _, attr = name.rpartition(".")
            module = out.get_submodule(owner)
            if isinstance(t, nn.Parameter):
                setattr(module, attr, nn.Parameter(dt, requires_grad=t.requires_grad))
            else:
                module._buffers[attr] = dt
    return out


def _sharded_step(model: nn.Module, optimizer, loss_fn: Callable, mesh: DeviceMesh,
                  axes: dict):
    """``(state, step_fn)`` of the eager step (``training.loop.eager_step``)
    on the sharded ``model``, whose collectives count on ``axes`` (``{mesh
    axis: MeshAxis}``); the loss and the gradients of the parameters not
    sharded over ``data`` averaged over it where the mesh has it."""
    params = list(model.parameters())
    groups = [{"params": ps} for ps in ([p for p in params if isinstance(p, DTensor)],
                                        [p for p in params if not isinstance(p, DTensor)]) if ps]
    opt = build_optimizer(optimizer, groups)

    def reduce(loss):
        return loss

    if "data" in mesh.mesh_dim_names:
        data = axes.setdefault("data", MeshAxis.of(mesh, "data"))
        averaged = [p for p in params if not isinstance(p, DTensor)
                    or sharded_dim(p.placements, mesh, "data") is None]
        reduce = average_over(mesh, "data", averaged, data.counts)
    state, step = eager_step(model, opt, loss_fn, reduce)

    def step_fn(state, batch, generator: Optional[torch.Generator] = None):
        for axis in axes.values():
            axis.counts.clear()
        state, metrics = step(state, batch, generator)
        metrics["collectives"] = {name: dict(axis.counts) for name, axis in axes.items()}
        return state, metrics

    return state, step_fn


def make_tensor_parallel_step(model: nn.Module, optimizer, loss_fn: Callable,
                              mesh: DeviceMesh, model_axis: str = "model", min_dim: int = 32):
    """Tensor-parallel training step: ``(state, step_fn)`` with
    ``step_fn(state, batch, generator=None) -> (state, metrics)`` as
    ``training.make_train_step``'s; ``loss_fn(model, batch, generator)``
    runs on ``state.model``, a copy of ``model`` whose wide parameter-net
    layers are sharded over ``model_axis`` (module docstring).
    ``optimizer(params)`` builds the optimizer (module docstring)."""
    plan = _tp_plan(model, _axis_size(mesh, model_axis), min_dim)
    if backend.made_fusion_enabled() and any(role == "made" for role, _ in plan.values()):
        raise RuntimeError("the fused MADE computes on whole weights and must stay off under "
                           "a model axis (ops.backend.set_made_fusion(False))")
    out = _sharded_copy(model, mesh, _tp_placements(model, mesh, model_axis, plan))
    axis = MeshAxis.of(mesh, model_axis)
    for path, (role, flag) in plan.items():
        module = out.get_submodule(path)
        base = next(b for r, b in _ROLE_CLASSES if r == role and isinstance(module, b))
        module.__class__ = _ROLE_CLASSES[(role, base)]
        module.tp_axis = axis
        if role == "column":
            module.tp_gather = flag
        elif role == "row":
            module.tp_input_sharded = flag
    return _sharded_step(out, optimizer, loss_fn, mesh, {model_axis: axis})


class _Call(nn.Module):
    """``fn(model, *args)`` as a module's forward, for
    ``torch.func.functional_call``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


def make_fsdp_step(model: nn.Module, optimizer, loss_fn: Callable, mesh: DeviceMesh,
                   axis: str = "data", min_size: int = 2 ** 14):
    """FSDP training step: ``(state, step_fn)`` as
    :func:`make_tensor_parallel_step`'s, the parameters of at least
    ``min_size`` elements (and their moments) sharded over ``axis``,
    gathered whole for each loss and their gradients reduce-scattered
    (module docstring)."""
    shardings = fsdp_shardings(model, mesh, axis, min_size)
    out = _sharded_copy(model, mesh, shardings)
    along = MeshAxis.of(mesh, axis)
    sharded = [(name, p, sharded_dim(p.placements, mesh, axis))
               for name, p in out.named_parameters() if isinstance(p, DTensor)]
    call = _Call(out)

    def gathered_loss(m, batch, generator):
        whole = {f"model.{name}": _GatheredShard.apply(p.to_local(), dim, along)
                 for name, p, dim in sharded}
        return torch.func.functional_call(call, whole, (loss_fn, batch, generator))

    return _sharded_step(out, optimizer, gathered_loss, mesh, {axis: along})
