"""Training checkpoints (port of ``normflows_tpu/training/checkpoint.py``).

The JAX package writes orbax pytree checkpoints; the port writes one
``torch.save`` file of plain containers and tensors, read back with
``torch.load(..., weights_only=True)``, so that loading one runs no pickled
code.  A checkpoint holds ``obj`` turned into such containers: a module
becomes its state dict, an optimizer its state dict, a :class:`TrainState`
``{"model", "optimizer", "step"}`` (the whole training state), a
``torch.Generator`` its state, a tensor a CPU copy; dicts, lists and tuples
recurse, and numbers, strings and None stay.

Restoring walks a template ``like`` of the same structure and writes the
saved values into it in place: a module with
``core.facades.copy_tensors_like``'s checks (each tensor converted to the
module's dtype, the first name or shape that differs named), an optimizer's
state tensors copied into the ones it holds (or, where it holds none yet,
through ``load_state_dict``; its hyperparameters restored, its device
flags such as ``capturable`` kept), a tensor by ``copy_``, a generator by
``set_state``.  Writing in place keeps every address, so a chunk captured
in a CUDA graph (``training.make_step_chunk``) trains on from the restored
values.

In a ``torch.distributed`` world whose state is replicated, rank 0 writes,
every rank waits on a barrier, and every rank restores from the file.

State that differs across the ranks goes through
``torch.distributed.checkpoint`` instead: state holding ``DTensor``s (the
sharded steps of ``parallel``: tensor parallelism, FSDP), and a pipeline
stage's part of a flow (``parallel.pipeline.PipelineModel``, whose layers
keep their names in the whole flow, ``flows.<i>``).  Every rank writes its
own blocks and tensors into the checkpoint's directory (one tensor's
replicas once), and a restore reads into the template's tensors whatever
blocks their placements and names ask for, so that state saved on one
layout restores onto another (tensor-parallel state onto FSDP's, onto a
mesh of other sizes, onto plain tensors in a single process; a pipeline's
stages into the whole flow).  Such a
checkpoint keys the optimizer's state by the parameters' names, so that the
layouts need not agree on the order or the groups of the parameters, and
keeps one set of hyperparameters (the groups must agree on them).  A
template optimizer without state gets it first (a step of zero learning
rate on zero gradients), so that there is a tensor to read into.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch import nn
from torch.distributed.tensor import DTensor

from ..core.facades import copy_tensors_like
from .loop import TrainState

FORMAT = "normflows_tpu_torch checkpoint 1"


def _tree(obj):
    """``obj`` as plain containers of CPU tensors."""
    if isinstance(obj, TrainState):
        return {"model": _tree(obj.model), "optimizer": _tree(obj.optimizer),
                "step": _tree(obj.step)}
    if isinstance(obj, (nn.Module, torch.optim.Optimizer)):
        return _tree(dict(obj.state_dict()))
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree(v) for v in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"a checkpoint cannot hold a {type(obj).__name__}")


def _file(path: str, step: Optional[int]) -> str:
    path = os.path.abspath(path)
    return path if step is None else os.path.join(path, str(int(step)))


def _writes() -> bool:
    """Whether this process writes: the only one, or rank 0 of a
    ``torch.distributed`` world (whose state is replicated)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _written():
    """In a world of processes, every rank waits here until rank 0 has
    written, so that a restore after it finds the file."""
    if dist.is_initialized():
        dist.barrier()


def _write(target: str, obj):
    os.makedirs(os.path.dirname(target), exist_ok=True)
    torch.save({"format": FORMAT, "tree": _tree(obj)}, target + ".tmp")
    os.replace(target + ".tmp", target)


def _per_rank(obj) -> bool:
    """Whether ``obj`` holds state that differs across the ranks: DTensors,
    or a module that says so (``differs_across_ranks``: a pipeline stage's
    part of a flow)."""
    if isinstance(obj, TrainState):
        return _per_rank(obj.model) or _per_rank(obj.optimizer)
    if isinstance(obj, nn.Module):
        return any(getattr(m, "differs_across_ranks", False) for m in obj.modules()) or any(
            isinstance(t, DTensor) for t in [*obj.parameters(), *obj.buffers()])
    if isinstance(obj, torch.optim.Optimizer):
        return any(isinstance(p, DTensor) for g in obj.param_groups for p in g["params"])
    if isinstance(obj, dict):
        return any(_per_rank(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_per_rank(v) for v in obj)
    return isinstance(obj, DTensor)


def _zero_lr_step(opt: torch.optim.Optimizer):
    """Give every parameter of ``opt`` its state: one step at learning rate
    0 on zero gradients, each learning rate and gradient restored after."""
    params = [p for g in opt.param_groups for p in g["params"]]
    grads = [p.grad for p in params]
    lrs = [g["lr"] for g in opt.param_groups]
    with torch.no_grad():
        for g in opt.param_groups:
            g["lr"] = g["lr"].clone().zero_() if isinstance(g["lr"], torch.Tensor) else 0.0
        for p in params:
            p.grad = torch.zeros_like(p)
        opt.step()
    for g, lr in zip(opt.param_groups, lrs):
        g["lr"] = lr
    for p, grad in zip(params, grads):
        p.grad = grad


def _optimizer_tree(opt: torch.optim.Optimizer, model: Optional[nn.Module], where: str):
    """The optimizer's state keyed by parameter name (``model``'s names, or
    the parameters' places in ``opt``), and its hyperparameters."""
    params = [p for g in opt.param_groups for p in g["params"]]
    names = {id(p): n for n, p in model.named_parameters()} if model is not None else {}
    hyper = [{k: v for k, v in g.items() if k not in _HOW_IT_RUNS} for g in opt.param_groups]
    if any(h.keys() != hyper[0].keys() or any(
            not _same(h[k], hyper[0][k]) for k in h) for h in hyper):
        raise ValueError(f"{where}: a sharded checkpoint keeps one set of hyperparameters, "
                         f"and the optimizer's groups differ")
    return {"state": {names.get(id(p), str(i)): opt.state[p] for i, p in enumerate(params)},
            "hyperparameters": hyper[0]}


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    return a == b


def _sharded_tree(obj, where: str, model: Optional[nn.Module] = None):
    """``obj`` as the nested dicts ``torch.distributed.checkpoint`` reads and
    writes, its tensors the live ones (a module's ``state_dict``, the
    optimizer's state), so that a load writes them in place."""
    if isinstance(obj, TrainState):
        return {"model": _sharded_tree(obj.model, where),
                "optimizer": _sharded_tree(obj.optimizer, where, obj.model), "step": obj.step}
    if isinstance(obj, nn.Module):
        return dict(obj.state_dict())
    if isinstance(obj, torch.optim.Optimizer):
        return _optimizer_tree(obj, model, where)
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if isinstance(obj, dict):
        return {k: _sharded_tree(v, where) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return {str(i): _sharded_tree(v, where) for i, v in enumerate(obj)}
    if isinstance(obj, torch.Tensor) or obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"a checkpoint cannot hold a {type(obj).__name__}")


def _save_sharded(target: str, obj):
    """Every rank writes its blocks into ``target + ".tmp"``; rank 0 moves
    the directory into place once all have."""
    tree = _sharded_tree(obj, f"checkpoint at {target}")
    tmp = target + ".tmp"
    if _writes() and os.path.exists(tmp):
        shutil.rmtree(tmp)
    _written()
    dcp.save(tree, checkpoint_id=tmp, no_dist=not dist.is_initialized())
    _written()
    if _writes():
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.replace(tmp, target)
    _written()


def _is_sharded(target: str) -> bool:
    return os.path.isfile(os.path.join(target, ".metadata"))


def _restore_sharded(like, target: str, where: str):
    """Read the checkpoint at ``target`` into the tensors of ``like`` (an
    optimizer without state gets it first), then set what is not a tensor:
    the hyperparameters, step counts, numbers, generators."""
    def prepare(x):
        if isinstance(x, TrainState):
            prepare(x.optimizer)
        elif isinstance(x, torch.optim.Optimizer):
            if not all(x.state.get(p) for g in x.param_groups for p in g["params"]):
                _zero_lr_step(x)
        elif isinstance(x, dict):
            for v in x.values():
                prepare(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                prepare(v)

    prepare(like)
    tree = _sharded_tree(like, where)
    dcp.load(tree, checkpoint_id=target, no_dist=not dist.is_initialized())
    return _settle(like, tree, where)


def _settle(like, tree, where: str):
    """What a load into :func:`_sharded_tree`'s tensors leaves to set."""
    if isinstance(like, TrainState):
        _settle(like.optimizer, tree["optimizer"], where)
        like.step = tree["step"]
        return like
    if isinstance(like, torch.optim.Optimizer):
        for g in like.param_groups:
            for k, v in tree["hyperparameters"].items():
                if isinstance(g.get(k), torch.Tensor):
                    g[k].copy_(torch.as_tensor(v))
                else:
                    g[k] = v
        return like
    if isinstance(like, torch.Generator):
        like.set_state(tree)
        return like
    if isinstance(like, dict):
        for k in like:
            like[k] = _settle(like[k], tree[k], f"{where}[{k!r}]")
        return like
    if isinstance(like, (list, tuple)):
        values = [_settle(v, tree[str(i)], f"{where}[{i}]") for i, v in enumerate(like)]
        if isinstance(like, tuple):
            return tuple(values)
        like[:] = values
        return like
    if isinstance(like, (nn.Module, torch.Tensor)):
        return like
    return tree


def save_checkpoint(path: str, obj, step: Optional[int] = None):
    """Write ``obj`` (a model, an optimizer, a ``TrainState``, or dicts,
    lists and tuples of them, tensors, generators and numbers) to ``path``;
    with ``step``, to ``path/<step>``, so that successive saves are
    versioned.  The file is written whole, then moved into place.

    In a data-parallel world (``parallel``), whose training state is the
    same on every rank, rank 0 writes and every rank waits on a barrier
    until it has; every rank then restores from the one file.  State that
    differs across the ranks (DTensors, a pipeline stage's part) is written
    by every rank, as a directory (``torch.distributed.checkpoint``; module
    docstring)."""
    target = _file(path, step)
    if _per_rank(obj):
        _save_sharded(target, obj)
        return
    if _writes():
        _write(target, obj)
    _written()


def _load(target: str):
    data = torch.load(target, map_location="cpu", weights_only=True)
    if not isinstance(data, dict) or data.get("format") != FORMAT:
        raise ValueError(f"{target} is not a checkpoint of normflows_tpu_torch")
    return data["tree"]


# An optimizer group's entries that say how it runs, not what it computes:
# the template's stay, so that a checkpoint of the card's capturable Adam
# restores into a plain Adam on the CPU, and the other way round.
_HOW_IT_RUNS = ("params", "capturable", "foreach", "fused", "differentiable")


def _restore_optimizer(opt: torch.optim.Optimizer, saved: dict, where: str):
    groups, saved_groups = opt.param_groups, saved["param_groups"]
    if [len(g["params"]) for g in groups] != [len(g["params"]) for g in saved_groups]:
        raise ValueError(f"{where}: the checkpoint's parameter groups do not match the "
                         f"optimizer's")
    with torch.no_grad():
        for group, s in zip(groups, saved_groups):
            for k, v in s.items():
                if k in _HOW_IT_RUNS:
                    continue
                if isinstance(group.get(k), torch.Tensor):
                    # a tensor learning rate (a chunk's schedule) keeps its tensor
                    group[k].copy_(torch.as_tensor(v))
                else:
                    group[k] = v.item() if isinstance(v, torch.Tensor) else v
    params = [p for group in groups for p in group["params"]]
    held = [bool(opt.state.get(p)) for p in params]
    if not any(held):
        opt.load_state_dict({"state": saved["state"],
                             "param_groups": opt.state_dict()["param_groups"]})
        return opt
    if not all(held):
        raise ValueError(f"{where}: the optimizer holds state for some parameters only")
    with torch.no_grad():
        for i, p in enumerate(params):
            mine, theirs = opt.state[p], saved["state"].get(i, {})
            if set(mine) != set(theirs):
                raise ValueError(f"{where}: parameter {i} has state {sorted(theirs)} in the "
                                 f"checkpoint, {sorted(mine)} in the optimizer")
            for k, v in theirs.items():
                if not isinstance(mine[k], torch.Tensor):
                    mine[k] = v
                elif tuple(mine[k].shape) != tuple(v.shape):
                    raise ValueError(f"{where}: state {i}.{k} has shape {tuple(v.shape)}, "
                                     f"the optimizer's {tuple(mine[k].shape)}")
                else:
                    mine[k].copy_(v)
    return opt


def _restore(like, saved, where: str):
    """Write ``saved`` into ``like`` in place where it can; return the
    restored value."""
    if isinstance(like, TrainState):
        like.model = _restore(like.model, saved["model"], where + ".model")
        like.optimizer = _restore(like.optimizer, saved["optimizer"], where + ".optimizer")
        like.step = _restore(like.step, saved["step"], where + ".step")
        return like
    if isinstance(like, nn.Module):
        return copy_tensors_like(like, saved, where)
    if isinstance(like, torch.optim.Optimizer):
        return _restore_optimizer(like, saved, where)
    if isinstance(like, torch.Generator):
        like.set_state(saved)
        return like
    if isinstance(like, torch.Tensor):
        saved = torch.as_tensor(saved)
        if tuple(saved.shape) != tuple(like.shape):
            raise ValueError(f"{where} has shape {tuple(saved.shape)}, the template "
                             f"{tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(saved)
        return like
    if isinstance(like, dict):
        if list(like) != list(saved):
            raise ValueError(f"{where}: keys {list(saved)} in the checkpoint, {list(like)} "
                             f"in the template")
        for k in like:
            like[k] = _restore(like[k], saved[k], f"{where}[{k!r}]")
        return like
    if isinstance(like, (list, tuple)):
        if len(like) != len(saved):
            raise ValueError(f"{where}: {len(saved)} entries in the checkpoint, "
                             f"{len(like)} in the template")
        values = [_restore(a, b, f"{where}[{i}]") for i, (a, b) in enumerate(zip(like, saved))]
        if isinstance(like, tuple):
            return tuple(values)
        like[:] = values
        return like
    return saved.item() if isinstance(saved, torch.Tensor) else saved


def restore_checkpoint(path: str, like, step: Optional[int] = None):
    """Restore what :func:`save_checkpoint` wrote to ``path`` (``path/<step>``
    with ``step``) into ``like``, a template of the same structure, in place
    where it can, and return it."""
    target = _file(path, step)
    if _is_sharded(target):
        return _restore_sharded(like, target, f"checkpoint at {target}")
    if _per_rank(like):
        raise ValueError(f"{target} holds replicated state, and the template state that "
                         f"differs across the ranks: restore it into a template of the "
                         f"whole state")
    return _restore(like, _load(target), f"checkpoint at {target}")


class CheckpointManager:
    """Rolling training checkpoints in ``directory``, one file (a directory
    for sharded state) a step, the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self):
        return sorted(int(name) for name in os.listdir(self.directory) if name.isdigit())

    def save(self, step: int, obj):
        """Write ``obj`` as ``step`` and drop the oldest beyond
        ``max_to_keep``: rank 0 of a world does both, as
        :func:`save_checkpoint` says (every rank writes sharded state, rank 0
        drops)."""
        target = _file(self.directory, step)
        if _per_rank(obj):
            _save_sharded(target, obj)
        elif _writes():
            _write(target, obj)
        if _writes():
            for old in self.all_steps()[:-self.max_to_keep]:
                old = os.path.join(self.directory, str(old))
                if os.path.isdir(old):
                    shutil.rmtree(old)
                else:
                    os.remove(old)
        _written()

    def restore(self, like, step: Optional[int] = None):
        """Restore ``step`` (the newest if None) into ``like``; None when
        there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return restore_checkpoint(self.directory, like, step)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self):
        """Nothing stays open between calls; kept for the JAX package's
        interface."""
