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

In a ``torch.distributed`` world the state is replicated: rank 0 writes,
every rank waits on a barrier, and every rank restores from the file.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

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


def save_checkpoint(path: str, obj, step: Optional[int] = None):
    """Write ``obj`` (a model, an optimizer, a ``TrainState``, or dicts,
    lists and tuples of them, tensors, generators and numbers) to ``path``;
    with ``step``, to ``path/<step>``, so that successive saves are
    versioned.  The file is written whole, then moved into place.

    In a data-parallel world (``parallel``), whose training state is the
    same on every rank, rank 0 writes and every rank waits on a barrier
    until it has; every rank then restores from the one file."""
    if _writes():
        _write(_file(path, step), obj)
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
    return _restore(like, _load(target), f"checkpoint at {target}")


class CheckpointManager:
    """Rolling training checkpoints in ``directory``, one file a step, the
    newest ``max_to_keep`` kept."""

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
        :func:`save_checkpoint` says."""
        if _writes():
            _write(_file(self.directory, step), obj)
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(os.path.join(self.directory, str(old)))
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
