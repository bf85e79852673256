"""Weights carried across from a ``normflows_tpu`` (JAX) model.

:func:`load_jax_leaves` takes the JAX model's leaves as a dict of numpy
arrays keyed by their ``jax.tree_util.keystr`` paths, built on the JAX side
as ``{keystr(p): np.asarray(l) for p, l in tree_flatten_with_path(model)[0]}``
(``.flows[0].mprqat.autoregressive_net.initial_layer.weight``, ``.q0.scale``,
...).  This module never imports JAX.

Each path names the port's tensor of the same name.  A parameter is copied;
the (in, out) weights of ``Linear`` / ``MaskedLinear`` are transposed into
torch's (out, in), and so are their masks (a ``ScanChain``'s stacked
(depth, in, out) leaves on their last two axes).  A buffer drawn at random
(one a module lists in its ``random_buffers``, such as a random permutation, which
a torch generator cannot draw as a JAX key does) is copied too, and so is
one it lists in its ``state_buffers`` (data-dependent state, such as
ActNorm's ``initialized``).  A buffer
the port recomputes (masks, degrees, ``input_order``, index buffers, scales)
is held for equality instead.  The first path that is missing, extra, of the
wrong shape or unequal raises, and the message names it.

A module the model holds at several paths (the target that a stochastic
flow's MCMC layers and its ``p`` share, the prior and target of every HAIS
rung) has one leaf a path in JAX and one tensor in the port: every path is
accepted, and its leaves must be equal.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .nets.mlp import Linear

_TRANSPOSED = ("weight", "mask")


def _torch_name(path: str) -> str:
    """``.flows[0].q0.scale`` -> ``flows.0.q0.scale``."""
    return re.sub(r"\[(\d+)\]", r".\1", path).lstrip(".")


def load_jax_leaves(model: torch.nn.Module, leaves: dict) -> torch.nn.Module:
    """Copy ``leaves`` into ``model`` in place and return it."""
    params = dict(model.named_parameters(remove_duplicate=False))
    buffers = dict(model.named_buffers(remove_duplicate=False))
    seen = set()
    first = {}  # id of a tensor copied -> (the path it came from, its value)
    for path, value in leaves.items():
        name = _torch_name(path)
        owner, _, attr = name.rpartition(".")
        target = params.get(name, buffers.get(name))
        if target is None:
            raise KeyError(f"load_jax_leaves: {path} has no counterpart in the port")
        value = np.array(value)  # a writable copy: JAX hands out read-only views
        module = model.get_submodule(owner)
        if attr in _TRANSPOSED and isinstance(module, Linear):
            # the last two axes: a ScanChain's stacked (depth, in, out) leaf
            # becomes (depth, out, in)
            value = np.swapaxes(value, -2, -1)
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"load_jax_leaves: {path} has shape {value.shape}, "
                             f"the port's {name} {tuple(target.shape)}")
        copied = (*getattr(module, "random_buffers", ()), *getattr(module, "state_buffers", ()))
        if name in params or attr in copied:
            if id(target) in first:
                path0, value0 = first[id(target)]
                if not np.array_equal(value, value0):
                    raise ValueError(f"load_jax_leaves: {path} differs from {path0}, the "
                                     f"same tensor ({name}) in the port")
            else:
                first[id(target)] = (path, value)
                with torch.no_grad():
                    target.copy_(torch.as_tensor(value, dtype=target.dtype))
        elif not np.array_equal(value, target.detach().cpu().numpy()):
            raise ValueError(f"load_jax_leaves: {path} differs from the buffer "
                             f"the port computed")
        seen.add(name)
    for name in [*params, *buffers]:
        if name not in seen:
            raise KeyError(f"load_jax_leaves: no leaf for the port's {name}")
    return model
