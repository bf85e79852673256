"""Optimizer-side helpers (port of ``normflows_tpu/utils/optim.py``).

:func:`update_lipschitz` is what a residual flow's training step calls after
each update.  It runs power iteration on every induced-norm layer of a
model in place.  The linear layers are grouped by shape and settings, and
each group takes one power-iteration step as one batched product and one
batched normalisation each way: the same arithmetic as layer by layer, in a
few hundred launches a call where one layer at a time takes thousands (48
layers of three shapes in the residual two-moons model).  Convolutional
layers, and layers left to iterate to a tolerance, run one at a time.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nets.lipschitz import InducedNormConv2d, InducedNormLinear, power_iterate


def set_requires_grad(model: nn.Module, flag: bool) -> nn.Module:
    """Set ``requires_grad`` of every parameter of ``model`` to ``flag``."""
    for p in model.parameters():
        p.requires_grad_(flag)
    return model


def clear_grad(model: nn.Module) -> nn.Module:
    """Drop every parameter's gradient (``zero_grad(set_to_none=True)``)."""
    model.zero_grad(set_to_none=True)
    return model


def _groups(model: nn.Module, n_iterations: Optional[int]):
    """The induced-norm layers of ``model``: linear layers with a step count
    grouped by (shape, dtype, device, orders, steps); every other layer
    alone."""
    groups, alone = {}, []
    for m in model.modules():
        if not isinstance(m, (InducedNormLinear, InducedNormConv2d)):
            continue
        n = m.n_iterations if n_iterations is None else n_iterations
        if isinstance(m, InducedNormConv2d) or n is None:
            alone.append(m)
            continue
        w = m.weight
        key = (tuple(w.shape), w.dtype, w.device, m.domain, m.codomain, n)
        groups.setdefault(key, []).append(m)
    return groups, alone


@torch.no_grad()
def update_lipschitz(model: nn.Module, n_iterations: Optional[int] = 50) -> nn.Module:
    """Power iteration on every ``InducedNormLinear`` and ``InducedNormConv2d``
    of ``model``, in place: ``n_iterations`` steps (each layer's own when
    None); returns ``model``.  A CUDA graph can capture it where every layer
    runs a fixed number of steps."""
    groups, alone = _groups(model, n_iterations)
    for (_, _, _, domain, codomain, n), layers in groups.items():
        w = torch.stack([m.weight.detach() for m in layers])
        u, v = power_iterate(torch.stack([m.u for m in layers]),
                             torch.stack([m.v for m in layers]),
                             lambda v: InducedNormLinear._forward_map(v, w),
                             lambda u: InducedNormLinear._adjoint(u, w), n,
                             domain=domain, codomain=codomain)
        sigma = torch.sum(u * InducedNormLinear._forward_map(v, w), dim=-1)
        torch._foreach_copy_([m.u for m in layers], list(u.unbind(0)))
        torch._foreach_copy_([m.v for m in layers], list(v.unbind(0)))
        torch._foreach_copy_([m.scale for m in layers], list(sigma.unbind(0)))
    for m in alone:
        m.update_power_iteration(n_iterations)
    return model
