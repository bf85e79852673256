"""Residual parameter networks (port of ``normflows_tpu/nets/resnet.py``):
``ResidualBlock`` and ``ResidualNet``, the coupling splines' transform net.

Pre-activation blocks, x + linear_1(act(linear_0(act(x)))), whose second
linear starts within +-1e-3 (``zero_initialization``), and an optional
elementwise ``preprocessing`` module before the first layer.  Every layer is
a ``Linear``, so ``utils.set_compute_dtype`` reaches them all.  A context
(the concatenated input and the blocks' GLU gate) and dropout wait for a
later slice of the port and raise ``NotImplementedError``, as
``use_batch_norm=True`` does in the JAX package; ``ConvResidualNet`` waits
for the image slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.backend import resolve_device
from .mlp import Linear, uniform_

_CONTEXT = ("a context (the blocks' GLU gate) waits for a later slice of the PyTorch port "
            "(ROADMAP.md queue 1, item 5)")
_DROPOUT = ("ResidualNet dropout waits for a later slice of the PyTorch port "
            "(ROADMAP.md queue 1, item 5)")


def _act(name, x):
    if name == "relu":
        return torch.relu(x)
    if name == "tanh":
        return torch.tanh(x)
    raise NotImplementedError(name)


def _refuse(context_features, dropout_probability):
    if context_features is not None:
        raise NotImplementedError(_CONTEXT)
    if dropout_probability:
        raise NotImplementedError(_DROPOUT)


class ResidualBlock(nn.Module):
    """Pre-activation residual MLP block."""

    def __init__(self, features: int, context_features=None, activation: str = "relu",
                 dropout_probability: float = 0.0, zero_initialization: bool = True, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        _refuse(context_features, dropout_probability)
        device = resolve_device(device)
        self.linear_0 = Linear(features, features, generator=generator, device=device)
        self.linear_1 = Linear(features, features, generator=generator, device=device)
        if zero_initialization:
            with torch.no_grad():
                self.linear_1.weight.copy_(uniform_((features, features), 1e-3, generator,
                                                    device))
                self.linear_1.bias.copy_(uniform_((features,), 1e-3, generator, device))
        self.activation = activation

    def forward(self, x, context=None):
        if context is not None:
            raise NotImplementedError(_CONTEXT)
        temps = self.linear_0(_act(self.activation, x))
        temps = self.linear_1(_act(self.activation, temps))
        return x + temps


class ResidualNet(nn.Module):
    """Residual MLP: initial linear, ``num_blocks`` residual blocks, final
    linear; ``hidden_features`` sets the coupling's logit scaling."""

    def __init__(self, in_features: int, out_features: int, hidden_features: int,
                 context_features=None, num_blocks: int = 2, activation: str = "relu",
                 dropout_probability: float = 0.0, use_batch_norm: bool = False,
                 preprocessing=None, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if use_batch_norm:
            raise NotImplementedError(
                "use_batch_norm=True is not supported (nor by the JAX package)")
        _refuse(context_features, dropout_probability)
        device = resolve_device(device)
        self.initial_layer = Linear(in_features, hidden_features, generator=generator,
                                    device=device)
        self.blocks = nn.ModuleList(
            ResidualBlock(hidden_features, activation=activation, generator=generator,
                          device=device) for _ in range(num_blocks))
        self.final_layer = Linear(hidden_features, out_features, generator=generator,
                                  device=device)
        self.preprocessing = preprocessing
        self.hidden_features = hidden_features

    @classmethod
    def create(cls, generator: Optional[torch.Generator], in_features: int,
               out_features: int, hidden_features: int, context_features=None,
               num_blocks: int = 2, activation: str = "relu",
               dropout_probability: float = 0.0, use_batch_norm: bool = False,
               preprocessing=None, *, device="cuda"):
        """``generator`` draws the weights (the JAX ``key``'s place; ``None``
        uses torch's default generator)."""
        return cls(in_features, out_features, hidden_features, context_features, num_blocks,
                   activation, dropout_probability, use_batch_norm, preprocessing,
                   generator=generator, device=device)

    def forward(self, x, context=None):
        if context is not None:
            raise NotImplementedError(_CONTEXT)
        temps = self.preprocessing(x) if self.preprocessing is not None else x
        temps = self.initial_layer(temps)
        for block in self.blocks:
            temps = block(temps)
        return self.final_layer(temps)
