"""Residual parameter networks (port of ``normflows_tpu/nets/resnet.py``):
``ResidualBlock`` and ``ResidualNet``, the coupling splines' transform net,
and their convolutional forms ``ConvResidualBlock`` and ``ConvResidualNet``
(3x3 blocks between 1x1 convolutions), the image couplings' net.

Pre-activation blocks, x + linear_1(act(linear_0(act(x)))), whose second
linear starts within +-1e-3 (``zero_initialization``), and an optional
elementwise ``preprocessing`` module before the first layer.  With
``context_features`` the context is concatenated to the net's input and
gates each block's output with sigmoid(context_layer(context)) (GLU).
Every layer is a ``Linear``, so ``utils.set_compute_dtype`` reaches them all.

Dropout acts between a block's second activation and its second linear
where the caller passes a ``torch.Generator`` as ``generator=`` (the JAX
package's ``key=..., train=True``); without one the net is the
deterministic eval-mode function.  Every dropout mask of the package comes
from :func:`_dropout_keep`.  ``use_batch_norm=True`` raises, as in the JAX
package.  The convolutional blocks gate with a 1x1 convolution of an image
context, and their convolutions are ``Conv2d`` (so ``set_compute_dtype``
reaches them too).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.backend import resolve_device
from .cnn import Conv2d
from .mlp import Linear, uniform_


def _dropout_keep(shape, p: float, generator: torch.Generator, device):
    """The keep mask of one dropout: True with probability 1 - p."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - p


def _dropout(x, p: float, generator: Optional[torch.Generator]):
    """Inverted dropout: the kept entries scaled by 1 / (1 - p).  The
    identity without a generator or at p == 0."""
    if generator is None or p == 0.0:
        return x
    keep = 1.0 - p
    return torch.where(_dropout_keep(x.shape, p, generator, x.device), x / keep, 0.0)


def _act(name, x):
    if name == "relu":
        return torch.relu(x)
    if name == "tanh":
        return torch.tanh(x)
    raise NotImplementedError(name)


class ResidualBlock(nn.Module):
    """Pre-activation residual MLP block with an optional GLU context gate."""

    def __init__(self, features: int, context_features=None, activation: str = "relu",
                 dropout_probability: float = 0.0, zero_initialization: bool = True, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.linear_0 = Linear(features, features, generator=generator, device=device)
        self.linear_1 = Linear(features, features, generator=generator, device=device)
        if zero_initialization:
            with torch.no_grad():
                self.linear_1.weight.copy_(uniform_((features, features), 1e-3, generator,
                                                    device))
                self.linear_1.bias.copy_(uniform_((features,), 1e-3, generator, device))
        self.context_layer = (Linear(context_features, features, generator=generator,
                                     device=device)
                              if context_features is not None else None)
        self.activation = activation
        self.dropout_probability = dropout_probability

    def forward(self, x, context=None, *, generator: Optional[torch.Generator] = None):
        temps = self.linear_0(_act(self.activation, x))
        temps = _act(self.activation, temps)
        temps = _dropout(temps, self.dropout_probability, generator)
        temps = self.linear_1(temps)
        if context is not None and self.context_layer is not None:
            temps = temps * torch.sigmoid(self.context_layer(context))
        return x + temps


class ResidualNet(nn.Module):
    """Residual MLP: initial linear (on the input and the context, side by
    side), ``num_blocks`` residual blocks, final linear;
    ``hidden_features`` sets the coupling's logit scaling."""

    def __init__(self, in_features: int, out_features: int, hidden_features: int,
                 context_features=None, num_blocks: int = 2, activation: str = "relu",
                 dropout_probability: float = 0.0, use_batch_norm: bool = False,
                 preprocessing=None, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if use_batch_norm:
            raise NotImplementedError(
                "use_batch_norm=True is not supported (nor by the JAX package)")
        device = resolve_device(device)
        self.initial_layer = Linear(in_features + (context_features or 0), hidden_features,
                                    generator=generator, device=device)
        self.blocks = nn.ModuleList(
            ResidualBlock(hidden_features, context_features=context_features,
                          activation=activation, dropout_probability=dropout_probability,
                          generator=generator, device=device)
            for _ in range(num_blocks))
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

    def forward(self, x, context=None, *, generator: Optional[torch.Generator] = None):
        temps = self.preprocessing(x) if self.preprocessing is not None else x
        if context is not None:
            temps = torch.cat([temps, context], dim=1)
        temps = self.initial_layer(temps)
        for block in self.blocks:
            temps = block(temps, context, generator=generator)
        return self.final_layer(temps)


class ConvResidualBlock(nn.Module):
    """Pre-activation 3x3 convolution block with an optional 1x1 context
    gate; its second convolution starts within +-1e-3."""

    def __init__(self, channels: int, context_channels=None, activation: str = "relu",
                 dropout_probability: float = 0.0, zero_initialization: bool = True, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.conv_0 = Conv2d(channels, channels, 3, generator=generator, device=device)
        self.conv_1 = Conv2d(channels, channels, 3, generator=generator, device=device)
        if zero_initialization:
            with torch.no_grad():
                self.conv_1.weight.copy_(uniform_(tuple(self.conv_1.weight.shape), 1e-3,
                                                  generator, device))
                self.conv_1.bias.copy_(uniform_((channels,), 1e-3, generator, device))
        self.context_layer = (Conv2d(context_channels, channels, 1, generator=generator,
                                     device=device)
                              if context_channels is not None else None)
        self.activation = activation
        self.dropout_probability = dropout_probability

    def forward(self, x, context=None, *, generator: Optional[torch.Generator] = None):
        temps = self.conv_0(_act(self.activation, x))
        temps = _act(self.activation, temps)
        temps = _dropout(temps, self.dropout_probability, generator)
        temps = self.conv_1(temps)
        if context is not None and self.context_layer is not None:
            temps = temps * torch.sigmoid(self.context_layer(context))
        return x + temps


class ConvResidualNet(nn.Module):
    """1x1 convolution in (on the input and the context, stacked along the
    channels), ``num_blocks`` 3x3 residual blocks, 1x1 convolution out;
    ``hidden_channels`` sets the image coupling's logit scaling."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 context_channels=None, num_blocks: int = 2, activation: str = "relu",
                 dropout_probability: float = 0.0, use_batch_norm: bool = False, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        if use_batch_norm:
            raise NotImplementedError(
                "use_batch_norm=True is not supported (nor by the JAX package)")
        device = resolve_device(device)
        self.initial_layer = Conv2d(in_channels + (context_channels or 0), hidden_channels,
                                    1, generator=generator, device=device)
        self.blocks = nn.ModuleList(
            ConvResidualBlock(hidden_channels, context_channels=context_channels,
                              activation=activation, dropout_probability=dropout_probability,
                              generator=generator, device=device)
            for _ in range(num_blocks))
        self.final_layer = Conv2d(hidden_channels, out_channels, 1, generator=generator,
                                  device=device)
        self.hidden_channels = hidden_channels

    @classmethod
    def create(cls, generator: Optional[torch.Generator], in_channels: int,
               out_channels: int, hidden_channels: int, context_channels=None,
               num_blocks: int = 2, activation: str = "relu",
               dropout_probability: float = 0.0, use_batch_norm: bool = False, *,
               device="cuda"):
        """``generator`` draws the weights (the JAX ``key``'s place)."""
        return cls(in_channels, out_channels, hidden_channels, context_channels, num_blocks,
                   activation, dropout_probability, use_batch_norm, generator=generator,
                   device=device)

    def forward(self, x, context=None, *, generator: Optional[torch.Generator] = None):
        if context is not None:
            x = torch.cat([x, context], dim=1)
        temps = self.initial_layer(x)
        for block in self.blocks:
            temps = block(temps, context, generator=generator)
        return self.final_layer(temps)
