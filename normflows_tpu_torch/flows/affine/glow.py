"""``GlowBlock`` (port of ``normflows_tpu/flows/affine/glow.py``): an affine
coupling on a ``ConvNet2d``, an invertible 1x1 convolution and an ActNorm."""

from __future__ import annotations

from typing import Optional

import torch

from ...core.flow import Composite
from ...nets.cnn import ConvNet2d
from ..mixing import Invertible1x1Conv
from ..normalization import ActNorm
from .coupling import AffineCouplingBlock


class GlowBlock(Composite):
    """A ``Composite`` of ``AffineCouplingBlock`` (a ``ConvNet2d`` of kernels
    (3, 1, 3) as its param map), ``Invertible1x1Conv`` (none for one
    channel) and ``ActNorm((channels, 1, 1))``.  The param net's channels
    follow the split: the conditioning half in, one (shift) or two (shift
    and scale) outputs per transformed channel, odd channel counts
    included; the checkerboard modes take every channel in and out."""

    def __init__(self, channels: int, hidden_channels: int, scale: bool = True,
                 scale_map: str = "sigmoid", split_mode: str = "channel", leaky: float = 0.0,
                 init_zeros: bool = True, use_lu: bool = True, net_actnorm: bool = False, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        num_param = 2 if scale else 1
        if split_mode == "channel":
            channels_ = ((channels + 1) // 2, hidden_channels, hidden_channels,
                         num_param * (channels // 2))
        elif split_mode == "channel_inv":
            channels_ = (channels // 2, hidden_channels, hidden_channels,
                         num_param * ((channels + 1) // 2))
        elif "checkerboard" in split_mode:
            channels_ = (channels, hidden_channels, hidden_channels, num_param * channels)
        else:
            raise NotImplementedError(f"Mode {split_mode} is not implemented.")
        param_map = ConvNet2d(channels_, (3, 1, 3), leaky, init_zeros, actnorm=net_actnorm,
                              generator=generator, device=device)
        layers = [AffineCouplingBlock(param_map, scale, scale_map, split_mode)]
        if channels > 1:
            layers.append(Invertible1x1Conv(channels, use_lu, generator=generator,
                                            device=device))
        layers.append(ActNorm((channels, 1, 1), device=device))
        super().__init__(layers)

    @classmethod
    def create(cls, generator: Optional[torch.Generator], channels: int,
               hidden_channels: int, scale: bool = True, scale_map: str = "sigmoid",
               split_mode: str = "channel", leaky: float = 0.0, init_zeros: bool = True,
               use_lu: bool = True, net_actnorm: bool = False, *, device="cuda"):
        """``generator`` draws the conv weights and the 1x1 convolution's
        orthogonal init (the JAX ``key``'s place)."""
        return cls(channels, hidden_channels, scale, scale_map, split_mode, leaky,
                   init_zeros, use_lu, net_actnorm, generator=generator, device=device)
