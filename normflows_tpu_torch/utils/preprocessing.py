"""Dataloader-side preprocessing (port of
``normflows_tpu/utils/preprocessing.py``): ``Logit``, ``Jitter`` and
``Scale``, callables on tensors.  ``Jitter`` draws its noise from a
``torch.Generator`` (the JAX package's key), through :func:`uniform_noise`."""

from __future__ import annotations

from typing import Optional

import torch


def uniform_noise(shape, *, generator: Optional[torch.Generator] = None,
                  dtype=torch.float32, device="cpu") -> torch.Tensor:
    """U[0, 1) draws of ``shape`` from ``generator``: every draw of
    :class:`Jitter`."""
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


class Logit:
    """logit(alpha + (1 - alpha) x) and its inverse."""

    def __init__(self, alpha: float = 0.0):
        self.alpha = alpha

    def __call__(self, x):
        x_ = self.alpha + (1 - self.alpha) * x
        return torch.log(x_ / (1 - x_))

    def inverse(self, x):
        return (torch.sigmoid(x) - self.alpha) / (1 - self.alpha)


class Jitter:
    """Uniform dequantisation noise: x + U[0, 1) * ``scale``."""

    def __init__(self, scale: float = 1.0 / 256):
        self.scale = scale

    def __call__(self, x, generator: Optional[torch.Generator] = None):
        return x + uniform_noise(x.shape, generator=generator, dtype=x.dtype,
                                 device=x.device) * self.scale


class Scale:
    """Multiplication by a constant, e.g. 255/256."""

    def __init__(self, scale: float = 255.0 / 256.0):
        self.scale = scale

    def __call__(self, x):
        return x * self.scale


__all__ = ["Jitter", "Logit", "Scale", "uniform_noise"]
