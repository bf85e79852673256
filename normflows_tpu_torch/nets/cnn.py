"""Convolutional nets (port of ``normflows_tpu/nets/cnn.py``): ``Conv2d``,
``NetActNorm`` and ``ConvNet2d``, in the NCHW / OIHW layout of both packages,
so that weights copy across without a transpose.

``Conv2d`` pads by ``kernel_size // 2`` and takes torch's default init
(weight ~ U(+-1/sqrt(fan_in)), zero bias), zeros, or N(0, weight_std^2).
Its ``compute_dtype`` (``utils.set_compute_dtype``) casts both operands to
bfloat16; the output is rounded to bfloat16, as the JAX package's fully
bf16 convolution gives it, before the cast back and the bias.

**What float32 means.**  cuDNN runs float32 convolutions as TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which rounds the operands to
10 mantissa bits.  The JAX package's float32 convolution accumulates float32
products.  So a float32 ``Conv2d`` runs its forward and its backward
(:class:`_FP32Conv`: the gradients' convolutions run in the backward pass,
after the forward has returned) inside :func:`fp32_convs`, which turns
cuDNN's TF32 off for the call and restores the caller's setting after it (a
bfloat16 convolution does not read it).  A ``torch.export`` program keeps
no such setting: ``serving`` runs its programs inside :func:`fp32_convs`
too.

**Deterministic.**  cuDNN's default choice for a float32 convolution's
weight gradient at Glow's widths (``wgrad_alg0_engine``) adds partial sums
with atomics, so two runs of one step, or a captured step and its eager
twin, part in the last bits.  :func:`fp32_convs` also asks cuDNN for its
deterministic algorithms (``torch.backends.cudnn.deterministic``), so that
a float32 step gives the same bits on every run, captured or eager.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.backend import resolve_device


@contextlib.contextmanager
def fp32_convs():
    """cuDNN's TF32 off and its deterministic algorithms on for the block
    (``torch.backends.cudnn.allow_tf32``, ``deterministic``), the caller's
    settings restored after it."""
    prior = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = prior


class _FP32Conv(torch.autograd.Function):
    """``F.conv2d`` (stride 1, square padding) whose forward and backward
    convolutions both run inside :func:`fp32_convs`."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding: int):
        with fp32_convs():
            y = F.conv2d(x, weight, bias, padding=padding)
        ctx.save_for_backward(x, weight)
        ctx.padding, ctx.has_bias = padding, bias is not None
        return y

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        p = ctx.padding
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.has_bias and ctx.needs_input_grad[2]]
        with fp32_convs():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if ctx.has_bias else None, [1, 1], [p, p],
                [1, 1], False, [0, 0], 1, mask)
        return gx, gw, gb, None


class Conv2d(nn.Module):
    """2-D convolution, NCHW, stride 1, padding ``kernel_size // 2``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = True, zeros: bool = False, weight_std: Optional[float] = None,
                 compute_dtype=None, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        k = kernel_size
        shape = (out_channels, in_channels, k, k)
        if zeros:
            w = torch.zeros(shape)
        elif weight_std is not None:
            w = weight_std * torch.randn(shape, generator=generator)
        else:  # drawn on the CPU, so that a seed gives the same weights everywhere
            bound = 1.0 / math.sqrt(in_channels * k * k)
            w = torch.empty(shape).uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if bias else None
        self.padding = k // 2
        self.compute_dtype: Optional[torch.dtype] = compute_dtype

    def forward(self, x):
        return self.convolve(x, self.weight, self.bias)

    def convolve(self, x, weight, bias):
        """The convolution of ``x`` with ``weight`` and ``bias`` (None:
        none), this layer's or a shard of them (``parallel.tensor_parallel``)."""
        dt = self.compute_dtype
        if dt is None:
            return _FP32Conv.apply(x, weight, bias, self.padding)
        with fp32_convs():
            y = F.conv2d(x.to(dt), weight.to(dt), padding=self.padding).to(x.dtype)
        if bias is not None:
            y = y + bias[None, :, None, None].to(y.dtype)
        return y


class NetActNorm(nn.Module):
    """Per-channel scale and shift inside ``ConvNet2d``: x exp(s) + t in x's
    dtype, identity at init."""

    def __init__(self, shape, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.s = nn.Parameter(torch.zeros(1, *shape, device=device))
        self.t = nn.Parameter(torch.zeros(1, *shape, device=device))

    def forward(self, x):
        return x * torch.exp(self.s).to(x.dtype) + self.t.to(x.dtype)


def leaky_relu(x, negative_slope: float):
    """JAX's ``leaky_relu``: x where x >= 0, else slope * x.  Its gradient at
    0 is 1 (torch's ``leaky_relu`` takes the slope there), which a hidden
    pixel whose inputs are all 0 meets while the biases are 0."""
    return torch.where(x >= 0, x, negative_slope * x)


class ConvNet2d(nn.Module):
    """Convolutions with leaky ReLU between them (:func:`leaky_relu`), the
    last one zero at init (``init_zeros``); with ``actnorm`` each hidden
    convolution has no bias and a ``NetActNorm`` after it."""

    def __init__(self, channels, kernel_size, leaky: float = 0.0, init_zeros: bool = True,
                 actnorm: bool = False, weight_std: Optional[float] = None,
                 compute_dtype=None, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        n = len(kernel_size)
        convs = [Conv2d(channels[i], channels[i + 1], kernel_size[i], bias=not actnorm,
                        weight_std=weight_std, compute_dtype=compute_dtype,
                        generator=generator, device=device) for i in range(n - 1)]
        convs.append(Conv2d(channels[n - 1], channels[n], kernel_size[-1], zeros=init_zeros,
                            compute_dtype=compute_dtype, generator=generator, device=device))
        self.convs = nn.ModuleList(convs)
        # the JAX package's tuple of None entries without actnorm: no leaves
        self.actnorms = nn.ModuleList(
            NetActNorm((channels[i + 1], 1, 1), device=device) for i in range(n - 1)
        ) if actnorm else None
        self.leaky = leaky

    @classmethod
    def create(cls, generator: Optional[torch.Generator], channels, kernel_size,
               leaky: float = 0.0, init_zeros: bool = True, actnorm: bool = False,
               weight_std: Optional[float] = None, compute_dtype=None, *, device="cuda"):
        """``generator`` draws the weights (the JAX ``key``'s place)."""
        return cls(channels, kernel_size, leaky, init_zeros, actnorm, weight_std,
                   compute_dtype, generator=generator, device=device)

    def forward(self, x, context=None):
        for i, conv in enumerate(self.convs[:-1]):
            x = conv(x)
            if self.actnorms is not None:
                x = self.actnorms[i](x)
            x = leaky_relu(x, self.leaky)
        return self.convs[-1](x)
