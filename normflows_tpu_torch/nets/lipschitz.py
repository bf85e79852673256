"""Lipschitz-constrained nets by induced-norm (spectral) normalisation (port of
``normflows_tpu/nets/lipschitz.py``).

``InducedNormLinear`` and ``InducedNormConv2d`` keep a power-iteration pair
``u``, ``v`` and the last ``scale`` (sigma) as buffers.  Power iteration runs
at construction (50 steps) and whenever :meth:`update_power_iteration` or
``utils.optim.update_lipschitz`` asks for it, in place, never inside a
forward pass.  The forward divides the weight by max(1, sigma / coeff) with
sigma = u . (W v) taken from the current weight, so that the factor stays
differentiable in the weight.

Every fixed induced-norm order is supported on either side (2 by L2 power
iteration, 1 and infinity by the one-hot maximiser, any other p by the
dual-norm maximiser steps); the reference's learnable order is out of scope,
as in the JAX package.  The normalisers act on the last axis, so that one
call serves a stack of layers of one shape (``update_lipschitz``'s grouped
form) as it serves one layer.

Power iteration runs a fixed number of steps (``n_iterations``), or, where
that is None, to the layer's (atol, rtol) tolerance, capped at 200 steps:
that loop reads the device once a step and cannot run inside a CUDA graph's
capture, where it raises.

Initial weights and the initial ``u``, ``v`` are drawn from a
``torch.Generator`` on the CPU (the JAX package's key), then placed on
``device``; ``interop.load_jax_leaves`` copies a JAX model's ``u`` and ``v``
(``random_buffers``) and ``scale`` (``state_buffers``).  A float32 convolution
runs with cuDNN's TF32 off, its backward too (``nets.cnn._FP32Conv``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.backend import capturing, resolve_device
from .cnn import _FP32Conv, fp32_convs

TOL_MAX_ITERS = 200  # the cap when iterating to a tolerance (JAX lipschitz.py:103)


class Swish(nn.Module):
    """x * sigmoid(softplus(beta) x) / 1.1 with a learnable beta."""

    def __init__(self, *, device="cuda"):
        super().__init__()
        self.beta = nn.Parameter(torch.full((1,), 0.5, device=resolve_device(device)))

    def forward(self, x):
        return x * torch.sigmoid(x * F.softplus(self.beta)) / 1.1


def _check_p(domain, codomain):
    """Fixed induced-norm orders p >= 1 on both sides; the learnable order
    of the reference is out of scope."""
    for p in (domain, codomain):
        if not isinstance(p, (int, float)) or not 1 <= p:
            raise NotImplementedError(
                f"induced-norm order must be a fixed float >= 1, got {p!r}"
                " (the reference's learnable-ord mode is out of scope)")


def _normalize(x, eps=1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def _projmax(x):
    """sign(x_i) at the first i of largest |x_i|, zeros elsewhere."""
    idx = torch.argmax(torch.abs(x), dim=-1, keepdim=True)
    return torch.zeros_like(x).scatter_(-1, idx, torch.sign(torch.gather(x, -1, idx)))


def _pnorm(x, p):
    return torch.sum(torch.abs(x) ** p, dim=-1, keepdim=True) ** (1.0 / p)


def _max_abs(x, eps):
    return torch.clamp(torch.amax(x, dim=-1, keepdim=True), min=eps)


def _normalize_v(v, domain, eps=1e-12):
    """The dual-norm maximiser step on the input side."""
    if domain == 2:
        return _normalize(v, eps)
    if domain == 1:
        return _projmax(v)
    vabs = torch.abs(v)
    vph = torch.where(vabs == 0, 1.0, torch.sign(v))
    vabs = (vabs / _max_abs(vabs, eps)) ** (1.0 / (domain - 1))
    return vph * vabs / torch.clamp(_pnorm(vabs, domain), min=eps)


def _normalize_u(u, codomain, eps=1e-12):
    """The dual-norm maximiser step on the output side."""
    if codomain == 2:
        return _normalize(u, eps)
    if codomain == math.inf:
        return _projmax(u)
    uabs = torch.abs(u)
    uph = torch.where(uabs == 0, 1.0, torch.sign(u))
    uabs = (uabs / _max_abs(uabs, eps)) ** (codomain - 1)
    if codomain == 1:
        return uph * uabs / _max_abs(uabs, eps)
    q = codomain / (codomain - 1.0)
    return uph * uabs / torch.clamp(_pnorm(uabs, q), min=eps)


def power_iterate(u, v, fwd, bwd, n, atol=None, rtol=None, domain=2.0, codomain=2.0):
    """``n`` power-iteration steps from ``(u, v)`` (each u = N_u(fwd(v)),
    then v = N_v(bwd(u))), or, with ``n`` None, steps until both moved less
    than the (atol, rtol) tolerance, at most 200.  Returns the new pair.

    The tolerance loop reads the device once a step: under a CUDA graph's
    capture it raises (give ``n``)."""
    def step(u, v):
        u = _normalize_u(fwd(v), codomain)
        return u, _normalize_v(bwd(u), domain)

    if n is not None:
        for _ in range(n):
            u, v = step(u, v)
        return u, v
    if atol is None or rtol is None:
        raise ValueError("Need one of n_iterations or (atol, rtol).")
    if capturing():
        raise RuntimeError(
            "power iteration to a tolerance reads the device every step and cannot "
            "be captured in a CUDA graph: pass a fixed n_iterations (update_lipschitz("
            "model, n) does)")
    for _ in range(TOL_MAX_ITERS):
        new_u, new_v = step(u, v)
        err_u = torch.linalg.vector_norm(new_u - u) / math.sqrt(u.numel())
        err_v = torch.linalg.vector_norm(new_v - v) / math.sqrt(v.numel())
        done = (err_u < atol + rtol * torch.max(new_u)) & (err_v < atol + rtol * torch.max(new_v))
        u, v = new_u, new_v
        if bool(done):
            break
    return u, v


class _InducedNorm(nn.Module):
    """What the linear and the convolutional layer share: the power-iteration
    buffers, the settings and the scaled weight."""

    random_buffers = ("u", "v")
    state_buffers = ("scale",)

    def _setup(self, weight, bias, u, v, coeff, n_iterations, atol, rtol, domain, codomain,
               device):
        self.weight = nn.Parameter(weight.to(device))
        self.bias = nn.Parameter(bias.to(device)) if bias is not None else None
        self.register_buffer("u", u.to(device))
        self.register_buffer("v", v.to(device))
        self.register_buffer("scale", torch.zeros((), device=device))
        self.coeff, self.n_iterations = coeff, n_iterations
        self.atol, self.rtol = atol, rtol
        self.domain, self.codomain = float(domain), float(codomain)

    def _sigma(self, weight, u, v):
        raise NotImplementedError

    def _scaled_weight(self):
        sigma = self._sigma(self.weight, self.u, self.v)
        factor = torch.maximum(torch.ones_like(sigma), sigma / self.coeff)
        return self.weight / factor

    @torch.no_grad()
    def update_power_iteration(self, n_iterations: Optional[int] = None):
        """Power iteration on the current weight, in place: ``n_iterations``
        steps (the layer's own when None; to its tolerance when that is None
        too); ``scale`` becomes sigma.  Returns the layer."""
        n = self.n_iterations if n_iterations is None else n_iterations
        w = self.weight.detach()
        u, v = power_iterate(self.u, self.v, lambda v: self._forward_map(v, w),
                             lambda u: self._adjoint(u, w), n, self.atol, self.rtol,
                             self.domain, self.codomain)
        self.u.copy_(u)
        self.v.copy_(v)
        self.scale.copy_(self._sigma(w, u, v))
        return self


class InducedNormLinear(_InducedNorm):
    """A linear layer whose weight (out, in) is scaled to an induced norm of at
    most ``coeff``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 coeff: float = 0.97, n_iterations: Optional[int] = 5, zero_init: bool = False,
                 domain=2, codomain=2, atol=None, rtol=None, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        _check_p(domain, codomain)
        device = resolve_device(device)
        w = torch.randn(out_features, in_features, generator=generator)
        w = 1e-5 * w if zero_init else w * math.sqrt(1.0 / in_features)
        u = _normalize(torch.randn(out_features, generator=generator))
        v = _normalize(torch.randn(in_features, generator=generator))
        self._setup(w, torch.zeros(out_features) if bias else None, u, v, coeff,
                    n_iterations, atol, rtol, domain, codomain, device)
        self.update_power_iteration(50)

    @classmethod
    def create(cls, generator, in_features, out_features, bias=True, coeff=0.97,
               n_iterations=5, zero_init=False, domain=2, codomain=2, atol=None, rtol=None,
               *, device="cuda"):
        return cls(in_features, out_features, bias, coeff, n_iterations, zero_init, domain,
                   codomain, atol, rtol, generator=generator, device=device)

    @staticmethod
    def _forward_map(v, w):
        """W v for v (..., in) and w (..., out, in)."""
        return torch.matmul(w, v.unsqueeze(-1)).squeeze(-1)

    @staticmethod
    def _adjoint(u, w):
        return torch.matmul(w.transpose(-1, -2), u.unsqueeze(-1)).squeeze(-1)

    def _sigma(self, weight, u, v):
        return torch.sum(u * self._forward_map(v, weight), dim=-1)

    def forward(self, x):
        y = x @ self._scaled_weight().T
        if self.bias is not None:
            y = y + self.bias
        return y


class InducedNormConv2d(_InducedNorm):
    """A stride-1 'same' convolution (OIHW weight) scaled to an induced norm
    of at most ``coeff`` over fixed spatial dims: ``u`` is the flattened
    output map, ``v`` the input map, and power iteration maps them through
    the convolution and its transpose."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, spatial_dims,
                 bias: bool = True, coeff: float = 0.97, n_iterations: Optional[int] = 5,
                 zero_init: bool = False, stride: int = 1, padding=None, domain=2, codomain=2,
                 atol=None, rtol=None, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        _check_p(domain, codomain)
        if stride != 1:
            raise NotImplementedError("stride != 1 is not supported (LipschitzCNN uses 1)")
        if padding is not None and padding != kernel_size // 2:
            raise NotImplementedError("only 'same' padding (kernel_size // 2) is supported")
        device = resolve_device(device)
        k = kernel_size
        h, w_ = spatial_dims
        w = torch.randn(out_channels, in_channels, k, k, generator=generator)
        w = 1e-5 * w if zero_init else w * math.sqrt(1.0 / (in_channels * k * k))
        u = _normalize_u(torch.randn(out_channels * h * w_, generator=generator), codomain)
        v = _normalize_v(torch.randn(in_channels * h * w_, generator=generator), domain)
        self.in_shape, self.out_shape = (in_channels, h, w_), (out_channels, h, w_)
        self.padding = k // 2
        self._setup(w, torch.zeros(out_channels) if bias else None, u, v, coeff,
                    n_iterations, atol, rtol, domain, codomain, device)
        self.update_power_iteration(50)

    @classmethod
    def create(cls, generator, in_channels, out_channels, kernel_size, spatial_dims, bias=True,
               coeff=0.97, n_iterations=5, zero_init=False, stride=1, padding=None, domain=2,
               codomain=2, atol=None, rtol=None, *, device="cuda"):
        return cls(in_channels, out_channels, kernel_size, spatial_dims, bias, coeff,
                   n_iterations, zero_init, stride, padding, domain, codomain, atol, rtol,
                   generator=generator, device=device)

    def _conv(self, x, w, bias=None):
        """The convolution; in float32 forward and backward with cuDNN's TF32
        off (``nets.cnn._FP32Conv``)."""
        if x.dtype == torch.float32:
            return _FP32Conv.apply(x, w, bias, self.padding)
        return F.conv2d(x, w, bias, padding=self.padding)

    def _forward_map(self, v, w):
        return self._conv(v.reshape(1, *self.in_shape), w).reshape(-1)

    def _adjoint(self, u, w):
        # the convolution's adjoint: its transpose with the same weight
        with fp32_convs():
            return F.conv_transpose2d(u.reshape(1, *self.out_shape), w,
                                      padding=self.padding).reshape(-1)

    def _sigma(self, weight, u, v):
        return torch.dot(u, self._forward_map(v, weight))

    def forward(self, x):
        return self._conv(x, self._scaled_weight(), self.bias)


class LipschitzMLP(nn.Module):
    """Swish and ``InducedNormLinear`` in turn (``layers``), the last linear
    layer near zero with ``init_zeros``; ``max_lipschitz_iter=None`` with
    ``lipschitz_tolerance`` iterates to the tolerance."""

    def __init__(self, channels, lipschitz_const: float = 0.97, max_lipschitz_iter=5,
                 lipschitz_tolerance=None, init_zeros: bool = True, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        n = len(channels) - 1
        layers = []
        for i in range(n):
            layers.append(Swish(device=device))
            layers.append(InducedNormLinear(
                channels[i], channels[i + 1], coeff=lipschitz_const,
                n_iterations=max_lipschitz_iter, zero_init=init_zeros and i == n - 1,
                atol=lipschitz_tolerance, rtol=lipschitz_tolerance, generator=generator,
                device=device))
        self.layers = nn.ModuleList(layers)

    @classmethod
    def create(cls, generator, channels, lipschitz_const=0.97, max_lipschitz_iter=5,
               lipschitz_tolerance=None, init_zeros=True, *, device="cuda"):
        return cls(channels, lipschitz_const, max_lipschitz_iter, lipschitz_tolerance,
                   init_zeros, generator=generator, device=device)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class LipschitzCNN(nn.Module):
    """Swish and ``InducedNormConv2d`` in turn over fixed ``spatial_dims``."""

    def __init__(self, channels, kernel_size, spatial_dims, lipschitz_const: float = 0.97,
                 max_lipschitz_iter=5, lipschitz_tolerance=None, init_zeros: bool = True, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        n = len(kernel_size)
        layers = []
        for i in range(n):
            layers.append(Swish(device=device))
            layers.append(InducedNormConv2d(
                channels[i], channels[i + 1], kernel_size[i], spatial_dims,
                coeff=lipschitz_const, n_iterations=max_lipschitz_iter,
                zero_init=init_zeros and i == n - 1, atol=lipschitz_tolerance,
                rtol=lipschitz_tolerance, generator=generator, device=device))
        self.layers = nn.ModuleList(layers)

    @classmethod
    def create(cls, generator, channels, kernel_size, spatial_dims, lipschitz_const=0.97,
               max_lipschitz_iter=5, lipschitz_tolerance=None, init_zeros=True, *,
               device="cuda"):
        return cls(channels, kernel_size, spatial_dims, lipschitz_const, max_lipschitz_iter,
                   lipschitz_tolerance, init_zeros, generator=generator, device=device)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


def leaky_elu(x, a=0.3):
    return a * x + (1 - a) * F.elu(x)


def asym_squash(x):
    return torch.tanh(-leaky_elu(-x + 0.5493061829986572)) * 2 + 3
