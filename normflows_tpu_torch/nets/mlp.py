"""``Linear`` and ``MLP`` (port of ``normflows_tpu/nets/mlp.py``).

``Linear`` takes the torch-default init (weight ~ U(-1/sqrt(in),
1/sqrt(in)), zero bias, as the JAX package's ``init="torch"``), or zeros.
Weights are stored torch-style, (out, in); ``interop.load_jax_leaves``
transposes the JAX package's (in, out) ones.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.backend import resolve_device
from ..utils.nn import ClampExp


def uniform_(shape, bound, generator, device):
    """U(-bound, bound) drawn on the CPU from ``generator`` (so a seed gives
    the same weights on every device), then placed on ``device``."""
    w = torch.empty(shape).uniform_(-bound, bound, generator=generator)
    return w.to(device)


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *, zeros: bool = False,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(
            torch.zeros(out_dim, in_dim, device=device) if zeros else
            uniform_((out_dim, in_dim), 1.0 / math.sqrt(in_dim), generator, device))
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device)) if bias else None
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        return self.finish(self.product(x, self.weight), self.bias, x.dtype)

    def product(self, x, w):
        """``x @ w.T``, the layer's product before its bias (``w`` the
        weight, or a shard of it: ``parallel.tensor_parallel`` splits the
        two steps)."""
        if self.compute_dtype is not None:
            # low-precision operands, f32 accumulation and result
            return (x.to(self.compute_dtype) @ w.to(self.compute_dtype).T).float()
        return x @ w.T

    def finish(self, y, bias, dtype):
        """The product ``y`` plus ``bias`` (None: none), cast to ``dtype``."""
        if bias is not None:
            y = y + bias
        return y.to(dtype)


_OUTPUT_FNS = {"sigmoid": torch.sigmoid, "relu": torch.relu, "tanh": torch.tanh,
               "clampexp": ClampExp()}


class MLP(nn.Module):
    """Leaky-ReLU MLP with an optional output function and scale (port of
    ``MLP`` in ``normflows_tpu/nets/mlp.py:50-122``).

    The layers are ``linears`` (``load_jax_leaves`` maps the JAX package's
    ``.linears[i].weight`` to them); a leaky ReLU of slope ``leaky`` follows
    each but the last.  ``output_fn`` (``"sigmoid"``, ``"relu"``,
    ``"tanh"``, ``"clampexp"``) applies after ``x * score_scale`` and
    before ``x * output_scale``.  ``init_zeros`` zeroes the last layer's
    weight.  With ``dropout_rate``, the last layer's input is dropped out
    while the module is in training mode (``model.train()``, torch's
    default), with draws from ``generator`` (torch's default generator when
    None), as the JAX package's ``train=True`` with a key; ``model.eval()``
    turns it off.  The compute dtype of its layers is
    ``utils.set_compute_dtype``'s."""

    def __init__(self, layer_sizes=None, leaky: float = 0.0, score_scale=None,
                 output_fn: Optional[str] = None, output_scale=None,
                 init_zeros: bool = False, dropout_rate: Optional[float] = None,
                 layers=None, dropout=None, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        if layers is not None:
            if layer_sizes is not None:
                raise TypeError("pass either layer_sizes or layers, not both")
            layer_sizes = layers
        if layer_sizes is None:
            raise TypeError("layer_sizes (or layers) is required")
        if dropout is not None:
            if dropout_rate is not None:
                raise TypeError("pass either dropout_rate or dropout, not both")
            dropout_rate = dropout
        if output_fn is not None and output_fn not in _OUTPUT_FNS:
            raise NotImplementedError(f"output function {output_fn}")
        n = len(layer_sizes) - 1
        self.linears = nn.ModuleList(
            Linear(layer_sizes[i], layer_sizes[i + 1], zeros=init_zeros and i == n - 1,
                   generator=generator, device=device) for i in range(n))
        self.leaky = leaky
        self.score_scale = score_scale
        self.output_fn = output_fn
        self.output_scale = output_scale
        self.dropout_rate = dropout_rate

    @classmethod
    def create(cls, generator: Optional[torch.Generator], layer_sizes=None, leaky=0.0,
               score_scale=None, output_fn=None, output_scale=None, init_zeros=False,
               dropout_rate=None, layers=None, dropout=None, *, device="cuda"):
        """``generator`` draws the initial weights (it takes the place of the
        JAX ``key``; ``None`` uses torch's default generator)."""
        return cls(layer_sizes, leaky, score_scale, output_fn, output_scale, init_zeros,
                   dropout_rate, layers, dropout, generator=generator, device=device)

    def forward(self, x, *, generator: Optional[torch.Generator] = None):
        n = len(self.linears)
        for i, lin in enumerate(self.linears):
            if i == n - 1 and self.dropout_rate is not None and self.training:
                keep = 1.0 - self.dropout_rate
                mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
                x = torch.where(mask, x / keep, 0.0)
            x = lin(x)
            if i < n - 1:
                x = F.leaky_relu(x, self.leaky)
        if self.output_fn is not None:
            if self.score_scale is not None:
                x = x * self.score_scale
            x = _OUTPUT_FNS[self.output_fn](x)
            if self.output_scale is not None:
                x = x * self.output_scale
        return x
