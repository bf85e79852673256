"""MADE, the masked autoregressive parameter network (port of
``normflows_tpu/nets/made.py``).

The degree masks come from the same numpy code as the JAX package, so they
are bit-equal; they are buffers, and each masked matmul is a dense
``(weight * mask)`` product.  Weights are stored torch-style, (out, in), and
so are the masks.

``MaskedLinear`` (with the JAX package's random masks, drawn from
``np.random.default_rng(rng_seed)`` as there), ``MaskedFeedforwardBlock``,
``MaskedResidualBlock`` and ``MADE`` with ``apply_t``.  A conditional MADE
(``context_features``) adds a projection of the context to the first
hidden layer and gates each residual block's output with the sigmoid of
its own projection (the GLU gate); :meth:`MADE.context_cache_t` projects
the context once for the transposed passes of a recursion.

Dropout (``dropout_probability``) acts where a caller passes a
``torch.Generator`` as ``generator=``, the stand-in for the JAX package's
key: without one the net is the deterministic eval-mode function.  The
masks come from ``nets.resnet._dropout_keep``.  With
``ops.backend.set_made_fusion(True)``, ``MADE.forward`` runs the whole MADE
as the fused kernels of ``ops/made_fused.py`` where their gate ``fusable``
holds and no generator is passed, as the JAX package's ``MADE.__call__``
does; ``apply_t`` is never fused.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops import backend, made_fused
from ..ops.backend import resolve_device
from . import resnet
from .mlp import Linear, uniform_


def _input_degrees(features: int) -> np.ndarray:
    return np.arange(1, features + 1)


def _hidden_degrees(out_features: int, autoregressive_features: int,
                    rng: Optional[np.random.Generator], min_in_degree: int):
    """Degrees for a hidden masked layer (same code as the JAX package)."""
    if rng is not None:  # random mask
        lo = min(min_in_degree, autoregressive_features - 1)
        return rng.integers(lo, autoregressive_features, size=out_features)
    max_ = max(1, autoregressive_features - 1)
    min_ = min(1, autoregressive_features - 1)
    return np.arange(out_features) % max_ + min_


def _act(name, x):
    if name == "relu":
        return torch.relu(x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "leaky_relu":
        return torch.nn.functional.leaky_relu(x)
    raise NotImplementedError(f"activation {name}")


class MaskedLinear(Linear):
    """Linear layer with a fixed autoregressive mask.

    ``weight`` and ``mask`` are (out, in); ``degrees`` (out,) are the output
    degrees.  With ``compute_dtype`` set (``utils.precision``) the matmul and
    the bias add run in that dtype and the activation stays in it, as in the
    JAX package: the MADE casts its output back to the input dtype."""

    def __init__(self, in_degrees, out_features: int, autoregressive_features: int,
                 random_mask: bool = False, is_output: bool = False,
                 bias: bool = True, out_degrees_=None, rng_seed: int = 0, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        device = resolve_device(device)
        in_degrees = np.asarray(in_degrees)
        if is_output:
            if out_degrees_ is None:
                out_degrees_ = _input_degrees(autoregressive_features)
            out_degrees = np.repeat(np.asarray(out_degrees_),
                                    out_features // autoregressive_features)
            # strict mask: an output sees only strictly lower degrees
            mask = (out_degrees[:, None] > in_degrees[None, :]).astype(np.float32)
        else:
            rng = np.random.default_rng(rng_seed) if random_mask else None
            out_degrees = _hidden_degrees(out_features, autoregressive_features,
                                          rng, int(in_degrees.min()))
            mask = (out_degrees[:, None] >= in_degrees[None, :]).astype(np.float32)
        super().__init__(len(in_degrees), out_features, bias,
                         generator=generator, device=device)
        self.register_buffer("mask", torch.as_tensor(mask, device=device))
        self.register_buffer("degrees", torch.as_tensor(out_degrees, device=device))

    def np_degrees(self) -> np.ndarray:
        return self.degrees.cpu().numpy()

    def forward(self, x):
        """(B, in) -> (B, out)."""
        return self.finish(self.product(x, self.weight * self.mask), self.bias, x.dtype)

    def apply_t(self, x_t):
        """Transposed layout, (in, B) -> (out, B): the batch stays on the last
        axis, the layout the planar spline kernel takes."""
        return self.finish_t(self.product_t(x_t, self.weight * self.mask), self.bias)

    def product(self, x, w):
        """``x @ w.T`` with the masked weight ``w`` (or a shard of it), in
        the compute dtype where one is set, before the bias."""
        if self.compute_dtype is not None:
            return x.to(self.compute_dtype) @ w.to(self.compute_dtype).T
        return x @ w.T

    def finish(self, y, bias, dtype=None):
        """The product ``y`` plus ``bias`` (None: none), in the compute
        dtype where one is set (the MADE casts its output back)."""
        if bias is None:
            return y
        return y + (bias.to(self.compute_dtype) if self.compute_dtype is not None else bias)

    def product_t(self, x_t, w):
        """:meth:`product` in the transposed layout: ``w @ x_t``."""
        if self.compute_dtype is not None:
            return w.to(self.compute_dtype) @ x_t.to(self.compute_dtype)
        return w @ x_t

    def finish_t(self, y, bias):
        """:meth:`finish` in the transposed layout (the bias a column)."""
        return self.finish(y, None if bias is None else bias[:, None])




class MaskedFeedforwardBlock(nn.Module):
    """A masked linear (random or cyclic degrees) and its activation, with
    dropout after it; a context does not enter it (as in the JAX
    package)."""

    def __init__(self, in_degrees, autoregressive_features: int,
                 random_mask: bool = False, activation: str = "relu",
                 dropout_probability: float = 0.0, rng_seed: int = 0, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.linear = MaskedLinear(in_degrees, len(in_degrees), autoregressive_features,
                                   random_mask=random_mask, rng_seed=rng_seed,
                                   generator=generator, device=device)
        self.activation = activation
        self.dropout_probability = dropout_probability

    def np_degrees(self) -> np.ndarray:
        return self.linear.np_degrees()

    def forward(self, x, context=None, *, generator: Optional[torch.Generator] = None):
        return resnet._dropout(_act(self.activation, self.linear(x)),
                               self.dropout_probability, generator)

    def apply_t(self, x_t, gate_t=None):
        return _act(self.activation, self.linear.apply_t(x_t))


class MaskedResidualBlock(nn.Module):
    """Two masked linears with a residual connection; with
    ``context_features``, the second linear's output is gated by
    sigmoid(context_layer(context)) (GLU).

    ``zero_initialization`` draws the second linear's weight and bias from
    U(-1e-3, 1e-3), as the JAX package does, so the block starts near the
    identity."""

    def __init__(self, in_degrees, autoregressive_features: int,
                 context_features=None, activation: str = "relu",
                 dropout_probability: float = 0.0,
                 zero_initialization: bool = True, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        f = len(in_degrees)
        self.linear_0 = MaskedLinear(in_degrees, f, autoregressive_features,
                                     generator=generator, device=device)
        self.linear_1 = MaskedLinear(self.linear_0.np_degrees(), f,
                                     autoregressive_features,
                                     generator=generator, device=device)
        if not np.all(self.linear_1.np_degrees() >= np.asarray(in_degrees)):
            raise RuntimeError(
                "In a masked residual block, the output degrees can't be"
                " less than the corresponding input degrees.")
        if zero_initialization:
            with torch.no_grad():
                self.linear_1.weight.copy_(uniform_((f, f), 1e-3, generator, device))
                self.linear_1.bias.copy_(uniform_((f,), 1e-3, generator, device))
        self.context_layer = (Linear(context_features, f, generator=generator, device=device)
                              if context_features is not None else None)
        self.activation = activation
        self.dropout_probability = dropout_probability

    def np_degrees(self) -> np.ndarray:
        return self.linear_1.np_degrees()

    def forward(self, x, context=None, *, generator: Optional[torch.Generator] = None):
        temps = self.linear_0(_act(self.activation, x))
        temps = _act(self.activation, temps)
        temps = resnet._dropout(temps, self.dropout_probability, generator)
        temps = self.linear_1(temps)
        if context is not None and self.context_layer is not None:
            gate = torch.sigmoid(self.context_layer(context))
            temps = temps * gate.to(temps.dtype)
        return x + temps

    def apply_t(self, x_t, gate_t=None):
        """Transposed block; ``gate_t`` is the (H, B) or (H, 1) GLU gate
        that :meth:`MADE.context_cache_t` made."""
        temps = self.linear_0.apply_t(_act(self.activation, x_t))
        temps = self.linear_1.apply_t(_act(self.activation, temps))
        if gate_t is not None:
            temps = temps * gate_t.to(temps.dtype)
        return x_t + temps


class MADE(nn.Module):
    """MADE with residual or feedforward blocks.

    ``input_order`` holds the feature positions sorted by autoregressive
    degree (the argsort of the possibly permuted input degrees), and
    ``input_order_host`` the same as a tuple of ints."""

    # host copies of a buffer, which may differ between the layers of a
    # core.flow.ScanChain: it sets each layer's own before the layer runs
    host_mirrors = ("input_order_host",)

    def __init__(self, features: int, hidden_features: int,
                 context_features=None, num_blocks: int = 2,
                 output_multiplier: int = 1, use_residual_blocks: bool = True,
                 random_mask: bool = False, permute_mask: bool = False,
                 activation: str = "relu", dropout_probability: float = 0.0,
                 use_batch_norm: bool = False, preprocessing=None,
                 rng_seed: int = 0, *, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if use_batch_norm:
            raise NotImplementedError(
                "use_batch_norm=True is not supported (nor by the JAX package)")
        if use_residual_blocks and random_mask:
            raise ValueError("Residual blocks can't be used with random masks.")
        device = resolve_device(device)
        input_degrees_ = _input_degrees(features)
        if permute_mask:
            rng = np.random.default_rng(rng_seed)
            input_degrees_ = input_degrees_[rng.permutation(features)]
        self.initial_layer = MaskedLinear(
            input_degrees_, hidden_features, features, random_mask=random_mask,
            rng_seed=rng_seed, generator=generator, device=device)
        self.context_layer = (
            Linear(context_features, hidden_features, generator=generator, device=device)
            if context_features is not None else None)
        blocks = []
        prev = self.initial_layer.np_degrees()
        for i in range(num_blocks):
            if use_residual_blocks:
                block = MaskedResidualBlock(
                    prev, features, context_features=context_features,
                    activation=activation, dropout_probability=dropout_probability,
                    generator=generator, device=device)
            else:
                block = MaskedFeedforwardBlock(
                    prev, features, random_mask=random_mask, activation=activation,
                    dropout_probability=dropout_probability, rng_seed=rng_seed + i + 1,
                    generator=generator, device=device)
            prev = block.np_degrees()
            blocks.append(block)
        self.blocks = nn.ModuleList(blocks)
        self.final_layer = MaskedLinear(
            prev, features * output_multiplier, features, is_output=True,
            out_degrees_=input_degrees_, generator=generator, device=device)
        self.preprocessing = preprocessing
        self.hidden_features = hidden_features
        order = np.argsort(input_degrees_, kind="stable")
        self.register_buffer("input_order", torch.as_tensor(order, device=device))
        # the same on the host, for loops that index features by it
        self.input_order_host = tuple(int(i) for i in order)

    def fuses(self, x, context=None) -> bool:
        """Whether :meth:`forward` on ``x`` with no generator takes the fused
        kernels: fusion is on and ``made_fused.fusable`` holds (the
        preprocessing is elementwise, so ``x`` stands for its output)."""
        return backend.made_fusion_enabled() and made_fused.fusable(self, x, context)

    def forward(self, x, context=None, *, generator: Optional[torch.Generator] = None):
        """(B, F) -> (B, F * output_multiplier).  ``generator`` turns dropout
        on (the JAX package's ``key=..., train=True``) and fusion off."""
        out = self.preprocessing(x) if self.preprocessing is not None else x
        if generator is None and self.fuses(out, context):
            return made_fused.made_apply_fused(self, out).to(x.dtype)
        out = self.initial_layer(out)
        if context is not None and self.context_layer is not None:
            out = out + self.context_layer(context).to(out.dtype)
        for block in self.blocks:
            out = block(out, context, generator=generator)
        return self.final_layer(out).to(x.dtype)

    def supports_t(self) -> bool:
        """Whether :meth:`apply_t` applies: the preprocessing, if any, must
        have a transposed form too."""
        return self.preprocessing is None or hasattr(self.preprocessing, "apply_t")

    def context_cache_t(self, context):
        """The context's terms of :meth:`apply_t`, projected once for the
        passes of a recursion, which all see the same context: the first
        hidden layer's additive (H, B) term and each residual block's
        (H, B) GLU gate (None for a block without one).  None when there is
        nothing to cache.  A 1-D (unbatched) context becomes an (H, 1)
        column, which broadcasts over the batch: an (H,) row would broadcast
        along the wrong axis, silently where B == H."""
        if context is None or self.context_layer is None:
            return None
        context = torch.atleast_2d(context)
        # each term in the dtype :meth:`apply_t` adds it in (the compute
        # dtype of the layer it meets), cast once here, not once a pass
        dt = self.initial_layer.compute_dtype
        init_t = self.context_layer(context).T
        gates = tuple(
            torch.sigmoid(b.context_layer(context)).T.to(b.linear_1.compute_dtype or
                                                          context.dtype)
            if getattr(b, "context_layer", None) is not None else None
            for b in self.blocks)
        return init_t.to(dt or init_t.dtype), gates

    def apply_t(self, x_t, ctx_cache=None):
        """Transposed layout, (F, B) -> (P, B), with the batch on the last
        axis from the MADE input to the spline kernel.  ``ctx_cache`` is
        :meth:`context_cache_t`'s output."""
        out = self.preprocessing.apply_t(x_t) if self.preprocessing is not None else x_t
        out = self.initial_layer.apply_t(out)
        if ctx_cache is not None:
            out = out + ctx_cache[0].to(out.dtype)
        gates = ctx_cache[1] if ctx_cache is not None else (None,) * len(self.blocks)
        for block, gate_t in zip(self.blocks, gates):
            out = block.apply_t(out, gate_t)
        return self.final_layer.apply_t(out).to(x_t.dtype)
