"""Autoregressive flows (port of ``normflows_tpu/flows/affine/autoregressive.py``).

The port runs the autoregressive transform in the transposed layout (the
batch on the last axis) from the MADE to the elementwise transform, which
the JAX package does only on its planar kernel path.  The base class holds
the two directions; a subclass supplies the elementwise transform
:meth:`Autoregressive._elementwise_t` and, for more than 8 features, the
one-feature inverse :meth:`Autoregressive._elementwise_inverse_row`.

The inverse is the D-step recursion.  For D <= 8 features it is unrolled.
Without a context its first pass is the batch-1 pass of the JAX package:
the degree-1 outputs of the MADE see no input, and every sample starts from
the same zero carry, so one column broadcast over the batch is exact.  With
a context those outputs differ from sample to sample, and the first pass is
full width, as in the JAX package.  For D > 8 it is the sliced inverse of the
JAX package (``Autoregressive._inverse_sliced``): step t runs the full MADE
on the carry, but only the feature of degree t+1 becomes final, so only its
(mult, B) slab of the net's output goes through the elementwise inverse.  A
context is projected once a call for all the passes
(``MADE.context_cache_t``).

The density direction (:meth:`Autoregressive.forward`) is one MADE pass.
Above 8 features, with the fused MADE on (``ops.backend.set_made_fusion``)
and its gate holding, that pass is the fused (B, F) kernel, as in the JAX
package, whose ``_transposed_ok`` sends more than 8 features to
``MADE.__call__``; its (B, P) output goes to the elementwise transform as the
transposed view (P, B).  The recursion stays on ``apply_t``.

Dropout follows the JAX package: it acts where the caller passes a
``torch.Generator`` as ``generator=`` (the JAX ``key``) and a block of the
MADE has ``dropout_probability > 0`` (``utils.nn.net_dropout_active``).
Then each pass is the (B, F) ``MADE.forward`` with that generator, a fresh
mask each pass of the recursion, and the inverse never takes the batch-1
pass or the sliced inverse.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.flow import Flow
from ...nets.made import MADE
from ...utils.nn import net_dropout_active

MAX_UNROLLED_FEATURES = 8
_LATER = "a later slice of the PyTorch port"


class Autoregressive(Flow):
    """Elementwise transform with autoregressive parameters from
    ``autoregressive_net`` (a MADE with ``apply_t``)."""

    def __init__(self, autoregressive_net: nn.Module):
        super().__init__()
        if not autoregressive_net.supports_t():
            raise NotImplementedError(
                f"an autoregressive net without a transposed form waits for {_LATER}")
        self.autoregressive_net = autoregressive_net

    def _elementwise_t(self, x_t, params_t, inverse: bool):
        """x_t (F, B), params_t (P, B) -> (y_t (F, B), log|det| (F, B))."""
        raise NotImplementedError

    def _elementwise_inverse_single(self, x_col, params, dim_idx: int):
        """Inverse transform of ONE feature column: ``x_col`` (B, 1),
        ``params`` (B, mult), ``dim_idx`` the feature's position; returns
        ``(y_col (B, 1), log|det| (B,))``."""
        raise NotImplementedError

    def _elementwise_inverse_row(self, x_row, params_rows, dim_idx: int, tails=None):
        """One step of the sliced inverse in the transposed layout: ``x_row``
        (B,), ``params_rows`` (mult, B) -> ``(y_row (B,), log|det| (B,))``.
        ``tails`` is what :meth:`_sliced_tails` made for this call.  The
        default bridges to :meth:`_elementwise_inverse_single` by two
        transposes."""
        y_col, ld = self._elementwise_inverse_single(x_row[:, None], params_rows.T, dim_idx)
        return y_col[:, 0], ld

    def _sliced_tails(self, x_t):
        """Per-call state of the sliced inverse, made once before its D
        steps (the spline's tail rows); None by default."""
        return None

    def _check(self, inputs):
        if inputs.dim() != 2:
            raise NotImplementedError(
                f"autoregressive flows take (batch, features) inputs in this slice, "
                f"got shape {tuple(inputs.shape)}")

    def forward(self, inputs, context=None, *, generator: Optional[torch.Generator] = None):
        self._check(inputs)
        net = self.autoregressive_net
        x_t = inputs.T.contiguous()
        if net_dropout_active(net, generator):
            params_t = net(inputs, context, generator=generator).T.contiguous()
        elif inputs.shape[1] > MAX_UNROLLED_FEATURES and net.fuses(inputs, context):
            params_t = net(inputs).T  # the fused (B, P) output, viewed (P, B)
        else:
            params_t = net.apply_t(x_t, net.context_cache_t(context))
        y_t, ld_t = self._elementwise_t(x_t, params_t, inverse=False)
        return y_t.T, ld_t.sum(dim=0)

    def inverse(self, inputs, context=None, *, generator: Optional[torch.Generator] = None):
        self._check(inputs)
        F, B = inputs.shape[1], inputs.shape[0]
        net = self.autoregressive_net
        if net_dropout_active(net, generator):
            return self._inverse_dropout(inputs, context, generator)
        if F > MAX_UNROLLED_FEATURES:
            return self._inverse_sliced(inputs, context)
        x_t = inputs.T.contiguous()
        cache = net.context_cache_t(context)
        if cache is None:
            # pass 1: batch-1 MADE pass, broadcast over the batch (exact)
            p1 = net.apply_t(x_t.new_zeros(F, 1))
            params_t = p1.expand(p1.shape[0], B).contiguous()
        else:
            # the context differs between samples: a full-width pass 1
            params_t = net.apply_t(torch.zeros_like(x_t), cache)
        out_t, ld_t = self._elementwise_t(x_t, params_t, inverse=True)
        for _ in range(1, F):
            params_t = net.apply_t(out_t, cache)
            out_t, ld_t = self._elementwise_t(x_t, params_t, inverse=True)
        return out_t.T, ld_t.sum(dim=0)

    def _inverse_dropout(self, inputs, context, generator):
        """The recursion with dropout on: D passes of the (B, F) MADE, each
        with its own masks from ``generator``, as the JAX package's
        recursion under a key."""
        net = self.autoregressive_net
        x_t = inputs.T.contiguous()
        out = torch.zeros_like(inputs)
        for _ in range(inputs.shape[1]):
            params_t = net(out, context, generator=generator).T.contiguous()
            out_t, ld_t = self._elementwise_t(x_t, params_t, inverse=True)
            out = out_t.T
        return out, ld_t.sum(dim=0)

    def _inverse_sliced(self, inputs, context=None):
        """The sliced sequential inverse (JAX ``_inverse_sliced``): D full
        MADE passes, each followed by the one-feature inverse of the feature
        of the next degree.  The feature order is a host tuple, so no step
        waits on the device; the carry's row is replaced out of place,
        because autograd has saved the carry for the MADE's backward.  A
        context is projected once, before the D passes."""
        net = self.autoregressive_net
        B, F = inputs.shape
        mult = net.final_layer.weight.shape[0] // F
        x_t = inputs.T.contiguous()
        tails = self._sliced_tails(x_t)
        cache = net.context_cache_t(context)
        out_t = torch.zeros_like(x_t)
        ld = x_t.new_zeros(B)
        for p in net.input_order_host:
            params_t = net.apply_t(out_t, cache)  # (F * mult, B)
            y_row, ld_row = self._elementwise_inverse_row(
                x_t[p], params_t[p * mult:(p + 1) * mult], p, tails)
            out_t = torch.cat((out_t[:p], y_row[None].to(out_t.dtype), out_t[p + 1:]))
            ld = ld + ld_row
        return out_t.T, ld


def _constrain_scale(unconstrained):
    """MAF scale parameterisation, sigmoid(s + 2) + 1e-3: the one source for
    the full-width and the one-feature paths."""
    return torch.sigmoid(unconstrained + 2.0) + 1e-3


class MaskedAffineAutoregressive(Autoregressive):
    """MAF layer; scale = sigmoid(s + 2) + 1e-3.  The MADE's output
    multiplier is 2: row ``2 f`` of its transposed output holds feature f's
    unconstrained scale, row ``2 f + 1`` its shift.  The MADE takes the
    context, dropout, feedforward blocks and random masks of the JAX
    package."""

    def __init__(self, autoregressive_net, features: int):
        super().__init__(autoregressive_net)
        self.features = features

    @classmethod
    def create(
        cls,
        generator: Optional[torch.Generator],
        features: int,
        hidden_features: int,
        context_features=None,
        num_blocks: int = 2,
        use_residual_blocks: bool = True,
        random_mask: bool = False,
        activation: str = "relu",
        dropout_probability: float = 0.0,
        use_batch_norm: bool = False,
        rng_seed: int = 0,
        *,
        device="cuda",
    ):
        """``generator`` draws the initial weights (it takes the place of the
        JAX ``key``; ``None`` uses torch's default generator)."""
        made = MADE(
            features=features,
            hidden_features=hidden_features,
            context_features=context_features,
            num_blocks=num_blocks,
            output_multiplier=2,
            use_residual_blocks=use_residual_blocks,
            random_mask=random_mask,
            activation=activation,
            dropout_probability=dropout_probability,
            use_batch_norm=use_batch_norm,
            rng_seed=rng_seed,
            generator=generator,
            device=device,
        )
        return cls(made, features)

    def _elementwise_t(self, x_t, params_t, inverse: bool):
        p = params_t.view(self.features, 2, -1)
        scale = _constrain_scale(p[:, 0])
        shift = p[:, 1]
        if inverse:
            return (x_t - shift) / scale, -torch.log(scale)
        return scale * x_t + shift, torch.log(scale)

    def _elementwise_inverse_single(self, x_col, params, dim_idx: int):
        # params (B, 2): [unconstrained scale, shift]
        scale = _constrain_scale(params[:, :1])
        shift = params[:, 1:]
        return (x_col - shift) / scale, -torch.log(scale[:, 0])

    def _elementwise_inverse_row(self, x_row, params_rows, dim_idx: int, tails=None):
        # planar form, no transposes: params_rows (2, B)
        scale = _constrain_scale(params_rows[0])
        return (x_row - params_rows[1]) / scale, -torch.log(scale)
