"""Masked autoregressive RQ-spline transform (port of
``normflows_tpu/flows/neural_spline/autoregressive.py``).

Every dim takes the uniform 3K+1 parameter layout (widths | heights |
derivatives).  Both directions run the transposed MADE (``apply_t``).  Up to
8 features its output goes whole into the planar spline,
:func:`~normflows_tpu_torch.ops.spline_cuda.rqs_transposed`, as behind the
JAX package's gate ``_transposed_ok``.  Above 8 features the density
direction takes the flat spline on the (B, F, 3K+1) view of that output
(:func:`~normflows_tpu_torch.ops.spline_flat.unconstrained_rational_quadratic_spline_flat`,
as JAX's ``_elementwise``), and the sampling direction the sliced inverse,
whose steps each take one feature's slab
(:func:`~normflows_tpu_torch.ops.spline_flat.unconstrained_rqs_dyncodes`, as
JAX's ``_elementwise_inverse_row``).  Each is the CUDA kernel for a tensor on
the card and its plain version for a CPU tensor.  A context reaches the
splines through the MADE (``MADE.context_cache_t`` in both directions); with
dropout on, the (B, F) MADE feeds the same splines (see
``flows/affine/autoregressive.py``).

Constrained splines (``tails=None``: the K+1 slopes all learned, the spline
on [0, 1] with no tails) run the plain
:func:`~normflows_tpu_torch.ops.splines.constrained_rational_quadratic_spline`
on every device, as the JAX package runs its jnp spline there and no Pallas
kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...nets.made import MADE
from ...ops import spline_cuda, spline_flat, splines
from ...ops.backend import resolve_device
from ...utils.nn import PeriodicFeaturesElementwise
from ..affine.autoregressive import Autoregressive, MAX_UNROLLED_FEATURES


class MaskedPiecewiseRationalQuadraticAutoregressive(Autoregressive):
    """MADE-parameterised RQ-spline autoregressive transform."""

    def __init__(self, autoregressive_net, tail_codes, tail_bound, features: int,
                 num_bins: int,
                 min_bin_width: float = splines.DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height: float = splines.DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative: float = splines.DEFAULT_MIN_DERIVATIVE):
        super().__init__(autoregressive_net)
        # None: constrained (tails=None)
        self.constrained = tail_codes is None
        self.tail_codes = None if tail_codes is None else tuple(int(c) for c in tail_codes)
        self.tail_bound = tuple(float(b) for b in tail_bound)
        self.features = features
        self.num_bins = num_bins
        self.min_bin_width = min_bin_width
        self.min_bin_height = min_bin_height
        self.min_derivative = min_derivative

    @classmethod
    def create(
        cls,
        generator: Optional[torch.Generator],
        features: int,
        hidden_features: int,
        context_features=None,
        num_bins: int = 10,
        tails=None,
        tail_bound=1.0,
        num_blocks: int = 2,
        use_residual_blocks: bool = True,
        random_mask: bool = False,
        permute_mask: bool = False,
        activation: str = "relu",
        dropout_probability: float = 0.0,
        use_batch_norm: bool = False,
        init_identity: bool = True,
        rng_seed: int = 0,
        min_bin_width=splines.DEFAULT_MIN_BIN_WIDTH,
        min_bin_height=splines.DEFAULT_MIN_BIN_HEIGHT,
        min_derivative=splines.DEFAULT_MIN_DERIVATIVE,
        *,
        device="cuda",
    ):
        """``generator`` draws the initial weights (it takes the place of the
        JAX ``key``; ``None`` uses torch's default generator)."""
        device = resolve_device(device)
        # circular preprocessing
        preprocessing = None
        codes = None  # tails=None: constrained
        if isinstance(tails, (list, tuple)):
            ind_circ = [i for i in range(features) if tails[i] == "circular"]
            if ind_circ:
                tb = np.asarray(tail_bound, np.float32)
                scale_pf = np.pi / tb[ind_circ] if tb.ndim > 0 else np.pi / float(tail_bound)
                preprocessing = PeriodicFeaturesElementwise(
                    features, ind_circ, scale_pf, device=device)
            codes = [splines.tail_code(t) for t in tails]
        elif tails is not None:
            codes = [splines.tail_code(tails)] * features

        made = MADE(
            features=features,
            hidden_features=hidden_features,
            context_features=context_features,
            num_blocks=num_blocks,
            output_multiplier=3 * num_bins + 1,  # uniform layout
            use_residual_blocks=use_residual_blocks,
            random_mask=random_mask,
            permute_mask=permute_mask,
            activation=activation,
            dropout_probability=dropout_probability,
            use_batch_norm=use_batch_norm,
            preprocessing=preprocessing,
            rng_seed=rng_seed,
            generator=generator,
            device=device,
        )
        if init_identity:
            # softplus(constant) + min_derivative == 1: the identity spline
            constant = float(np.log(np.exp(1 - min_derivative) - 1))
            with torch.no_grad():
                made.final_layer.weight.zero_()
                made.final_layer.bias.fill_(constant)
        bound = (np.full(features, float(tail_bound), np.float32)
                 if np.ndim(tail_bound) == 0 else np.asarray(tail_bound, np.float32))
        return cls(made, codes, bound, features, num_bins, min_bin_width,
                   min_bin_height, min_derivative)

    def _constrained(self, x, p, inverse: bool):
        """The plain constrained spline of ``x`` (...) on its parameters
        ``p`` (..., 3K+1)."""
        K = self.num_bins
        return splines.constrained_rational_quadratic_spline(
            x, p[..., :K], p[..., K:2 * K], p[..., 2 * K:], inverse, self.min_bin_width,
            self.min_bin_height, self.min_derivative)

    # NOTE: unlike the coupling path, there is NO 1/sqrt(hidden) softmax
    # rescale here: the reference gates it on hasattr(net, "hidden_features")
    # and its MADE never sets that attribute, so the reference AR layer runs
    # unscaled (the JAX package checks this against the reference).
    def _elementwise_t(self, x_t, params_t, inverse: bool):
        F, B = x_t.shape
        if self.constrained:
            y, ld = self._constrained(x_t.T, params_t.T.reshape(B, F, -1), inverse)
            return y.T, ld.T
        if F <= MAX_UNROLLED_FEATURES:
            return spline_cuda.rqs_transposed(
                x_t, params_t, self.tail_codes, self.tail_bound, inverse,
                self.min_bin_width, self.min_bin_height, self.min_derivative)
        K = self.num_bins
        p = params_t.T.view(B, F, 3 * K + 1)
        y, ld = spline_flat.unconstrained_rational_quadratic_spline_flat(
            x_t.T, p[..., :K], p[..., K:2 * K], p[..., 2 * K:], self.tail_codes,
            self.tail_bound, inverse, self.min_bin_width, self.min_bin_height,
            self.min_derivative)
        return y.T, ld.T

    def _sliced_tails(self, x_t):
        """Each feature's tail code and bound spread over the batch, (F, B)
        each: made once a call, a row of each for every step; None for a
        constrained spline."""
        if self.constrained:
            return None
        F, B = x_t.shape
        rows = []
        for values, dtype in ((self.tail_codes, torch.int32), (self.tail_bound, x_t.dtype)):
            per_dim = spline_flat.per_dim(values, dtype, x_t.device)
            rows.append(per_dim[:, None].expand(F, B).contiguous())
        return rows

    def _elementwise_inverse_row(self, x_row, params_rows, dim_idx: int, tails=None):
        """One feature's RQS inverse, for a step of the sliced inverse: its
        (3K+1, B) slab of the net's output, rows of one contiguous tensor,
        goes to the flat kernel as it lies (a constrained spline takes the
        plain spline)."""
        if self.constrained:
            y, ld = self._constrained(x_row[:, None], params_rows.T[:, None], True)
            return y[:, 0], ld[:, 0]
        codes, bounds = tails
        K = self.num_bins
        return spline_flat.unconstrained_rqs_dyncodes(
            x_row, params_rows[:K], params_rows[K:2 * K], params_rows[2 * K:],
            codes[dim_idx], bounds[dim_idx], True, self.min_bin_width,
            self.min_bin_height, self.min_derivative)
