"""User-facing NSF constructors (port of
``normflows_tpu/flows/neural_spline/wrapper.py``).

Note the direction flip: a wrapper's ``forward`` (latent -> data, sampling)
is its inner transform's ``inverse``, and its ``inverse`` (data -> latent,
for densities) the inner ``forward``.  For the autoregressive wrappers that
makes sampling the D-step recursion and the density one pass of the MAF;
for the coupling wrappers both directions are one pass of the transform
net and two flat spline launches (the coupling's and its CDF's).  Each takes
``num_context_channels`` (the context's width) and ``dropout_probability``
of its net; ``generator=`` turns the dropout on in a call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.flow import Flow
from ...nets.resnet import ResidualNet
from ...ops.splines import DEFAULT_MIN_DERIVATIVE
from ...utils.masks import create_alternating_binary_mask
from ...utils.nn import PeriodicFeaturesElementwise
from .autoregressive import MaskedPiecewiseRationalQuadraticAutoregressive
from .coupling import PiecewiseRationalQuadraticCoupling


def _identity_init_resnet(net: ResidualNet) -> ResidualNet:
    """Zero the final layer's weight and set its bias so that every spline
    starts as the identity: softplus(bias) + min_derivative == 1."""
    constant = float(np.log(np.exp(1 - DEFAULT_MIN_DERIVATIVE) - 1))
    with torch.no_grad():
        net.final_layer.weight.zero_()
        net.final_layer.bias.fill_(constant)
    return net


class CoupledRationalQuadraticSpline(Flow):
    """NSF coupling layer: an alternating mask, a ResidualNet transform net
    and the unconditional CDF on the identity features."""

    def __init__(self, prqct: PiecewiseRationalQuadraticCoupling):
        super().__init__()
        self.prqct = prqct

    @classmethod
    def create(
        cls,
        generator: Optional[torch.Generator],
        num_input_channels: int,
        num_blocks: int,
        num_hidden_channels: int,
        num_context_channels=None,
        num_bins: int = 8,
        tails="linear",
        tail_bound: float = 3.0,
        activation: str = "relu",
        reverse_mask: bool = False,
        dropout_probability: float = 0.0,
        init_identity: bool = True,
        *,
        device="cuda",
    ):
        """``generator`` draws the transform net's weights (the JAX ``key``'s
        place; ``None`` uses torch's default generator)."""
        def transform_net_create_fn(in_features, out_features):
            net = ResidualNet.create(
                generator, in_features, out_features, num_hidden_channels,
                context_features=num_context_channels, num_blocks=num_blocks,
                activation=activation, dropout_probability=dropout_probability,
                device=device)
            return _identity_init_resnet(net) if init_identity else net

        return cls(PiecewiseRationalQuadraticCoupling.create(
            mask=create_alternating_binary_mask(num_input_channels, even=reverse_mask).numpy(),
            transform_net_create_fn=transform_net_create_fn,
            num_bins=num_bins,
            tails=tails,
            tail_bound=tail_bound,
            apply_unconditional_transform=True,
            device=device,
        ))

    def forward(self, z, context=None, *, generator: Optional[torch.Generator] = None):
        return self.prqct.inverse(z, context, generator=generator)

    def inverse(self, z, context=None, *, generator: Optional[torch.Generator] = None):
        return self.prqct.forward(z, context, generator=generator)


class CircularCoupledRationalQuadraticSpline(CoupledRationalQuadraticSpline):
    """NSF coupling layer whose ``ind_circ`` dims are circular; the
    transform net sees the circular identity features through
    ``PeriodicFeaturesElementwise``.  ``tail_bound`` is a scalar or one
    bound per dim."""

    @classmethod
    def create(
        cls,
        generator: Optional[torch.Generator],
        num_input_channels: int,
        num_blocks: int,
        num_hidden_channels: int,
        ind_circ,
        num_context_channels=None,
        num_bins: int = 8,
        tail_bound=3.0,
        activation: str = "relu",
        reverse_mask: bool = False,
        mask=None,
        dropout_probability: float = 0.0,
        init_identity: bool = True,
        *,
        device="cuda",
    ):
        if mask is None:
            mask = create_alternating_binary_mask(num_input_channels, even=reverse_mask)
        mask = np.asarray(mask)
        identity_features = np.nonzero(mask <= 0)[0]
        ind_circ = list(np.asarray(ind_circ).reshape(-1))
        # positions of the circular dims within the identity split
        ind_circ_id = [i for i, idx in enumerate(identity_features) if idx in ind_circ]
        tb = np.asarray(tail_bound, np.float32)
        scale_pf = (np.pi / tb[identity_features[ind_circ_id]] if tb.ndim > 0
                    else np.pi / float(tail_bound))

        def transform_net_create_fn(in_features, out_features):
            pf = (PeriodicFeaturesElementwise(in_features, ind_circ_id, scale_pf, device=device)
                  if ind_circ_id else None)
            net = ResidualNet.create(
                generator, in_features, out_features, num_hidden_channels,
                context_features=num_context_channels, num_blocks=num_blocks,
                activation=activation, dropout_probability=dropout_probability,
                preprocessing=pf, device=device)
            return _identity_init_resnet(net) if init_identity else net

        tails = ["circular" if i in ind_circ else "linear" for i in range(num_input_channels)]
        return cls(PiecewiseRationalQuadraticCoupling.create(
            mask=mask,
            transform_net_create_fn=transform_net_create_fn,
            num_bins=num_bins,
            tails=tails,
            tail_bound=tail_bound,
            apply_unconditional_transform=True,
            device=device,
        ))


class AutoregressiveRationalQuadraticSpline(Flow):
    """NSF autoregressive layer with linear tails."""

    def __init__(self, mprqat: MaskedPiecewiseRationalQuadraticAutoregressive):
        super().__init__()
        self.mprqat = mprqat

    @classmethod
    def create(
        cls,
        generator: Optional[torch.Generator],
        num_input_channels: int,
        num_blocks: int,
        num_hidden_channels: int,
        num_context_channels=None,
        num_bins: int = 8,
        tail_bound: float = 3.0,
        activation: str = "relu",
        permute_mask: bool = False,
        dropout_probability: float = 0.0,
        init_identity: bool = True,
        rng_seed: int = 0,
        *,
        device="cuda",
    ):
        return cls(MaskedPiecewiseRationalQuadraticAutoregressive.create(
            generator,
            features=num_input_channels,
            hidden_features=num_hidden_channels,
            context_features=num_context_channels,
            num_bins=num_bins,
            tails="linear",
            tail_bound=tail_bound,
            num_blocks=num_blocks,
            use_residual_blocks=True,
            random_mask=False,
            permute_mask=permute_mask,
            activation=activation,
            dropout_probability=dropout_probability,
            init_identity=init_identity,
            rng_seed=rng_seed,
            device=device,
        ))

    def forward(self, z, context=None, *, generator: Optional[torch.Generator] = None):
        return self.mprqat.inverse(z, context, generator=generator)

    def inverse(self, z, context=None, *, generator: Optional[torch.Generator] = None):
        return self.mprqat.forward(z, context, generator=generator)


class CircularAutoregressiveRationalQuadraticSpline(AutoregressiveRationalQuadraticSpline):
    """NSF autoregressive layer whose ``ind_circ`` dims are circular."""

    @classmethod
    def create(
        cls,
        generator: Optional[torch.Generator],
        num_input_channels: int,
        num_blocks: int,
        num_hidden_channels: int,
        ind_circ,
        num_context_channels=None,
        num_bins: int = 8,
        tail_bound=3.0,
        activation: str = "relu",
        permute_mask: bool = True,
        dropout_probability: float = 0.0,
        init_identity: bool = True,
        rng_seed: int = 0,
        *,
        device="cuda",
    ):
        ind_circ = list(np.asarray(ind_circ).reshape(-1))
        tails = ["circular" if i in ind_circ else "linear"
                 for i in range(num_input_channels)]
        return cls(MaskedPiecewiseRationalQuadraticAutoregressive.create(
            generator,
            features=num_input_channels,
            hidden_features=num_hidden_channels,
            context_features=num_context_channels,
            num_bins=num_bins,
            tails=tails,
            tail_bound=tail_bound,
            num_blocks=num_blocks,
            use_residual_blocks=True,
            random_mask=False,
            permute_mask=permute_mask,
            activation=activation,
            dropout_probability=dropout_probability,
            init_identity=init_identity,
            rng_seed=rng_seed,
            device=device,
        ))
