"""Flow layers of the port: the autoregressive and coupled RQ splines (on
vectors and on images), the affine autoregressive and coupling flows (Real
NVP), Glow's block and its parts (ActNorm, the invertible 1x1 convolution,
the squeeze), the other mixing flows, BatchNorm, the feature split, residual
flows, the planar, radial and periodic flows, and the stochastic (MCMC) layers
of stochastic normalizing flows."""

from ..core.flow import Flow, Reverse, Composite, Identity, ScanChain, zero_log_det_like_z
from . import base
from .affine.autoregressive import Autoregressive, MaskedAffineAutoregressive
from .affine.coupling import (
    AffineConstFlow,
    AffineCoupling,
    AffineCouplingBlock,
    CCAffineConst,
    MaskedAffineFlow,
)
from .affine.glow import GlowBlock
from .reshape import Merge, Split, Squeeze
from .mixing import Invertible1x1Conv, InvertibleAffine, LULinearPermute, Permute
from .normalization import ActNorm, BatchNorm
from .periodic import PeriodicShift, PeriodicWrap
from .planar import Planar
from .radial import Radial
from .residual import Residual, iResBlock
from .stochastic import HamiltonianMonteCarlo, MetropolisHastings
from .neural_spline import (
    MaskedPiecewiseRationalQuadraticAutoregressive,
    AutoregressiveRationalQuadraticSpline,
    CircularAutoregressiveRationalQuadraticSpline,
    PiecewiseRationalQuadraticCoupling,
    PiecewiseRationalQuadraticCDF,
    CoupledRationalQuadraticSpline,
    CircularCoupledRationalQuadraticSpline,
)

__all__ = [
    "Flow",
    "Reverse",
    "Composite",
    "Identity",
    "ScanChain",
    "Autoregressive",
    "MaskedAffineAutoregressive",
    "AffineConstFlow",
    "CCAffineConst",
    "AffineCoupling",
    "MaskedAffineFlow",
    "AffineCouplingBlock",
    "GlowBlock",
    "Split",
    "Merge",
    "Squeeze",
    "ActNorm",
    "BatchNorm",
    "Invertible1x1Conv",
    "InvertibleAffine",
    "Permute",
    "LULinearPermute",
    "MaskedPiecewiseRationalQuadraticAutoregressive",
    "AutoregressiveRationalQuadraticSpline",
    "CircularAutoregressiveRationalQuadraticSpline",
    "PiecewiseRationalQuadraticCoupling",
    "PiecewiseRationalQuadraticCDF",
    "CoupledRationalQuadraticSpline",
    "CircularCoupledRationalQuadraticSpline",
    "Residual",
    "iResBlock",
    "Planar",
    "Radial",
    "PeriodicWrap",
    "PeriodicShift",
    "MetropolisHastings",
    "HamiltonianMonteCarlo",
]
