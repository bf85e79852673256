"""Flow layers of the port: the autoregressive and coupled RQ splines, the
affine autoregressive and coupling flows (Real NVP), ``LULinearPermute`` and
the feature split."""

from ..core.flow import Flow, Reverse, Composite, Identity, zero_log_det_like_z
from . import base
from .affine.autoregressive import Autoregressive, MaskedAffineAutoregressive
from .affine.coupling import (
    AffineConstFlow,
    AffineCoupling,
    AffineCouplingBlock,
    CCAffineConst,
    MaskedAffineFlow,
)
from .reshape import Merge, Split
from .mixing import LULinearPermute
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
    "Autoregressive",
    "MaskedAffineAutoregressive",
    "AffineConstFlow",
    "CCAffineConst",
    "AffineCoupling",
    "MaskedAffineFlow",
    "AffineCouplingBlock",
    "Split",
    "Merge",
    "LULinearPermute",
    "MaskedPiecewiseRationalQuadraticAutoregressive",
    "AutoregressiveRationalQuadraticSpline",
    "CircularAutoregressiveRationalQuadraticSpline",
    "PiecewiseRationalQuadraticCoupling",
    "PiecewiseRationalQuadraticCDF",
    "CoupledRationalQuadraticSpline",
    "CircularCoupledRationalQuadraticSpline",
]
