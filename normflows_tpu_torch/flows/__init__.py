"""Flow layers of this slice of the port."""

from ..core.flow import Flow, Reverse, Composite, Identity, zero_log_det_like_z
from . import base
from .affine.autoregressive import Autoregressive, MaskedAffineAutoregressive
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
    "LULinearPermute",
    "MaskedPiecewiseRationalQuadraticAutoregressive",
    "AutoregressiveRationalQuadraticSpline",
    "CircularAutoregressiveRationalQuadraticSpline",
    "PiecewiseRationalQuadraticCoupling",
    "PiecewiseRationalQuadraticCDF",
    "CoupledRationalQuadraticSpline",
    "CircularCoupledRationalQuadraticSpline",
]
