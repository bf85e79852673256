from .autoregressive import MaskedPiecewiseRationalQuadraticAutoregressive
from .coupling import PiecewiseRationalQuadraticCDF, PiecewiseRationalQuadraticCoupling
from .wrapper import (
    AutoregressiveRationalQuadraticSpline,
    CircularAutoregressiveRationalQuadraticSpline,
    CircularCoupledRationalQuadraticSpline,
    CoupledRationalQuadraticSpline,
)
