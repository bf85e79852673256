from .autoregressive import MaskedPiecewiseRationalQuadraticAutoregressive
from .coupling import Coupling, PiecewiseRationalQuadraticCDF, PiecewiseRationalQuadraticCoupling
from .wrapper import (
    AutoregressiveRationalQuadraticSpline,
    CircularAutoregressiveRationalQuadraticSpline,
    CircularCoupledRationalQuadraticSpline,
    CoupledRationalQuadraticSpline,
)
