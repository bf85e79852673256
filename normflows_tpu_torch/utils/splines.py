"""The spline functions under the name the reference and the JAX package
give them (``utils.splines``): they live in ``ops/splines.py``."""

from ..ops.splines import (  # noqa: F401
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    TAIL_CIRCULAR,
    TAIL_LINEAR,
    TAIL_NONE,
    make_knot_derivatives,
    rational_quadratic_spline,
    searchsorted,
    unconstrained_rational_quadratic_spline,
)
