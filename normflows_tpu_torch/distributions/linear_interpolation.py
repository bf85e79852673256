"""The annealing bridge (port of
``normflows_tpu/distributions/linear_interpolation.py``)."""

from __future__ import annotations

from torch import nn


class LinearInterpolation(nn.Module):
    """log p = alpha log p1 + (1 - alpha) log p2; ``alpha`` a Python float
    (static in the JAX package).  ``dist1`` and ``dist2`` stay the caller's
    modules: a ladder of bridges shares them."""

    def __init__(self, dist1: nn.Module, dist2: nn.Module, alpha: float = 0.5):
        super().__init__()
        self.dist1 = dist1
        self.dist2 = dist2
        self.alpha = float(alpha)

    def log_prob(self, z, context=None):
        return self.alpha * self.dist1.log_prob(z) + (1.0 - self.alpha) * self.dist2.log_prob(z)
