"""Distributions."""

from .base import (BaseDistribution, ConditionalDiagGaussian, DiagGaussian, Uniform,
                   UniformGaussian)
from .target import (CircularGaussianMixture, GaussianVonMises, RingMixture, Target,
                     TwoIndependent, TwoMoons)
from .target import ConditionalDiagGaussian as ConditionalDiagGaussianTarget
