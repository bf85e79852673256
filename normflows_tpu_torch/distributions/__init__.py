"""Distributions."""

from .base import (BaseDistribution, ClassCondDiagGaussian, ConditionalDiagGaussian,
                   DiagGaussian, GlowBase, Uniform, UniformGaussian, one_hot)
from .prior import (ImagePrior, PriorDistribution, Sinusoidal, Sinusoidal_gap,
                    Sinusoidal_split, Smiley, TwoModes)
from .target import (CircularGaussianMixture, GaussianVonMises, RingMixture, Target,
                     TwoIndependent, TwoMoons)
from .target import ConditionalDiagGaussian as ConditionalDiagGaussianTarget
