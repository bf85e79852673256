"""Distributions."""

from .base import (AffineGaussian, BaseDistribution, ClassCondDiagGaussian,
                   ConditionalDiagGaussian, DiagGaussian, GaussianMixture, GaussianPCA,
                   GlowBase, Uniform, UniformGaussian, one_hot)
from .decoder import BaseDecoder, NNBernoulliDecoder, NNDiagGaussianDecoder
from .encoder import BaseEncoder, ConstDiagGaussian, Dirac, NNDiagGaussian
from .encoder import Uniform as UniformEncoder
from .linear_interpolation import LinearInterpolation
from .mh_proposal import DiagGaussianProposal, MHProposal
from .prior import (ImagePrior, PriorDistribution, Sinusoidal, Sinusoidal_gap,
                    Sinusoidal_split, Smiley, TwoModes)
from .target import (CircularGaussianMixture, GaussianVonMises, RingMixture, Target,
                     TwoIndependent, TwoMoons)
from .target import ConditionalDiagGaussian as ConditionalDiagGaussianTarget
