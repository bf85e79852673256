"""Distributions."""

from .base import BaseDistribution, DiagGaussian, UniformGaussian
from .target import Target, GaussianVonMises, TwoMoons
