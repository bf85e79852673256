"""Numerical kernels: the plain PyTorch spline, the planar and flat CUDA
spline kernels, and their build."""

from . import backend, cuda_build, spline_cuda, spline_flat, splines
from .backend import resolve_device, use_kernel
