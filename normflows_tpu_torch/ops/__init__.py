"""Numerical kernels: the plain PyTorch spline, the planar and flat CUDA
spline kernels, the flat backward's ablation, the fused MADE's CUDA kernels,
and their build."""

from . import backend, cuda_build, made_fused, spline_ablate, spline_cuda, spline_flat, splines
from .backend import resolve_device, use_kernel
