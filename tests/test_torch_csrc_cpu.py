"""The spline kernels' CUDA sources (``normflows_tpu_torch/csrc/rqs_flat.cu``,
``rqs_transposed.cu``) compiled for the CPU with ``g++`` and run there.

A small stand-in ``cuda_runtime.h`` defines the CUDA keywords away and runs a
launch ``kernel<<<grid, block, 0, stream>>>(args)`` as a loop over every
block and thread; a regex rewrites each launch into that loop.  The kernels'
C functions are then called through ctypes on CPU tensors.  Compiled with
``-ffp-contract=off`` (no multiply-add fused into an fma), this holds:

* each kernel, forward and backward, against the float64 plain version at
  the card's bars, at every instantiation (K = 2, 8, 10, 16, 20) and a
  ragged N;
* the register forms (``select_bin_regs``, ``spline_element_backward_regs``)
  bit for bit against the loops over a runtime K they replaced (the
  design-step variants ``loops_256``, ``backward_loops_256`` and
  ``planar_loops_256``): the same operations in the same order.  On the card
  nvcc contracts multiply-adds differently in the flat backward's two forms,
  so there it is the float64 bars that hold them (tests/test_torch_gpu.py).

Needs ``g++`` (skips without it); warp intrinsics do not compile here.
"""

import ctypes
import math
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from normflows_tpu_torch.examples import design_steps
from normflows_tpu_torch.ops import spline_cuda, spline_flat

torch.set_num_threads(2)

BINS = [2, 8, 10, 16, 20]
DIRECTIONS = pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
MINS = (1e-3, 1e-3, 1e-3)  # min bin width, min bin height, min derivative
CODES, BOUNDS = (1, 2), (5.0, math.pi)

STAND_IN = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class Kernel, class... Args>
void cpu_launch(dim3 grid, dim3 block, int, cudaStream_t, Kernel kernel, Args... args) {
  gridDim = grid;
  blockDim = block;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx)
      for (unsigned tx = 0; tx < block.x; ++tx) {
        blockIdx = {bx, by, 0};
        threadIdx = {tx, 0, 0};
        kernel(args...);
      }
}
"""


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """``{name: CDLL}`` of the shipped sources and the loops variants."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    root = tmp_path_factory.mktemp("csrc_cpu")
    (root / "include").mkdir()
    (root / "include" / "cuda_runtime.h").write_text(STAND_IN)
    variants = design_steps.write_variants(root / "variants")
    sources = {"flat": ("flat", spline_flat.SOURCE), "planar": ("planar", spline_cuda.SOURCE),
               **{name: (kind, variants[(kind, name)]) for kind, name in (
                   ("flat", "loops_256"), ("flat", "backward_loops_256"),
                   ("planar", "planar_loops_256"))}}
    out = {}
    for name, (kind, source) in sources.items():
        text = re.sub(r"(\w+<[^<>;]*>)<<<(.*?)>>>\(", r"cpu_launch(\2, \1, ", source.read_text())
        cpp = root / f"{name}.cpp"
        cpp.write_text(text)
        lib = root / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-w",
                        "-I", str(root / "include"), "-I", str(source.parent), "-o", str(lib),
                        str(cpp)], check=True, capture_output=True)
        out[name] = ctypes.CDLL(str(lib))
        signatures = spline_flat._SIGNATURES if kind == "flat" else spline_cuda._SIGNATURES
        for fn, argtypes in signatures.items():
            getattr(out[name], fn).argtypes = argtypes
            getattr(out[name], fn).restype = ctypes.c_int
    return out


def flat_case(K, seed):
    """x, uw_t, uh_t, ud_t, codes, bounds (one feature's rows of a wider
    tensor) and cotangents, N = 293, ~20% of x outside the bounds."""
    rng = np.random.default_rng(seed)
    N, S = 293, 3 * K + 1
    codes = rng.choice([1, 2], size=N).astype(np.int32)
    bounds = np.where(codes == 1, 3.0, np.pi).astype(np.float32)
    x = (rng.uniform(-1.25, 1.25, N) * bounds).astype(np.float32)
    p = torch.from_numpy((0.3 * rng.normal(size=(3 * S, N))).astype(np.float32))[S:2 * S]
    t = torch.from_numpy
    return ((t(x), p[:K], p[K:2 * K], p[2 * K:], t(codes), t(bounds)),
            tuple(map(t, rng.normal(size=(2, N)).astype(np.float32))))


def flat_run(lib, args, cts, inverse):
    x, uw = args[0], args[1]
    N, K = x.shape[0], uw.shape[0]
    y, ld, dx, dp = torch.empty(N), torch.empty(N), torch.empty(N), torch.empty(3 * K + 1, N)
    tail = (N, K, args[3].stride(0), int(inverse), *MINS, None)
    assert lib.rqs_flat_forward(*(a.data_ptr() for a in (*args, y, ld)), *tail) == 0
    assert lib.rqs_flat_backward(*(a.data_ptr() for a in (*args, *cts, dx, dp)), *tail) == 0
    return y, ld, dx, dp[:K], dp[K:2 * K], dp[2 * K:]


def planar_run(lib, x, p, K, inverse):
    F, B = x.shape
    y, ld = torch.empty_like(x), torch.empty_like(x)
    rc = lib.rqs_transposed_forward(x.data_ptr(), p.data_ptr(), y.data_ptr(), ld.data_ptr(),
                                    (ctypes.c_int * F)(*CODES), (ctypes.c_float * F)(*BOUNDS),
                                    F, B, K, int(inverse), *MINS, None)
    assert rc == 0
    return y, ld


def close(a, b, tol, name):
    np.testing.assert_allclose(a.double().numpy(), b.double().numpy(), atol=tol, rtol=tol,
                               err_msg=name)


@DIRECTIONS
@pytest.mark.parametrize("K", BINS)
def test_flat_kernels_on_the_cpu(libs, K, inverse):
    args, cts = flat_case(K, seed=K)
    got = flat_run(libs["flat"], args, cts, inverse)
    f64 = [a.double() if a.is_floating_point() else a for a in (*args, *cts)]
    want = (*spline_flat.unconstrained_rqs_dyncodes_reference(*f64[:6], inverse),
            *spline_flat.unconstrained_rqs_dyncodes_backward_reference(*f64, inverse))
    names = ("y", "ld", "dx", "duw", "duh", "dud")
    for name, a, b, tol in zip(names, got, want, (1e-5, 1e-4) + (1e-3,) * 4):
        close(a, b, tol, name)
    loops = flat_run(libs["loops_256"], args, cts, inverse)[:2] + \
        flat_run(libs["backward_loops_256"], args, cts, inverse)[2:]
    for name, a, b in zip(names, got, loops):
        assert torch.equal(a, b), name


@DIRECTIONS
@pytest.mark.parametrize("K", BINS)
def test_planar_kernel_on_the_cpu(libs, K, inverse):
    rng = np.random.default_rng(K)
    B = 293
    x = torch.from_numpy((rng.uniform(-1.25, 1.25, (2, B)) *
                          np.asarray(BOUNDS, np.float32)[:, None]).astype(np.float32))
    p = torch.from_numpy((0.5 * rng.normal(size=(2 * (3 * K + 1), B))).astype(np.float32))
    got = planar_run(libs["planar"], x, p, K, inverse)
    want = spline_cuda.rqs_transposed_reference(x.double(), p.double(), CODES, BOUNDS, inverse)
    for name, a, b, tol in zip(("y", "ld"), got, want, (2e-5, 2e-4)):
        close(a, b, tol, name)
    for name, a, b in zip(("y", "ld"), got, planar_run(libs["planar_loops_256"], x, p, K,
                                                       inverse)):
        assert torch.equal(a, b), name
