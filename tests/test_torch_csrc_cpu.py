"""The spline kernels' CUDA sources (``normflows_tpu_torch/csrc/rqs_flat.cu``,
``rqs_transposed.cu``, ``rqs_flat_ablate.cu``) compiled for the CPU with
``g++`` and run there.

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
  design-step variants ``loops_256``, ``backward_loops_256``,
  ``planar_loops_256`` and ``planar_backward_loops_256``): the same
  operations in the same order.  On the card nvcc contracts multiply-adds
  differently in a backward's two forms, so there it is the float64 bars
  that hold them (tests/test_torch_gpu.py);
* each variant of the ablation kernel against its plain version
  (``spline_ablate.REFERENCES``) in float64 at the same bin counts
  (``vjp_all`` refuses K = 20), and ``full`` bit for bit against the flat
  backward of ``rqs_flat.cu``, whose call it shares.

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
from normflows_tpu_torch.ops import spline_ablate, spline_cuda, spline_flat

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
               "ablate": ("ablate", spline_ablate.SOURCE),
               **{name: (kind, variants[(kind, name)]) for kind, name in (
                   ("flat", "loops_256"), ("flat", "backward_loops_256"),
                   ("planar", "planar_loops_256"), ("planar", "planar_backward_loops_256"))}}
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
        signatures = {"flat": spline_flat, "planar": spline_cuda,
                      "ablate": spline_ablate}[kind]._SIGNATURES
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


def planar_case(K):
    """x_t (2, B) with ~20% outside the bounds, params_t (2(3K+1), B) and
    cotangents (2, B), B = 293."""
    rng = np.random.default_rng(K)
    B = 293
    x = torch.from_numpy((rng.uniform(-1.25, 1.25, (2, B)) *
                          np.asarray(BOUNDS, np.float32)[:, None]).astype(np.float32))
    p = torch.from_numpy((0.5 * rng.normal(size=(2 * (3 * K + 1), B))).astype(np.float32))
    return (x, p, *map(torch.from_numpy, rng.normal(size=(2, 2, B)).astype(np.float32)))


def planar_run(lib, x, p, K, inverse):
    F, B = x.shape
    y, ld = torch.empty_like(x), torch.empty_like(x)
    rc = lib.rqs_transposed_forward(x.data_ptr(), p.data_ptr(), y.data_ptr(), ld.data_ptr(),
                                    (ctypes.c_int * F)(*CODES), (ctypes.c_float * F)(*BOUNDS),
                                    F, B, K, int(inverse), *MINS, None)
    assert rc == 0
    return y, ld


def planar_backward_run(lib, x, p, yb, lb, K, inverse):
    F, B = x.shape
    dx, dp = torch.empty_like(x), torch.empty_like(p)
    rc = lib.rqs_transposed_backward(*(t.data_ptr() for t in (x, p, yb, lb, dx, dp)),
                                     (ctypes.c_int * F)(*CODES), (ctypes.c_float * F)(*BOUNDS),
                                     F, B, K, int(inverse), *MINS, None)
    assert rc == 0
    return dx, dp


def mixed_case(K, seed):
    """The ablation's operands at N = 293: mixed tails (linear at 5, circular
    at pi) with x ~ N(0, 1), so that no linear input is clamped (where
    sel_post's unmasked pull-back would meet the clip's tie), logits ~
    0.3 N(0, 1), random cotangents."""
    rng = np.random.default_rng(seed)
    N = 293
    codes = rng.choice([1, 2], size=N).astype(np.int32)
    bounds = np.where(codes == 1, 5.0, np.pi).astype(np.float32)
    p = torch.from_numpy((0.3 * rng.normal(size=(3 * K + 1, N))).astype(np.float32))
    t = torch.from_numpy
    return ((t(rng.normal(size=N).astype(np.float32)), p[:K], p[K:2 * K], p[2 * K:], t(codes),
             t(bounds)), tuple(map(t, rng.normal(size=(2, N)).astype(np.float32))))


def ablate_run(lib, mode, args, cts, inverse):
    x, uw = args[0], args[1]
    N, K = x.shape[0], uw.shape[0]
    xg, dp = torch.empty(N), torch.empty(3 * K + 1, N)
    rc = lib.rqs_flat_ablate(spline_ablate.VARIANTS.index(mode),
                             *(a.data_ptr() for a in (*args, *cts, xg, dp)), N, K,
                             args[3].stride(0), int(inverse), *MINS, None)
    return rc, (xg, dp[:K], dp[K:2 * K], dp[2 * K:])


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
    x, p, _, _ = planar_case(K)
    got = planar_run(libs["planar"], x, p, K, inverse)
    want = spline_cuda.rqs_transposed_reference(x.double(), p.double(), CODES, BOUNDS, inverse)
    for name, a, b, tol in zip(("y", "ld"), got, want, (2e-5, 2e-4)):
        close(a, b, tol, name)
    for name, a, b in zip(("y", "ld"), got, planar_run(libs["planar_loops_256"], x, p, K,
                                                       inverse)):
        assert torch.equal(a, b), name


@DIRECTIONS
@pytest.mark.parametrize("K", BINS)
def test_planar_backward_on_the_cpu(libs, K, inverse):
    """The planar backward against its float64 plain version at the JAX
    package's gradient bar (2e-3), and bit for bit against the loops it
    replaced (``planar_backward_loops_256``)."""
    x, p, yb, lb = planar_case(K)
    got = planar_backward_run(libs["planar"], x, p, yb, lb, K, inverse)
    want = spline_cuda.rqs_transposed_backward_reference(
        *(t.double() for t in (x, p, yb, lb)), CODES, BOUNDS, inverse)
    loops = planar_backward_run(libs["planar_backward_loops_256"], x, p, yb, lb, K, inverse)
    for name, a, b, c in zip(("dx", "dparams"), got, want, loops):
        close(a, b, 2e-3, name)
        assert torch.equal(a, c), name


@DIRECTIONS
@pytest.mark.parametrize("K", BINS)
@pytest.mark.parametrize("mode", spline_ablate.VARIANTS)
def test_ablate_kernel_on_the_cpu(libs, mode, K, inverse):
    """Each variant against its plain version in float64 (sel_only 1e-5, the
    rest the flat backward's 1e-3): full and vjp_all on ~20% of the inputs
    outside their bounds, sel_only and sel_post on the mixed-tail case;
    ``full`` bit for bit against the flat backward; vjp_all refuses K > 16."""
    args, cts = (flat_case if mode in ("full", "vjp_all") else mixed_case)(K, seed=K)
    rc, got = ablate_run(libs["ablate"], mode, args, cts, inverse)
    if mode == "vjp_all" and K > spline_ablate.MAX_BINS:
        assert rc != 0
        return
    assert rc == 0
    f64 = [a.double() if a.is_floating_point() else a for a in (*args, *cts)]
    want = spline_ablate.REFERENCES[mode](*f64, inverse)
    tol = 1e-5 if mode == "sel_only" else 1e-3
    for name, a, b in zip(("xg", "uwg", "uhg", "udg"), got, want):
        close(a, b, tol, name)
    if mode == "full":
        for name, a, b in zip(("dx", "duw", "duh", "dud"), got,
                              flat_run(libs["flat"], args, cts, inverse)[2:]):
            assert torch.equal(a, b), name
