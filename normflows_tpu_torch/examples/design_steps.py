"""The design steps of the port's redesigned kernels, timed on the card: the
fused MADE forward (``csrc/made_fused.cu``), the flat RQ-spline forward and
backward (``csrc/rqs_flat.cu``) and the planar RQ-spline forward/inverse
and backward (``csrc/rqs_transposed.cu``).

    python normflows_tpu_torch/examples/design_steps.py [--parent DIR] [--out FILE]

Each step is a variant of a shipped source with one design decision undone
(or one alternative put in), written into ``_build/design_steps/``, built
with ``nvcc`` beside the shipped source and timed against it in the same
process, in turns (shipped, variants, shipped, variants):

* MADE ``fragment_split`` (float32; bf16 as shipped): the final layer as
  the backward's dh_R kernel runs its product, float32 h_R and Wf each
  split into bf16 terms as the warps read their fragments, on 64 x 64
  tiles;
* MADE ``final_128x64``: the final layer's first tile shape, 128 x 64
  outputs of 8 warps through a 3-deep ring, in both precisions;
* MADE ``bf16_promoted``: bf16 sums promoted into a float32 running sum
  each k16 step, as the float32 route's;
* MADE ``chain_rows_16`` / ``chain_rows_32``: the chain on 16-row tiles
  (the backward tile pass's; shipped for float32) in both precisions, or on
  32-row tiles (shipped for bf16) in both;
* flat ``loops_256``: the forward on ``select_bin``'s loops over a runtime
  K at 256 threads a block, the earlier kernel's arithmetic and launch;
* flat ``registers_256``: the forward's register selection at 256 threads
  a block;
* flat ``lane_groups``: the forward on one element per group of 8 or 16
  lanes (one bin a lane; shuffled maxima, sequential sums of shuffled
  values, a ballot);
* flat ``backward_loops_256``: the backward on ``select_bin`` and
  ``spline_element_backward``'s loops over a runtime K at 256 threads a
  block, the earlier backward;
* flat ``backward_registers_256``: the backward from registers at 256
  threads a block;
* flat ``backward_vjp_all``: the ablation's ``vjp_all_element``
  (``csrc/rqs_flat_ablate.cu``, every residual of every bin kept, sums in
  another order) in the shipped backward's launch;
* planar ``planar_loops_256``: the forward/inverse on ``select_bin``'s
  loops at 256 threads a block, the earlier kernel;
* planar ``planar_registers_256`` / ``planar_registers_64``: the register
  selection at 256 or 64 threads a block (128 shipped);
* planar ``planar_backward_loops_256``: the backward on ``select_bin`` and
  ``spline_element_backward``'s loops at 256 threads a block, the earlier
  backward;
* planar ``planar_backward_registers_256`` / ``planar_backward_registers_64``:
  the backward from registers at 256 or 64 threads a block (128 shipped).

For each it prints one JSON line: device µs of one call (64 calls of a
spline kernel or 16 of the MADE, one CUDA graph, replayed), device µs of
each CUDA kernel a MADE call launches (torch.profiler over 10 calls),
registers and spills (ptxas), and max |output - shipped output| of the
forward and of the backward, at the timed size and, for the spline kernels,
at every bin count of SWEEP_BINS.  The flat kernels run at N = 4096 (the sliced
inverse's slab), 16,384 (the coupled model's request) and 262,144 (the
large-D density direction), K = 8, the planar kernels at the flagship's
F = 2, K = 10, B = 2^14, each beside the launch floor: ``torch.neg`` on the
same number of floats in the same kind of graph.  The MADE runs at the
large-D shape (B 4096, F 64, H 256, R 1, P 1600).  With ``--parent DIR`` (a
checkout of another commit) that checkout's kernels are timed too, through
the same public entry points, in a process of their own.  ``--dry-run``
writes the variant sources and stops: it needs no card, and a CPU test runs
it to keep every variant applicable to the shipped sources.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import re
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
MADE_SHAPE = (4096, 64, 256, 1, 25)  # B, F, H, R, output multiplier
FLAT_SIZES = ((4096, True), (2**14, False), (4096 * 64, False))  # N, slab
BINS, SLAB_FEATURES, PARAM_STD = 8, 64, 0.5
PLANAR_SHAPE = (2, 10, 2**14)  # F, K, B: the flagship's
PLANAR_TAILS = ((1, 2), (5.0, 3.141592653589793))
SWEEP_BINS = (2, 8, 10, 16, 20)  # every instantiation; outputs only, no times

# the flat forward's lane-group design (one element per group of G lanes)
_GROUP_KERNEL = r'''
template <bool kInverse, int G>
__global__ void __launch_bounds__(256)
rqs_flat_group_kernel(const float* __restrict__ x, const float* __restrict__ uw,
                      const float* __restrict__ uh, const float* __restrict__ ud,
                      const int* __restrict__ codes, const float* __restrict__ bounds,
                      float* __restrict__ y, float* __restrict__ ld, int N, size_t stride,
                      int K, Consts c) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int n = static_cast<int>(t / G), j = static_cast<int>(t % G);
  if (n >= N) return;  // a group leaves whole
  const unsigned lane = threadIdx.x & 31, base = lane & ~(G - 1);
  const unsigned mask = G == 32 ? 0xffffffffu : ((1u << G) - 1) << base;
  const float xn = x[n];
  const bool on = j < K;
  const float w_raw = on ? uw[j * stride + n] : __int_as_float(0xff800000);
  const float h_raw = on ? uh[j * stride + n] : __int_as_float(0xff800000);
  const float d = j <= K ? ud[j * stride + n] : 0.0f;
  const float dK = K == G ? ud[K * stride + n] : 0.0f;
  Selection e;
  e.is_circ = codes[n] == rqs::kTailCircular;
  e.is_lin = codes[n] == rqs::kTailLinear;
  const float left = -bounds[n], right = -left;
  e.span = 2.0f * bounds[n];
  e.inside = (xn >= left) && (xn <= right);
  if (e.is_circ) {
    float r = fmodf(xn - left, e.span);
    if (r < 0.0f) r += e.span;
    e.xs = left + r;
  } else {
    e.xs = fminf(fmaxf(xn, left), right);
  }
  e.wmax = w_raw;
  e.hmax = h_raw;
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) {
    e.wmax = fmaxf(e.wmax, __shfl_xor_sync(mask, e.wmax, o, G));
    e.hmax = fmaxf(e.hmax, __shfl_xor_sync(mask, e.hmax, o, G));
  }
  const float ew = on ? expf(w_raw - e.wmax) : 0.0f, eh = on ? expf(h_raw - e.hmax) : 0.0f;
  e.wsum = 0.0f;
  e.hsum = 0.0f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float a = __shfl_sync(mask, ew, k, G), b = __shfl_sync(mask, eh, k, G);
    if (k < K) {
      e.wsum += a;
      e.hsum += b;
    }
  }
  const float w_k = (c.min_bin_width + c.fw * (ew / e.wsum)) * e.span;
  const float h_k = (c.min_bin_height + c.fh * (eh / e.hsum)) * e.span;
  float cw = left, ch = left, my_cw = 0.0f, my_ch = 0.0f;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float a = __shfl_sync(mask, w_k, k, G), b = __shfl_sync(mask, h_k, k, G);
    if (k == j) {
      my_cw = cw;
      my_ch = ch;
    }
    if (k < K) {
      cw = cw + a;
      ch = ch + b;
    }
  }
  const bool cond = on && ((j == K - 1) || (e.xs < (kInverse ? my_ch + h_k : my_cw + w_k)));
  const int sel = __ffs(__ballot_sync(mask, cond) >> base) - 1;
  e.k = sel;
  e.cw = __shfl_sync(mask, my_cw, sel, G);
  e.w = __shfl_sync(mask, w_k, sel, G);
  e.ch = __shfl_sync(mask, my_ch, sel, G);
  e.h = __shfl_sync(mask, h_k, sel, G);
  const float d_lo = __shfl_sync(mask, d, sel, G);
  const float nxt = __shfl_sync(mask, d, (sel + 1) & (G - 1), G);
  const float d_hi = sel + 1 < G ? nxt : dK;
  const float d0_raw = c.min_derivative + rqs::softplus(__shfl_sync(mask, d, 0, G));
  e.dk = sel == 0 ? (e.is_lin ? 1.0f : d0_raw) : c.min_derivative + rqs::softplus(d_lo);
  if (sel + 1 == K && e.is_lin) {
    e.dk1 = 1.0f;
  } else if (sel + 1 == K && e.is_circ) {
    e.dk1 = d0_raw;
  } else {
    e.dk1 = c.min_derivative + rqs::softplus(d_hi);
  }
  if (j == 0) rqs::spline_element<kInverse>(e, xn, y + n, ld + n);
}

template <bool kInverse>
bool launch_group(const float* x, const float* uw, const float* uh, const float* ud,
                  const int* codes, const float* bounds, float* y, float* ld, int N,
                  size_t stride, int K, const Consts& consts, cudaStream_t s) {
  const int G = K <= 8 ? 8 : 16;
  const int blocks = static_cast<int>((static_cast<long long>(N) * G + 255) / 256);
  if (K <= 8) {
    rqs_flat_group_kernel<kInverse, 8><<<blocks, 256, 0, s>>>(x, uw, uh, ud, codes, bounds, y,
                                                              ld, N, stride, K, consts);
  } else if (K <= 16) {
    rqs_flat_group_kernel<kInverse, 16><<<blocks, 256, 0, s>>>(x, uw, uh, ud, codes, bounds, y,
                                                               ld, N, stride, K, consts);
  } else {
    return false;
  }
  return true;
}

'''

# the final layer split as warps read fragments: float32 h_R and Wf
_FRAGMENT_FINAL = r'''
__global__ void __launch_bounds__(128)
made_final_split_kernel(const float* h, const float* wf, const float* bf, float* out, int B,
                        int P, int H) {
  extern __shared__ float4 smem4[];
  const int n0 = blockIdx.x * 64, m0 = blockIdx.y * 64;
  split_gemm<64, 64, 2, 2, 32, 3, false, true, true>(
      min(64, B - m0), min(64, P - n0), H, kMaxTerms, kMaxTerms,
      Operand<float, true>{h + static_cast<size_t>(m0) * H, H},
      Operand<float, true>{wf + static_cast<size_t>(n0) * H, H}, Identity{}, Identity{},
      reinterpret_cast<char*>(smem4), NoChunk{}, [&](int m, int n, float v) {
        out[static_cast<size_t>(m0 + m) * P + n0 + n] = v + bf[n0 + n];
      });
}

'''
_FRAGMENT_LAUNCH = r'''  if constexpr (!kBf16) {
    static bool split_allowed[kMaxDevices] = {};
    constexpr size_t kSmem = split_smem<64, 64, 32, 3, false, true, float, true>();
    e = allow_smem(made_final_split_kernel, kSmem, split_allowed);
    if (e != cudaSuccess) return static_cast<int>(e);
    made_final_split_kernel<<<dim3((p.P + 63) / 64, (p.B + 63) / 64), 128, kSmem, s>>>(
        reinterpret_cast<const float*>(work), p.wf, p.bf, out, p.B, p.P, p.H);
    return static_cast<int>(cudaGetLastError());
  }
'''


def _patch(text, old, new, count=1):
    if text.count(old) < 1:
        raise ValueError(f"design_steps: the shipped source no longer holds {old[:60]!r}")
    return text.replace(old, new, count)


def _patch_in(text, anchor, old, new):
    """``_patch`` of the first ``old`` after ``anchor`` (a function's head)."""
    i = text.find(anchor)
    if i < 0:
        raise ValueError(f"design_steps: the shipped source no longer holds {anchor[:60]!r}")
    return text[:i] + _patch(text[i:], old, new)


def _find(pattern, text):
    m = re.search(pattern, text, re.S)
    if m is None:
        raise ValueError(f"design_steps: the shipped source no longer holds {pattern!r}")
    return m.group(0)


def made_variants(src):
    """``{name: source}`` of the fused MADE's variants."""
    f32_tile = _find(r"PlaneTile<kMaxTerms, [^>]*>", src)
    bf16_tile = _find(r"PlaneTile<1, [^>]*>", src)
    h_store = "    split_store<kBf16 ? 1 : kMaxTerms>(rnd<kBf16>(Hs[i]), dst + i, h_plane);"
    fragment = _patch(src, h_store, "    if constexpr (kBf16) split_store<1>(Hs[i], dst + i, h_plane);\n"
                      "    else reinterpret_cast<float*>(h_planes)"
                      "[static_cast<size_t>(row0) * H + i] = Hs[i];")
    fragment = _patch(fragment, "template <bool kBf16>\nint forward(const Made<kBf16>& p",
                      _FRAGMENT_FINAL + "template <bool kBf16>\nint forward(const Made<kBf16>& p")
    fragment = _patch(fragment, "  Planes wf{wf_planes, p.H, wf_plane};",
                      _FRAGMENT_LAUNCH + "  Planes wf{wf_planes, p.H, wf_plane};")
    return {
        "fragment_split": fragment,
        "final_128x64": _patch(_patch(src, f32_tile, "PlaneTile<kMaxTerms, 128, 64, 4, 2, 3>"),
                               bf16_tile, "PlaneTile<1, 128, 64, 4, 2, 3>"),
        "bf16_promoted": _patch(src, "static constexpr bool kPromote = TERMS > 1;",
                                "static constexpr bool kPromote = true;"),
        "chain_rows_16": _patch(src, "constexpr int kChainRows = kBf16 ? 32 : 16;",
                                "constexpr int kChainRows = kBf16 ? 16 : 16;"),
        "chain_rows_32": _patch(src, "constexpr int kChainRows = kBf16 ? 32 : 16;",
                                "constexpr int kChainRows = kBf16 ? 32 : 32;"),
    }


def _fixed_threads(src, launcher, threads, old):
    """``src`` with the launch function ``launcher``'s block size fixed."""
    return _patch_in(src, launcher, old, f"  const int threads = {threads};")


def _loops_only(src, launcher, macro):
    """``src`` with ``launcher`` dispatching every K to the loops over a
    runtime K (``macro(0, false)``)."""
    return _patch_in(src, launcher, _find(rf"  if \(K == \d+\) \{{\n    {macro}\(.*?\n  \}}\n", src),
                     f"  {macro}(0, false);\n")


# the backward's register form, replaced by the ablation's whole-block
# pull-back (its residual arrays sized at the compile-time bin count, K <= 16)
_VJP_ALL_CALL = """  if constexpr (KB == 0) {
{call}  } else {
    vjp_all_element<kInverse, KB, kExact>(
        x[n], rqs::load_params<KB, kExact>(uw + n, uh + n, ud + n, stride, K), K, codes[n],
        bounds[n], ybar[n], lbar[n], consts, dx + n, duw, duh, dud, out);
  }
"""


def flat_variants(src):
    """``{name: source}`` of the flat forward's and backward's variants."""
    threads = "  const int threads = rqs::block_threads(N, 1, kMinBlocks);"
    fwd, bwd = "void launch_forward(", "void launch_backward("
    fixed = _fixed_threads(src, fwd, "kThreads", threads)
    dispatch = _find(r"  if \(K == 8\) \{.*?\} else if \(K <= kMaxBins\) \{", src)
    loops = _patch(fixed, dispatch,
                   "  if (false) {\n    RQS_FLAT_LAUNCH(8, true);\n  } else if (K < 0) {")
    anchor = "template <bool kInverse>\nvoid launch_forward("
    groups = _patch(src, anchor, _GROUP_KERNEL + anchor)
    groups = _patch_in(groups, fwd, threads + "\n",
                       "  if (launch_group<kInverse>(x, uw, uh, ud, codes, bounds, y, ld, N, stride,"
                       " K, consts, s))\n    return;\n" + threads + "\n")
    bwd_fixed = _fixed_threads(src, bwd, "kThreads", threads)
    ablate = (PACKAGE / "csrc" / "rqs_flat_ablate.cu").read_text()
    vjp_all = _find(r"// The whole-block pull-back of one element.*?\n}\n", ablate)
    bwd_anchor = "// The same bin counts as the forward's\n"
    vjp = _patch(src, bwd_anchor, "using rqs::PostGrads;\n\n" + vjp_all + "\n" + bwd_anchor)
    call = _find(r"  rqs::element_backward<kInverse, KB, kExact>\([^;]*;\n", src)
    vjp = _patch(vjp, call, _VJP_ALL_CALL.replace("{call}", "  " + call))
    return {"loops_256": loops, "registers_256": fixed, "lane_groups": groups,
            "backward_loops_256": _loops_only(bwd_fixed, bwd, "RQS_FLAT_BACKWARD_LAUNCH"),
            "backward_registers_256": bwd_fixed, "backward_vjp_all": vjp}


def planar_variants(src):
    """``{name: source}`` of the planar forward's and backward's variants."""
    threads = "  const int threads = rqs::block_threads(B, F, kMinBlocks);"
    out = {}
    for prefix, launcher, macro in (("planar", "void launch_forward(", "RQS_PLANAR_LAUNCH"),
                                    ("planar_backward", "void launch_backward(",
                                     "RQS_PLANAR_BACKWARD_LAUNCH")):
        fixed = _fixed_threads(src, launcher, "kThreads", threads)
        out[f"{prefix}_loops_256"] = _loops_only(fixed, launcher, macro)
        out[f"{prefix}_registers_256"] = fixed
        out[f"{prefix}_registers_64"] = _fixed_threads(src, launcher, "64", threads)
    return out


# kind: (the source's stem, its variants, the module that loads it)
KINDS = {"made": ("made_fused", made_variants, "made_fused"),
         "flat": ("rqs_flat", flat_variants, "spline_flat"),
         "planar": ("rqs_transposed", planar_variants, "spline_cuda")}


def write_variants(build_dir):
    """Write every variant beside a copy of the shared header; returns
    ``{("made" | "flat" | "planar", name): path}``."""
    csrc = PACKAGE / "csrc"
    build_dir.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (build_dir / header.name).write_text(header.read_text())
    out = {}
    for kind, (stem, make, _) in KINDS.items():
        for name, text in make((csrc / f"{stem}.cu").read_text()).items():
            path = build_dir / f"{stem}_{name}.cu"
            path.write_text(text)
            out[(kind, name)] = path
    return out


# ---- measurement (on the card) -------------------------------------------------

def graph_us(fn, reps, replays=5):
    """Device µs of one ``fn``: ``reps`` calls in one CUDA graph, replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (replays * reps)


def launch_us(fn, calls=10):
    """Device µs a launch of each CUDA kernel of ``fn`` (torch.profiler), by
    the kernel's name and template arguments."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key).split("(")[0]
            out[name[:60]] = e.self_device_time_total / e.count
    return out


def resources(ptxas, pattern):
    """Registers and spill stores of each kernel whose name matches, keyed by
    its name and mangled template arguments."""
    out, key = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '\w*?(" + pattern + r")(I(?:L[bi]\d+E)+E)?",
                      line)
        if "Compiling entry function" in line:
            key = m.group(1) + (m.group(2) or "") if m else None
            continue
        if key and (m := re.search(r"(\d+) bytes spill stores", line)):
            out.setdefault(key, {})["spill_store_bytes"] = int(m.group(1))
        if key and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(key, {})["registers"] = int(m.group(1))
            key = None
    return out


def made_inputs(bf16, seed=50):
    import numpy as np
    import torch

    import normflows_tpu_torch as nft
    from normflows_tpu_torch.ops import made_fused

    B, F, H, R, mult = MADE_SHAPE
    made = nft.nets.MADE(F, H, num_blocks=R, output_multiplier=mult, permute_mask=True,
                         rng_seed=seed, generator=torch.Generator().manual_seed(seed),
                         device="cuda")
    if bf16:
        nft.utils.set_compute_dtype(made, "bfloat16")
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(B, F)).astype(np.float32))
    return x.cuda(), [t.detach() for t in made_fused.pack(made)]


@functools.lru_cache(maxsize=None)
def flat_inputs(N, slab, sets=16, K=BINS):
    """16 input sets of the flat kernels at N, each with its cotangents
    (made once a process: every variant times the same inputs)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(N + K)
    S = 3 * K + 1
    out = []
    for _ in range(sets):
        codes = rng.choice([1, 2], size=N).astype(np.int32)
        bounds = np.where(codes == 1, 3.0, np.pi).astype(np.float32)
        x = (rng.uniform(-1.25, 1.25, N) * bounds).astype(np.float32)
        p = torch.from_numpy((PARAM_STD * rng.normal(size=(S * (SLAB_FEATURES if slab else 1), N)))
                             .astype(np.float32)).cuda()[:S]
        to = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
        out.append((to(x), p[:K], p[K:2 * K], p[2 * K:], to(codes), to(bounds),
                    *map(to, rng.normal(size=(2, N)).astype(np.float32))))
    return out


@functools.lru_cache(maxsize=None)
def planar_inputs(sets=16, K=PLANAR_SHAPE[1], B=PLANAR_SHAPE[2]):
    """16 input sets of the planar kernels at PLANAR_SHAPE: x_t (F, B) with
    ~20% outside +-bound, params_t (F(3K+1), B), cotangents (F, B)."""
    import numpy as np
    import torch

    F = PLANAR_SHAPE[0]
    rng = np.random.default_rng(B + K)
    bounds = np.asarray(PLANAR_TAILS[1], np.float32)[:, None]
    out = []
    for _ in range(sets):
        x = (rng.uniform(-1.25, 1.25, (F, B)) * bounds).astype(np.float32)
        p = (PARAM_STD * rng.normal(size=(F * (3 * K + 1), B))).astype(np.float32)
        out.append(tuple(torch.from_numpy(a).cuda() for a in
                         (x, p, *rng.normal(size=(2, F, B)).astype(np.float32))))
    return out


def _spline_entry(kind, args, inverse, backward):
    """One call of the flat or planar wrapper on an input set."""
    from normflows_tpu_torch.ops import spline_cuda, spline_flat

    if kind == "flat":
        if backward:
            return spline_flat.unconstrained_rqs_dyncodes_backward(*args, inverse)
        return spline_flat.unconstrained_rqs_dyncodes(*args[:6], inverse)
    if backward:
        return spline_cuda.rqs_transposed_backward(*args, *PLANAR_TAILS, inverse)
    return spline_cuda.rqs_transposed(*args[:2], *PLANAR_TAILS, inverse)


def time_splines(kind):
    """``{size: {...}}`` of the flat or planar kernels: the launch floor and
    µs a launch of the forward and the backward in both directions, and
    their outputs on the first input set (the inverse direction's); and
    under ``bins``, at every bin count of SWEEP_BINS (the flat slab at
    4096 + 37, the planar B at 2^14 + 37), the outputs of both directions."""
    import torch

    sizes = ([(str(N), flat_inputs(N, slab)) for N, slab in FLAT_SIZES] if kind == "flat"
             else [("x".join(map(str, PLANAR_SHAPE)), planar_inputs())])
    r = {"bins": {}}
    for K in SWEEP_BINS:
        args = (flat_inputs(4096 + 37, True, 1, K) if kind == "flat" else
                planar_inputs(1, K, PLANAR_SHAPE[2] + 37))[0]
        r["bins"][f"K{K}"] = {
            f"out{'_backward' if backward else ''}": tuple(
                t for inverse in (False, True) for t in _spline_entry(kind, args, inverse, backward))
            for backward in (False, True)}
    for size, sets in sizes:
        rot, y = itertools.cycle(sets), torch.empty_like(sets[0][0])
        e = {"floor_us": graph_us(lambda: torch.neg(next(rot)[0], out=y), 64)}
        for backward, inverse in itertools.product((False, True), (False, True)):
            rot = itertools.cycle(sets)
            key = ("backward_" if backward else "") + ("inverse_us" if inverse else "forward_us")
            e[key] = graph_us(lambda: _spline_entry(kind, next(rot), inverse, backward), 64)
        e["out"] = _spline_entry(kind, sets[0], True, False)
        e["out_backward"] = _spline_entry(kind, sets[0], True, True)
        r[size] = e
    return r


def measure(label, kind=None, source=None, ptxas=None):
    """Time the package's kernels of ``kind`` (every kind without one) from
    their shipped sources or from ``source``; one JSON line each."""
    import importlib

    lines = []
    for k in [kind] if kind else KINDS:
        module = importlib.import_module(f"normflows_tpu_torch.ops.{KINDS[k][2]}")
        shipped, module.SOURCE = module.SOURCE, source or module.SOURCE
        r = {"kind": k, "label": label}
        try:
            if k == "made":
                r["shape"] = MADE_SHAPE
                for bf16 in (False, True):
                    x, ops = made_inputs(bf16)
                    run = lambda: module.fused_resmade(x, *ops)  # noqa: E731
                    r["bf16" if bf16 else "f32"] = {"us": graph_us(run, 16),
                                                    "launch_us": launch_us(run), "out": run()}
            else:
                r["bins"] = BINS if k == "flat" else PLANAR_SHAPE[1]
                r.update(time_splines(k))
        finally:
            module.SOURCE = shipped
        r["resources"] = resources(ptxas or "", {"made": r"made_[a-z_]*?_kernel",
                                                 "flat": r"rqs_flat[a-z_]*?_kernel",
                                                 "planar": r"rqs_transposed[a-z_]*?_kernel"}[k])
        lines.append(r)
    return lines


def _strip(r, shipped):
    """The JSON line of ``r``: each output ``out<suffix>`` replaced by
    ``max_abs<suffix>_vs_shipped``, max |r - shipped| (None without
    ``shipped``)."""
    out = {}
    for k, v in r.items():
        ref = shipped.get(k) if isinstance(shipped, dict) else None
        if isinstance(v, dict):
            v = _strip(v, ref)
        elif k.startswith("out"):
            k = "max_abs" + k[3:] + "_vs_shipped"
            pairs = list(zip(v, ref)) if isinstance(v, tuple) and ref else [(v, ref)]
            v = None if ref is None else max(float((a - b).abs().max()) for a, b in pairs)
        out[k] = v
    return out


def _sources():
    from normflows_tpu_torch.ops import made_fused, spline_cuda, spline_flat

    return {"made": made_fused.SOURCE, "flat": spline_flat.SOURCE, "planar": spline_cuda.SOURCE}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="a checkout of another commit, timed too")
    parser.add_argument("--out", type=Path, help="also append the JSON lines to this file")
    parser.add_argument("--dry-run", action="store_true", help="write the variants and stop")
    parser.add_argument("--measure-root", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    build_dir = PACKAGE / "_build" / "design_steps"
    variants = write_variants(build_dir)
    if args.dry_run:
        print(json.dumps({"variants": {f"{k}/{n}": str(p) for (k, n), p in variants.items()}}))
        return 0

    def emit(r):
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(line + "\n")

    import torch

    if not torch.cuda.is_available():
        print("design_steps: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from normflows_tpu_torch.ops import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    shipped_sources = _sources()
    info = cuda_build.build([*shipped_sources.values(), *variants.values()], force=True)
    ptx = {p: i["ptxas"] for p, i in info.items()}
    for turn in range(2):
        shipped = {r["kind"]: r for r in measure(
            "shipped", ptxas="".join(ptx[p] for p in shipped_sources.values()))}
        for r in shipped.values():
            emit({"turn": turn, "card": smi, **_strip(r, None)})
        for (kind, name), path in variants.items():
            r = measure(name, kind, path, ptxas=ptx[path])[0]
            emit({"turn": turn, "card": smi, **_strip(r, shipped[kind])})
    if args.parent:
        out = subprocess.run([sys.executable, __file__, "--measure-root",
                              str(args.parent.resolve())], capture_output=True, text=True)
        for line in out.stdout.splitlines():
            emit({"card": smi, **json.loads(line)})
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
    return 0


def measure_root(root: Path) -> int:
    """Time the kernels of the checkout at ``root`` (its own package, built
    there) and print their JSON lines, outputs left out."""
    sys.path.insert(0, str(root))
    from normflows_tpu_torch.ops import cuda_build

    info = cuda_build.build(list(_sources().values()), force=True)
    ptxas = "".join(i["ptxas"] for i in info.values())
    for r in measure(f"parent:{root.name}", ptxas=ptxas):
        print(json.dumps(_strip(r, None)), flush=True)
    return 0


if __name__ == "__main__":
    if "--measure-root" in sys.argv:
        sys.exit(measure_root(Path(sys.argv[sys.argv.index("--measure-root") + 1])))
    sys.path.insert(0, str(PACKAGE.parent))
    sys.exit(main())
