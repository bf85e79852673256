// The flat spline backward's ablation, for Hopper, sm_90a: four variants of
// one kernel that split the backward's cost into its parts.
//
// `rqs_flat_ablate_kernel<kMode, kInverse, KB, kExact>` replaces the TPU kernel
// `variant_kernel` (examples/spline_bwd_ablate.py:51), launched by
// `run_variant` (:101, call :117) on the flat layout of
// `spline_pallas._specs` (normflows_tpu/ops/spline_pallas.py:321).  For each
// of N elements it reads x[n], its tail code and bound, its 3K+1 parameters
// on rows `stride` floats apart (widths uw[k * stride], heights uh[k *
// stride], derivative logits ud[k * stride]) and the cotangents ybar[n],
// lbar[n], and writes xg[n] and 3K+1 planes packed into dparams (3K+1, N):
//
//   kSelOnly  the bin search alone (`_selection(collect=True)`):
//             xg = xs + sum of the selected (cw, w, ch, h, dk, dk1)
//             + (wmax + wsum + hmax + hsum) + sum of the hit masks, summed
//             in the search's loop (1: the search selects exactly one bin,
//             the last catching the rest); the planes are the parameters
//             copied through.
//   kSelPost  the search, then the pull-back of the rational-quadratic map
//             of the selected bin (`_post_math`) at the cotangents
//             (ybar, lbar) as given, with no inside/tail masking: xg = the
//             sum of its 7 cotangents + the sum of the hits; planes copied.
//             The pull-back follows the direction of the search: in the
//             forward direction it is that of the forward map, where the
//             TPU kernel pulls back the inverse map whatever its search
//             did (its script runs the inverse direction only, where the
//             two agree).
//   kFull     the shipped flat backward (`_bwd_scatter`): the same call as
//             rqs_flat_backward_kernel (rqs_flat.cu), dx and the gradients.
//   kVjpAll   the same function as kFull, structured as reverse-mode
//             automatic differentiation of the whole block
//             (`jax.vjp(_spline_block)`): a forward sweep keeps every bin's
//             residuals (exponentials, probabilities, widths, heights,
//             cumulative edges, hit masks, knot slopes and softplus
//             gradients) in per-thread arrays, and a reverse sweep
//             carries the cotangents through all K bins to dense
//             gradients of every logit.  kFull instead keeps the
//             parameters (exp(logit - max) after the search), the selected
//             bin and four softmax statistics, and recomputes the rest.
//
// kSelPost uses rqs::post_math_vjp_forward / _inverse, which take their
// cotangents unmasked and follow JAX's tie rules (jnp.maximum of the
// discriminant splits a tie at 0, the denom_root == 0 guard passes no
// gradient, jnp.clip of theta splits a tie at either end).
//
// What bounds it on this card: memory.  At K = 10 an element of kFull,
// kVjpAll or kSelPost reads x, code, bound, ybar, lbar and 31 parameters and
// writes 32 floats, 272 B (kSelOnly needs no cotangents: 264 B); at
// run_variant's N = 32,768 that is 8.9 MB, 2.7 us at 3.35 TB/s.  One thread
// per element on threadIdx.x, as in rqs_flat.cu, so that every row read
// and write is coalesced across a warp.
//
// The design is the shipped flat backward's, so that the ablation measures
// the kernel that ships: the bin count is a template argument (8 and 10
// exactly, K <= kMaxBins with the bins above K masked, the loops over a
// runtime K above that; kVjpAll takes K <= kMaxBins only), an element's
// 3K+1 parameters are loaded into registers in one unrolled pass
// (`rqs::load_params`), and the block size follows N (`rqs::block_threads`,
// rqs_flat.cu's rule).  kSelOnly and kSelPost search with
// `rqs::select_bin_regs` and copy the planes through from the registers;
// kFull is `rqs::element_backward`, the flat backward's own call; kVjpAll
// sizes its residual arrays at the compile-time bin count and reads its
// parameters from the registers, every array index a constant of the
// unrolled loops, so that the arrays can live in registers.

#include "rqs_common.cuh"

namespace {

using rqs::Consts;
using rqs::PostGrads;
using rqs::Selection;

constexpr int kThreads = 256;
constexpr int kMaxBins = 16;     // the largest K of the register path, and of kVjpAll
constexpr int kMinBlocks = 128;  // a launch's blocks, where N allows (rqs_flat.cu's)

constexpr int kSelOnly = 0;
constexpr int kSelPost = 1;
constexpr int kFull = 2;
constexpr int kVjpAll = 3;

// The 3K+1 parameter rows copied through into the packed planes.
__device__ __forceinline__ void copy_through(const float* uw, const float* uh,
                                             const float* ud, size_t n_in,
                                             int K, float* dp, size_t n_out) {
  for (int k = 0; k < K; ++k) {
    dp[k * n_out] = uw[k * n_in];
    dp[(K + k) * n_out] = uh[k * n_in];
  }
  for (int k = 0; k <= K; ++k) dp[(2 * K + k) * n_out] = ud[k * n_in];
}

// The same from the registers `rqs::load_params` filled.
template <int KB, bool kExact>
__device__ __forceinline__ void copy_through_regs(const rqs::ParamRegs<KB>& r, int K,
                                                  float* dw, float* dh, float* dd,
                                                  size_t n_out) {
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (kExact || k < K) {
      dw[k * n_out] = r.w[k];
      dh[k * n_out] = r.h[k];
    }
  }
#pragma unroll
  for (int k = 0; k <= KB; ++k) {
    if (kExact || k <= K) dd[k * n_out] = r.d[k];
  }
}

// The whole-block pull-back of one element: `_spline_block` run forward
// with its residuals kept, then differentiated in reverse.  KB bins
// (kExact) or K <= KB, the element's raw parameters in `r`.
template <bool kInverse, int KB, bool kExact>
__device__ __forceinline__ void vjp_all_element(
    float x, const rqs::ParamRegs<KB>& r, int K_arg, int code, float bound, float ybar,
    float lbar, const Consts& c, float* dx, float* duw, float* duh, float* dud,
    size_t n_out) {
  const int K = kExact ? KB : K_arg;
  // ---- forward sweep, every residual kept ----
  float ew[KB], eh[KB];  // exp(logit - max)
  float pw[KB], ph[KB];  // softmax probabilities
  float wk[KB], hk[KB];  // bin widths and heights
  float cwe[KB + 1], che[KB + 1];  // cumulative edges
  float d[KB + 1], sg[KB + 1];     // knot slopes, sigmoid(ud)
  bool hit[KB];

  const bool is_circ = code == rqs::kTailCircular;
  const bool is_lin = code == rqs::kTailLinear;
  const float left = -bound;
  const float span = 2.0f * bound;
  const bool inside = (x >= left) && (x <= -left);
  float xs;
  if (is_circ) {
    float m = fmodf(x - left, span);
    if (m < 0.0f) m += span;
    xs = left + m;
  } else {
    xs = fminf(fmaxf(x, left), -left);
  }

  float wmax = r.w[0], hmax = r.h[0];
#pragma unroll
  for (int k = 1; k < KB; ++k) {
    if (kExact || k < K) {
      wmax = fmaxf(wmax, r.w[k]);
      hmax = fmaxf(hmax, r.h[k]);
    }
  }
  float wsum = 0.0f, hsum = 0.0f;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (kExact || k < K) {
      ew[k] = expf(r.w[k] - wmax);
      eh[k] = expf(r.h[k] - hmax);
      wsum += ew[k];
      hsum += eh[k];
    }
  }
  cwe[0] = left;
  che[0] = left;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (kExact || k < K) {
      pw[k] = ew[k] / wsum;
      ph[k] = eh[k] / hsum;
      wk[k] = (c.min_bin_width + c.fw * pw[k]) * span;
      hk[k] = (c.min_bin_height + c.fh * ph[k]) * span;
      cwe[k + 1] = cwe[k] + wk[k];
      che[k + 1] = che[k] + hk[k];
    }
  }
  // knot slopes: linear tails pin both ends to 1, circular ones close
  // d_K = d_0; softplus' gradient kept beside each
#pragma unroll
  for (int k = 0; k <= KB; ++k) {
    if (kExact || k <= K) {
      d[k] = c.min_derivative + rqs::softplus(r.d[k]);
      sg[k] = rqs::sigmoid(r.d[k]);
    }
  }
  const float d0_raw = d[0];
  if (is_lin) d[0] = 1.0f;
#pragma unroll
  for (int k = 1; k <= KB; ++k) {
    if (k == K) d[k] = is_lin ? 1.0f : (is_circ ? d0_raw : d[k]);
  }

  // the accumulate-and-select search, its hit masks kept
  Selection e;
  e.xs = xs;
  e.cw = 0.0f, e.w = 1.0f, e.ch = 0.0f, e.h = 1.0f, e.dk = 1.0f, e.dk1 = 1.0f;
  bool found = false;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (kExact || k < K) {
      const bool cond =
          (k == K - 1) || (xs < (kInverse ? che[k + 1] : cwe[k + 1]));
      hit[k] = !found && cond;
      found = found || hit[k];
      if (hit[k]) {
        e.cw = cwe[k];
        e.w = wk[k];
        e.ch = che[k];
        e.h = hk[k];
        e.dk = d[k];
        e.dk1 = d[k + 1];
      }
    }
  }

  // ---- reverse sweep ----
  // y = where(use_spline, out, x), logdet = where(use_spline, ld, 0)
  const bool use_spline = inside || is_circ;
  const float yb = use_spline ? ybar : 0.0f;
  const float lb = use_spline ? lbar : 0.0f;
  const PostGrads g = kInverse ? rqs::post_math_vjp_inverse(e, yb, lb)
                               : rqs::post_math_vjp_forward(e, yb, lb);

  // xs = wrap (slope 1) or clamp (slope 1 on [-B, B], as `_bwd_scatter`)
  *dx = g.xs * ((is_circ || inside) ? 1.0f : 0.0f) + (use_spline ? 0.0f : ybar);

  // the selection's where(hit_k, .) sends each cotangent to the bin that
  // hit; cwe[k + 1] = cwe[k] + wk[k] sends an edge's cotangent to the width
  // below it and to the edge below that
  float gw[KB], gh[KB], gd[KB + 1];
#pragma unroll
  for (int k = 0; k <= KB; ++k) gd[k] = 0.0f;
  float g_cw_edge = 0.0f, g_ch_edge = 0.0f;  // cotangents of cwe/che[k + 1]
#pragma unroll
  for (int k = KB - 1; k >= 0; --k) {
    if (kExact || k < K) {
      gw[k] = (hit[k] ? g.w : 0.0f) + g_cw_edge;
      gh[k] = (hit[k] ? g.h : 0.0f) + g_ch_edge;
      g_cw_edge += hit[k] ? g.cw : 0.0f;
      g_ch_edge += hit[k] ? g.ch : 0.0f;
      gd[k] += hit[k] ? g.dk : 0.0f;
      gd[k + 1] += hit[k] ? g.dk1 : 0.0f;
    }
  }

  // wk = (min + f p) span; p = e / sum; e = exp(u - max), max held
  // constant (stop_gradient): du = e (gp / sum - sum_j gp_j e_j / sum^2)
  float gsw = 0.0f, gsh = 0.0f;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (kExact || k < K) {
      gw[k] *= c.fw * span;  // now the cotangent of pw[k]
      gh[k] *= c.fh * span;
      gsw -= gw[k] * ew[k];
      gsh -= gh[k] * eh[k];
    }
  }
  gsw /= wsum * wsum;
  gsh /= hsum * hsum;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (kExact || k < K) {
      duw[k * n_out] = ew[k] * (gw[k] / wsum + gsw);
      duh[k * n_out] = eh[k] * (gh[k] / hsum + gsh);
    }
  }

  // slopes back to their logits: knot 0 pinned by a linear tail, knot K
  // pinned by a linear tail or taken from knot 0 by a circular one
  float g_raw0 = is_lin ? 0.0f : gd[0];
#pragma unroll
  for (int k = 1; k <= KB; ++k) {
    if (k == K) {
      if (is_circ && !is_lin) g_raw0 += gd[k];
      if (is_lin || is_circ) gd[k] = 0.0f;
    }
  }
  gd[0] = g_raw0;
#pragma unroll
  for (int k = 0; k <= KB; ++k) {
    if (kExact || k <= K) dud[k * n_out] = gd[k] * sg[k];
  }
}

// KB bins (kExact) or K <= KB; KB = 0: the loops over a runtime K (never
// kVjpAll)
template <int kMode, bool kInverse, int KB, bool kExact>
__global__ void __launch_bounds__(kThreads)
rqs_flat_ablate_kernel(const float* __restrict__ x,
                       const float* __restrict__ uw,
                       const float* __restrict__ uh,
                       const float* __restrict__ ud,
                       const int* __restrict__ codes,
                       const float* __restrict__ bounds,
                       const float* __restrict__ ybar,
                       const float* __restrict__ lbar,
                       float* __restrict__ xg, float* __restrict__ dparams,
                       int N, size_t stride, int K_arg, Consts consts) {
  static_assert(kMode != kVjpAll || KB > 0, "vjp_all takes a compile-time bin count");
  const int K = kExact ? KB : K_arg;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t out = static_cast<size_t>(N);
  float* duw = dparams + n;
  float* duh = duw + static_cast<size_t>(K) * out;
  float* dud = duh + static_cast<size_t>(K) * out;
  if constexpr (kMode == kFull) {
    rqs::element_backward<kInverse, KB, kExact>(x + n, uw + n, uh + n, ud + n, stride, K,
                                                codes[n], bounds[n], ybar + n, lbar + n, consts,
                                                xg + n, duw, duh, dud, out);
  } else if constexpr (kMode == kVjpAll) {
    vjp_all_element<kInverse, KB, kExact>(
        x[n], rqs::load_params<KB, kExact>(uw + n, uh + n, ud + n, stride, K), K, codes[n],
        bounds[n], ybar[n], lbar[n], consts, xg + n, duw, duh, dud, out);
  } else {
    const float xn = x[n];
    Selection e;
    if constexpr (KB == 0) {
      e = rqs::select_bin<kInverse>(xn, uw + n, uh + n, ud + n, stride, K, codes[n],
                                    bounds[n], consts);
      copy_through(uw + n, uh + n, ud + n, stride, K, dparams + n, out);
    } else {
      rqs::ParamRegs<KB> r = rqs::load_params<KB, kExact>(uw + n, uh + n, ud + n, stride, K);
      copy_through_regs<KB, kExact>(r, K, duw, duh, dud, out);
      e = rqs::select_bin_regs<kInverse, KB, kExact>(xn, r, K, codes[n], bounds[n], consts);
    }
    float acc;
    if constexpr (kMode == kSelOnly) {
      const float sel = 0.0f + e.cw + e.w + e.ch + e.h + e.dk + e.dk1;
      const float stats = 0.0f + e.wmax + e.wsum + e.hmax + e.hsum;
      acc = e.xs + sel + stats;
    } else {
      const PostGrads g = kInverse ? rqs::post_math_vjp_inverse(e, ybar[n], lbar[n])
                                   : rqs::post_math_vjp_forward(e, ybar[n], lbar[n]);
      acc = 0.0f + g.xs + g.cw + g.w + g.ch + g.h + g.dk + g.dk1;
    }
    xg[n] = acc + e.hits;
  }
}

struct Args {
  const float *x, *uw, *uh, *ud;
  const int* codes;
  const float *bounds, *ybar, *lbar;
  float *xg, *dparams;
  int N;
  size_t stride;
  int K;
  Consts consts;
};

template <int kMode, bool kInverse>
void launch(const Args& a, cudaStream_t s) {
  const int threads = rqs::block_threads(a.N, 1, kMinBlocks);
  const int blocks = (a.N + threads - 1) / threads;
#define RQS_ABLATE_LAUNCH(KB, EXACT)                                            \
  rqs_flat_ablate_kernel<kMode, kInverse, KB, EXACT><<<blocks, threads, 0, s>>>( \
      a.x, a.uw, a.uh, a.ud, a.codes, a.bounds, a.ybar, a.lbar, a.xg, a.dparams, a.N,  \
      a.stride, a.K, a.consts)
  if (a.K == 8) {
    RQS_ABLATE_LAUNCH(8, true);
  } else if (a.K == 10) {
    RQS_ABLATE_LAUNCH(10, true);
  } else if (a.K <= kMaxBins) {
    RQS_ABLATE_LAUNCH(kMaxBins, false);
  } else if constexpr (kMode != kVjpAll) {
    RQS_ABLATE_LAUNCH(0, false);
  }
#undef RQS_ABLATE_LAUNCH
}

template <int kMode>
void launch(bool inverse, const Args& a, cudaStream_t s) {
  if (inverse) {
    launch<kMode, true>(a, s);
  } else {
    launch<kMode, false>(a, s);
  }
}

}  // namespace

// Launches variant `mode` (0 sel_only, 1 sel_post, 2 full, 3 vjp_all) on
// `stream` and returns cudaGetLastError() (0 on success).  All pointers are
// device pointers; uw and uh hold K rows and ud K+1 rows of at least N
// floats, `stride` floats apart; xg holds N floats and dparams (3K+1) * N.
// vjp_all takes K <= 16.
extern "C" int rqs_flat_ablate(int mode, const float* x, const float* uw,
                               const float* uh, const float* ud,
                               const int* codes, const float* bounds,
                               const float* ybar, const float* lbar,
                               float* xg, float* dparams, int N, int K,
                               long long stride, int inverse,
                               double min_bin_width, double min_bin_height,
                               double min_derivative, void* stream) {
  if (N < 1 || K < 1 || stride < N || mode < kSelOnly || mode > kVjpAll ||
      (mode == kVjpAll && K > kMaxBins)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, uw, uh, ud, codes, bounds, ybar, lbar, xg, dparams, N,
               static_cast<size_t>(stride), K,
               rqs::make_consts(K, min_bin_width, min_bin_height, min_derivative)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0;
  switch (mode) {
    case kSelOnly:
      launch<kSelOnly>(inv, a, s);
      break;
    case kSelPost:
      launch<kSelPost>(inv, a, s);
      break;
    case kFull:
      launch<kFull>(inv, a, s);
      break;
    default:
      launch<kVjpAll>(inv, a, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
