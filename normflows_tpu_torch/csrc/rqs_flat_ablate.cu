// The flat spline backward's ablation, for Hopper, sm_90a: four variants of
// one kernel that split the backward's cost into its parts.
//
// `rqs_flat_ablate_kernel<kMode, kInverse>` replaces the TPU kernel
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
//   kFull     the shipped flat backward (`_bwd_scatter`): the same work as
//             rqs_flat_backward_kernel (rqs_flat.cu), dx and the gradients.
//   kVjpAll   the same function as kFull, structured as reverse-mode
//             automatic differentiation of the whole block
//             (`jax.vjp(_spline_block)`): a forward sweep keeps every bin's
//             residuals (exponentials, probabilities, widths, heights,
//             cumulative edges, hit masks, knot slopes and softplus
//             gradients) in per-thread arrays of kMaxBins, and a reverse
//             sweep carries the cotangents through all K bins to dense
//             gradients of every logit.  kFull instead keeps the selected
//             bin and four softmax statistics and recomputes the rest.
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
// and write is coalesced across a warp.  The point of the ablation is each
// instantiation's registers and spills (nvcc -Xptxas -v).  kVjpAll's
// residual arrays are fully unrolled over kMaxBins, so that every index is a
// constant and they can live in registers: on sm_90a ptxas gives it 128
// registers and a 72-byte stack frame, with no spill (PERF.md).

#include "rqs_common.cuh"

namespace {

using rqs::Consts;
using rqs::PostGrads;
using rqs::Selection;

constexpr int kThreads = 256;
// the largest K of kVjpAll, whose residual arrays are sized at compile time
constexpr int kMaxBins = 16;

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

// The whole-block pull-back of one element: `_spline_block` run forward
// with its residuals kept, then differentiated in reverse.
template <bool kInverse>
__device__ __forceinline__ void vjp_all_element(
    float x, const float* uw, const float* uh, const float* ud, size_t n_in,
    int K, int code, float bound, float ybar, float lbar, const Consts& c,
    float* dx, float* duw, float* duh, float* dud, size_t n_out) {
  // ---- forward sweep, every residual kept ----
  float ew[kMaxBins], eh[kMaxBins];  // exp(logit - max)
  float pw[kMaxBins], ph[kMaxBins];  // softmax probabilities
  float wk[kMaxBins], hk[kMaxBins];  // bin widths and heights
  float cwe[kMaxBins + 1], che[kMaxBins + 1];  // cumulative edges
  float d[kMaxBins + 1], sg[kMaxBins + 1];     // knot slopes, sigmoid(ud)
  bool hit[kMaxBins];

  const bool is_circ = code == rqs::kTailCircular;
  const bool is_lin = code == rqs::kTailLinear;
  const float left = -bound;
  const float span = 2.0f * bound;
  const bool inside = (x >= left) && (x <= -left);
  float xs;
  if (is_circ) {
    float r = fmodf(x - left, span);
    if (r < 0.0f) r += span;
    xs = left + r;
  } else {
    xs = fminf(fmaxf(x, left), -left);
  }

  float wmax = uw[0], hmax = uh[0];
#pragma unroll
  for (int k = 1; k < kMaxBins; ++k) {
    if (k < K) {
      wmax = fmaxf(wmax, uw[k * n_in]);
      hmax = fmaxf(hmax, uh[k * n_in]);
    }
  }
  float wsum = 0.0f, hsum = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxBins; ++k) {
    if (k < K) {
      ew[k] = expf(uw[k * n_in] - wmax);
      eh[k] = expf(uh[k * n_in] - hmax);
      wsum += ew[k];
      hsum += eh[k];
    }
  }
  cwe[0] = left;
  che[0] = left;
#pragma unroll
  for (int k = 0; k < kMaxBins; ++k) {
    if (k < K) {
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
  for (int k = 0; k <= kMaxBins; ++k) {
    if (k <= K) {
      const float u = ud[k * n_in];
      d[k] = c.min_derivative + rqs::softplus(u);
      sg[k] = rqs::sigmoid(u);
    }
  }
  const float d0_raw = d[0];
  if (is_lin) d[0] = 1.0f;
#pragma unroll
  for (int k = 1; k <= kMaxBins; ++k) {
    if (k == K) d[k] = is_lin ? 1.0f : (is_circ ? d0_raw : d[k]);
  }

  // the accumulate-and-select search, its hit masks kept
  Selection e;
  e.xs = xs;
  e.cw = 0.0f, e.w = 1.0f, e.ch = 0.0f, e.h = 1.0f, e.dk = 1.0f, e.dk1 = 1.0f;
  bool found = false;
#pragma unroll
  for (int k = 0; k < kMaxBins; ++k) {
    if (k < K) {
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
  float gw[kMaxBins], gh[kMaxBins], gd[kMaxBins + 1];
#pragma unroll
  for (int k = 0; k <= kMaxBins; ++k) gd[k] = 0.0f;
  float g_cw_edge = 0.0f, g_ch_edge = 0.0f;  // cotangents of cwe/che[k + 1]
#pragma unroll
  for (int k = kMaxBins - 1; k >= 0; --k) {
    if (k < K) {
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
  for (int k = 0; k < kMaxBins; ++k) {
    if (k < K) {
      gw[k] *= c.fw * span;  // now the cotangent of pw[k]
      gh[k] *= c.fh * span;
      gsw -= gw[k] * ew[k];
      gsh -= gh[k] * eh[k];
    }
  }
  gsw /= wsum * wsum;
  gsh /= hsum * hsum;
#pragma unroll
  for (int k = 0; k < kMaxBins; ++k) {
    if (k < K) {
      duw[k * n_out] = ew[k] * (gw[k] / wsum + gsw);
      duh[k * n_out] = eh[k] * (gh[k] / hsum + gsh);
    }
  }

  // slopes back to their logits: knot 0 pinned by a linear tail, knot K
  // pinned by a linear tail or taken from knot 0 by a circular one
  float g_raw0 = is_lin ? 0.0f : gd[0];
#pragma unroll
  for (int k = 1; k <= kMaxBins; ++k) {
    if (k == K) {
      if (is_circ && !is_lin) g_raw0 += gd[k];
      if (is_lin || is_circ) gd[k] = 0.0f;
    }
  }
  gd[0] = g_raw0;
#pragma unroll
  for (int k = 0; k <= kMaxBins; ++k) {
    if (k <= K) dud[k * n_out] = gd[k] * sg[k];
  }
}

template <int kMode, bool kInverse>
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
                       int N, size_t stride, int K, Consts consts) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t out = static_cast<size_t>(N);
  float* duw = dparams + n;
  float* duh = duw + static_cast<size_t>(K) * out;
  float* dud = duh + static_cast<size_t>(K) * out;
  if (kMode == kVjpAll) {
    vjp_all_element<kInverse>(x[n], uw + n, uh + n, ud + n, stride, K,
                              codes[n], bounds[n], ybar[n], lbar[n], consts,
                              xg + n, duw, duh, dud, out);
    return;
  }
  const float xn = x[n];
  const Selection e = rqs::select_bin<kInverse>(
      xn, uw + n, uh + n, ud + n, stride, K, codes[n], bounds[n], consts);
  if (kMode == kFull) {
    rqs::spline_element_backward<kInverse>(e, ybar[n], lbar[n], uw + n,
                                           uh + n, ud + n, stride, K, consts,
                                           xg + n, duw, duh, dud, out);
    return;
  }
  float acc;
  if (kMode == kSelOnly) {
    const float sel = 0.0f + e.cw + e.w + e.ch + e.h + e.dk + e.dk1;
    const float stats = 0.0f + e.wmax + e.wsum + e.hmax + e.hsum;
    acc = e.xs + sel + stats;
  } else {
    const PostGrads g = kInverse ? rqs::post_math_vjp_inverse(e, ybar[n], lbar[n])
                                 : rqs::post_math_vjp_forward(e, ybar[n], lbar[n]);
    acc = 0.0f + g.xs + g.cw + g.w + g.ch + g.h + g.dk + g.dk1;
  }
  xg[n] = acc + e.hits;
  copy_through(uw + n, uh + n, ud + n, stride, K, dparams + n, out);
}

template <int kMode>
void launch(bool inverse, int blocks, cudaStream_t s, const float* x,
            const float* uw, const float* uh, const float* ud,
            const int* codes, const float* bounds, const float* ybar,
            const float* lbar, float* xg, float* dparams, int N, size_t st,
            int K, const Consts& consts) {
  if (inverse) {
    rqs_flat_ablate_kernel<kMode, true><<<blocks, kThreads, 0, s>>>(
        x, uw, uh, ud, codes, bounds, ybar, lbar, xg, dparams, N, st, K,
        consts);
  } else {
    rqs_flat_ablate_kernel<kMode, false><<<blocks, kThreads, 0, s>>>(
        x, uw, uh, ud, codes, bounds, ybar, lbar, xg, dparams, N, st, K,
        consts);
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
  const Consts consts =
      rqs::make_consts(K, min_bin_width, min_bin_height, min_derivative);
  const int blocks = (N + kThreads - 1) / kThreads;
  const size_t st = static_cast<size_t>(stride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0;
  switch (mode) {
    case kSelOnly:
      launch<kSelOnly>(inv, blocks, s, x, uw, uh, ud, codes, bounds, ybar,
                       lbar, xg, dparams, N, st, K, consts);
      break;
    case kSelPost:
      launch<kSelPost>(inv, blocks, s, x, uw, uh, ud, codes, bounds, ybar,
                       lbar, xg, dparams, N, st, K, consts);
      break;
    case kFull:
      launch<kFull>(inv, blocks, s, x, uw, uh, ud, codes, bounds, ybar, lbar,
                    xg, dparams, N, st, K, consts);
      break;
    default:
      launch<kVjpAll>(inv, blocks, s, x, uw, uh, ud, codes, bounds, ybar,
                      lbar, xg, dparams, N, st, K, consts);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
