// Planar rational-quadratic spline (forward or inverse) and its backward, for
// Hopper, sm_90a.
//
// `rqs_transposed_kernel` replaces the TPU kernel `_t_fwd_kernel`, launched
// by `rqs_transposed_pallas` (normflows_tpu/ops/spline_pallas.py:559, :726).
// It computes the same function: for every element (f, b) of the planar
// input x_t (F, B) it normalises the feature's K width and K height logits by
// softmax, builds the K+1 knot slopes from its tail mode, finds the bin by the
// K-step accumulate-and-select search of `_selection` (:89-176, the last bin
// catches every element the search leaves over), and evaluates the
// rational-quadratic map and its log|det| as `_post_math` (:50-86) does.
// Parameters come planar too: row f*(3K+1)+s of params_t (F*(3K+1), B) holds
// widths (s < K), heights (K <= s < 2K), then slopes (2K <= s <= 3K).
//
// `rqs_transposed_backward_kernel` replaces `_t_bwd_kernel` (:591), the
// custom-vjp backward `_t_vjp_bwd` (:774) via `_bwd_scatter` (:198-300):
// from the cotangents ybar, lbar (F, B) it computes dx (F, B) and dparams
// (F*(3K+1), B).  It recomputes the softmax statistics and the bin search,
// pulls the cotangents back through the rational-quadratic map by
// hand-derived partials (the JAX kernel has jax.vjp trace `_post_math`), and
// scatters them through the selection.
//
// The per-element math of both (bin search, map, backward) lives in
// rqs_common.cuh, shared with the flat kernels of rqs_flat.cu; this file
// holds only where an element's data lie: feature f's tail code and bound
// travel by value in the launch's arguments, and its parameter rows are B
// floats apart.
//
// What bounds both on this card: memory.  The forward reads 1 + (3K+1)
// floats an element and writes 2 (at F=2, K=10, B=2^14: 4.46 MB, 1.33 us at
// 3.35 TB/s); the backward reads 3 + (3K+1) and writes 1 + (3K+1) (8.65 MB,
// 2.58 us).  Each does a few hundred operations an element, ~10^7 in all,
// far below the bytes' time.  Both put one thread on each (f, b) element,
// the batch index on threadIdx.x, so every read of a parameter row and
// every write is coalesced across a warp, and mask the ragged edge of B
// rather than pad it.
//
// What sets their time is one element's chain of dependent loads and
// exponentials: at B = 2^14 the 2^15 threads give each SM about 8 warps,
// too few to hide it.  So both kernels take the bin count as a template
// argument, as the flat kernels do: 10 and 8 exactly (the flagship, the
// large-D model), K <= kMaxBins with the bins above K masked, and the loops
// of `select_bin` / `spline_element_backward` over a runtime K above that.
// An element's 3K+1 parameters are loaded into registers in one unrolled
// pass (`rqs::load_params`), so that all of its loads and exponentials are
// in flight at once, with the loops' operations in their order; the
// backward scatters its gradients from the same registers
// (`rqs::element_backward`, shared with the flat backward) rather than
// reading and exponentiating every logit again.  Both size their blocks
// from the element count (`rqs::block_threads`: 128 threads, 256 blocks at
// F = 2, B = 2^14), so that the grid spreads over the 132 SMs.

#include "rqs_common.cuh"

namespace {

using rqs::Consts;
using rqs::Selection;

constexpr int kMaxFeatures = 8;
constexpr int kThreads = 256;
constexpr int kMaxBins = 16;     // the largest K of the register path
constexpr int kMinBlocks = 256;  // a launch's blocks, where F and B allow

struct Tails {
  int code[kMaxFeatures];
  float bound[kMaxFeatures];
};

// KB bins (kExact) or K <= KB; KB = 0: `select_bin` over a runtime K
template <bool kInverse, int KB, bool kExact>
__global__ void __launch_bounds__(kThreads)
rqs_transposed_kernel(const float* __restrict__ x_t,
                      const float* __restrict__ params_t,
                      float* __restrict__ y_t, float* __restrict__ ld_t,
                      Tails tails, int B, int K_arg, Consts consts) {
  const int K = kExact ? KB : K_arg;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int f = blockIdx.y;
  const size_t n = static_cast<size_t>(B);
  const size_t S = static_cast<size_t>(3 * K + 1);
  const float* uw = params_t + static_cast<size_t>(f) * S * n + b;
  const float* uh = uw + static_cast<size_t>(K) * n;
  const float* ud = uh + static_cast<size_t>(K) * n;

  const size_t i = static_cast<size_t>(f) * n + b;
  const float x = x_t[i];
  Selection e;
  if constexpr (KB == 0) {
    e = rqs::select_bin<kInverse>(x, uw, uh, ud, n, K, tails.code[f], tails.bound[f], consts);
  } else {
    rqs::ParamRegs<KB> r = rqs::load_params<KB, kExact>(uw, uh, ud, n, K);
    e = rqs::select_bin_regs<kInverse, KB, kExact>(x, r, K, tails.code[f], tails.bound[f],
                                                    consts);
  }
  rqs::spline_element<kInverse>(e, x, y_t + i, ld_t + i);
}

template <bool kInverse>
void launch_forward(const float* x_t, const float* params_t, float* y_t, float* ld_t,
                    const Tails& tails, int F, int B, int K, const Consts& consts,
                    cudaStream_t s) {
  const int threads = rqs::block_threads(B, F, kMinBlocks);
  const dim3 grid((B + threads - 1) / threads, F);
#define RQS_PLANAR_LAUNCH(KB, EXACT)                                           \
  rqs_transposed_kernel<kInverse, KB, EXACT><<<grid, threads, 0, s>>>(         \
      x_t, params_t, y_t, ld_t, tails, B, K, consts)
  if (K == 10) {
    RQS_PLANAR_LAUNCH(10, true);
  } else if (K == 8) {
    RQS_PLANAR_LAUNCH(8, true);
  } else if (K <= kMaxBins) {
    RQS_PLANAR_LAUNCH(kMaxBins, false);
  } else {
    RQS_PLANAR_LAUNCH(0, false);
  }
#undef RQS_PLANAR_LAUNCH
}

// The forward's bin counts; KB = 0: the loops over a runtime K
template <bool kInverse, int KB, bool kExact>
__global__ void __launch_bounds__(kThreads)
rqs_transposed_backward_kernel(const float* __restrict__ x_t,
                               const float* __restrict__ params_t,
                               const float* __restrict__ ybar_t,
                               const float* __restrict__ lbar_t,
                               float* __restrict__ dx_t,
                               float* __restrict__ dparams_t, Tails tails,
                               int B, int K_arg, Consts consts) {
  const int K = kExact ? KB : K_arg;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int f = blockIdx.y;
  const size_t n = static_cast<size_t>(B);
  const size_t S = static_cast<size_t>(3 * K + 1);
  const size_t row0 = static_cast<size_t>(f) * S * n + b;
  const float* uw = params_t + row0;
  const float* uh = uw + static_cast<size_t>(K) * n;
  const float* ud = uh + static_cast<size_t>(K) * n;
  float* duw = dparams_t + row0;
  float* duh = duw + static_cast<size_t>(K) * n;
  float* dud = duh + static_cast<size_t>(K) * n;

  const size_t i = static_cast<size_t>(f) * n + b;
  rqs::element_backward<kInverse, KB, kExact>(x_t + i, uw, uh, ud, n, K, tails.code[f],
                                              tails.bound[f], ybar_t + i, lbar_t + i, consts,
                                              dx_t + i, duw, duh, dud, n);
}

template <bool kInverse>
void launch_backward(const float* x_t, const float* params_t, const float* ybar_t,
                     const float* lbar_t, float* dx_t, float* dparams_t, const Tails& tails,
                     int F, int B, int K, const Consts& consts, cudaStream_t s) {
  const int threads = rqs::block_threads(B, F, kMinBlocks);
  const dim3 grid((B + threads - 1) / threads, F);
#define RQS_PLANAR_BACKWARD_LAUNCH(KB, EXACT)                                  \
  rqs_transposed_backward_kernel<kInverse, KB, EXACT><<<grid, threads, 0, s>>>( \
      x_t, params_t, ybar_t, lbar_t, dx_t, dparams_t, tails, B, K, consts)
  if (K == 10) {
    RQS_PLANAR_BACKWARD_LAUNCH(10, true);
  } else if (K == 8) {
    RQS_PLANAR_BACKWARD_LAUNCH(8, true);
  } else if (K <= kMaxBins) {
    RQS_PLANAR_BACKWARD_LAUNCH(kMaxBins, false);
  } else {
    RQS_PLANAR_BACKWARD_LAUNCH(0, false);
  }
#undef RQS_PLANAR_BACKWARD_LAUNCH
}

bool fill_tails(const int* codes, const float* bounds, int F, Tails* tails) {
  if (F < 1 || F > kMaxFeatures) return false;
  for (int f = 0; f < F; ++f) {
    tails->code[f] = codes[f];
    tails->bound[f] = bounds[f];
  }
  for (int f = F; f < kMaxFeatures; ++f) {
    tails->code[f] = rqs::kTailLinear;
    tails->bound[f] = 1.0f;
  }
  return true;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `codes` and `bounds` are host arrays of F entries; they travel to the
// device by value in the kernel's arguments.
extern "C" int rqs_transposed_forward(const float* x_t, const float* params_t,
                                      float* y_t, float* ld_t,
                                      const int* codes, const float* bounds,
                                      int F, int B, int K, int inverse,
                                      double min_bin_width,
                                      double min_bin_height,
                                      double min_derivative, void* stream) {
  Tails tails;
  if (B < 1 || K < 1 || !fill_tails(codes, bounds, F, &tails)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Consts consts =
      rqs::make_consts(K, min_bin_width, min_bin_height, min_derivative);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inverse) {
    launch_forward<true>(x_t, params_t, y_t, ld_t, tails, F, B, K, consts, s);
  } else {
    launch_forward<false>(x_t, params_t, y_t, ld_t, tails, F, B, K, consts, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward of rqs_transposed_forward with the same arguments: from the
// cotangents ybar_t, lbar_t (F, B) it writes dx_t (F, B) and dparams_t
// (F*(3K+1), B), every element.  Same stream and return rules.
extern "C" int rqs_transposed_backward(
    const float* x_t, const float* params_t, const float* ybar_t,
    const float* lbar_t, float* dx_t, float* dparams_t, const int* codes,
    const float* bounds, int F, int B, int K, int inverse,
    double min_bin_width, double min_bin_height, double min_derivative,
    void* stream) {
  Tails tails;
  if (B < 1 || K < 1 || !fill_tails(codes, bounds, F, &tails)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Consts consts =
      rqs::make_consts(K, min_bin_width, min_bin_height, min_derivative);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inverse) {
    launch_backward<true>(x_t, params_t, ybar_t, lbar_t, dx_t, dparams_t, tails, F, B, K,
                          consts, s);
  } else {
    launch_backward<false>(x_t, params_t, ybar_t, lbar_t, dx_t, dparams_t, tails, F, B, K,
                           consts, s);
  }
  return static_cast<int>(cudaGetLastError());
}
