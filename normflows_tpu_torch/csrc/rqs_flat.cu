// Flat rational-quadratic spline (forward or inverse) and its backward, for
// Hopper, sm_90a.
//
// `rqs_flat_kernel` replaces the TPU kernel `_fwd_kernel`
// (normflows_tpu/ops/spline_pallas.py:303, body `_spline_block` :179),
// launched by `_pallas_fwd_flat` (:332, call :345).  Two entry points of the
// JAX package reach it: `unconstrained_rqs_pallas_dyncodes` (:636), whose
// tail codes and bounds are runtime arrays (the sliced sequential inverse of
// the large-D autoregressive flow calls it once per step), and
// `unconstrained_rational_quadratic_spline_pallas` (:444), whose static
// per-dim tails `_prepare` (:408) spreads into such arrays after relaying
// the parameters out from (..., S) to (S, N).  Both are ops/spline_flat.py
// here.  For each of N elements it reads x[n], its tail code codes[n] and
// bound bounds[n], and its 3K+1 parameters on rows `stride` floats apart
// (widths uw[k * stride], heights uh[k * stride], derivative logits
// ud[k * stride]): stride is N for packed (S, N) operands and B for the
// (3K+1, B) slab of one feature in the autoregressive net's (F*(3K+1), B)
// output, which is the same number there, since N = B.  It writes y[n] and
// ld[n].
//
// `rqs_flat_backward_kernel` replaces `_bwd_kernel` (:313, body
// `_bwd_scatter` :198), launched by `_pallas_bwd_flat` (:359, call :373):
// from the cotangents ybar, lbar (N,) it writes dx (N,) and the 3K+1
// parameter gradients, every one, zeros included, packed into dparams
// (3K+1, N) (widths, heights, derivative logits).  No gradient goes to the
// codes or the bounds, as in the JAX package.
//
// The per-element math (bin search, rational-quadratic map, hand-derived
// backward) is rqs_common.cuh, shared with the planar kernels of
// rqs_transposed.cu; both directions come from the template argument.
//
// What bounds both on this card: memory.  The forward reads 1 + (3K+1)
// floats and 2 words of tail an element and writes 2: at K = 8 that is
// 120 B an element, 0.49 MB at N = 4096 (0.15 us at 3.35 TB/s) and 31.5 MB
// at N = 262,144 (9.4 us); the backward reads 3 + (3K+1) floats and the 2
// words of tail and writes 1 + (3K+1), 224 B an element (0.92 MB and
// 58.7 MB at the same sizes).  The design is the planar kernel's: one
// thread per element on threadIdx.x, so that every row read and every
// write is coalesced across a warp, and the ragged edge masked rather
// than padded.
//
// The launches are small: the sliced inverse gives the forward N = 4096,
// 256 times a sample, and the backward the same N, 256 times a reverse-KL
// step; one element's chain of loads and exponentials, not the bytes, sets
// their time.  So both kernels take the bin count as a template argument:
// 8 and 10 exactly (the large-D and coupled models, the flagship and the
// ablation), K <= kMaxBins with the bins above K masked, and the loops of
// `select_bin` / `spline_element_backward` over a runtime K above that.
// An element's 3K+1 parameters are loaded into registers in one unrolled
// pass (`rqs::ParamRegs`), so that every load and every exponential is in
// flight at once, and the backward scatters from the same registers
// (exp(logit - max) of every width and height, the raw derivative logits)
// rather than reading and exponentiating them again.  Both follow the
// loops' operations in their order, so they give the same bits.  Their
// block size follows N (`rqs::block_threads`), so that a small launch
// spreads over the SMs (N = 4096: 64 blocks of 64 threads, where 256-thread
// blocks gave 16) and a large one keeps 256 threads a block.

#include "rqs_common.cuh"

namespace {

using rqs::Consts;
using rqs::Selection;

constexpr int kThreads = 256;
constexpr int kMaxBins = 16;     // the largest K of the register path
constexpr int kMinBlocks = 128;  // a launch's blocks, where N allows

// KB bins (kExact) or K <= KB; KB = 0: `select_bin` over a runtime K
template <bool kInverse, int KB, bool kExact>
__global__ void __launch_bounds__(kThreads)
rqs_flat_kernel(const float* __restrict__ x, const float* __restrict__ uw,
                const float* __restrict__ uh, const float* __restrict__ ud,
                const int* __restrict__ codes,
                const float* __restrict__ bounds, float* __restrict__ y,
                float* __restrict__ ld, int N, size_t stride, int K,
                Consts consts) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float xn = x[n];
  Selection e;
  if constexpr (KB == 0) {
    e = rqs::select_bin<kInverse>(xn, uw + n, uh + n, ud + n, stride, K, codes[n],
                                  bounds[n], consts);
  } else {
    rqs::ParamRegs<KB> r = rqs::load_params<KB, kExact>(uw + n, uh + n, ud + n, stride, K);
    e = rqs::select_bin_regs<kInverse, KB, kExact>(xn, r, K, codes[n], bounds[n], consts);
  }
  rqs::spline_element<kInverse>(e, xn, y + n, ld + n);
}

// The same bin counts as the forward's
template <bool kInverse, int KB, bool kExact>
__global__ void __launch_bounds__(kThreads)
rqs_flat_backward_kernel(const float* __restrict__ x,
                         const float* __restrict__ uw,
                         const float* __restrict__ uh,
                         const float* __restrict__ ud,
                         const int* __restrict__ codes,
                         const float* __restrict__ bounds,
                         const float* __restrict__ ybar,
                         const float* __restrict__ lbar,
                         float* __restrict__ dx,
                         float* __restrict__ dparams, int N, size_t stride,
                         int K, Consts consts) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t out = static_cast<size_t>(N);
  float* duw = dparams + n;
  float* duh = duw + static_cast<size_t>(K) * out;
  float* dud = duh + static_cast<size_t>(K) * out;
  rqs::element_backward<kInverse, KB, kExact>(x + n, uw + n, uh + n, ud + n, stride, K, codes[n],
                                              bounds[n], ybar + n, lbar + n, consts, dx + n, duw,
                                              duh, dud, out);
}

template <bool kInverse>
void launch_forward(const float* x, const float* uw, const float* uh, const float* ud,
                    const int* codes, const float* bounds, float* y, float* ld, int N,
                    size_t stride, int K, const Consts& consts, cudaStream_t s) {
  const int threads = rqs::block_threads(N, 1, kMinBlocks);
  const int blocks = (N + threads - 1) / threads;
#define RQS_FLAT_LAUNCH(KB, EXACT)                                             \
  rqs_flat_kernel<kInverse, KB, EXACT><<<blocks, threads, 0, s>>>(             \
      x, uw, uh, ud, codes, bounds, y, ld, N, stride, K, consts)
  if (K == 8) {
    RQS_FLAT_LAUNCH(8, true);
  } else if (K == 10) {
    RQS_FLAT_LAUNCH(10, true);
  } else if (K <= kMaxBins) {
    RQS_FLAT_LAUNCH(kMaxBins, false);
  } else {
    RQS_FLAT_LAUNCH(0, false);
  }
#undef RQS_FLAT_LAUNCH
}

template <bool kInverse>
void launch_backward(const float* x, const float* uw, const float* uh, const float* ud,
                     const int* codes, const float* bounds, const float* ybar,
                     const float* lbar, float* dx, float* dparams, int N, size_t stride,
                     int K, const Consts& consts, cudaStream_t s) {
  const int threads = rqs::block_threads(N, 1, kMinBlocks);
  const int blocks = (N + threads - 1) / threads;
#define RQS_FLAT_BACKWARD_LAUNCH(KB, EXACT)                                    \
  rqs_flat_backward_kernel<kInverse, KB, EXACT><<<blocks, threads, 0, s>>>(    \
      x, uw, uh, ud, codes, bounds, ybar, lbar, dx, dparams, N, stride, K, consts)
  if (K == 8) {
    RQS_FLAT_BACKWARD_LAUNCH(8, true);
  } else if (K == 10) {
    RQS_FLAT_BACKWARD_LAUNCH(10, true);
  } else if (K <= kMaxBins) {
    RQS_FLAT_BACKWARD_LAUNCH(kMaxBins, false);
  } else {
    RQS_FLAT_BACKWARD_LAUNCH(0, false);
  }
#undef RQS_FLAT_BACKWARD_LAUNCH
}

bool valid(int N, int K, long long stride) {
  return N >= 1 && K >= 1 && stride >= N;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  All
// pointers are device pointers; uw and uh hold K rows and ud K+1 rows of at
// least N floats, `stride` floats apart.
extern "C" int rqs_flat_forward(const float* x, const float* uw,
                                const float* uh, const float* ud,
                                const int* codes, const float* bounds,
                                float* y, float* ld, int N, int K,
                                long long stride, int inverse,
                                double min_bin_width, double min_bin_height,
                                double min_derivative, void* stream) {
  if (!valid(N, K, stride)) return static_cast<int>(cudaErrorInvalidValue);
  const Consts consts =
      rqs::make_consts(K, min_bin_width, min_bin_height, min_derivative);
  const size_t st = static_cast<size_t>(stride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inverse) {
    launch_forward<true>(x, uw, uh, ud, codes, bounds, y, ld, N, st, K, consts, s);
  } else {
    launch_forward<false>(x, uw, uh, ud, codes, bounds, y, ld, N, st, K, consts, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward of rqs_flat_forward with the same arguments: from the
// cotangents ybar, lbar (N,) it writes dx (N,) and dparams (3K+1, N),
// packed.  Same stream and return rules.
extern "C" int rqs_flat_backward(const float* x, const float* uw,
                                 const float* uh, const float* ud,
                                 const int* codes, const float* bounds,
                                 const float* ybar, const float* lbar,
                                 float* dx, float* dparams, int N, int K,
                                 long long stride, int inverse,
                                 double min_bin_width, double min_bin_height,
                                 double min_derivative, void* stream) {
  if (!valid(N, K, stride)) return static_cast<int>(cudaErrorInvalidValue);
  const Consts consts =
      rqs::make_consts(K, min_bin_width, min_bin_height, min_derivative);
  const size_t st = static_cast<size_t>(stride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inverse) {
    launch_backward<true>(x, uw, uh, ud, codes, bounds, ybar, lbar, dx, dparams, N, st, K,
                          consts, s);
  } else {
    launch_backward<false>(x, uw, uh, ud, codes, bounds, ybar, lbar, dx, dparams, N, st, K,
                           consts, s);
  }
  return static_cast<int>(cudaGetLastError());
}
