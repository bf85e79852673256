// Fused residual MADE (context-free, masks pre-multiplied into the weights),
// forward and backward, for Hopper, sm_90a.
//
// `made_fwd_kernel` replaces the TPU kernel `_fwd_kernel`
// (normflows_tpu/ops/made_pallas.py:89, math `_mlp_block` :60), launched by
// `_fwd_impl` (:168, call :177).  For a (B, F) input it computes
//
//     h   = mm(x, W0) + b0
//     for r < R:  h += mm(act(mm(act(h), W1[r]) + b1[r]), W2[r]) + b2[r]
//     out = mm(h, Wf) + bf                                   (B, P), float32
//
// with the weights in torch's (out, in) layout: W0 (H, F), W1/W2 (R, H, H),
// Wf (P, H), float32 or bfloat16; biases float32.  mm(a, W) rounds its
// activation operand to bfloat16 when the weights are bfloat16 (JAX's `mm`,
// :74-77) and sums in float32; biases, activations and the residual stay
// float32.  A bf16 x bf16 product is exact in float32, so these SIMT FMAs
// give JAX's numbers up to the order of the sums.  There is no TF32.
//
// The backward replaces `_bwd_kernel` (:117), launched by `_vjp_bwd` (:194,
// call :209).  JAX recomputes each batch tile's forward in the kernel, pulls
// it back, and carries the weight gradients across the sequential grid in
// revisited output blocks (`_acc` :98).  Blocks of a CUDA grid run at once
// and in no order, so the backward here is three launches of one C call:
//
//   1. `made_bwd_tile_kernel`, one block per 32-row tile: the forward again,
//      then the pull-back to dx; it writes each layer's pre-activations and
//      its output cotangent to a scratch buffer;
//   2. `made_wgrad_kernel`: for every layer, dW = dC^T a and db = sum dC over
//      one 512-row split of the batch, one 64 x 64 tile of dW a block, into
//      a float32 partial buffer (no atomics);
//   3. `made_reduce_kernel`: the sum of the partials in split order (skipped
//      when the batch is one split).
//
// It is deterministic.  The bf16 rounding points of the input cotangents
// are JAX's (the vjp of its bf16 dot): each g W is summed in float32 and
// rounded to bfloat16.  The weight cotangents are summed in float32 over the
// whole batch and rounded to bfloat16 once (the caller's cast).  JAX rounds
// each 512-row tile's sum to bfloat16 before adding the tiles, and where the
// tiles' sums cancel that rounding alone moves a gradient by an ulp of a
// tile's sum (0.25 on values near 0.4 at the large-D shape, on an H100).
//
// Design.  One block of 256 threads owns 32 batch rows and keeps their
// hidden activation h and the block's inner pre-activation z (two 32 x H
// float32 tiles) in shared memory for the whole chain: no hidden activation
// goes to device memory in the forward.  Each product is a block GEMM: the
// activation operand is staged 16 columns at a time (transformed on the way
// in: act, bf16 rounding), the weights 256 outputs x 16 inputs at a time
// (widened to float32), the next chunk loaded into registers while the
// current one is multiplied, and each thread holds an 8 x 4 tile of the
// result in registers.  Edges in B, P and F are masked, not padded.  The
// dW kernel stages 32 rows of a layer's cotangent and operand at a time,
// prefetched the same way, and each thread holds a 4 x 4 tile of dW.
// Shared memory: 2 x 32 x H x 4 bytes + 22.5 KB of staging, which caps H at
// 768 (the gate `fusable` refuses more).
//
// With bfloat16 weights the forward's products (and the backward's
// recompute) run on the tensor cores: every operand is bf16 there, each
// product exact in float32, and mma.sync m16n8k16 sums in float32, so the
// numbers are the SIMT kernel's up to the order of the sums.  The backward's
// other products multiply a float32 cotangent by bf16 weights or operands,
// as JAX does in float32; they stay SIMT, since rounding the cotangent to
// bf16 for the tensor cores would change the numbers.
//
// What bounds it on this card: at the large-D shape (B 4096, F 64, H 256,
// R 1, P 1600) the forward does 4.56 GFLOP and moves ~29.5 MB (f32): in
// float32 operations (68 us at 67 TFLOP/s), in bf16 bytes (8.5 us at
// 3.35 TB/s, the tensor cores' 989 TFLOP/s being 4.6 us); the backward
// 10.3 GFLOP (154 us in float32).  B / 32 = 128 blocks give one wave of one
// block an SM, eight warps each, which is what holds these kernels at a
// fraction of either bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTB = 32;          // batch rows of a block
constexpr int kBN = 256;         // outputs of one GEMM pass: 32 lanes x 8
constexpr int kBK = 16;          // reduction depth of one staged chunk
constexpr int kAPad = kTB + 4;   // staged operand row (k-major), 16-byte rows
constexpr int kWPad = kBN + 1;   // staged weight row, no bank conflicts
constexpr int kMmaK = 32;          // depth of a staged chunk, tensor-core path
constexpr int kMmaRow = kMmaK + 8;  // its staged bf16 rows: 80 bytes, no conflicts
constexpr int kStageFloats =
    (kBK * kAPad + kBK * kWPad) > ((kTB + kBN) * kMmaRow / 2)
        ? (kBK * kAPad + kBK * kWPad)
        : ((kTB + kBN) * kMmaRow / 2);
constexpr int kMaxHidden = 768;  // 2 x 32 x 768 x 4 + staging <= 227 KB
constexpr int kSplit = 512;      // rows of one weight-gradient partial
constexpr int kWT = 64;          // dW tile: 64 outputs x 64 inputs
constexpr int kBM = 32;          // rows staged at a time in the dW kernel
constexpr int kMaxLayers = 16;   // layers of one dW launch

enum Act { kRelu = 0, kTanh = 1, kLeakyRelu = 2 };
enum Xform { kNone = 0, kRound = 1, kActRound = 2 };

__device__ __forceinline__ float act(int a, float x) {
  if (a == kRelu) return x > 0.f ? x : 0.f;
  if (a == kTanh) return tanhf(x);
  return x >= 0.f ? x : 0.01f * x;  // jax.nn.leaky_relu
}

// JAX's derivatives: relu' = (x > 0), leaky_relu' = (x >= 0 ? 1 : 0.01),
// tanh' = (1 + t)(1 - t) with t = tanh(x).
__device__ __forceinline__ float act_grad(int a, float x) {
  if (a == kRelu) return x > 0.f ? 1.f : 0.f;
  if (a == kTanh) {
    const float t = tanhf(x);
    return (1.f + t) * (1.f - t);
  }
  return x >= 0.f ? 1.f : 0.01f;
}

template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float widen(float w) { return w; }
__device__ __forceinline__ float widen(__nv_bfloat16 w) {
  return __bfloat162float(w);
}

template <bool kBf16>
__device__ __forceinline__ float transform(int xform, int a, float v) {
  if (xform == kActRound) v = act(a, v);
  return xform == kNone ? v : rnd<kBf16>(v);
}

template <bool kBf16>
using Weight = typename std::conditional<kBf16, __nv_bfloat16, float>::type;

// C[m][n] = sum_k t(A[m][k]) W(n, k) for m < rows, n < N, on one block;
// W(n, k) = W[n * sn + k * sk] (sk = 1: the (out, in) layout read forward;
// sn = 1: read transposed, for an input cotangent).  `epi(m, n, c)` takes
// each result.  A may lie in shared or device memory.  The next chunk's
// operands are loaded into registers while the current one is multiplied
// (the transform t and the widening happen at the store, so that nothing
// waits on the loads early).  Ends with a barrier, so that the next call
// sees what `epi` wrote.
template <bool kBf16, class Epi>
__device__ void block_gemm(const float* A, int lda, int rows, int K, int xform,
                           int act_kind, const Weight<kBf16>* W, long long sn,
                           long long sk, int N, float* stage, Epi epi) {
  constexpr int kAPer = kTB * kBK / kThreads;  // operand values a thread stages
  constexpr int kWPer = kBN * kBK / kThreads;  // weight values a thread stages
  float* As = stage;                // [kBK][kAPad], k-major
  float* Ws = stage + kBK * kAPad;  // [kBK][kWPad]
  // thread tile: rows ty * 8 ... + 7 (a broadcast across the warp), outputs
  // tx + 64 j: 2 + 4 shared-memory reads a k for 32 FMAs
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const bool along_k = sk == 1;  // coalesce the weight loads along k, else n
  float ar[kAPer];
  Weight<kBf16> wr[kWPer];
  // the (row or output, k) a thread stages as its j-th operand / weight value
  auto a_at = [&](int j, int& m, int& k) {
    const int i = tid + j * kThreads;
    m = i / kBK;
    k = i % kBK;
  };
  auto w_at = [&](int j, int& n, int& k) {
    const int i = tid + j * kThreads;
    n = along_k ? i / kBK : i % kBN;
    k = along_k ? i % kBK : i / kBN;
  };
  for (int n0 = 0; n0 < N; n0 += kBN) {
    auto load = [&](int k0) {
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {
        int m, k;
        a_at(j, m, k);
        ar[j] = m < rows && k0 + k < K ? A[static_cast<size_t>(m) * lda + k0 + k] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kWPer; ++j) {
        int n, k;
        w_at(j, n, k);
        wr[j] = n0 + n < N && k0 + k < K
                    ? W[static_cast<size_t>(n0 + n) * sn + static_cast<size_t>(k0 + k) * sk]
                    : Weight<kBf16>{};
      }
    };
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    load(0);
    for (int k0 = 0; k0 < K; k0 += kBK) {
      // t(0) = 0 for every transform, so the masked zeros stay zeros
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {
        int m, k;
        a_at(j, m, k);
        As[k * kAPad + m] = transform<kBf16>(xform, act_kind, ar[j]);
      }
#pragma unroll
      for (int j = 0; j < kWPer; ++j) {
        int n, k;
        w_at(j, n, k);
        Ws[k * kWPad + n] = widen(wr[j]);
      }
      __syncthreads();
      if (k0 + kBK < K) load(k0 + kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kAPad + ty * 8);
        const float4 a1 = *reinterpret_cast<const float4*>(As + kk * kAPad + ty * 8 + 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = Ws[kk * kWPad + tx + 64 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = ty * 8 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 64 * j;
        if (m < rows && n < N) epi(m, n, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// D += A B on the tensor cores: A 16 x 16 (row-major) and B 16 x 8 (k
// fastest, "col") bfloat16 fragments, D 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pair_at(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// block_gemm for a product of the forward with bfloat16 weights read in the
// (out, in) layout (sk = 1): the operand rounded to bfloat16 (xform kRound
// or kActRound), so every product is bf16 x bf16, exact in float32, and the
// tensor cores' float32 sums give the SIMT kernel's numbers up to their
// order.  Warp w computes outputs w * 32 ... w * 32 + 31 of a 256-wide pass
// for all 32 rows: 2 x 4 m16n8k16 tiles, 32 float32 sums a thread.
template <class Epi>
__device__ void block_gemm_mma(const float* A, int lda, int rows, int K, int xform,
                               int act_kind, const __nv_bfloat16* W, long long sn,
                               int N, float* stage, Epi epi) {
  constexpr int kAPer = kTB * kMmaK / kThreads;       // operand values a thread stages
  constexpr int kWVec = kBN * kMmaK / (8 * kThreads);  // 8-weight vectors a thread stages
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(stage);  // [kTB][kMmaRow]
  __nv_bfloat16* Ws = As + kTB * kMmaRow;                          // [kBN][kMmaRow]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group and thread
  // 16-byte weight loads where every row starts 16 bytes apart and no vector
  // straddles K; else two bf16 at a time into the same registers
  const bool vec = sn % 8 == 0 && K % 8 == 0;
  float ar[kAPer];
  uint4 wr[kWVec];  // vector j: weights (n, k ... k + 7) of one output row
  auto w_at = [&](int j, int& n, int& k) {
    const int i = tid + j * kThreads;
    n = i / (kMmaK / 8);
    k = (i % (kMmaK / 8)) * 8;
  };
  for (int n0 = 0; n0 < N; n0 += kBN) {
    auto load = [&](int k0) {
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {  // a warp reads 32 consecutive k of one row
        const int i = tid + j * kThreads, m = i / kMmaK, k = i % kMmaK;
        ar[j] = m < rows && k0 + k < K ? A[static_cast<size_t>(m) * lda + k0 + k] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kWVec; ++j) {
        int n, k;
        w_at(j, n, k);
        const __nv_bfloat16* src = W + static_cast<size_t>(n0 + n) * sn + k0 + k;
        const bool row = n0 + n < N;
        if (vec) {
          wr[j] = row && k0 + k < K ? *reinterpret_cast<const uint4*>(src)
                                    : make_uint4(0, 0, 0, 0);
        } else {
          uint32_t w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int kq = k0 + k + 2 * q;
            const uint32_t lo = row && kq < K ? __bfloat16_as_ushort(src[2 * q]) : 0u;
            const uint32_t hi = row && kq + 1 < K ? __bfloat16_as_ushort(src[2 * q + 1]) : 0u;
            w[q] = lo | (hi << 16);
          }
          wr[j] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    };
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
    load(0);
    for (int k0 = 0; k0 < K; k0 += kMmaK) {
#pragma unroll
      for (int j = 0; j < kAPer; ++j) {
        const int i = tid + j * kThreads;
        As[(i / kMmaK) * kMmaRow + i % kMmaK] =
            __float2bfloat16_rn(transform<true>(xform, act_kind, ar[j]));
      }
#pragma unroll
      for (int j = 0; j < kWVec; ++j) {
        int n, k;
        w_at(j, n, k);
        *reinterpret_cast<uint4*>(Ws + n * kMmaRow + k) = wr[j];
      }
      __syncthreads();
      if (k0 + kMmaK < K) load(k0 + kMmaK);
#pragma unroll
      for (int ks = 0; ks < kMmaK; ks += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* r = As + (mt * 16 + g) * kMmaRow + ks + 2 * t;
          a[mt][0] = pair_at(r);
          a[mt][1] = pair_at(r + 8 * kMmaRow);
          a[mt][2] = pair_at(r + 8);
          a[mt][3] = pair_at(r + 8 * kMmaRow + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat16* c = Ws + (warp * 32 + nt * 8 + g) * kMmaRow + ks + 2 * t;
          const uint32_t b0 = pair_at(c), b1 = pair_at(c + 8);
          mma_bf16(acc[0][nt], a[0], b0, b1);
          mma_bf16(acc[1][nt], a[1], b0, b1);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = mt * 16 + g + (c >= 2 ? 8 : 0);
          const int n = n0 + warp * 32 + nt * 8 + 2 * t + (c & 1);
          if (m < rows && n < N) epi(m, n, acc[mt][nt][c]);
        }
  }
  __syncthreads();
}

// A product of the forward: weights in the (out, in) layout and the operand
// rounded (xform kRound or kActRound); bf16 weights take the tensor cores.
template <bool kBf16, class Epi>
__device__ void forward_gemm(const float* A, int lda, int rows, int K, int xform,
                             int act_kind, const Weight<kBf16>* W, long long sn, int N,
                             float* stage, Epi epi) {
  if constexpr (kBf16) {
    block_gemm_mma(A, lda, rows, K, xform, act_kind, W, sn, N, stage, epi);
  } else {
    block_gemm<false>(A, lda, rows, K, xform, act_kind, W, sn, 1, N, stage, epi);
  }
}

__device__ void save_tile(const float* S, float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = S[i];
}

template <bool kBf16>
struct Made {
  const float* x;
  const Weight<kBf16>* w0;
  const float* b0;
  const Weight<kBf16>* w1s;
  const float* b1s;
  const Weight<kBf16>* w2s;
  const float* b2s;
  const Weight<kBf16>* wf;
  const float* bf;
  int B, F, H, R, P, act;
};

// Scratch of the backward, each (B, H) slab row-major: h[r] (r <= R, the
// residual stream before block r; h[R] feeds the final layer), z[r] (block
// r's inner pre-activation), d2[r] and d1[r] (the cotangents of block r's
// two products' outputs), d0 (of the first layer's output).
struct Scratch {
  float *h, *z, *d2, *d1, *d0;
};

__host__ __device__ inline Scratch carve(float* s, int B, int H, int R) {
  const size_t slab = static_cast<size_t>(B) * H;
  Scratch out;
  out.h = s;
  out.z = out.h + (R + 1) * slab;
  out.d2 = out.z + R * slab;
  out.d1 = out.d2 + R * slab;
  out.d0 = out.d1 + R * slab;
  return out;
}

// The forward of one tile up to h[R] (left in Hs); with `save`, the
// pre-activations go to the scratch as well.
template <bool kBf16>
__device__ void forward_chain(const Made<kBf16>& p, int row0, int rows,
                             float* stage, float* Hs, float* Zs,
                             const Scratch* save) {
  const int H = p.H;
  const size_t slab = static_cast<size_t>(p.B) * H;
  const size_t at = static_cast<size_t>(row0) * H;
  forward_gemm<kBf16>(p.x + static_cast<size_t>(row0) * p.F, p.F, rows, p.F,
                      kRound, p.act, p.w0, p.F, H, stage,
                      [&](int m, int n, float c) { Hs[m * H + n] = c + p.b0[n]; });
  if (save) save_tile(Hs, save->h + at, rows * H);
  for (int r = 0; r < p.R; ++r) {
    const size_t wr = static_cast<size_t>(r) * H * H;
    const float* b1 = p.b1s + r * H;
    const float* b2 = p.b2s + r * H;
    forward_gemm<kBf16>(Hs, H, rows, H, kActRound, p.act, p.w1s + wr, H, H, stage,
                        [&](int m, int n, float c) { Zs[m * H + n] = c + b1[n]; });
    if (save) save_tile(Zs, save->z + r * slab + at, rows * H);
    forward_gemm<kBf16>(Zs, H, rows, H, kActRound, p.act, p.w2s + wr, H, H, stage,
                        [&](int m, int n, float c) {
                          Hs[m * H + n] = Hs[m * H + n] + (c + b2[n]);
                        });
    if (save) save_tile(Hs, save->h + (r + 1) * slab + at, rows * H);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
made_fwd_kernel(Made<kBf16> p, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* Hs = stage + kStageFloats;
  float* Zs = Hs + kTB * p.H;
  const int row0 = blockIdx.x * kTB;
  const int rows = min(kTB, p.B - row0);
  forward_chain<kBf16>(p, row0, rows, stage, Hs, Zs, nullptr);
  float* o = out + static_cast<size_t>(row0) * p.P;
  const int P = p.P;
  forward_gemm<kBf16>(Hs, p.H, rows, p.H, kRound, p.act, p.wf, p.H, P, stage,
                      [&](int m, int n, float c) {
                        o[static_cast<size_t>(m) * P + n] = c + p.bf[n];
                      });
}

// Pass 1 of the backward: recompute, pull back to dx, write the scratch.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
made_bwd_tile_kernel(Made<kBf16> p, const float* __restrict__ g,
                     float* __restrict__ dx, float* scratch) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* Hs = stage + kStageFloats;
  float* Zs = Hs + kTB * p.H;
  const int H = p.H, F = p.F, P = p.P;
  const int row0 = blockIdx.x * kTB;
  const int rows = min(kTB, p.B - row0);
  const Scratch s = carve(scratch, p.B, H, p.R);
  const size_t slab = static_cast<size_t>(p.B) * H;
  const size_t at = static_cast<size_t>(row0) * H;
  forward_chain<kBf16>(p, row0, rows, stage, Hs, Zs, &s);
  // dh = g Wf (the final layer's input cotangent)
  block_gemm<kBf16>(g + static_cast<size_t>(row0) * P, P, rows, P, kNone, p.act,
                    p.wf, 1, H, H, stage, [&](int m, int n, float c) {
                      Hs[m * H + n] = rnd<kBf16>(c);
                    });
  for (int r = p.R - 1; r >= 0; --r) {
    const size_t wr = static_cast<size_t>(r) * H * H;
    const float* z = s.z + r * slab + at;
    const float* h = s.h + r * slab + at;
    save_tile(Hs, s.d2 + r * slab + at, rows * H);  // dz2 = dh
    block_gemm<kBf16>(Hs, H, rows, H, kNone, p.act, p.w2s + wr, 1, H, H, stage,
                      [&](int m, int n, float c) {
                        Zs[m * H + n] = rnd<kBf16>(c) * act_grad(p.act, z[m * H + n]);
                      });
    save_tile(Zs, s.d1 + r * slab + at, rows * H);  // dz1
    block_gemm<kBf16>(Zs, H, rows, H, kNone, p.act, p.w1s + wr, 1, H, H, stage,
                      [&](int m, int n, float c) {
                        Hs[m * H + n] += rnd<kBf16>(c) * act_grad(p.act, h[m * H + n]);
                      });
  }
  save_tile(Hs, s.d0 + at, rows * H);  // dh0
  float* d = dx + static_cast<size_t>(row0) * F;
  block_gemm<kBf16>(Hs, H, rows, H, kNone, p.act, p.w0, 1, F, F, stage,
                    [&](int m, int n, float c) {
                      d[static_cast<size_t>(m) * F + n] = rnd<kBf16>(c);
                    });
}

// One layer of pass 2: dW (N, K) += dC^T t(A) and db (N,) += sum dC.
struct WgradLayer {
  const float* dc;
  const float* a;
  int ldc, lda, xform, N, K;
  long long w_off, b_off;  // into the flat gradient
  int tiles_k, tile0;      // dW tiles along K; the layer's first tile
};

struct WgradTable {
  WgradLayer layer[kMaxLayers];
  int count;
};

// Block (tile, split): one kWT x kWT tile of one layer's dW over the rows
// of one split, written to part[split]; the tiles at k = 0 also write the
// split's db.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
made_wgrad_kernel(WgradTable t, int B, int act_kind, long long total,
                  float* __restrict__ part) {
  __shared__ __align__(16) float Cs[kBM][kWT];
  __shared__ __align__(16) float As[kBM][kWT];
  int li = 0;
  while (li + 1 < t.count && static_cast<int>(blockIdx.x) >= t.layer[li + 1].tile0) ++li;
  const WgradLayer L = t.layer[li];
  const int tile = blockIdx.x - L.tile0;
  const int n0 = (tile / L.tiles_k) * kWT, k0 = (tile % L.tiles_k) * kWT;
  const int lo = blockIdx.y * kSplit, hi = min(B, lo + kSplit);
  const int tid = threadIdx.x, tn = tid / 16, tk = tid % 16;
  constexpr int kPer = kBM * kWT / kThreads;  // values of each a thread stages
  float cr[kPer], ar[kPer];
  auto load = [&](int m0) {  // raw values; the transform waits for the store
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads, m = i / kWT, c = i % kWT;
      const bool row = m0 + m < hi;
      const size_t rm = static_cast<size_t>(m0 + m);
      cr[j] = row && n0 + c < L.N ? L.dc[rm * L.ldc + n0 + c] : 0.f;
      ar[j] = row && k0 + c < L.K ? L.a[rm * L.lda + k0 + c] : 0.f;
    }
  };
  float acc[4][4] = {};
  float bacc = 0.f;
  load(lo);
  for (int m0 = lo; m0 < hi; m0 += kBM) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads, m = i / kWT, c = i % kWT;
      Cs[m][c] = cr[j];
      As[m][c] = transform<kBf16>(L.xform, act_kind, ar[j]);
    }
    __syncthreads();
    if (m0 + kBM < hi) load(m0 + kBM);
#pragma unroll 8
    for (int m = 0; m < kBM; ++m) {
      const float4 c = *reinterpret_cast<const float4*>(&Cs[m][tn * 4]);
      const float4 a = *reinterpret_cast<const float4*>(&As[m][tk * 4]);
      const float cv[4] = {c.x, c.y, c.z, c.w}, av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], av[j], acc[i][j]);
    }
    if (k0 == 0 && tid < kWT) {
      for (int m = 0; m < kBM; ++m) bacc += Cs[m][tid];
    }
    __syncthreads();
  }
  float* out = part + blockIdx.y * total;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + tn * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tk * 4 + j;
      if (n < L.N && k < L.K)
        out[L.w_off + static_cast<long long>(n) * L.K + k] = acc[i][j];
    }
  }
  if (k0 == 0 && tid < kWT && n0 + tid < L.N) out[L.b_off + n0 + tid] = bacc;
}

// Pass 3: grads[i] = sum over the splits of part[s][i], in split order.
__global__ void __launch_bounds__(kThreads)
made_reduce_kernel(const float* __restrict__ part, int splits, long long total,
                   float* __restrict__ grads) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * total + i];
  grads[i] = s;
}

bool valid(int B, int F, int H, int R, int P, int act) {
  return B >= 1 && F >= 1 && H >= 1 && H <= kMaxHidden && R >= 1 && P >= 1 &&
         act >= kRelu && act <= kLeakyRelu;
}

size_t chain_smem(int H) {
  return sizeof(float) * (kStageFloats + 2 * static_cast<size_t>(kTB) * H);
}

// Opts `kernel` in to the shared memory of the widest H, once per device
// and process (not a stream operation, so a later call may be captured in a
// CUDA graph).
constexpr int kMaxDevices = 64;

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(chain_smem(kMaxHidden)));
  done[device] = e == cudaSuccess;
  return e;
}

template <bool kBf16>
Made<kBf16> made_of(const float* x, const void* w0, const float* b0,
                    const void* w1s, const float* b1s, const void* w2s,
                    const float* b2s, const void* wf, const float* bf, int B,
                    int F, int H, int R, int P, int act) {
  using W = Weight<kBf16>;
  return Made<kBf16>{x, static_cast<const W*>(w0), b0,
                     static_cast<const W*>(w1s), b1s,
                     static_cast<const W*>(w2s), b2s,
                     static_cast<const W*>(wf), bf, B, F, H, R, P, act};
}

template <bool kBf16>
int forward(const Made<kBf16>& p, float* out, cudaStream_t s) {
  static bool allowed[kMaxDevices] = {};
  const cudaError_t e = allow_smem(made_fwd_kernel<kBf16>, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = chain_smem(p.H);
  made_fwd_kernel<kBf16><<<(p.B + kTB - 1) / kTB, kThreads, smem, s>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int backward(const Made<kBf16>& p, const float* g, float* dx, float* grads,
             float* scratch, float* part, cudaStream_t s) {
  const int B = p.B, F = p.F, H = p.H, R = p.R, P = p.P;
  static bool allowed[kMaxDevices] = {};
  cudaError_t e = allow_smem(made_bwd_tile_kernel<kBf16>, allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = chain_smem(H);
  made_bwd_tile_kernel<kBf16><<<(B + kTB - 1) / kTB, kThreads, smem, s>>>(
      p, g, dx, scratch);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  // the flat gradient: dW0, dW1s, dW2s, dWf, then db0, db1s, db2s, dbf
  const long long HH = static_cast<long long>(H) * H;
  const long long w1 = static_cast<long long>(H) * F, w2 = w1 + R * HH;
  const long long wfin = w2 + R * HH, wend = wfin + static_cast<long long>(P) * H;
  const long long total = wend + H + 2LL * R * H + P;
  const Scratch sc = carve(scratch, B, H, R);
  const size_t slab = static_cast<size_t>(B) * H;
  WgradLayer all[2 * 64 + 2];
  const int n_layers = 2 * R + 2;
  if (R > 64) return static_cast<int>(cudaErrorInvalidValue);
  all[0] = {sc.d0, p.x, H, F, kRound, H, F, 0, wend, 0, 0};
  for (int r = 0; r < R; ++r) {
    all[1 + 2 * r] = {sc.d1 + r * slab, sc.h + r * slab, H, H, kActRound, H, H,
                      w1 + r * HH, wend + H + static_cast<long long>(r) * H, 0, 0};
    all[2 + 2 * r] = {sc.d2 + r * slab, sc.z + r * slab, H, H, kActRound, H, H,
                      w2 + r * HH, wend + H + static_cast<long long>(R + r) * H, 0, 0};
  }
  all[n_layers - 1] = {g, sc.h + R * slab, P, H, kRound, P, H, wfin,
                       wend + H + 2LL * R * H, 0, 0};
  const int splits = (B + kSplit - 1) / kSplit;
  float* target = splits == 1 ? grads : part;
  for (int first = 0; first < n_layers; first += kMaxLayers) {
    WgradTable t;
    t.count = 0;
    int tiles = 0;
    for (int i = first; i < n_layers && t.count < kMaxLayers; ++i) {
      WgradLayer L = all[i];
      L.tiles_k = (L.K + kWT - 1) / kWT;
      L.tile0 = tiles;
      tiles += ((L.N + kWT - 1) / kWT) * L.tiles_k;
      t.layer[t.count++] = L;
    }
    made_wgrad_kernel<kBf16><<<dim3(tiles, splits), kThreads, 0, s>>>(
        t, B, p.act, total, target);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  if (splits > 1) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    made_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        part, splits, total, grads);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns the CUDA error code (0 on success).  All
// pointers are device pointers to contiguous row-major tensors: x (B, F),
// w0 (H, F), b0 (H,), w1s / w2s (R, H, H), b1s / b2s (R, H), wf (P, H),
// bf (P,), out (B, P); the weights bfloat16 when `bf16`, else float32.
// `act`: 0 relu, 1 tanh, 2 leaky_relu (slope 0.01).
extern "C" int made_fused_forward(const float* x, const void* w0,
                                  const float* b0, const void* w1s,
                                  const float* b1s, const void* w2s,
                                  const float* b2s, const void* wf,
                                  const float* bf, float* out, int B, int F,
                                  int H, int R, int P, int act, int bf16,
                                  void* stream) {
  if (!valid(B, F, H, R, P, act)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return forward(made_of<true>(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, B, F, H,
                                 R, P, act), out, s);
  return forward(made_of<false>(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, B, F, H,
                                R, P, act), out, s);
}

// The backward of made_fused_forward with the same arguments and the output
// cotangent g (B, P): writes dx (B, F) and the flat float32 gradient
// `grads` (dW0, dW1s, dW2s, dWf, db0, db1s, db2s, dbf, each row-major, the
// weights' in the (out, in) layout).  `scratch` holds (4R + 2) B H floats;
// `part` ceil(B / 512) times the length of `grads` (unused, and may alias
// `grads`, when B <= 512).  Same stream and return rules.
extern "C" int made_fused_backward(const float* x, const void* w0,
                                   const float* b0, const void* w1s,
                                   const float* b1s, const void* w2s,
                                   const float* b2s, const void* wf,
                                   const float* bf, const float* g, float* dx,
                                   float* grads, float* scratch, float* part,
                                   int B, int F, int H, int R, int P, int act,
                                   int bf16, void* stream) {
  if (!valid(B, F, H, R, P, act) || R > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return backward(made_of<true>(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, B, F,
                                  H, R, P, act), g, dx, grads, scratch, part, s);
  return backward(made_of<false>(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, B, F, H,
                                 R, P, act), g, dx, grads, scratch, part, s);
}
