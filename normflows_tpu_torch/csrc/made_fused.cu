// Fused residual MADE (context-free, masks pre-multiplied into the weights),
// forward and backward, for Hopper, sm_90a.
//
// The forward replaces the TPU kernel `_fwd_kernel`
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
// float32.  There is no TF32.
//
// The backward replaces `_bwd_kernel` (:117), launched by `_vjp_bwd` (:194,
// call :209).  JAX recomputes each batch tile's forward in the kernel, pulls
// it back, and carries the weight gradients across the sequential grid in
// revisited output blocks (`_acc` :98).  Blocks of a CUDA grid run at once
// and in no order, so the backward here is four launches of one C call:
//
//   1. `made_dh_kernel`: dh_R = g Wf, the final layer's input cotangent and
//      the backward's largest product, on a grid of 64 x 64 output tiles;
//   2. `made_bwd_tile_kernel`, one block per 16-row tile: the forward again,
//      then the pull-back from dh_R to dx; it writes each layer's
//      pre-activations and its output cotangent to a scratch buffer;
//   3. `made_wgrad_kernel`: for every layer, dW = dC^T a and db = sum dC over
//      one 512-row split of the batch, one 64 x 64 tile of dW a block, into
//      a float32 partial buffer (no atomics);
//   4. `made_reduce_kernel`: the sum of the partials in split order (skipped
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
// Every product runs on the tensor cores through a split (`split_gemm`
// below): a float32 operand is three bf16 terms that add back to it
// exactly, so with bf16 weights the products are JAX's float32 x bf16 ones
// up to the order of the sums; with float32 weights both operands split and
// 6 of the 9 partial products are taken, each left out below 2^-24 of the
// product.  So the fused float32 forward is not bit-equal to the unfused
// (cuBLAS, SIMT float32) pass; it lies as close to float64.
//
// Design of the forward: two launches of one C call.
//   1. `made_chain_kernel`, one block per tile of rows (16 with float32
//      weights; 32 with bf16 up to H = 512, half the weight reads): the
//      chain up to h_R, which is the backward tile pass's recompute
//      (`tile_chain`), h and z of the tile in shared memory.  It writes
//      h_R, rounded as the final layer's operand, to a workspace as bf16
//      term planes (three with float32 weights, one with bf16 weights), and
//      with float32 weights splits its share of Wf into three planes beside
//      them.
//   2. `made_final_kernel`: out = h_R Wf^T + bf, three quarters of the
//      forward's operations at the large-D shape, on a grid of output tiles
//      (64 x 64 with float32 weights, 128 x 128 with bf16) read from those
//      planes (`plane_gemm`): a tile reads only its rows of h_R and of Wf
//      (not all of Wf, as a row block would), through a cp.async ring, and
//      its warps read ready bf16 fragments with ldmatrix: the split was
//      done once a call, not as each warp reads a fragment.  With bf16
//      weights the products are bf16 x bf16, exact, and the tensor cores
//      keep the sums over K = H; with float32 weights each k16 step's six
//      partial products are promoted into a float32 running sum, as the
//      backward's.
//
// Design of the backward.  The largest product, dh_R = g Wf (a third of the
// backward's operations at the large-D shape), depends on nothing the tile
// pass computes, so it runs first as a grid of 64 x 64 tiles.  The tile pass
// owns 16 rows a block (B / 16 = 256 blocks, two an SM at H = 256).  The
// weight gradients are 64 x 64 tiles over 512-row splits.  Operands reach
// shared memory through a three-deep cp.async ring as they lie in device
// memory, and each warp splits its fragments as it reads them: loads of
// later chunks overlap the products of this one, and no thread waits on a
// load it issued.  Shared memory of the tile pass: 2 x 16 x H x 4 bytes and
// a ring of up to 77 KB (forward products, f32), within 227 KB up to
// H = 768 (the gate `fusable` refuses more).
//
// What bounds it on this card: at the large-D shape (B 4096, F 64, H 256,
// R 1, P 1600) the forward does 4.56 GFLOP and moves ~29.5 MB (f32): in
// float32 operations (68 us at 67 TFLOP/s), in bf16 bytes (8.5 us at
// 3.35 TB/s, the tensor cores' 989 TFLOP/s being 4.6 us); the split's
// partial products issue 27.4 GFLOP of tensor-core work in f32 (28 us at
// 989 TFLOP/s).  The final layer re-reads h_R's and Wf's planes from L2,
// once for each tile across and down (~310 MB in f32, ~50 MB in bf16).
// The backward does 10.3 GFLOP, and its partial products issue 24 (bf16)
// and 62 (f32) GFLOP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHidden = 768;  // 2 x 16 x 768 x 4 + the tile pass's ring <= 227 KB
constexpr int kSplit = 512;      // rows of one weight-gradient partial
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

template <bool kBf16>
__device__ __forceinline__ float transform(int xform, int a, float v) {
  if (xform == kActRound) v = act(a, v);
  return xform == kNone ? v : rnd<kBf16>(v);
}

template <bool kBf16>
using Weight = typename std::conditional<kBf16, __nv_bfloat16, float>::type;

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

// ---- split tensor-core products ------------------------------------------
//
// A float32 value c is the sum of three bfloat16 terms, exactly:
//   c0 = bf16(c), c1 = bf16(c - c0), c2 = c - c0 - c1
// (each subtraction is exact, and c2 needs at most 8 significant bits; this
// holds for |c| >= 2^-110, where no term falls below bf16's subnormals).  A
// product of a term and a bf16 value is exact in float32, and mma.sync
// m16n8k16 sums such products in float32.  So with bf16 weights the three
// products c0 w + c1 w + c2 w give JAX's float32 x bf16 product up to the
// order of the sums; where the cotangent is bf16 already (relu's dz1, the
// last block's dh = bf16(g Wf)) one term is all of it.  With float32
// weights both operands split, and the products of terms i, j with
// i + j < kOrder are taken: 6 of the 9, each left out below 2^-24 of the
// product.  The smallest products go first into each sum.  The tensor
// cores' own sums do not round to nearest (on an H100, with the running
// sum kept in the mma accumulator, the f32 route's dW0 at B = 4096 missed
// its 2e-4 bar by 8.3e-4 where the SIMT kernel passed it): each k16 step's
// partial products go to a fresh register and join the running sum in a
// float32 add.
constexpr int kOrder = 3;
constexpr int kMaxTerms = 3;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The `terms` bf16 terms of (x, y), each as a pair in one register (x in
// the low half, as an mma fragment wants the lower k).
__device__ __forceinline__ void split_pair(float x, float y, int terms,
                                           uint32_t (&u)[kMaxTerms]) {
  __nv_bfloat162 t = __floats2bfloat162_rn(x, y);
  u[0] = bits(t);
#pragma unroll
  for (int q = 1; q < kMaxTerms; ++q) {
    if (q >= terms) break;
    const float2 f = __bfloat1622float2(t);
    x -= f.x;
    y -= f.y;
    t = __floats2bfloat162_rn(x, y);
    u[q] = bits(t);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One operand of split_gemm: a ROWS x K matrix in device memory, element
// (r, k) at p[r * ld + k] (KFAST) or p[k * ld + r].
template <class T, bool KFAST>
struct Operand {
  const T* p;
  long long ld;
};

// Its tile of KC along k in shared memory, in the same layout: [ROWS][KC +
// 8] (k fastest: float2 fragment reads meet no bank conflict) or [KC][ROWS
// + pad] (rows fastest: 4 floats, 8 bf16 of padding, for the same).
template <class T, bool KFAST, int ROWS, int KC>
struct Tile {
  static constexpr int stride = KFAST ? KC + 8 : ROWS + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int elems = KFAST ? ROWS * stride : KC * stride;
  __device__ static int at(int r, int k) { return KFAST ? r * stride + k : k * stride + r; }
};

// Copies the tile at k0 (rows < rows_valid, k < K) into `dst`, zeros
// elsewhere: 16-byte cp.async where every row of the operand starts 16
// bytes apart, else element by element (an operand of a few columns).
template <class T, bool KFAST, int ROWS, int KC, int THREADS>
__device__ void stage_tile(Operand<T, KFAST> op, bool vec, int rows_valid, int k0, int K,
                           T* dst) {
  using TL = Tile<T, KFAST, ROWS, KC>;
  constexpr int V = 16 / sizeof(T);
  constexpr int kInner = KFAST ? KC : ROWS;  // the contiguous dimension
  if (vec) {
    for (int v = threadIdx.x; v < ROWS * KC / V; v += THREADS) {
      const int outer = v / (kInner / V), c = (v % (kInner / V)) * V;
      const int r = KFAST ? outer : c, k = KFAST ? c : outer;
      const int limit = KFAST ? (r < rows_valid ? K - k0 : 0) : (k0 + k < K ? rows_valid : 0);
      const int valid = max(0, min(V, limit - c));
      const T* src = valid ? op.p + (KFAST ? r * op.ld + k0 + k : (k0 + k) * op.ld + r)
                           : op.p;
      cp_async16(dst + TL::at(r, k), src, valid * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * KC; i += THREADS) {
      const int outer = i / kInner, c = i % kInner;
      const int r = KFAST ? outer : c, k = KFAST ? c : outer;
      dst[TL::at(r, k)] = r < rows_valid && k0 + k < K
                              ? op.p[KFAST ? r * op.ld + k0 + k : (k0 + k) * op.ld + r]
                              : T{};
    }
  }
}

template <class T, bool KFAST>
__device__ bool vector_ok(Operand<T, KFAST> op) {
  constexpr int V = 16 / sizeof(T);
  return op.ld % V == 0 && reinterpret_cast<uintptr_t>(op.p) % 16 == 0;
}

// Shared memory of split_gemm: STAGES tiles of each operand (A's none when
// it lies in shared memory already).
template <int MT, int NT, int KC, int STAGES, bool A_SMEM, bool A_KFAST, class TB_RAW,
          bool B_KFAST>
__host__ __device__ constexpr size_t split_smem() {
  return STAGES * ((A_SMEM ? 0 : sizeof(float) * Tile<float, A_KFAST, MT, KC>::elems) +
                   sizeof(TB_RAW) * Tile<TB_RAW, B_KFAST, NT, KC>::elems);
}

// C (M x N, M <= MT, N <= NT) = sum_k A(m, k) B(k, n) over k < K on one
// block of WM x WN warps, each warp an (MT / WM) x (NT / WN) tile of m16n8k16
// products.  A is float32, `to_a` gives its value (the activation and
// rounding of a forward product's operand, or the identity), and it splits
// into `ta` terms; B is a bf16 weight (one term, used as it lies) or
// float32, `to_b` giving its value from the raw one (the identity, or the
// activation and rounding of a weight gradient's operand) and `tb` its
// terms (1: bf16-valued already).  Both come through a ring of STAGES
// tiles of KC along k, copied with cp.async as they lie (A_SMEM: A is a
// float32 tile in shared memory already, k fastest, `a_smem_ld` apart), so
// that the copies of later chunks overlap the products of this one; the
// split happens as each warp reads its fragments.  `chunk(As, k0)` runs on
// each staged A tile (k0 its first k); `epi(m, n, c)` takes each result.
// Ends with a barrier.
template <int MT, int NT, int WM, int WN, int KC, int STAGES, bool A_SMEM, bool A_KFAST,
          bool B_KFAST, class TB_RAW, class ToA, class ToB, class Chunk, class Epi>
__device__ void split_gemm(int M, int N, int K, int ta, int tb, Operand<float, A_KFAST> a,
                           Operand<TB_RAW, B_KFAST> b, ToA to_a, ToB to_b, char* smem,
                           Chunk chunk, Epi epi) {
  using TA = Tile<float, A_KFAST, MT, KC>;
  using TBt = Tile<TB_RAW, B_KFAST, NT, KC>;
  constexpr int kThr = WM * WN * 32;
  constexpr int kWarpM = MT / WM, kWarpN = NT / WN;
  constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;
  static_assert(kMT >= 1 && kNT >= 1 && kWarpM % 16 == 0 && kWarpN % 8 == 0, "warps");
  static_assert(KC % 16 == 0 && STAGES >= 2, "chunks");
  static_assert(!A_SMEM || A_KFAST, "a tile in shared memory lies k fastest");
  float* As = reinterpret_cast<float*>(smem);
  TB_RAW* Bs = reinterpret_cast<TB_RAW*>(smem + (A_SMEM ? 0 : STAGES * sizeof(float) * TA::elems));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const bool a_vec = !A_SMEM && vector_ok(a), b_vec = vector_ok(b);
  const int chunks = (K + KC - 1) / KC;
  auto issue = [&](int c) {
    if (c < chunks) {
      const int s = c % STAGES;
      if constexpr (!A_SMEM)
        stage_tile<float, A_KFAST, MT, KC, kThr>(a, a_vec, M, c * KC, K, As + s * TA::elems);
      stage_tile<TB_RAW, B_KFAST, NT, KC, kThr>(b, b_vec, N, c * KC, K, Bs + s * TBt::elems);
    }
    cp_async_commit();
  };
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(c + STAGES - 1);
    const int k0 = c * KC;
    const float* at = A_SMEM ? a.p : As + (c % STAGES) * TA::elems;
    const TB_RAW* bt = Bs + (c % STAGES) * TBt::elems;
    chunk(at, k0);
    // A(r, k) of this chunk; in shared memory already, A starts at column k0
    auto a_at = [&](int r, int k) -> const float* {
      return A_SMEM ? at + r * a.ld + k0 + k : at + TA::at(r, k);
    };
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t af[kMT][4][kMaxTerms], bfr[kNT][2][kMaxTerms];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // (row, k): (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8)
          const int r = wm * kWarpM + mt * 16 + g + (q & 1) * 8, k = ks + 2 * t + (q >> 1) * 8;
          float x, y;
          if (A_KFAST) {
            const float2 v = *reinterpret_cast<const float2*>(a_at(r, k));
            x = v.x;
            y = v.y;
          } else {
            x = *a_at(r, k);
            y = *a_at(r, k + 1);
          }
          split_pair(to_a(x), to_a(y), ta, af[mt][q]);
        }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // (n, k): (g, 2t), (g, 2t + 8)
          const int n = wn * kWarpN + nt * 8 + g, k = ks + 2 * t + q * 8;
          TB_RAW x, y;
          if (B_KFAST) {  // the pair in one read
            using Pair = typename std::conditional<sizeof(TB_RAW) == 4, float2,
                                                   __nv_bfloat162>::type;
            const Pair v = *reinterpret_cast<const Pair*>(bt + TBt::at(n, k));
            x = v.x;
            y = v.y;
          } else {
            x = bt[TBt::at(n, k)];
            y = bt[TBt::at(n, k + 1)];
          }
          if constexpr (sizeof(TB_RAW) == 2) {  // a bf16 weight is its own one term
            bfr[nt][q][0] = bits(__nv_bfloat162{x, y});
          } else {
            split_pair(to_b(x), to_b(y), tb, bfr[nt][q]);
          }
        }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int s = kOrder - 1; s >= 0; --s)
#pragma unroll
            for (int i = 0; i <= s; ++i) {
              const int j = s - i;
              if (i < kMaxTerms && j < kMaxTerms && i < ta && j < tb) {
                const uint32_t fa[4] = {af[mt][0][i], af[mt][1][i], af[mt][2][i], af[mt][3][i]};
                mma_bf16(part, fa, bfr[nt][0][j], bfr[nt][1][j]);
              }
            }
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) acc[mt][nt][c4] += part[c4];
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = wm * kWarpM + mt * 16 + g + (c >= 2 ? 8 : 0);
        const int n = wn * kWarpN + nt * 8 + 2 * t + (c & 1);
        if (m < M && n < N) epi(m, n, acc[mt][nt][c]);
      }
  __syncthreads();
}

struct NoChunk {
  __device__ void operator()(const float*, int) const {}
};

struct Identity {
  __device__ float operator()(float v) const { return v; }
};

// The operand of a forward product: act (kActRound) and rounding, as
// `transform`.
template <bool kBf16>
struct Transform {
  int xform, act;
  __device__ float operator()(float v) const { return transform<kBf16>(xform, act, v); }
};

// The tile pass: a block of 256 threads owns ROWS batch rows (16 in the
// backward), h and z of those rows (two ROWS x H float32 tiles) in shared
// memory, and runs every product as split_gemm over 256 outputs a pass (8
// warps of 16 x 32 at 16 rows) at depth 16: the recompute's products (A the
// activation operand, from x or those tiles; W read in the (out, in)
// layout, k contiguous) and the pull-back's (A the cotangent; W read as it
// lies, n contiguous).  The backward's keeps to 128 registers a thread, so
// that two blocks share a multiprocessor at H = 256 (B / 16 = 256 blocks at
// the large-D shape).
template <bool kBf16, int ROWS_ = 16>
struct TilePass {
  static constexpr int ROWS = ROWS_, NT = 256, WM = ROWS / 16, WN = 8 / WM, KC = 16, STAGES = 3;
  static constexpr int terms = kBf16 ? 1 : kMaxTerms;  // of a weight, and of a forward operand
  static constexpr size_t from_x =
      split_smem<ROWS, NT, KC, STAGES, false, true, Weight<kBf16>, true>();
  static constexpr size_t pull =
      split_smem<ROWS, NT, KC, STAGES, true, true, Weight<kBf16>, false>();
  static constexpr size_t ring = from_x > pull ? from_x : pull;
};

// C (rows x N) = to_a(A) W over K, 256 outputs at a time: W(k, n) at
// W[n * K + k] (B_KFAST: a forward product) or W[k * N + n] (a pull-back).
template <bool kBf16, bool A_SMEM, bool B_KFAST, int ROWS = 16, class ToA, class Epi>
__device__ void tile_gemm(Operand<float, true> a, ToA to_a, int ta, int rows, int K,
                          const Weight<kBf16>* W, int N, char* ring, Epi epi) {
  using TP = TilePass<kBf16, ROWS>;
  for (int n0 = 0; n0 < N; n0 += TP::NT) {
    const Operand<Weight<kBf16>, B_KFAST> b{
        B_KFAST ? W + static_cast<size_t>(n0) * K : W + n0, B_KFAST ? K : N};
    split_gemm<TP::ROWS, TP::NT, TP::WM, TP::WN, TP::KC, TP::STAGES, A_SMEM, true, B_KFAST>(
        rows, min(TP::NT, N - n0), K, ta, TP::terms, a, b, to_a, Identity{}, ring, NoChunk{},
        [&](int m, int n, float c) { epi(m, n0 + n, c); });
  }
}

template <int ROWS>
size_t tile_smem(int H, bool bf16) {
  return (bf16 ? TilePass<true, ROWS>::ring : TilePass<false, ROWS>::ring) +
         sizeof(float) * 2 * ROWS * static_cast<size_t>(H);
}

// Rows of the forward chain's tiles: with bf16 weights 32 (half the weight
// reads of 16-row tiles) where two 32 x H tiles and the ring fit in shared
// memory, H <= 512; with float32 16 (at 32 rows its 210 registers a thread
// left one block an SM, and it ran slower: PERF.md).
template <bool kBf16>
constexpr int kChainRows = kBf16 ? 32 : 16;
constexpr int kChainRowsMaxHidden = 512;

// The shared memory a chain kernel of ROWS-row tiles opts in to: the
// widest H it is launched at.
template <int ROWS>
size_t chain_smem_max(bool bf16) {
  return tile_smem<ROWS>(ROWS == 16 ? kMaxHidden : kChainRowsMaxHidden, bf16);
}

// The chain of one tile of the tile pass (TilePass::ROWS rows from row0)
// up to h_R, left in Hs: the forward's first launch and the backward's
// recompute.  `save(tile, r, is_z)` runs after each of h[r] (r <= R) and
// z[r] is complete in shared memory.
template <bool kBf16, int ROWS = 16, class Save>
__device__ void tile_chain(const Made<kBf16>& p, int row0, int rows, char* ring, float* Hs,
                           float* Zs, Save save) {
  using TP = TilePass<kBf16, ROWS>;
  const int H = p.H, F = p.F;
  const Transform<kBf16> round_x{kRound, p.act}, act_round{kActRound, p.act};
  const Operand<float, true> x{p.x + static_cast<size_t>(row0) * F, F};
  tile_gemm<kBf16, false, true, ROWS>(x, round_x, TP::terms, rows, F, p.w0, H, ring,
                                      [&](int m, int n, float c) { Hs[m * H + n] = c + p.b0[n]; });
  save(Hs, 0, false);
  for (int r = 0; r < p.R; ++r) {
    const size_t wr = static_cast<size_t>(r) * H * H;
    const float* b1 = p.b1s + r * H;
    const float* b2 = p.b2s + r * H;
    tile_gemm<kBf16, true, true, ROWS>(Operand<float, true>{Hs, H}, act_round, TP::terms, rows,
                                       H, p.w1s + wr, H, ring,
                                       [&](int m, int n, float c) { Zs[m * H + n] = c + b1[n]; });
    save(Zs, r, true);
    tile_gemm<kBf16, true, true, ROWS>(Operand<float, true>{Zs, H}, act_round, TP::terms, rows,
                                       H, p.w2s + wr, H, ring, [&](int m, int n, float c) {
                                         Hs[m * H + n] = Hs[m * H + n] + (c + b2[n]);
                                       });
    save(Hs, r + 1, false);
  }
}

// ---- the forward: the chain, then the final layer from bf16 term planes ----

// `terms` bf16 planes of a matrix, element (r, k) of plane t at
// p[t * plane + r * ld + k].  The forward's workspace holds h_R's planes
// ((B, H), plane = B H rounded up to 8) and, with float32 weights, Wf's
// three ((P, H), plane = P H rounded up to 8) after them
// (ops/made_fused.py `forward_workspace` computes the same size).
struct Planes {
  const __nv_bfloat16* p;
  long long ld, plane;
};

__host__ __device__ inline long long plane_of(long long elems) { return (elems + 7) / 8 * 8; }

// The bf16 terms of c that add back to it (as split_pair): c0 = bf16(c),
// c1 = bf16(c - c0), c2 = bf16(c - c0 - c1), written to dst[t * plane].
template <int TERMS>
__device__ __forceinline__ void split_store(float c, __nv_bfloat16* dst, long long plane) {
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
    const __nv_bfloat16 b = __float2bfloat16_rn(c);
    dst[t * plane] = b;
    c -= __bfloat162float(b);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* at) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(at));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The final layer's tiles: MT x NT outputs a block of WM x WN warps, chunks
// of KC along k through a ring of STAGES, TERMS bf16 planes of each
// operand.  kPromote: each k16 step's partial products go to a fresh
// register and join the float32 running sum in a float32 add (the split's
// rule, above); without it (one term each: exact bf16 x bf16 products over
// K <= 768) the tensor cores keep the sum.
template <int TERMS, int MT_, int NT_, int WM_, int WN_, int STAGES_>
struct PlaneTile {
  static constexpr int TA = TERMS, TB = TERMS;
  static constexpr int MT = MT_, NT = NT_, WM = WM_, WN = WN_, KC = 32, STAGES = STAGES_;
  static constexpr bool kPromote = TERMS > 1;
  static constexpr int kThreads = WM * WN * 32;
  using TAt = Tile<__nv_bfloat16, true, MT, KC>;
  using TBt = Tile<__nv_bfloat16, true, NT, KC>;
  static constexpr int stage_elems = TA * TAt::elems + TB * TBt::elems;
  static constexpr size_t smem = sizeof(__nv_bfloat16) * STAGES * stage_elems;
};

// f32: 64 x 64 tiles of 4 warps, 2 stages (61 KB); bf16: 128 x 128 tiles
// of 8 warps, 3 stages (61 KB): the fastest of the shapes measured
// (PERF.md)
template <bool kBf16>
using FinalTile = typename std::conditional<kBf16, PlaneTile<1, 128, 128, 2, 4, 3>,
                                            PlaneTile<kMaxTerms, 64, 64, 2, 2, 2>>::type;

// A thread's share of one chunk's copy: its 16-byte vectors of a ROWS x KC
// tile, the same rows and columns every chunk, each term's plane copied to
// `dst` + term * stride (zeros past rows_valid and K).
template <int ROWS, int KC, int THREADS, int TERMS>
__device__ __forceinline__ void copy_planes(const Planes& op, int rows_valid, int k0, int K,
                                            __nv_bfloat16* dst, int stride) {
  using TL = Tile<__nv_bfloat16, true, ROWS, KC>;
  constexpr int kRowVecs = KC / 8, kVecs = ROWS * kRowVecs / THREADS;
  static_assert(kVecs * THREADS == ROWS * kRowVecs, "whole vectors a thread");
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = threadIdx.x + i * THREADS, r = v / kRowVecs, col = v % kRowVecs * 8;
    const int bytes = r < rows_valid ? max(0, min(16, 2 * (K - k0 - col))) : 0;
    const __nv_bfloat16* src = op.p + (bytes ? r * op.ld + k0 + col : 0);
#pragma unroll
    for (int q = 0; q < TERMS; ++q)
      cp_async16(dst + q * stride + TL::at(r, col), src + (bytes ? q * op.plane : 0), bytes);
  }
}

// C (M x N, M <= MT, N <= NT) = sum_k A(m, k) B(n, k) over k < K on one
// block of FT's shape, A and B given as FT::TA and FT::TB bf16 term planes,
// k fastest.  Each k16 step takes the products of terms i, j with
// i + j < kOrder, smallest first (as split_gemm).  `epi(m, n, c0, c1)`
// takes the results (m, n) and (m, n + 1) (n even; the caller masks n + 1
// against N).  Ends with a barrier.
template <class FT, class Epi>
__device__ void plane_gemm(int M, int N, int K, Planes a, Planes b, char* smem, Epi epi) {
  constexpr int TA = FT::TA, TB = FT::TB, KC = FT::KC;
  constexpr int kWarpM = FT::MT / FT::WM, kWarpN = FT::NT / FT::WN;
  constexpr int kMT = kWarpM / 16, kNT = kWarpN / 8;
  static_assert(kWarpM % 16 == 0 && kWarpN % 16 == 0 && KC % 16 == 0, "tiles");
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / FT::WN, wn = warp % FT::WN;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = a.plane % 8 == 0 && b.plane % 8 == 0 &&
                   vector_ok(Operand<__nv_bfloat16, true>{a.p, a.ld}) &&
                   vector_ok(Operand<__nv_bfloat16, true>{b.p, b.ld});
  const int chunks = (K + KC - 1) / KC;
  auto a_tile = [&](int s, int q) { return ring + s * FT::stage_elems + q * FT::TAt::elems; };
  auto b_tile = [&](int s, int q) {
    return ring + s * FT::stage_elems + TA * FT::TAt::elems + q * FT::TBt::elems;
  };
  auto issue = [&](int c) {
    if (c < chunks) {
      const int s = c % FT::STAGES, k0 = c * KC;
      if (vec) {
        copy_planes<FT::MT, KC, FT::kThreads, TA>(a, M, k0, K, a_tile(s, 0), FT::TAt::elems);
        copy_planes<FT::NT, KC, FT::kThreads, TB>(b, N, k0, K, b_tile(s, 0), FT::TBt::elems);
      } else {
#pragma unroll
        for (int q = 0; q < TA; ++q)
          stage_tile<__nv_bfloat16, true, FT::MT, KC, FT::kThreads>(
              Operand<__nv_bfloat16, true>{a.p + q * a.plane, a.ld}, false, M, k0, K,
              a_tile(s, q));
#pragma unroll
        for (int q = 0; q < TB; ++q)
          stage_tile<__nv_bfloat16, true, FT::NT, KC, FT::kThreads>(
              Operand<__nv_bfloat16, true>{b.p + q * b.plane, b.ld}, false, N, k0, K,
              b_tile(s, q));
      }
    }
    cp_async_commit();
  };
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
#pragma unroll
  for (int s = 0; s < FT::STAGES - 1; ++s) issue(s);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<FT::STAGES - 2>();
    __syncthreads();
    issue(c + FT::STAGES - 1);
    const int s = c % FT::STAGES;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      // A: matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
      // of each 16 x 16 fragment, lane l giving row l % 16 at k (l / 16) 8;
      // B: (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) of two
      // 8-wide fragments, lane l giving n l % 8 + (l / 16) 8 at k (l / 8 % 2) 8
      uint32_t af[TA][kMT][4], bfr[TB][kNT][2];
#pragma unroll
      for (int q = 0; q < TA; ++q)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          ldmatrix_x4(af[q][mt], a_tile(s, q) + FT::TAt::at(wm * kWarpM + mt * 16 + (lane & 15),
                                                            ks + (lane >> 4) * 8));
#pragma unroll
      for (int q = 0; q < TB; ++q)
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, b_tile(s, q) + FT::TBt::at(wn * kWarpN + np * 16 + (lane & 7) +
                                                        (lane >> 4) * 8,
                                                    ks + ((lane >> 3) & 1) * 8));
          bfr[q][2 * np][0] = r[0];
          bfr[q][2 * np][1] = r[1];
          bfr[q][2 * np + 1][0] = r[2];
          bfr[q][2 * np + 1][1] = r[3];
        }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if constexpr (FT::kPromote) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int o = kOrder - 1; o >= 0; --o)
#pragma unroll
              for (int i = 0; i <= o; ++i) {
                const int j = o - i;
                if (i < TA && j < TB) mma_bf16(part, af[i][mt], bfr[j][nt][0], bfr[j][nt][1]);
              }
#pragma unroll
            for (int c4 = 0; c4 < 4; ++c4) acc[mt][nt][c4] += part[c4];
          } else {
            mma_bf16(acc[mt][nt], af[0][mt], bfr[0][nt][0], bfr[0][nt][1]);
          }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm * kWarpM + mt * 16 + g + h * 8;
        const int n = wn * kWarpN + nt * 8 + 2 * t;
        if (m < M && n < N) epi(m, n, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  __syncthreads();
}

// Launch 1, one block per tile of ROWS rows: h_R of the tile through
// `tile_chain`, written as its `terms` bf16 planes (the final layer's
// operand: rounded to bf16 with bf16 weights); with float32 weights each
// block also splits its share of Wf into `wf_planes`.
template <bool kBf16, int ROWS>
__global__ void __launch_bounds__(kThreads, ROWS == 16 ? 2 : 1)
made_chain_kernel(Made<kBf16> p, __nv_bfloat16* __restrict__ h_planes, long long h_plane,
                  __nv_bfloat16* __restrict__ wf_planes, long long wf_plane) {
  using TP = TilePass<kBf16, ROWS>;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  const int H = p.H;
  float* Hs = reinterpret_cast<float*>(ring + TP::ring);
  float* Zs = Hs + TP::ROWS * H;
  const int row0 = blockIdx.x * TP::ROWS;
  const int rows = min(TP::ROWS, p.B - row0);
  if constexpr (!kBf16) {
    const long long total = static_cast<long long>(p.P) * H;
    const long long share = (total + gridDim.x - 1) / gridDim.x;
    const long long end = min(total, (blockIdx.x + 1) * share);
    for (long long i = blockIdx.x * share + threadIdx.x; i < end; i += kThreads)
      split_store<kMaxTerms>(p.wf[i], wf_planes + i, wf_plane);
  }
  tile_chain<kBf16, ROWS>(p, row0, rows, ring, Hs, Zs, [](const float*, int, bool) {});
  __nv_bfloat16* dst = h_planes + static_cast<size_t>(row0) * H;
  for (int i = threadIdx.x; i < rows * H; i += kThreads)
    split_store<kBf16 ? 1 : kMaxTerms>(rnd<kBf16>(Hs[i]), dst + i, h_plane);
}

// Launch 2: out = h_R Wf^T + bf on a grid of FinalTile output tiles
// (blockIdx.x along P, blockIdx.y along B), from the planes of h_R and of
// Wf (bf16 weights: Wf itself, one plane).
template <bool kBf16>
__global__ void __launch_bounds__(FinalTile<kBf16>::kThreads)
made_final_kernel(Planes h, Planes wf, const float* __restrict__ bf, float* __restrict__ out,
                  int B, int P, int H) {
  using FT = FinalTile<kBf16>;
  extern __shared__ float4 smem4[];
  const int n0 = blockIdx.x * FT::NT, m0 = blockIdx.y * FT::MT;
  const bool pairs = P % 2 == 0;  // (m, n), (m, n + 1) as one 8-byte store
  plane_gemm<FT>(min(FT::MT, B - m0), min(FT::NT, P - n0), H,
                     Planes{h.p + static_cast<size_t>(m0) * h.ld, h.ld, h.plane},
                     Planes{wf.p + static_cast<size_t>(n0) * wf.ld, wf.ld, wf.plane},
                     reinterpret_cast<char*>(smem4), [&](int m, int n, float c0, float c1) {
                       const int col = n0 + n;
                       float* o = out + static_cast<size_t>(m0 + m) * P + col;
                       if (pairs) {
                         *reinterpret_cast<float2*>(o) = make_float2(c0 + bf[col],
                                                                     c1 + bf[col + 1]);
                       } else {
                         o[0] = c0 + bf[col];
                         if (col + 1 < P) o[1] = c1 + bf[col + 1];
                       }
                     });
}


constexpr int kGT = 64;         // output tile of the grid-wide products: 64 x 64
constexpr int kGThreads = 128;  // 2 x 2 warps of 32 x 32
constexpr int kGK = 32;         // their depth of a staged chunk
constexpr int kGStages = 3;

template <bool kBf16>
constexpr size_t dh_smem() {
  return split_smem<kGT, kGT, kGK, kGStages, false, true, Weight<kBf16>, false>();
}

constexpr size_t wgrad_smem() {
  return split_smem<kGT, kGT, kGK, kGStages, false, false, float, false>();
}

// Pass 1: dh_R = bf16(g Wf) (B x H, over P), the final layer's input
// cotangent, the largest product of the pull-back, on a grid of 64 x 64
// tiles; it goes to the scratch's d2[R - 1], where the tile pass reads it.
template <bool kBf16>
__global__ void __launch_bounds__(kGThreads)
made_dh_kernel(Made<kBf16> p, const float* __restrict__ g, float* __restrict__ dh) {
  extern __shared__ float4 smem4[];
  const int H = p.H, P = p.P;
  const int n0 = blockIdx.x * kGT, m0 = blockIdx.y * kGT;
  split_gemm<kGT, kGT, 2, 2, kGK, kGStages, false, true, false>(
      min(kGT, p.B - m0), min(kGT, H - n0), P, kMaxTerms, kBf16 ? 1 : kMaxTerms,
      Operand<float, true>{g + static_cast<size_t>(m0) * P, P},
      Operand<Weight<kBf16>, false>{p.wf + n0, H}, Identity{}, Identity{},
      reinterpret_cast<char*>(smem4),
      NoChunk{}, [&](int m, int n, float c) {
        dh[static_cast<size_t>(m0 + m) * H + n0 + n] = rnd<kBf16>(c);
      });
}

// Pass 2, one block per 16-row tile: the forward again, then the pull-back
// from dh_R to dx through the R blocks; it writes each layer's
// pre-activations and output cotangent to the scratch.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
made_bwd_tile_kernel(Made<kBf16> p, float* __restrict__ dx, float* scratch) {
  using TP = TilePass<kBf16>;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  const int H = p.H, F = p.F, R = p.R;
  float* Hs = reinterpret_cast<float*>(ring + TP::ring);
  float* Zs = Hs + TP::ROWS * H;
  const int row0 = blockIdx.x * TP::ROWS;
  const int rows = min(TP::ROWS, p.B - row0);
  const Scratch s = carve(scratch, p.B, H, R);
  const size_t slab = static_cast<size_t>(p.B) * H;
  const size_t at = static_cast<size_t>(row0) * H;
  // the recompute
  tile_chain<kBf16>(p, row0, rows, ring, Hs, Zs, [&](const float* tile, int r, bool is_z) {
    save_tile(tile, (is_z ? s.z : s.h) + r * slab + at, rows * H);
  });
  // the pull-back from dh_R (made_dh_kernel), which replaces h_R in Hs
  __syncthreads();  // the last save_tile has read Hs
  const float* dh_r = s.d2 + (R - 1) * slab + at;
  for (int i = threadIdx.x; i < rows * H; i += kThreads) Hs[i] = dh_r[i];
  __syncthreads();
  // bf16: dh_R is bf16 (one term), and so is dz1 under relu (a bf16 value
  // times 0 or 1); the rest are general float32 values
  const int ta_dz1 = kBf16 && p.act == kRelu ? 1 : kMaxTerms;
  for (int r = R - 1; r >= 0; --r) {
    const size_t wr = static_cast<size_t>(r) * H * H;
    const float* z = s.z + r * slab + at;
    const float* h = s.h + r * slab + at;
    if (r < R - 1) save_tile(Hs, s.d2 + r * slab + at, rows * H);  // dz2 = dh
    tile_gemm<kBf16, true, false>(Operand<float, true>{Hs, H}, Identity{},
                                  kBf16 && r == R - 1 ? 1 : kMaxTerms, rows, H, p.w2s + wr, H,
                                  ring, [&](int m, int n, float c) {
                                    Zs[m * H + n] =
                                        rnd<kBf16>(c) * act_grad(p.act, z[m * H + n]);
                                  });
    save_tile(Zs, s.d1 + r * slab + at, rows * H);  // dz1
    tile_gemm<kBf16, true, false>(Operand<float, true>{Zs, H}, Identity{}, ta_dz1, rows, H,
                                  p.w1s + wr, H, ring, [&](int m, int n, float c) {
                                    Hs[m * H + n] += rnd<kBf16>(c) *
                                                     act_grad(p.act, h[m * H + n]);
                                  });
  }
  save_tile(Hs, s.d0 + at, rows * H);  // dh0
  float* d = dx + static_cast<size_t>(row0) * F;
  tile_gemm<kBf16, true, false>(Operand<float, true>{Hs, H}, Identity{}, kMaxTerms, rows, H,
                                p.w0, F, ring, [&](int m, int n, float c) {
                                  d[static_cast<size_t>(m) * F + n] = rnd<kBf16>(c);
                                });
}

// One layer of pass 3: dW (N, K) += dC^T t(A) and db (N,) += sum dC, with
// dC in `ta` terms (1: bf16 already).
struct WgradLayer {
  const float* dc;
  const float* a;
  int ldc, lda, xform, N, K, ta;
  long long w_off, b_off;  // into the flat gradient
  int tiles_k, tile0;      // dW tiles along K; the layer's first tile
};

struct WgradTable {
  WgradLayer layer[kMaxLayers];
  int count;
};

// Block (tile, split): one 64 x 64 tile of one layer's dW over the rows of
// one split (the products' depth), written to part[split]; the tiles at
// k = 0 also write the split's db, summed in row order from the staged dC.
template <bool kBf16>
__global__ void __launch_bounds__(kGThreads)
made_wgrad_kernel(WgradTable t, int B, int act_kind, long long total,
                  float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  using TC = Tile<float, false, kGT, kGK>;
  int li = 0;
  while (li + 1 < t.count && static_cast<int>(blockIdx.x) >= t.layer[li + 1].tile0) ++li;
  const WgradLayer L = t.layer[li];
  const int tile = blockIdx.x - L.tile0;
  const int n0 = (tile / L.tiles_k) * kGT, k0 = (tile % L.tiles_k) * kGT;
  const int lo = blockIdx.y * kSplit, hi = min(B, lo + kSplit);
  const int tid = threadIdx.x;
  float bacc = 0.f;
  float* out = part + blockIdx.y * total;
  split_gemm<kGT, kGT, 2, 2, kGK, kGStages, false, false, false>(
      min(kGT, L.N - n0), min(kGT, L.K - k0), hi - lo, L.ta, kBf16 ? 1 : kMaxTerms,
      Operand<float, false>{L.dc + static_cast<size_t>(lo) * L.ldc + n0, L.ldc},
      Operand<float, false>{L.a + static_cast<size_t>(lo) * L.lda + k0, L.lda},
      Identity{}, Transform<kBf16>{L.xform, act_kind},
      reinterpret_cast<char*>(smem4),
      [&](const float* Cs, int) {
        if (k0 != 0 || tid >= kGT) return;
        for (int m = 0; m < kGK; ++m) bacc += Cs[TC::at(tid, m)];
      },
      [&](int n, int k, float c) {
        out[L.w_off + static_cast<long long>(n0 + n) * L.K + k0 + k] = c;
      });
  if (k0 == 0 && tid < kGT && n0 + tid < L.N) out[L.b_off + n0 + tid] = bacc;
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

// H a multiple of the tile pass's chunk (16): its products read the hidden
// tiles in shared memory in whole chunks along H
bool valid(int B, int F, int H, int R, int P, int act) {
  return B >= 1 && F >= 1 && H >= 1 && H <= kMaxHidden && H % 16 == 0 && R >= 1 && P >= 1 &&
         act >= kRelu && act <= kLeakyRelu;
}

// Opts `kernel` in to `bytes` of dynamic shared memory (the widest H's),
// once per device and process (not a stream operation, so a later call may
// be captured in a CUDA graph).
constexpr int kMaxDevices = 64;

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
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
int forward(const Made<kBf16>& p, float* out, __nv_bfloat16* work, cudaStream_t s) {
  constexpr int terms = kBf16 ? 1 : kMaxTerms;
  using FT = FinalTile<kBf16>;
  constexpr int kTall = kChainRows<kBf16>;
  static bool allowed[3][kMaxDevices] = {};
  cudaError_t e = allow_smem(made_chain_kernel<kBf16, 16>, chain_smem_max<16>(kBf16), allowed[0]);
  if (e == cudaSuccess && kTall != 16)
    e = allow_smem(made_chain_kernel<kBf16, kTall>, chain_smem_max<kTall>(kBf16), allowed[1]);
  if (e == cudaSuccess) e = allow_smem(made_final_kernel<kBf16>, FT::smem, allowed[2]);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long h_plane = plane_of(static_cast<long long>(p.B) * p.H);
  const long long wf_plane = plane_of(static_cast<long long>(p.P) * p.H);
  __nv_bfloat16* wf_planes = work + terms * h_plane;  // float32 weights only
  if (p.H <= kChainRowsMaxHidden) {
    made_chain_kernel<kBf16, kTall><<<(p.B + kTall - 1) / kTall, kThreads,
                                      tile_smem<kTall>(p.H, kBf16), s>>>(
        p, work, h_plane, wf_planes, wf_plane);
  } else {
    made_chain_kernel<kBf16, 16><<<(p.B + 15) / 16, kThreads, tile_smem<16>(p.H, kBf16), s>>>(
        p, work, h_plane, wf_planes, wf_plane);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  Planes wf{wf_planes, p.H, wf_plane};
  if constexpr (kBf16) wf = Planes{p.wf, p.H, 0};  // the weights as they lie
  const dim3 grid((p.P + FT::NT - 1) / FT::NT, (p.B + FT::MT - 1) / FT::MT);
  made_final_kernel<kBf16><<<grid, FT::kThreads, FT::smem, s>>>(
      Planes{work, p.H, h_plane}, wf, p.bf, out, p.B, p.P, p.H);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int backward(const Made<kBf16>& p, const float* g, float* dx, float* grads,
             float* scratch, float* part, cudaStream_t s) {
  const int B = p.B, F = p.F, H = p.H, R = p.R, P = p.P;
  const Scratch sc = carve(scratch, B, H, R);
  const size_t slab = static_cast<size_t>(B) * H;
  static bool allowed[3][kMaxDevices] = {};
  cudaError_t e = allow_smem(made_bwd_tile_kernel<kBf16>, tile_smem<16>(kMaxHidden, kBf16),
                             allowed[0]);
  if (e == cudaSuccess) e = allow_smem(made_dh_kernel<kBf16>, dh_smem<kBf16>(), allowed[1]);
  if (e == cudaSuccess) e = allow_smem(made_wgrad_kernel<kBf16>, wgrad_smem(), allowed[2]);
  if (e != cudaSuccess) return static_cast<int>(e);
  made_dh_kernel<kBf16><<<dim3((H + kGT - 1) / kGT, (B + kGT - 1) / kGT), kGThreads,
                          dh_smem<kBf16>(), s>>>(p, g, sc.d2 + (R - 1) * slab);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  constexpr int kRows = TilePass<kBf16>::ROWS;
  made_bwd_tile_kernel<kBf16><<<(B + kRows - 1) / kRows, kThreads, tile_smem<16>(H, kBf16), s>>>(
      p, dx, scratch);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  // the flat gradient: dW0, dW1s, dW2s, dWf, then db0, db1s, db2s, dbf
  const long long HH = static_cast<long long>(H) * H;
  const long long w1 = static_cast<long long>(H) * F, w2 = w1 + R * HH;
  const long long wfin = w2 + R * HH, wend = wfin + static_cast<long long>(P) * H;
  const long long total = wend + H + 2LL * R * H + P;
  WgradLayer all[2 * 64 + 2];
  const int n_layers = 2 * R + 2;
  if (R > 64) return static_cast<int>(cudaErrorInvalidValue);
  // the terms of each cotangent: bf16-valued ones (see the tile pass) take one
  const int t_dz1 = kBf16 && p.act == kRelu ? 1 : kMaxTerms;
  all[0] = {sc.d0, p.x, H, F, kRound, H, F, kMaxTerms, 0, wend, 0, 0};
  for (int r = 0; r < R; ++r) {
    all[1 + 2 * r] = {sc.d1 + r * slab, sc.h + r * slab, H, H, kActRound, H, H, t_dz1,
                      w1 + r * HH, wend + H + static_cast<long long>(r) * H, 0, 0};
    all[2 + 2 * r] = {sc.d2 + r * slab, sc.z + r * slab, H, H, kActRound, H, H,
                      kBf16 && r == R - 1 ? 1 : kMaxTerms, w2 + r * HH,
                      wend + H + static_cast<long long>(R + r) * H, 0, 0};
  }
  all[n_layers - 1] = {g, sc.h + R * slab, P, H, kRound, P, H, kMaxTerms, wfin,
                       wend + H + 2LL * R * H, 0, 0};
  const int splits = (B + kSplit - 1) / kSplit;
  float* target = splits == 1 ? grads : part;
  for (int first = 0; first < n_layers; first += kMaxLayers) {
    WgradTable t;
    t.count = 0;
    int tiles = 0;
    for (int i = first; i < n_layers && t.count < kMaxLayers; ++i) {
      WgradLayer L = all[i];
      L.tiles_k = (L.K + kGT - 1) / kGT;
      L.tile0 = tiles;
      tiles += ((L.N + kGT - 1) / kGT) * L.tiles_k;
      t.layer[t.count++] = L;
    }
    made_wgrad_kernel<kBf16><<<dim3(tiles, splits), kGThreads, wgrad_smem(), s>>>(
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
// `work` is a bfloat16 workspace of T ceil8(B H) elements, and with float32
// weights 3 ceil8(P H) more, T being 1 with bf16 weights and 3 without
// (ceil8: rounded up to a multiple of 8).  `act`: 0 relu, 1 tanh,
// 2 leaky_relu (slope 0.01).
extern "C" int made_fused_forward(const float* x, const void* w0,
                                  const float* b0, const void* w1s,
                                  const float* b1s, const void* w2s,
                                  const float* b2s, const void* wf,
                                  const float* bf, float* out, void* work, int B,
                                  int F, int H, int R, int P, int act, int bf16,
                                  void* stream) {
  if (!valid(B, F, H, R, P, act)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* w = static_cast<__nv_bfloat16*>(work);
  if (bf16)
    return forward(made_of<true>(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, B, F, H,
                                 R, P, act), out, w, s);
  return forward(made_of<false>(x, w0, b0, w1s, b1s, w2s, b2s, wf, bf, B, F, H,
                                R, P, act), out, w, s);
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

// The backward kernels' theoretical occupancy at hidden width H: blocks a
// multiprocessor holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of
// the dh, tile and weight-gradient kernels, written to blocks[0..2].
extern "C" int made_fused_backward_occupancy(int H, int bf16, int* blocks) {
  if (H < 1 || H > kMaxHidden) return static_cast<int>(cudaErrorInvalidValue);
  auto query = [&](auto dh, auto tile, auto wgrad, bool b16) {
    static bool allowed[2][3][kMaxDevices] = {};
    const size_t dh_bytes = b16 ? dh_smem<true>() : dh_smem<false>();
    cudaError_t e = allow_smem(tile, tile_smem<16>(kMaxHidden, b16), allowed[b16][0]);
    if (e == cudaSuccess) e = allow_smem(dh, dh_bytes, allowed[b16][1]);
    if (e == cudaSuccess) e = allow_smem(wgrad, wgrad_smem(), allowed[b16][2]);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dh, kGThreads, dh_bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 1, tile, kThreads,
                                                        tile_smem<16>(H, b16));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 2, wgrad, kGThreads,
                                                        wgrad_smem());
    return static_cast<int>(e);
  };
  if (bf16)
    return query(made_dh_kernel<true>, made_bwd_tile_kernel<true>, made_wgrad_kernel<true>, true);
  return query(made_dh_kernel<false>, made_bwd_tile_kernel<false>, made_wgrad_kernel<false>,
               false);
}

// The forward kernels' theoretical occupancy at hidden width H: blocks a
// multiprocessor holds of the chain kernel (of the tile height it takes at
// H) and of the final-layer kernel, written to blocks[0..1].
extern "C" int made_fused_forward_occupancy(int H, int bf16, int* blocks) {
  if (H < 1 || H > kMaxHidden) return static_cast<int>(cudaErrorInvalidValue);
  // the attributes are set to the widest H's bytes, as the launches set them
  auto query = [&](auto chain, auto final_kernel, bool b16, size_t chain_max, size_t chain_smem,
                   size_t final_smem, int final_threads) {
    static bool allowed[2][2][kMaxDevices] = {};
    cudaError_t e = allow_smem(chain, chain_max, allowed[b16][0]);
    if (e == cudaSuccess) e = allow_smem(final_kernel, final_smem, allowed[b16][1]);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, chain, kThreads, chain_smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 1, final_kernel,
                                                        final_threads, final_smem);
    return static_cast<int>(e);
  };
  auto run = [&](auto b16) {
    constexpr bool kB = decltype(b16)::value;
    constexpr int kTall = kChainRows<kB>;
    using FT = FinalTile<kB>;
    if (H <= kChainRowsMaxHidden)
      return query(made_chain_kernel<kB, kTall>, made_final_kernel<kB>, kB,
                   chain_smem_max<kTall>(kB), tile_smem<kTall>(H, kB), FT::smem, FT::kThreads);
    return query(made_chain_kernel<kB, 16>, made_final_kernel<kB>, kB, chain_smem_max<16>(kB),
                 tile_smem<16>(H, kB), FT::smem, FT::kThreads);
  };
  return bf16 ? run(std::true_type{}) : run(std::false_type{});
}
