// Device functions shared by the planar (rqs_transposed.cu) and the flat
// (rqs_flat.cu) rational-quadratic spline kernels, so that the two cannot
// drift apart: one element's tail handling, softmax statistics and bin
// search, its rational-quadratic map and log|det| (`spline_element`), and
// its backward.  Two forms of the search and the backward compute the same
// function: `select_bin` and `spline_element_backward` loop over a runtime
// K and read the parameters from memory on each walk; `select_bin_regs` and
// `spline_element_backward_regs` take a compile-time bin count and share an
// element's parameters, loaded once into registers (`ParamRegs`).  The
// kernels differ only in where an element's input, parameters, tail code
// and bound lie, and in the threads a block (`block_threads`).
//
// An element's parameters lie on 3K+1 rows `stride` floats apart: widths
// uw[k * stride] (k < K), heights uh[k * stride], derivative logits
// ud[k * stride] (k <= K).  The JAX package's counterparts are `_selection`,
// `_post_math` and `_bwd_scatter` (normflows_tpu/ops/spline_pallas.py:89,
// :50, :198).
//
// Numerics, kept on purpose (tests hold the plain version to JAX, the chip
// check holds these kernels to the plain version):
// * the circular wrap is jnp.mod, which takes the divisor's sign: fmodf
//   truncates toward zero and is exact, so a negative remainder gets `span`
//   added back, which is how jnp.mod itself computes it (the same as
//   x - span * floor((x - left) / span) without the rounding of the
//   division);
// * the 1e-38 guard of the inverse root is a float32 subnormal, so no file
//   that includes this header may be built with --use_fast_math or
//   -ftz=true (0/0 would give NaN); it uses expf/logf/log1pf/sqrtf, not the
//   __ intrinsics;
// * softplus is max(x,0) + log1p(exp(-|x|)), the form jax.nn.softplus takes;
// * the backward takes JAX's gradients at ties: jnp.clip and jnp.maximum
//   split a tie evenly (0.5), the input clamp to [-B, B] passes the whole
//   gradient on the closed interval (`inside`), as `_bwd_scatter` does.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace rqs {

constexpr int kTailLinear = 1;
constexpr int kTailCircular = 2;

struct Consts {
  float min_bin_width, min_bin_height, min_derivative;
  float fw, fh;  // 1 - K * min_bin_width, 1 - K * min_bin_height
};

inline Consts make_consts(int K, double min_bin_width, double min_bin_height,
                          double min_derivative) {
  // the floors' complements in double, then rounded once, as the JAX kernel
  // folds its Python-float constants
  return Consts{static_cast<float>(min_bin_width),
                static_cast<float>(min_bin_height),
                static_cast<float>(min_derivative),
                static_cast<float>(1.0 - min_bin_width * K),
                static_cast<float>(1.0 - min_bin_height * K)};
}

// Threads a block for `rows` rows of n elements, one thread an element: 256
// or 128 where that still gives `min_blocks` blocks, else 64, so that a
// small launch spreads over the SMs and a large one keeps 256 threads.
inline int block_threads(long long n, int rows, int min_blocks) {
  for (int t = 256; t > 64; t /= 2)
    if (rows * ((n + t - 1) / t) >= min_blocks) return t;
  return 64;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// d clip(t, 0, 1) / dt as jnp.clip takes it: a tie at either end splits
__device__ __forceinline__ float clip_grad(float t) {
  if (t > 0.0f && t < 1.0f) return 1.0f;
  return (t == 0.0f || t == 1.0f) ? 0.5f : 0.0f;
}

// One element's input, its tail mode, the softmax statistics of its logits
// and the bin the search selected, with that bin's parameters.
struct Selection {
  float xs;  // wrapped (circular) or clamped (linear) input
  bool inside, is_circ, is_lin;
  float span;
  float wmax, wsum, hmax, hsum;
  int k;                       // selected bin
  float cw, w, ch, h, dk, dk1;  // its left edges, sizes and knot slopes
  float pw, ph;                // its width and height probabilities
  float pw_below, ph_below;    // sums of the probabilities of bins below it
  float hits;                  // sum of the K hit masks (1); only the
                               // ablation reads it, elsewhere it is dead code
};

// Tail handling, softmax statistics and the K-step accumulate-and-select bin
// search of `_selection`: the last bin catches every element the search
// leaves over.  Parameter rows are `n` floats apart.
template <bool kInverse>
__device__ __forceinline__ Selection select_bin(float x, const float* uw,
                                                const float* uh,
                                                const float* ud, size_t n,
                                                int K, int code, float bound,
                                                const Consts& c) {
  Selection e;
  e.is_circ = code == kTailCircular;
  e.is_lin = code == kTailLinear;
  const float left = -bound;
  const float right = -left;
  e.span = 2.0f * bound;
  e.inside = (x >= left) && (x <= right);
  if (e.is_circ) {
    float r = fmodf(x - left, e.span);
    if (r < 0.0f) r += e.span;
    e.xs = left + r;
  } else {
    e.xs = fminf(fmaxf(x, left), right);
  }

  // softmax statistics of the width and height logits
  e.wmax = uw[0];
  e.hmax = uh[0];
  for (int k = 1; k < K; ++k) {
    e.wmax = fmaxf(e.wmax, uw[k * n]);
    e.hmax = fmaxf(e.hmax, uh[k * n]);
  }
  e.wsum = 0.0f;
  e.hsum = 0.0f;
  for (int k = 0; k < K; ++k) {
    e.wsum += expf(uw[k * n] - e.wmax);
    e.hsum += expf(uh[k * n] - e.hmax);
  }

  // knot slopes: linear tails pin both ends to 1, circular ones close d_K = d_0
  const float d0_raw = c.min_derivative + softplus(ud[0]);
  const bool is_lin = e.is_lin, is_circ = e.is_circ;
  auto deriv = [&](int k) -> float {
    if (k == 0) return is_lin ? 1.0f : d0_raw;
    if (k == K && is_lin) return 1.0f;
    if (k == K && is_circ) return d0_raw;
    return c.min_derivative + softplus(ud[k * n]);
  };

  // K-step accumulate-and-select bin search
  float cw = left;
  float ch = left;
  bool found = false;
  e.k = K - 1;
  e.cw = 0.0f, e.w = 1.0f, e.ch = 0.0f, e.h = 1.0f;
  e.dk = 1.0f, e.dk1 = 1.0f;
  e.pw = 0.0f, e.ph = 0.0f, e.pw_below = 0.0f, e.ph_below = 0.0f;
  e.hits = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float p_w = expf(uw[k * n] - e.wmax) / e.wsum;
    const float p_h = expf(uh[k * n] - e.hmax) / e.hsum;
    const float w_k = (c.min_bin_width + c.fw * p_w) * e.span;
    const float h_k = (c.min_bin_height + c.fh * p_h) * e.span;
    const float cw_next = cw + w_k;
    const float ch_next = ch + h_k;
    const bool cond = (k == K - 1) || (e.xs < (kInverse ? ch_next : cw_next));
    const bool hit = !found && cond;
    e.hits += hit ? 1.0f : 0.0f;
    if (hit) {
      e.k = k;
      e.cw = cw;
      e.w = w_k;
      e.ch = ch;
      e.h = h_k;
      e.dk = deriv(k);
      e.dk1 = deriv(k + 1);
      e.pw = p_w;
      e.ph = p_h;
      found = true;
    } else if (!found) {
      e.pw_below += p_w;
      e.ph_below += p_h;
    }
    cw = cw_next;
    ch = ch_next;
  }
  return e;
}

// An element's 3K+1 parameters in registers, at a compile-time bin count
// KMAX: the width and height logits (exp(logit - max) once
// `select_bin_regs` has taken the softmax statistics) and the raw
// derivative logits.  With K < KMAX the bins from K up hold 0.
template <int KMAX>
struct ParamRegs {
  float w[KMAX], h[KMAX], d[KMAX + 1];
};

// One unrolled pass of loads, rows `n` floats apart, so that all of an
// element's loads are in flight at once.
template <int KMAX, bool kExact>
__device__ __forceinline__ ParamRegs<KMAX> load_params(const float* uw, const float* uh,
                                                       const float* ud, size_t n, int K) {
  ParamRegs<KMAX> r;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const bool on = kExact || k < K;
    r.w[k] = on ? uw[k * n] : 0.0f;
    r.h[k] = on ? uh[k * n] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k <= KMAX; ++k) r.d[k] = (kExact || k <= K) ? ud[k * n] : 0.0f;
  return r;
}

// `select_bin` on the parameters in `r`: the maxima, the sums and the search
// run over those registers with the same operations in the same order (the
// sums sequential over k), so the same bits as `select_bin`, and every
// exponential is in flight at once.  KMAX bins with kExact (K == KMAX), else
// K <= KMAX and the bins from K up masked.  No register array is indexed by
// a runtime value: the selected bin's two derivative logits are picked in
// the unrolled search.  On return r.w and r.h hold exp(logit - max).
template <bool kInverse, int KMAX, bool kExact>
__device__ __forceinline__ Selection select_bin_regs(float x, ParamRegs<KMAX>& r, int K_arg,
                                                     int code, float bound,
                                                     const Consts& c) {
  const int K = kExact ? KMAX : K_arg;
  Selection e;
  e.is_circ = code == kTailCircular;
  e.is_lin = code == kTailLinear;
  const float left = -bound;
  const float right = -left;
  e.span = 2.0f * bound;
  e.inside = (x >= left) && (x <= right);
  if (e.is_circ) {
    float m = fmodf(x - left, e.span);
    if (m < 0.0f) m += e.span;
    e.xs = left + m;
  } else {
    e.xs = fminf(fmaxf(x, left), right);
  }

  // softmax statistics; r.w and r.h then hold exp(logit - max)
  e.wmax = r.w[0];
  e.hmax = r.h[0];
#pragma unroll
  for (int k = 1; k < KMAX; ++k) {
    if (kExact || k < K) {
      e.wmax = fmaxf(e.wmax, r.w[k]);
      e.hmax = fmaxf(e.hmax, r.h[k]);
    }
  }
  e.wsum = 0.0f;
  e.hsum = 0.0f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (kExact || k < K) {
      r.w[k] = expf(r.w[k] - e.wmax);
      r.h[k] = expf(r.h[k] - e.hmax);
      e.wsum += r.w[k];
      e.hsum += r.h[k];
    }
  }

  // K-step accumulate-and-select bin search, as in select_bin
  float cw = left;
  float ch = left;
  bool found = false;
  float d_lo = 0.0f, d_hi = 0.0f;  // the selected bin's two derivative logits
  e.k = K - 1;
  e.cw = 0.0f, e.w = 1.0f, e.ch = 0.0f, e.h = 1.0f;
  e.dk = 1.0f, e.dk1 = 1.0f;
  e.pw = 0.0f, e.ph = 0.0f, e.pw_below = 0.0f, e.ph_below = 0.0f;
  e.hits = 0.0f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (kExact || k < K) {
      const float p_w = r.w[k] / e.wsum;
      const float p_h = r.h[k] / e.hsum;
      const float w_k = (c.min_bin_width + c.fw * p_w) * e.span;
      const float h_k = (c.min_bin_height + c.fh * p_h) * e.span;
      const float cw_next = cw + w_k;
      const float ch_next = ch + h_k;
      const bool cond = (k == K - 1) || (e.xs < (kInverse ? ch_next : cw_next));
      const bool hit = !found && cond;
      e.hits += hit ? 1.0f : 0.0f;
      if (hit) {
        e.k = k;
        e.cw = cw;
        e.w = w_k;
        e.ch = ch;
        e.h = h_k;
        d_lo = r.d[k];
        d_hi = r.d[k + 1];
        e.pw = p_w;
        e.ph = p_h;
        found = true;
      } else if (!found) {
        e.pw_below += p_w;
        e.ph_below += p_h;
      }
      cw = cw_next;
      ch = ch_next;
    }
  }

  // knot slopes: linear tails pin both ends to 1, circular ones close d_K = d_0
  const float d0_raw = c.min_derivative + softplus(r.d[0]);
  e.dk = e.k == 0 ? (e.is_lin ? 1.0f : d0_raw) : c.min_derivative + softplus(d_lo);
  if (e.k + 1 == K && e.is_lin) {
    e.dk1 = 1.0f;
  } else if (e.k + 1 == K && e.is_circ) {
    e.dk1 = d0_raw;
  } else {
    e.dk1 = c.min_derivative + softplus(d_hi);
  }
  return e;
}

// The rational-quadratic map in the selected bin (`_post_math`) and the
// identity tails: a linear tail outside [-B, B] is the identity with
// log|det| 0.
template <bool kInverse>
__device__ __forceinline__ void spline_element(const Selection& e, float x,
                                               float* y, float* ld) {
  const float delta = e.h / e.w;
  const float s = e.dk + e.dk1 - 2.0f * delta;
  float out;
  float l;
  if (kInverse) {
    const float y_rel = e.xs - e.ch;
    const float a = e.h * (delta - e.dk) + y_rel * s;
    const float bq = e.h * e.dk - y_rel * s;
    const float c = -delta * y_rel;
    const float disc = fmaxf(bq * bq - 4.0f * a * c, 0.0f);
    const float denom_root = -bq - sqrtf(disc);
    float theta = (2.0f * c) / (denom_root == 0.0f ? 1e-38f : denom_root);
    theta = fminf(fmaxf(theta, 0.0f), 1.0f);
    out = theta * e.w + e.cw;
    const float om = 1.0f - theta;
    const float tom = theta * om;
    const float denom = delta + s * tom;
    const float dnum = (delta * delta) *
        (e.dk1 * theta * theta + 2.0f * delta * tom + e.dk * om * om);
    l = -(logf(dnum) - 2.0f * logf(denom));
  } else {
    const float theta = fminf(fmaxf((e.xs - e.cw) / e.w, 0.0f), 1.0f);
    const float om = 1.0f - theta;
    const float tom = theta * om;
    const float num = e.h * (delta * theta * theta + e.dk * tom);
    const float denom = delta + s * tom;
    out = e.ch + num / denom;
    const float dnum = (delta * delta) *
        (e.dk1 * theta * theta + 2.0f * delta * tom + e.dk * om * om);
    l = logf(dnum) - 2.0f * logf(denom);
  }
  const bool use_spline = e.inside || e.is_circ;
  *y = use_spline ? out : x;
  *ld = use_spline ? l : 0.0f;
}

// Cotangents of the selected bin's inputs to `_post_math`.
struct PostGrads {
  float xs, cw, w, ch, h, dk, dk1;
};

// Cotangents that the log-det part of `_post_math` sends back.
struct ThetaGrads {
  float theta, delta, dk, dk1, s;
};

// The part both directions share: ld = lb_sign * (log dnum - 2 log denom),
// with lb_sign = lbar forward and -lbar inverse.  The caller's other uses of
// theta, tom and denom come in as g_theta_in, g_tom_in and g_denom_extra
// (the forward's out = ch + num / denom uses all three).
__device__ __forceinline__ ThetaGrads pull_back_log_det(
    float theta, float delta, float s, float dk, float dk1, float lb_sign,
    float g_denom_extra, float g_theta_in, float g_tom_in) {
  // dnum = delta^2 Q, Q = dk1 theta^2 + 2 delta tom + dk om^2;
  // ld = lb_sign * (log dnum - 2 log denom), denom = delta + s tom
  const float om = 1.0f - theta;
  const float tom = theta * om;
  const float Q = dk1 * theta * theta + 2.0f * delta * tom + dk * om * om;
  const float dnum = (delta * delta) * Q;
  const float denom = delta + s * tom;
  const float g_dnum = lb_sign / dnum;
  const float g_denom = -2.0f * lb_sign / denom + g_denom_extra;
  ThetaGrads g;
  const float g_Q = g_dnum * (delta * delta);
  g.delta = g_dnum * (2.0f * delta * Q) + g_Q * 2.0f * tom + g_denom;
  g.dk1 = g_Q * theta * theta;
  g.dk = g_Q * om * om;
  float g_theta = g_theta_in + g_Q * 2.0f * dk1 * theta;
  const float g_tom = g_tom_in + g_Q * 2.0f * delta + g_denom * s;
  float g_om = g_Q * 2.0f * dk * om;
  g.s = g_denom * tom;
  // tom = theta om, om = 1 - theta
  g_theta += g_tom * om;
  g_om += g_tom * theta;
  g.theta = g_theta - g_om;
  return g;
}

// VJP of `_post_math(..., inverse=False)`: out = ch + num / denom,
// ld = log(dnum) - 2 log(denom).
__device__ __forceinline__ PostGrads post_math_vjp_forward(const Selection& e,
                                                           float yb, float lb) {
  const float delta = e.h / e.w;
  const float s = e.dk + e.dk1 - 2.0f * delta;
  const float t_raw = (e.xs - e.cw) / e.w;
  const float theta = fminf(fmaxf(t_raw, 0.0f), 1.0f);
  const float om = 1.0f - theta;
  const float tom = theta * om;
  // num = h R, R = delta theta^2 + dk tom
  const float R = delta * theta * theta + e.dk * tom;
  const float num = e.h * R;
  const float denom = delta + s * tom;
  const float g_num = yb / denom;
  const float g_R = g_num * e.h;
  const ThetaGrads t = pull_back_log_det(
      theta, delta, s, e.dk, e.dk1, lb, -yb * num / (denom * denom),
      g_R * 2.0f * delta * theta, g_R * e.dk);
  PostGrads g;
  g.ch = yb;
  float g_delta = t.delta + g_R * theta * theta;
  const float g_dk = t.dk + g_R * tom + t.s;
  g.dk1 = t.dk1 + t.s;
  g_delta -= 2.0f * t.s;  // s = dk + dk1 - 2 delta
  g.dk = g_dk;
  // theta = clip((xs - cw) / w, 0, 1)
  const float g_t = t.theta * clip_grad(t_raw);
  const float g_u = g_t / e.w;
  g.xs = g_u;
  g.cw = -g_u;
  // delta = h / w
  g.h = g_num * R + g_delta / e.w;
  g.w = -(g_delta * delta + g_t * t_raw) / e.w;
  return g;
}

// VJP of `_post_math(..., inverse=True)`: theta is the stable root
// 2c / (-b - sqrt(b^2 - 4ac)), out = theta w + cw,
// ld = -(log(dnum) - 2 log(denom)).
__device__ __forceinline__ PostGrads post_math_vjp_inverse(const Selection& e,
                                                           float yb, float lb) {
  const float delta = e.h / e.w;
  const float s = e.dk + e.dk1 - 2.0f * delta;
  const float y_rel = e.xs - e.ch;
  const float a = e.h * (delta - e.dk) + y_rel * s;
  const float bq = e.h * e.dk - y_rel * s;
  const float c = -delta * y_rel;
  const float disc_raw = bq * bq - 4.0f * a * c;
  const float disc = fmaxf(disc_raw, 0.0f);
  const float sq = sqrtf(disc);
  const float dr = -bq - sq;
  const float dr_safe = dr == 0.0f ? 1e-38f : dr;
  const float t_raw = (2.0f * c) / dr_safe;
  const float theta = fminf(fmaxf(t_raw, 0.0f), 1.0f);
  const ThetaGrads t = pull_back_log_det(theta, delta, s, e.dk, e.dk1, -lb,
                                         0.0f, yb * e.w, 0.0f);
  PostGrads g;
  g.cw = yb;
  float g_w = yb * theta;
  float g_delta = t.delta;
  float g_dk = t.dk;
  float g_dk1 = t.dk1;
  float g_s = t.s;
  // theta = clip(t_raw, 0, 1), t_raw = 2c / dr_safe
  const float g_t = t.theta * clip_grad(t_raw);
  float g_c = 2.0f * g_t / dr_safe;
  const float g_dr = dr == 0.0f ? 0.0f : -g_t * t_raw / dr_safe;
  // dr = -bq - sqrt(max(disc_raw, 0)); jax's sqrt rule is g * 0.5 / sqrt,
  // and jnp.maximum splits a tie at 0
  float g_bq = -g_dr;
  const float g_disc = -g_dr * (0.5f / sq);
  const float g_draw =
      g_disc * (disc_raw > 0.0f ? 1.0f : (disc_raw == 0.0f ? 0.5f : 0.0f));
  // disc_raw = bq^2 - 4 a c
  g_bq += g_draw * 2.0f * bq;
  const float g_a = -4.0f * c * g_draw;
  g_c += -4.0f * a * g_draw;
  // c = -delta y_rel
  g_delta -= g_c * y_rel;
  float g_yrel = -g_c * delta;
  // bq = h dk - y_rel s
  float g_h = g_bq * e.dk;
  g_dk += g_bq * e.h;
  g_yrel -= g_bq * s;
  g_s -= g_bq * y_rel;
  // a = h (delta - dk) + y_rel s
  g_h += g_a * (delta - e.dk);
  g_delta += g_a * e.h;
  g_dk -= g_a * e.h;
  g_yrel += g_a * s;
  g_s += g_a * y_rel;
  // y_rel = xs - ch
  g.xs = g_yrel;
  g.ch = -g_yrel;
  // s = dk + dk1 - 2 delta
  g.dk = g_dk + g_s;
  g.dk1 = g_dk1 + g_s;
  g_delta -= 2.0f * g_s;
  // delta = h / w
  g.h = g_h + g_delta / e.w;
  g.w = g_w - g_delta * delta / e.w;
  return g;
}

// The backward of one element (`_bwd_scatter`): from the cotangents ybar,
// lbar of (y, ld) it writes dx and the 3K+1 parameter gradients, every one
// of them, zeros included, on rows `n_out` floats apart.  The selected bin
// k* stays an int (where `_bwd_scatter` carries K hit masks): the selected
// width and height take their bin's logits, the left edges cw and ch
// (prefix sums) the logits of every bin below k*, then softmax backward;
// the slopes dk, dk1 go to the derivative logits of knots k* and k*+1
// through softplus' gradient sigmoid, with the linear and circular boundary
// structure.  This form recomputes the probabilities and reads the logits
// from memory again.
template <bool kInverse>
__device__ __forceinline__ void spline_element_backward(
    const Selection& e, float ybar, float lbar, const float* uw,
    const float* uh, const float* ud, size_t n_in, int K, const Consts& c,
    float* dx, float* duw, float* duh, float* dud, size_t n_out) {
  const bool use_spline = e.inside || e.is_circ;
  const float yb = use_spline ? ybar : 0.0f;
  const float lb = use_spline ? lbar : 0.0f;
  const PostGrads g = kInverse ? post_math_vjp_inverse(e, yb, lb)
                               : post_math_vjp_forward(e, yb, lb);

  // x: xs is the wrap (slope 1) or the clamp (slope 1 on [-B, B]); a linear
  // tail outside it is the identity
  const float pass_through = (e.is_circ || e.inside) ? 1.0f : 0.0f;
  *dx = g.xs * pass_through + (use_spline ? 0.0f : ybar);

  // widths and heights: bin k* takes dw, every bin below it dcw (cw is a
  // prefix sum); then softmax backward, p_k (g_k - sum_j p_j g_j)
  const float gw_hit = g.w * (c.fw * e.span);
  const float gw_below = g.cw * (c.fw * e.span);
  const float gh_hit = g.h * (c.fh * e.span);
  const float gh_below = g.ch * (c.fh * e.span);
  const float sum_w = e.pw * gw_hit + e.pw_below * gw_below;
  const float sum_h = e.ph * gh_hit + e.ph_below * gh_below;
  for (int k = 0; k < K; ++k) {
    const float p_w = expf(uw[k * n_in] - e.wmax) / e.wsum;
    const float p_h = expf(uh[k * n_in] - e.hmax) / e.hsum;
    const float gw = k == e.k ? gw_hit : (k < e.k ? gw_below : 0.0f);
    const float gh = k == e.k ? gh_hit : (k < e.k ? gh_below : 0.0f);
    duw[k * n_out] = p_w * (gw - sum_w);
    duh[k * n_out] = p_h * (gh - sum_h);
  }

  // derivative logits: dk is knot k*'s slope, dk1 knot k*+1's; a linear
  // tail pins knots 0 and K to 1, a circular one takes knot K's slope from
  // knot 0's logit
  for (int j = 0; j <= K; ++j) {
    float gd = 0.0f;
    if (j == e.k && !(j == 0 && e.is_lin)) gd += g.dk;
    if (j == e.k + 1 && !(j == K && (e.is_lin || e.is_circ))) gd += g.dk1;
    if (j == 0 && e.k == K - 1 && e.is_circ && !e.is_lin) gd += g.dk1;
    dud[j * n_out] = gd * sigmoid(ud[j * n_in]);
  }
}

// `spline_element_backward` on the registers that `select_bin_regs` left in
// `r`: the probabilities are exp(logit - max) / sum from r.w and r.h, the
// sigmoids are of the logits in r.d, and no parameter is read from memory
// again.  The operations and their order are the loops' (built on the CPU
// without contraction the two agree bit for bit), but nvcc contracts
// multiply-adds into fmas differently in the two kernels, so on the card
// the outputs differ from the loops' by float32 rounding (PERF.md).
// Unrolled over KMAX; with K < KMAX the bins from K up write nothing.
template <bool kInverse, int KMAX, bool kExact>
__device__ __forceinline__ void spline_element_backward_regs(
    const Selection& e, const ParamRegs<KMAX>& r, float ybar, float lbar, int K_arg,
    const Consts& c, float* dx, float* duw, float* duh, float* dud, size_t n_out) {
  const int K = kExact ? KMAX : K_arg;
  const bool use_spline = e.inside || e.is_circ;
  const float yb = use_spline ? ybar : 0.0f;
  const float lb = use_spline ? lbar : 0.0f;
  const PostGrads g = kInverse ? post_math_vjp_inverse(e, yb, lb)
                               : post_math_vjp_forward(e, yb, lb);
  const float pass_through = (e.is_circ || e.inside) ? 1.0f : 0.0f;
  *dx = g.xs * pass_through + (use_spline ? 0.0f : ybar);

  const float gw_hit = g.w * (c.fw * e.span);
  const float gw_below = g.cw * (c.fw * e.span);
  const float gh_hit = g.h * (c.fh * e.span);
  const float gh_below = g.ch * (c.fh * e.span);
  const float sum_w = e.pw * gw_hit + e.pw_below * gw_below;
  const float sum_h = e.ph * gh_hit + e.ph_below * gh_below;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (kExact || k < K) {
      const float p_w = r.w[k] / e.wsum;
      const float p_h = r.h[k] / e.hsum;
      const float gw = k == e.k ? gw_hit : (k < e.k ? gw_below : 0.0f);
      const float gh = k == e.k ? gh_hit : (k < e.k ? gh_below : 0.0f);
      duw[k * n_out] = p_w * (gw - sum_w);
      duh[k * n_out] = p_h * (gh - sum_h);
    }
  }

#pragma unroll
  for (int j = 0; j <= KMAX; ++j) {
    if (kExact || j <= K) {
      float gd = 0.0f;
      if (j == e.k && !(j == 0 && e.is_lin)) gd += g.dk;
      if (j == e.k + 1 && !(j == K && (e.is_lin || e.is_circ))) gd += g.dk1;
      if (j == 0 && e.k == K - 1 && e.is_circ && !e.is_lin) gd += g.dk1;
      dud[j * n_out] = gd * sigmoid(r.d[j]);
    }
  }
}

// One element's backward from its parameter rows (`stride` floats apart)
// into gradient rows `n_out` floats apart: with KB = 0 the loops over a
// runtime K (`select_bin`, `spline_element_backward`), else the register
// form at KB bins (kExact) or K <= KB (`load_params`, `select_bin_regs`,
// `spline_element_backward_regs`).  The flat and the planar backward
// kernels and the ablation's `full` variant are this one call.  x, ybar and
// lbar come as pointers, read where the search and the scatter take them,
// so that the loops keep the registers of the kernels they were written in.
template <bool kInverse, int KB, bool kExact>
__device__ __forceinline__ void element_backward(
    const float* x, const float* uw, const float* uh, const float* ud, size_t stride, int K,
    int code, float bound, const float* ybar, const float* lbar, const Consts& c, float* dx,
    float* duw, float* duh, float* dud, size_t n_out) {
  if constexpr (KB == 0) {
    const Selection e = select_bin<kInverse>(*x, uw, uh, ud, stride, K, code, bound, c);
    spline_element_backward<kInverse>(e, *ybar, *lbar, uw, uh, ud, stride, K, c, dx, duw, duh,
                                      dud, n_out);
  } else {
    ParamRegs<KB> r = load_params<KB, kExact>(uw, uh, ud, stride, K);
    const Selection e = select_bin_regs<kInverse, KB, kExact>(*x, r, K, code, bound, c);
    spline_element_backward_regs<kInverse, KB, kExact>(e, r, *ybar, *lbar, K, c, dx, duw, duh,
                                                       dud, n_out);
  }
}

}  // namespace rqs
