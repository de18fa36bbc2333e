// The scalar implicit-MAP solve shared by the robust instantiations of K12
// (gated_filter.cu) and K9 (sqrt_filter.cu): the device twin of
// kernels/implicit_map.py, one scalar problem per call (one lane).
//
// Replaces the scalar half of the JAX package's B12 in
// metran_tpu/ops/implicit_map.py: _nll_factory (:135), _flag_fn (:187),
// _scalar_map_solve (:196).  A flagged slot's predicted observation
// s = z_i' x has the prior N(mu, c); the solve is damped Newton on
//   phi(s) = (s - mu)^2 / (2 c) + nll(s)
// with curvature 1/c + max(nll'', 0), the step clamped to +-8 sqrt(c), at
// most kNewtonIters steps, stopping once |phi'| sqrt(c) <= tol at the
// current iterate; then nll, nll' and nll'' once more at s_hat give
// w = max(nll'', 0) and the non-convergence verdict
// |phi'(s_hat)| sqrt(c) > nonconv_tol.
//
// The likelihoods (sig = max(sqrt(r), scale)):
//   censored   -log Phi((s - hi) / sig) at or above the high rail,
//              -log Phi((lo - s) / sig) otherwise;
//   quantized  -log [Phi(b) - Phi(a)], b, a = (y +- q/2 - s) / sig,
//              reflected when a + b > 0, as
//              lb + log1p(-exp(min(la - lb, log1p(-eps))));
//   huber_t    0.5 (nu + 1) log1p(((y - s) / sig)^2 / nu).
// log Phi is JAX's log_ndtr: -ndtr(-x) above the upper segment, log ndtr(x)
// between, the order-3 asymptotic series below the lower one (segments
// -20/8 in double, -10/5 in float; ndtr through erf near 0 and erfc in the
// tails).  Its derivative is JAX's custom JVP r(x) = exp(norm_logpdf(x) -
// log_ndtr(x)) in every branch, with r' = r (-x - r).  nll' and nll'' are
// the closed forms of jax.grad and of jax.jvp over it, written in the order
// of JAX's reverse pass and of the forward pass over it, like the plain
// version; every multiply and add here goes through the round-to-nearest
// intrinsics (no fused multiply-add), so the kernel rounds each operation
// as the plain PyTorch version does and the two differ only by the
// elementary functions' last bits.  IEEE erf/erfc/exp/log/log1p: the
// kernels are built without --use_fast_math.
//
// What bounds it: latency.  A solve is a serial chain of at most 13
// evaluations of a few dozen operations and two to four special
// functions; its lane runs it alone.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace imap {

enum Likelihood { kCensored = 0, kQuantized = 1, kHuberT = 2 };
constexpr int kNewtonIters = 12;
// verdict codes of a flagged slot (the gate's are 0/1/2)
constexpr int8_t kMap = 3;
constexpr int8_t kNonconv = 4;

// round-to-nearest arithmetic (never contracted into an FMA)
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double m_erf(double x) { return erf(x); }
__device__ __forceinline__ float m_erf(float x) { return erff(x); }
__device__ __forceinline__ double m_erfc(double x) { return erfc(x); }
__device__ __forceinline__ float m_erfc(float x) { return erfcf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }

template <typename T>
struct Consts;
template <>
struct Consts<double> {
  static constexpr double lower = -20.0, upper = 8.0;
  static constexpr double eps = 2.220446049250313e-16;
};
template <>
struct Consts<float> {
  static constexpr float lower = -10.0f, upper = 5.0f;
  static constexpr float eps = 1.1920928955078125e-07f;
};
// 0.5 log(2 pi) = log(sqrt(2 pi)), rounded once to T
constexpr double kHalfLog2Pi = 0.9189385332046727;

template <typename T>
__device__ T ndtr(T x) {
  const T hs2 = mul(T(0.5), m_sqrt(T(2)));
  const T w = mul(x, hs2);
  const T z = fabs(w);
  const T y = z < hs2 ? add(T(1), m_erf(w))
                      : (w > T(0) ? sub(T(2), m_erfc(z)) : m_erfc(z));
  return mul(T(0.5), y);
}

template <typename T>
__device__ T log_ndtr_lower(T x) {
  const T x2 = mul(x, x);
  const T log_scale =
      sub(sub(mul(T(-0.5), x2), m_log(-x)), T(kHalfLog2Pi));
  const T x4 = mul(x2, x2);
  const T odd = add(T(1) / x2, T(15) / mul(x4, x2));
  const T even = T(3) / x4;
  return add(log_scale, m_log(sub(add(T(1), even), odd)));
}

template <typename T>
__device__ T log_ndtr(T x) {
  if (x > Consts<T>::upper) return -ndtr(-x);
  if (x > Consts<T>::lower) return m_log(ndtr(x));
  return log_ndtr_lower(x);
}

// r(x) = exp(norm_logpdf(x) - log_ndtr(x)), lx = log_ndtr(x)
template <typename T>
__device__ T mills(T x, T lx) {
  return m_exp(sub(sub(mul(T(-0.5), mul(x, x)), T(kHalfLog2Pi)), lx));
}

template <typename T>
struct Nll {
  T f, d1, d2;
};

// nll, nll' and nll'' of one reading at s (the plain nll_derivs)
template <typename T, int kLik>
__device__ Nll<T> nll_derivs(T s, T y, T sig, T quantum, T lo, T hi,
                             double nu_d) {
  Nll<T> o;
  if (kLik == kCensored) {
    const bool hi_side = y >= hi;
    const T arg = hi_side ? sub(s, hi) / sig : sub(lo, s) / sig;
    const T t = hi_side ? T(1) / sig : T(-1) / sig;
    const T la = log_ndtr(arg);
    const T r = mills(arg, la);
    const T dr = mul(sub(-mul(t, arg), mul(t, r)), r);
    o.f = -la;
    o.d1 = hi_side ? -(r / sig) : r / sig;
    o.d2 = hi_side ? -(dr / sig) : dr / sig;
  } else if (kLik == kQuantized) {
    const T half = mul(T(0.5), quantum);
    const T b = sub(add(y, half), s) / sig;
    const T a = sub(sub(y, half), s) / sig;
    const bool flip = add(a, b) > T(0);
    const T aa = flip ? -b : a;
    const T bb = flip ? -a : b;
    const T la = log_ndtr(aa), lb = log_ndtr(bb);
    const T ra = mills(aa, la), rb = mills(bb, lb);
    const T raw = sub(la, lb);
    const T clip = m_log1p(-Consts<T>::eps);
    const T e = m_exp((raw < clip || isnan(raw)) ? raw : clip);
    const T be = raw < clip ? T(1) : (raw == clip ? T(0.5) : T(0));
    // the gradient, in the order of JAX's reverse pass
    const T v1 = add(-e, T(1));
    const T ct_e = -(T(-1) / v1);
    const T ct_raw = mul(mul(ct_e, e), be);
    const T ct_lb = add(T(-1), -ct_raw);
    const T ct_aa = mul(ct_raw, ra), ct_bb = mul(ct_lb, rb);
    const T ct_a = flip ? -ct_bb : ct_aa;
    const T ct_b = flip ? -ct_aa : ct_bb;
    o.d1 = add(-(ct_a / sig), -(ct_b / sig));
    // its derivative, ds = 1
    const T da = T(-1) / sig;
    const T daa = flip ? -da : da;
    const T dra =
        mul(sub(mul(T(-0.5), mul(daa, mul(T(2), aa))), mul(daa, ra)), ra);
    const T drb =
        mul(sub(mul(T(-0.5), mul(daa, mul(T(2), bb))), mul(daa, rb)), rb);
    const T draw = sub(mul(daa, ra), mul(daa, rb));
    const T de = mul(mul(draw, be), e);
    const T dct_e = -mul(mul(de, T(-1)), T(1) / mul(v1, v1));
    const T dct_raw = mul(add(mul(dct_e, e), mul(ct_e, de)), be);
    const T dct_aa = add(mul(dct_raw, ra), mul(ct_raw, dra));
    const T dct_bb = add(mul(-dct_raw, rb), mul(ct_lb, drb));
    const T dct_a = flip ? -dct_bb : dct_aa;
    const T dct_b = flip ? -dct_aa : dct_bb;
    o.d2 = add(-(dct_a / sig), -(dct_b / sig));
    o.f = -add(lb, m_log1p(-e));
  } else {  // kHuberT
    const T k = T(0.5 * (nu_d + 1.0));
    const T nu = T(nu_d);
    const T u = sub(y, s) / sig;
    const T q = mul(u, u) / nu;
    const T q1 = add(q, T(1));
    const T ct_r2 = (k / q1) / nu;
    o.d1 = -(mul(ct_r2, mul(T(2), u)) / sig);
    const T du = T(-1) / sig;
    const T dq = mul(du, mul(T(2), u)) / nu;
    const T dct_q = mul(mul(-dq, k), T(1) / mul(q1, q1));
    const T dct_u =
        add(mul(dct_q / nu, mul(T(2), u)), mul(ct_r2, mul(T(2), du)));
    o.d2 = -(dct_u / sig);
    o.f = mul(k, m_log1p(q));
  }
  return o;
}

// which readings take the MAP path (before the armed and observed tests)
template <typename T, int kLik>
__device__ __forceinline__ bool flags(T y, T lo, T hi) {
  return kLik == kCensored ? (y >= hi || y <= lo) : true;
}

template <typename T>
struct Solve {
  T s_hat, w, f;
  int iters;
  bool nonconv;
};

// the damped Newton solve of one lane (the plain scalar_map_solve_plain)
template <typename T, int kLik>
__device__ Solve<T> map_solve(T mu, T c_safe, T y, T sig, T quantum, T lo,
                              T hi, double nu, T tol, T nonconv_tol) {
  const T inv_c = T(1) / c_safe;
  const T sqrt_c = m_sqrt(c_safe);
  const T max_step = mul(T(8), sqrt_c);
  T s = mu;
  int iters = 0;
  for (int k = 0; k < kNewtonIters; ++k) {
    const Nll<T> n = nll_derivs<T, kLik>(s, y, sig, quantum, lo, hi, nu);
    const T gtot = add(mul(sub(s, mu), inv_c), n.d1);
    if (mul(fabs(gtot), sqrt_c) <= tol) break;  // done: s stays
    const T h = add(inv_c, n.d2 < T(0) ? T(0) : n.d2);
    T step = -gtot / h;
    step = step < -max_step ? -max_step : step;  // NaN passes, as jnp.clip
    step = step > max_step ? max_step : step;
    s = add(s, step);
    ++iters;
  }
  const Nll<T> n = nll_derivs<T, kLik>(s, y, sig, quantum, lo, hi, nu);
  const T g = add(mul(sub(s, mu), inv_c), n.d1);
  Solve<T> o;
  o.s_hat = s;
  o.w = n.d2 < T(0) ? T(0) : n.d2;
  o.f = n.f;
  o.iters = iters;
  o.nonconv = mul(fabs(g), sqrt_c) > nonconv_tol;
  return o;
}

// the slot scale max(sqrt(max(r, 0)), scale) (NaN-propagating, as
// torch.maximum)
template <typename T>
__device__ __forceinline__ T slot_scale(T r, T scale) {
  const T sr = m_sqrt(r < T(0) ? T(0) : r);
  return (isnan(sr) || sr > scale) ? sr : scale;
}

}  // namespace imap
