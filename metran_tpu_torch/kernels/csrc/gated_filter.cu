// K12: gated sequential-processing Kalman filter append, one thread block
// per model.
//
// Replaces the JAX package's device program B9b (gated) in
// metran_tpu/ops/kalman.py: _gated_sequential_update and
// _make_gated_core_step behind gated_filter_append (the serving path's
// observation gate, vmapped over a shape bucket by serve/engine.py), and,
// with the gate off, _sequential_update behind
// filter_append(engine="sequential"); in its robust modes, B12's
// sequential half in metran_tpu/ops/implicit_map.py:
// _robust_sequential_update (:260) with _make_robust_core_step (:336)
// behind implicit_map_filter_append (the robust serving update).
//
// Per model and appended step:
//   predict   m = phi o m,  P = (phi phi') o P + q
//   then one rank-1 update per OBSERVED slot i, in slot order:
//     v = y_i - z_i.m,  d = P z_i,  c = z_i.d,  f = c + r_i,  z = v / sqrt(f)
//     hit = armed && z^2 > t            (t = nsigma^2; never with "off")
//     reject   use = !hit
//     huber    v <- w v, w = hit ? sqrt(t / z^2) : 1
//     inflate  f <- hit ? v^2 / t : f   (> f exactly when hit)
//     if use:  k = d / f,  m += k v,  P -= (k k') f,
//              sigma += v^2 / f,  detf += log f
//   verdict: 2 (rejected) or 1 (downweighted) where hit, else 0; the
//   z-score is NaN on unobserved slots and, with the gate off, on every
//   slot, as the JAX function returns them.
// The robust modes (one per likelihood, censored / quantized / huber_t:
// kRobust + its code in implicit_map.cuh) never gate; an armed slot that
// flags (censored: y_i at or beyond a rail; the others: every reading)
// solves its scalar MAP problem on thread 0 (implicit_map.cuh, prior
// N(mu, c) with mu = y_i - v and c = max(c, sqrt(tiny))) and the same
// rank-1 update runs with d in place of k, (s_hat - mu) / c in place of v
// and w / (1 + c w) in place of f:
//     m += d (s_hat - mu) / c,  P -= (d d') w / (1 + c w),
//     sigma += (s_hat - mu)^2 / c + 2 nll(s_hat),  detf += log1p(c w);
//   verdict 3 (MAP) or 4 (the solve missed its residual bar), the Newton
//   steps in an int32 (B, k, N) output (0 where nothing flagged), and the
//   real z-score.
// An unobserved slot changes nothing, exactly as the JAX select does.
//
// Bit-exactness contract: a slot that does not trip (or flag) executes
// the same floating-point operations in every instantiation (w = 1 and
// the selects are exact identities, and the robust branch only chooses
// the rank-1 update's operands), so an armed gate that never trips, or an
// armed robust mode where nothing flags, gives the posterior and
// likelihood terms of the "off" instantiation bit for bit.  The policy is
// a template parameter; every instantiation shares the one body below.
//
// What bounds it on an H100: latency, as K1.  At the flagship bucket
// (N = 24, S = 32) a step is N dependent rank-1 updates of ~3 S^2 flops
// each, four block barriers apiece; the covariance, Z and the carry stay
// in shared memory for all k steps, device memory sees y, mask and the
// posterior once, and one launch serves the dispatch.  A flagged slot adds
// its serial Newton solve (up to 13 evaluations of the likelihood on one
// thread) between two of those barriers; huber_t and quantized flag every
// observed slot.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gated_step.cuh"

namespace {

using gatedk::kHuber;
using gatedk::kInflate;
using gatedk::kOff;
using gatedk::kReject;
using gatedk::kRobust;
using gatedk::kThreads;
using gatedk::RobustArgs;

// The step body is gatedk::filter_block (gated_step.cuh), which the
// arena update shares.
template <typename T, int kPolicy>
__global__ void __launch_bounds__(kThreads)
gated_filter_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                    const T* __restrict__ z, const T* __restrict__ r,
                    const T* __restrict__ mean0, const T* __restrict__ cov0,
                    const T* __restrict__ y, const uint8_t* __restrict__ mask,
                    const uint8_t* __restrict__ armed, double thresh_d,
                    T* __restrict__ mean_out, T* __restrict__ cov_out,
                    T* __restrict__ sigma_out, T* __restrict__ detf_out,
                    T* __restrict__ z_out, int8_t* __restrict__ verdict_out,
                    RobustArgs<T> rob, int k, int N, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  // the gate (or the robust mode) reads the flag; "off" never does
  const bool armed_b = kPolicy != kOff && armed[b] != 0;
  gatedk::filter_block<T, kPolicy>(smem_raw, phi, q, z, r, mean0, cov0, y,
                                   mask, armed_b, thresh_d, sigma_out,
                                   detf_out, z_out, verdict_out, rob, b, b,
                                   k, N, S);
  const gatedk::Smem<T> s = gatedk::carve<T>(smem_raw, N, S);
  for (int i = tid; i < S * S; i += kThreads)
    cov_out[(size_t)b * S * S + i] = s.P[i];
  for (int i = tid; i < S; i += kThreads) mean_out[(size_t)b * S + i] = s.m[i];
}

template <typename T>
size_t gated_filter_smem(int N, int S) {
  return sizeof(T) * gatedk::smem_elems<T>(N, S);
}

template <typename T, int kPolicy>
int launch(const void* phi, const void* q, const void* z, const void* r,
           const void* mean0, const void* cov0, const void* y,
           const void* mask, const void* armed, double thresh,
           void* mean_out, void* cov_out, void* sigma_out, void* detf_out,
           void* z_out, void* verdict_out, RobustArgs<T> rob, int B, int k,
           int N, int S, void* stream) {
  const size_t smem = gated_filter_smem<T>(N, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gated_filter_kernel<T, kPolicy>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0) return 0;
  gated_filter_kernel<T, kPolicy>
      <<<B, kThreads, smem, (cudaStream_t)stream>>>(
          (const T*)phi, (const T*)q, (const T*)z, (const T*)r,
          (const T*)mean0, (const T*)cov0, (const T*)y, (const uint8_t*)mask,
          (const uint8_t*)armed, thresh, (T*)mean_out, (T*)cov_out,
          (T*)sigma_out, (T*)detf_out, (T*)z_out, (int8_t*)verdict_out, rob,
          k, N, S);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gated_filter(const void* phi, const void* q, const void* z,
                        const void* r, const void* mean0, const void* cov0,
                        const void* y, const void* mask, const void* armed,
                        double thresh, void* mean_out, void* cov_out,
                        void* sigma_out, void* detf_out, void* z_out,
                        void* verdict_out, int B, int k, int N, int S,
                        int policy, void* stream) {
  const RobustArgs<T> none = {};
#define METRAN_GATED(P)                                                    \
  return launch<T, P>(phi, q, z, r, mean0, cov0, y, mask, armed, thresh,  \
                      mean_out, cov_out, sigma_out, detf_out, z_out,      \
                      verdict_out, none, B, k, N, S, stream)
  switch (policy) {
    case kOff: METRAN_GATED(kOff);
    case kReject: METRAN_GATED(kReject);
    case kHuber: METRAN_GATED(kHuber);
    case kInflate: METRAN_GATED(kInflate);
    default: return (int)cudaErrorInvalidValue;
  }
#undef METRAN_GATED
}

template <typename T>
int launch_robust_filter(const void* phi, const void* q, const void* z,
                         const void* r, const void* mean0, const void* cov0,
                         const void* y, const void* mask, const void* armed,
                         const void* rail_lo, const void* rail_hi,
                         const void* quantum, const void* scale, double nu,
                         double tol, double nonconv_tol, double c_floor,
                         void* mean_out, void* cov_out, void* sigma_out,
                         void* detf_out, void* z_out, void* verdict_out,
                         void* iters_out, int B, int k, int N, int S,
                         int likelihood, void* stream) {
  const RobustArgs<T> rob = {(const T*)rail_lo, (const T*)rail_hi,
                             (const T*)quantum, (const T*)scale, nu, tol,
                             nonconv_tol, c_floor, (int*)iters_out};
#define METRAN_ROBUST(L)                                                    \
  return launch<T, kRobust + L>(phi, q, z, r, mean0, cov0, y, mask, armed, \
                                0.0, mean_out, cov_out, sigma_out,         \
                                detf_out, z_out, verdict_out, rob, B, k, N, \
                                S, stream)
  switch (likelihood) {
    case imap::kCensored: METRAN_ROBUST(imap::kCensored);
    case imap::kQuantized: METRAN_ROBUST(imap::kQuantized);
    case imap::kHuberT: METRAN_ROBUST(imap::kHuberT);
    default: return (int)cudaErrorInvalidValue;
  }
#undef METRAN_ROBUST
}

}  // namespace

extern "C" {

// policy: 0 off, 1 reject, 2 huber, 3 inflate; thresh = nsigma^2;
// armed (B,) uint8 (read only when policy != 0)
int metran_gated_filter_f32(const void* phi, const void* q, const void* z,
                            const void* r, const void* mean0,
                            const void* cov0, const void* y, const void* mask,
                            const void* armed, double thresh, void* mean_out,
                            void* cov_out, void* sigma_out, void* detf_out,
                            void* z_out, void* verdict_out, int B, int k,
                            int N, int S, int policy, void* stream) {
  return launch_gated_filter<float>(phi, q, z, r, mean0, cov0, y, mask, armed,
                                    thresh, mean_out, cov_out, sigma_out,
                                    detf_out, z_out, verdict_out, B, k, N, S,
                                    policy, stream);
}

int metran_gated_filter_f64(const void* phi, const void* q, const void* z,
                            const void* r, const void* mean0,
                            const void* cov0, const void* y, const void* mask,
                            const void* armed, double thresh, void* mean_out,
                            void* cov_out, void* sigma_out, void* detf_out,
                            void* z_out, void* verdict_out, int B, int k,
                            int N, int S, int policy, void* stream) {
  return launch_gated_filter<double>(phi, q, z, r, mean0, cov0, y, mask,
                                     armed, thresh, mean_out, cov_out,
                                     sigma_out, detf_out, z_out, verdict_out,
                                     B, k, N, S, policy, stream);
}

// likelihood: 0 censored, 1 quantized, 2 huber_t; rail_lo, rail_hi,
// quantum, scale (B, N); tol, nonconv_tol: the solve's residual bars;
// c_floor: the floor of the slot's prior variance; iters (B, k, N) int32
int metran_gated_filter_robust_f32(
    const void* phi, const void* q, const void* z, const void* r,
    const void* mean0, const void* cov0, const void* y, const void* mask,
    const void* armed, const void* rail_lo, const void* rail_hi,
    const void* quantum, const void* scale, double nu, double tol,
    double nonconv_tol, double c_floor, void* mean_out, void* cov_out,
    void* sigma_out, void* detf_out, void* z_out, void* verdict_out,
    void* iters_out, int B, int k, int N, int S, int likelihood,
    void* stream) {
  return launch_robust_filter<float>(
      phi, q, z, r, mean0, cov0, y, mask, armed, rail_lo, rail_hi, quantum,
      scale, nu, tol, nonconv_tol, c_floor, mean_out, cov_out, sigma_out,
      detf_out, z_out, verdict_out, iters_out, B, k, N, S, likelihood,
      stream);
}

int metran_gated_filter_robust_f64(
    const void* phi, const void* q, const void* z, const void* r,
    const void* mean0, const void* cov0, const void* y, const void* mask,
    const void* armed, const void* rail_lo, const void* rail_hi,
    const void* quantum, const void* scale, double nu, double tol,
    double nonconv_tol, double c_floor, void* mean_out, void* cov_out,
    void* sigma_out, void* detf_out, void* z_out, void* verdict_out,
    void* iters_out, int B, int k, int N, int S, int likelihood,
    void* stream) {
  return launch_robust_filter<double>(
      phi, q, z, r, mean0, cov0, y, mask, armed, rail_lo, rail_hi, quantum,
      scale, nu, tol, nonconv_tol, c_floor, mean_out, cov_out, sigma_out,
      detf_out, z_out, verdict_out, iters_out, B, k, N, S, likelihood,
      stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
