// K14: the frozen-gain (steady-state) filter append, one warp per model.
//
// Replaces the JAX package's device program B9b (steady),
// metran_tpu/ops/kalman.py::_steady_filter_append (:1362) behind
// steady_filter_append, which the serving path vmaps over a shape bucket
// for every frozen model (serve/engine.py::make_steady_update_fn).
//
// Per model and appended step, from the carried mean m and the frozen
// gain K (S, N) with its innovation variances f (N,) (f_safe = f where
// f > 0, else 1; log_f = log f_safe on real slots, else 0):
//   predict   m_p = phi o m
//   full      = every slot's mask equals the real-slot pattern
// The vector form (kSeq = false: the joint gain, marginal variances):
//   v_i = mask_i ? y_i - Z_i.m_p : 0,  z_i = v_i / sqrt(f_i)
//   hit_i = armed && mask_i && z_i^2 > t          (never with "off")
//   huber  w_i = hit_i ? sqrt(t / z_i^2) : 1;  reject/inflate: w_i = 1
//          and any hit breaks the step
//   m = m_p + K (w o v),  sigma += sum mask (w v)^2 / f,
//   detf += sum mask log_f
// The per-slot form (kSeq = true, gated policies only: the per-slot
// sequential gains and conditional variances), slot by slot in order
// from m_s = m_p:
//   v = y_i - Z_i.m_s,  z = v / sqrt(f_i), the same hit and weight,
//   if mask_i: m_s += K_i (w v), sigma += (w v)^2 / f_i, detf += log_f_i
// broke (sticky) |= !full || a reject/inflate hit; after the last step
// broke |= any non-finite entry of the mean.  The z-score is NaN where
// unobserved; the verdict is 2 (rejected) or 1 (downweighted) where hit.
//
// The policy and the form are template parameters (as K12's policies
// and K6's modes are), so an instantiation carries no run-time branch
// of the others.  So is the horizons mode (fmeans given): the read
// path's mean half of the commit-time horizon pass over the final mean,
// horizonk::means_warp (horizon_step.cuh, shared with K17), as the JAX
// make_steady_update_fn (:936) appends it.
//
// What bounds it on an H100: bytes.  A step is O(S N) operations
// (Z m_p and K (w v)); with k = 1 each model reads Z and K once
// (2 S N words) and the recursion is a few dependent dot products, so
// the launch sets the time at serving shapes.  Design: one warp per
// model; Z and K go to shared memory (read again at every step when
// k > 1); the vector form gives one slot to a lane for v (a serial dot
// over the S states out of shared memory) and one state to a lane for
// the gain product; the per-slot form gives one state to a lane and
// reduces each slot's dot across the warp by shuffles.  Buckets with
// more than 32 states or slots loop the lanes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "horizon_step.cuh"
#include "steady_step.cuh"

namespace {

using steadyk::kFull;
using steadyk::kHuber;
using steadyk::kInflate;
using steadyk::kOff;
using steadyk::kReject;
using steadyk::kWarp;
using steadyk::steady_smem;

// The step body is steadyk::filter_warp (steady_step.cuh), which the
// arena steady update shares.
template <typename T, int kPolicy, bool kSeq, bool kHz>
__global__ void __launch_bounds__(kWarp)
steady_filter_kernel(const T* __restrict__ phi, const T* __restrict__ z,
                     const T* __restrict__ kgain, const T* __restrict__ fdiag,
                     const uint8_t* __restrict__ real,
                     const T* __restrict__ mean0, const T* __restrict__ y,
                     const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ armed, double thresh,
                     T* __restrict__ mean_out, T* __restrict__ sigma_out,
                     T* __restrict__ detf_out, uint8_t* __restrict__ broke_out,
                     T* __restrict__ z_out, int8_t* __restrict__ verdict_out,
                     const T* __restrict__ horizons, T* __restrict__ fmeans,
                     int H, int k, int N, int S) {
  extern __shared__ unsigned char smem_raw[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const steadyk::Result<T> res = steadyk::filter_warp<T, kPolicy, kSeq>(
      smem_raw, phi, z, kgain, fdiag, real, mean0, y, mask, armed[b] != 0,
      thresh, z_out, verdict_out, b, b, k, N, S);
  const T* sm = steadyk::smem_mean<T>(smem_raw, N, S);
  for (int s = lane; s < S; s += kWarp) mean_out[(size_t)b * S + s] = sm[s];
  if (lane == 0) {
    sigma_out[b] = res.sigma;
    detf_out[b] = res.detf;
    broke_out[b] = res.broke ? 1 : 0;
  }
  if (kHz)
    horizonk::means_warp<T>(phi + (size_t)b * S, sm,
                            reinterpret_cast<const T*>(smem_raw), horizons,
                            H, reinterpret_cast<T*>(smem_raw) +
                                   steady_smem<T>(N, S) / sizeof(T),
                            fmeans, b, N, S);
}

template <typename T, int kPolicy, bool kSeq, bool kHz>
int launch_mode(const void* phi, const void* z, const void* kgain,
                const void* fdiag, const void* real, const void* mean0,
                const void* y, const void* mask, const void* armed,
                double thresh, void* mean_out, void* sigma_out,
                void* detf_out, void* broke_out, void* z_out,
                void* verdict_out, const void* horizons, void* fmeans, int H,
                int B, int k, int N, int S, void* stream) {
  const size_t smem =
      steady_smem<T>(N, S) +
      (kHz ? sizeof(T) * horizonk::smem_elems(S) : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        steady_filter_kernel<T, kPolicy, kSeq, kHz>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0) return 0;
  steady_filter_kernel<T, kPolicy, kSeq, kHz>
      <<<B, kWarp, smem, (cudaStream_t)stream>>>(
          (const T*)phi, (const T*)z, (const T*)kgain, (const T*)fdiag,
          (const uint8_t*)real, (const T*)mean0, (const T*)y,
          (const uint8_t*)mask, (const uint8_t*)armed, thresh, (T*)mean_out,
          (T*)sigma_out, (T*)detf_out, (uint8_t*)broke_out, (T*)z_out,
          (int8_t*)verdict_out, (const T*)horizons, (T*)fmeans, H, k, N, S);
  return (int)cudaGetLastError();
}

template <typename T, int kPolicy, bool kSeq>
int launch(const void* phi, const void* z, const void* kgain,
           const void* fdiag, const void* real, const void* mean0,
           const void* y, const void* mask, const void* armed, double thresh,
           void* mean_out, void* sigma_out, void* detf_out, void* broke_out,
           void* z_out, void* verdict_out, const void* horizons,
           void* fmeans, int H, int B, int k, int N, int S, void* stream) {
  if (fmeans != nullptr)
    return launch_mode<T, kPolicy, kSeq, true>(
        phi, z, kgain, fdiag, real, mean0, y, mask, armed, thresh, mean_out,
        sigma_out, detf_out, broke_out, z_out, verdict_out, horizons, fmeans,
        H, B, k, N, S, stream);
  return launch_mode<T, kPolicy, kSeq, false>(
      phi, z, kgain, fdiag, real, mean0, y, mask, armed, thresh, mean_out,
      sigma_out, detf_out, broke_out, z_out, verdict_out, horizons, fmeans, H,
      B, k, N, S, stream);
}

template <typename T>
int dispatch(const void* phi, const void* z, const void* kgain,
             const void* fdiag, const void* real, const void* mean0,
             const void* y, const void* mask, const void* armed,
             double thresh, void* mean_out, void* sigma_out, void* detf_out,
             void* broke_out, void* z_out, void* verdict_out,
             const void* horizons, void* fmeans, int H, int B, int k, int N,
             int S, int policy, int sequential, void* stream) {
#define METRAN_STEADY(P, Q)                                                  \
  launch<T, P, Q>(phi, z, kgain, fdiag, real, mean0, y, mask, armed, thresh, \
                  mean_out, sigma_out, detf_out, broke_out, z_out,           \
                  verdict_out, horizons, fmeans, H, B, k, N, S, stream)
  if (sequential && policy != kOff) {
    switch (policy) {
      case kReject: return METRAN_STEADY(kReject, true);
      case kHuber: return METRAN_STEADY(kHuber, true);
      case kInflate: return METRAN_STEADY(kInflate, true);
    }
  } else {
    switch (policy) {
      case kOff: return METRAN_STEADY(kOff, false);
      case kReject: return METRAN_STEADY(kReject, false);
      case kHuber: return METRAN_STEADY(kHuber, false);
      case kInflate: return METRAN_STEADY(kInflate, false);
    }
  }
#undef METRAN_STEADY
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// phi (B, S), z (B, N, S), kgain (B, S, N), fdiag (B, N), real (B, N)
// uint8, mean0 (B, S), y (B, k, N), mask (B, k, N) uint8, armed (B,)
// uint8, thresh = nsigma^2; mean_out (B, S), sigma/detf (B,), broke (B,)
// uint8, z_out (B, k, N), verdict (B, k, N) int8; horizons (H,) and
// fmeans (B, H, N), fmeans null: the horizons mode off.  policy: 0 off,
// 1 reject, 2 huber, 3 inflate; sequential: the per-slot form (gated
// policies only).
int metran_steady_filter_f32(const void* phi, const void* z,
                             const void* kgain, const void* fdiag,
                             const void* real, const void* mean0,
                             const void* y, const void* mask,
                             const void* armed, double thresh, void* mean_out,
                             void* sigma_out, void* detf_out,
                             void* broke_out, void* z_out, void* verdict_out,
                             const void* horizons, void* fmeans, int H,
                             int B, int k, int N, int S, int policy,
                             int sequential, void* stream) {
  return dispatch<float>(phi, z, kgain, fdiag, real, mean0, y, mask, armed,
                         thresh, mean_out, sigma_out, detf_out, broke_out,
                         z_out, verdict_out, horizons, fmeans, H, B, k, N, S,
                         policy, sequential, stream);
}

int metran_steady_filter_f64(const void* phi, const void* z,
                             const void* kgain, const void* fdiag,
                             const void* real, const void* mean0,
                             const void* y, const void* mask,
                             const void* armed, double thresh, void* mean_out,
                             void* sigma_out, void* detf_out,
                             void* broke_out, void* z_out, void* verdict_out,
                             const void* horizons, void* fmeans, int H,
                             int B, int k, int N, int S, int policy,
                             int sequential, void* stream) {
  return dispatch<double>(phi, z, kgain, fdiag, real, mean0, y, mask, armed,
                          thresh, mean_out, sigma_out, detf_out, broke_out,
                          z_out, verdict_out, horizons, fmeans, H, B, k, N, S,
                          policy, sequential, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
