// K2: closed-form h-step forecast moments, one thread block per
// (model, horizon).
//
// Replaces the JAX package's device program
// metran_tpu/ops/forecast.py::forecast_observation_moments (with
// forecast_state_moments and metran_tpu/ops/kalman.py::project), which the
// serving path runs vmapped over a shape bucket, and forecast_horizons
// (covariance form) built on it.
//
// For a diagonal transition the h-step state moments need no recursion:
//   m_h      = phi^h o m
//   P_h[i,j] = (phi_i phi_j)^h P[i,j] + q[i,j] expm1(h log pp)/expm1(log pp)
// with pp = phi_i phi_j and the pp == 1 limit h (the at_one guard), in the
// same exp/log/expm1 form as the JAX code so near-unit-root models
// (alpha ~ 3e4) keep their digits.  Observation moments are Z m_h and
// max(diag(Z P_h Z'), 0) + r.
//
// What bounds it on an H100: the bytes of the inputs are a few KB per
// model, the work ~2 S^2 N flops per (model, horizon); at serving batch
// sizes the kernel is launch- and latency-bound.  One block builds P_h in
// shared memory, forms (Z P_h) o Z with one thread per entry and reduces
// its rows, without touching device memory again; B*H blocks fill the SMs.

#include <cuda_runtime.h>
#include <math.h>

#include "forecast_step.cuh"

namespace {

constexpr int kThreads = 128;

// The body is forecastk::moments_block (forecast_step.cuh), which the
// arena forecast shares.
template <typename T>
__global__ void __launch_bounds__(kThreads)
forecast_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                const T* __restrict__ z, const T* __restrict__ r,
                const T* __restrict__ mean, const T* __restrict__ cov,
                const T* __restrict__ horizons, T* __restrict__ means_out,
                T* __restrict__ vars_out, int H, int N, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / H;
  const int hi = blockIdx.x - b * H;
  forecastk::moments_block<T>(
      smem_raw, phi + (size_t)b * S, q + (size_t)b * S * S,
      z + (size_t)b * N * S, r + (size_t)b * N, mean + (size_t)b * S,
      cov + (size_t)b * S * S, horizons[hi], means_out, vars_out,
      ((size_t)b * H + hi) * N, N, S);
}

template <typename T>
int launch_forecast(const void* phi, const void* q, const void* z,
                    const void* r, const void* mean, const void* cov,
                    const void* horizons, void* means_out, void* vars_out,
                    int B, int H, int N, int S, void* stream) {
  const size_t smem = sizeof(T) * forecastk::smem_elems<T>(N, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        forecast_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0 || H == 0) return 0;
  forecast_kernel<T><<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)phi, (const T*)q, (const T*)z, (const T*)r, (const T*)mean,
      (const T*)cov, (const T*)horizons, (T*)means_out, (T*)vars_out, H, N,
      S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int metran_forecast_moments_f32(const void* phi, const void* q, const void* z,
                                const void* r, const void* mean,
                                const void* cov, const void* horizons,
                                void* means_out, void* vars_out, int B, int H,
                                int N, int S, void* stream) {
  return launch_forecast<float>(phi, q, z, r, mean, cov, horizons, means_out,
                                vars_out, B, H, N, S, stream);
}

int metran_forecast_moments_f64(const void* phi, const void* q, const void* z,
                                const void* r, const void* mean,
                                const void* cov, const void* horizons,
                                void* means_out, void* vars_out, int B, int H,
                                int N, int S, void* stream) {
  return launch_forecast<double>(phi, q, z, r, mean, cov, horizons, means_out,
                                 vars_out, B, H, N, S, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
