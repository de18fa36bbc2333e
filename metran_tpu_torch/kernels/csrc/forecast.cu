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

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
forecast_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                const T* __restrict__ z, const T* __restrict__ r,
                const T* __restrict__ mean, const T* __restrict__ cov,
                const T* __restrict__ horizons, T* __restrict__ means_out,
                T* __restrict__ vars_out, int H, int N, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ph = reinterpret_cast<T*>(smem_raw);  // S*S state covariance at h
  T* Zs = Ph + S * S;                       // N*S observation matrix
  T* W = Zs + N * S;                        // N*S: (Z P_h) o Z
  T* mh = W + N * S;                        // S state mean at h

  const int b = blockIdx.x / H;
  const int hi = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T h = horizons[hi];
  const T* phib = phi + (size_t)b * S;
  const T* qb = q + (size_t)b * S * S;
  const T* covb = cov + (size_t)b * S * S;

  for (int i = tid; i < N * S; i += nt) Zs[i] = z[(size_t)b * N * S + i];
  for (int i = tid; i < S; i += nt) mh[i] = pow(phib[i], h) * mean[(size_t)b * S + i];
  for (int idx = tid; idx < S * S; idx += nt) {
    const int i = idx / S, j = idx - (idx / S) * S;
    const T lp = log(phib[i] * phib[j]);
    const T pph = exp(h * lp);
    const T den = expm1(lp);
    const T geom = den == T(0) ? h : expm1(h * lp) / den;
    Ph[idx] = pph * covb[idx] + geom * qb[idx];
  }
  __syncthreads();
  // W[a, c] = (sum_j Z[a, j] P_h[j, c]) Z[a, c]
  for (int idx = tid; idx < N * S; idx += nt) {
    const int a = idx / S, c = idx - (idx / S) * S;
    T acc = 0;
    for (int j = 0; j < S; ++j) acc += Zs[a * S + j] * Ph[j * S + c];
    W[idx] = acc * Zs[idx];
  }
  __syncthreads();
  for (int a = tid; a < N; a += nt) {
    T mu = 0, var = 0;
    for (int j = 0; j < S; ++j) {
      mu += mh[j] * Zs[a * S + j];
      var += W[a * S + j];
    }
    const size_t o = ((size_t)b * H + hi) * N + a;
    means_out[o] = mu;
    vars_out[o] = (var > T(0) ? var : T(0)) + r[(size_t)b * N + a];
  }
}

template <typename T>
int launch_forecast(const void* phi, const void* q, const void* z,
                    const void* r, const void* mean, const void* cov,
                    const void* horizons, void* means_out, void* vars_out,
                    int B, int H, int N, int S, void* stream) {
  const size_t smem =
      sizeof(T) * ((size_t)S * S + 2 * (size_t)N * S + (size_t)S);
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
