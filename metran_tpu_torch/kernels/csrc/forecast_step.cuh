// The closed-form forecast moments of one (model, horizon), one block,
// shared by K2 (forecast.cu), the arena forecast K18 (arena_forecast.cu)
// and the horizons mode of the exact arena update K16
// (arena_commit.cuh).
//
// moments_block reads one model's phi (S), q (S, S), z (N, S), r (N),
// mean (S) and covariance (S, S) (forecast.cu documents the closed form)
// and writes the N observation means and variances of horizon h at
// means_out[o0 + a] and vars_out[o0 + a].  horizons_block runs it for
// every horizon of a set, and gram_block reconstitutes a covariance
// F F' from a square-root factor: K18 and K16 call the same two
// functions on the same row values, so a read-path snapshot and a
// compute-path read of one row agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace forecastk {

template <typename T>
__host__ __device__ inline size_t smem_elems(int N, int S) {
  return (size_t)S * S + 2 * (size_t)N * S + (size_t)S;
}

template <typename T>
__device__ void moments_block(unsigned char* smem_raw,
                              const T* __restrict__ phib,
                              const T* __restrict__ qb,
                              const T* __restrict__ zb,
                              const T* __restrict__ rb,
                              const T* __restrict__ meanb,
                              const T* __restrict__ covb, T h,
                              T* __restrict__ means_out,
                              T* __restrict__ vars_out, size_t o0, int N,
                              int S) {
  T* Ph = reinterpret_cast<T*>(smem_raw);  // S*S state covariance at h
  T* Zs = Ph + S * S;                       // N*S observation matrix
  T* W = Zs + N * S;                        // N*S: (Z P_h) o Z
  T* mh = W + N * S;                        // S state mean at h
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  for (int i = tid; i < N * S; i += nt) Zs[i] = zb[i];
  for (int i = tid; i < S; i += nt) mh[i] = pow(phib[i], h) * meanb[i];
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
    means_out[o0 + a] = mu;
    vars_out[o0 + a] = (var > T(0) ? var : T(0)) + rb[a];
  }
}

// C = F F' of one (S, S) row-major factor, one entry per thread
template <typename T>
__device__ void gram_block(const T* __restrict__ F, T* __restrict__ C,
                           int S) {
  for (int idx = threadIdx.x; idx < S * S; idx += blockDim.x) {
    const int i = idx / S, j = idx - (idx / S) * S;
    T acc = 0;
    for (int c = 0; c < S; ++c) acc += F[i * S + c] * F[j * S + c];
    C[idx] = acc;
  }
}

// moments_block for each of the H horizons, writing rows (b, hi) of the
// (G, H, N) outputs; smem_raw holds smem_elems(N, S) scratch elements
template <typename T>
__device__ void horizons_block(unsigned char* smem_raw,
                               const T* __restrict__ phib,
                               const T* __restrict__ qb,
                               const T* __restrict__ zb,
                               const T* __restrict__ rb,
                               const T* __restrict__ meanb,
                               const T* __restrict__ covb,
                               const T* __restrict__ horizons, int H,
                               T* __restrict__ means_out,
                               T* __restrict__ vars_out, int b, int N,
                               int S) {
  for (int hi = 0; hi < H; ++hi) {
    moments_block<T>(smem_raw, phib, qb, zb, rb, meanb, covb, horizons[hi],
                     means_out, vars_out, ((size_t)b * H + hi) * N, N, S);
    __syncthreads();
  }
}

}  // namespace forecastk
