// The mean half of the commit-time horizon pass, one warp per model,
// shared by the horizons modes of K14 (steady_filter.cu) and K17
// (arena_steady.cu).
//
// Replaces the JAX package's metran_tpu/serve/engine.py::
// _steady_horizon_means (:856): a frozen model's covariance never
// changes, so its horizon variances are a constant cached at freeze, and
// a commit recomputes only the means
//   means[hi, a] = sum_j Z[a, j] (phi_j^h m_j),  h = horizons[hi],
// in K2's operations and order (forecast_step.cuh's moments_block forms
// phi^h o m the same way and sums over j in the same order), so the mean
// of a frozen row's snapshot equals a compute-path read of its row bit
// for bit.  h is read as a value: any horizon set, not only 1..H.
//
// What bounds it on an H100: bytes and latency — H (S + N S) operations
// a model against H N words written; the warp loops the horizons, the
// lanes the states for phi^h o m and the slots for the sums.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace horizonk {

// the shared memory the pass adds to its caller's (elements): phi^h o m
__host__ __device__ inline size_t smem_elems(int S) { return (size_t)S; }

// one warp: the means of model b at each of the H horizons into
// out[(b * H + hi) * N + a]; phi (S) and the mean m (S) in any memory, Z
// (N, S) row-major (the caller's shared copy), mh: S shared elements
template <typename T>
__device__ void means_warp(const T* __restrict__ phi,
                           const T* __restrict__ m,
                           const T* __restrict__ Z,
                           const T* __restrict__ horizons, int H,
                           T* __restrict__ mh, T* __restrict__ out, int b,
                           int N, int S) {
  const int lane = threadIdx.x;
  const int nt = blockDim.x;
  for (int hi = 0; hi < H; ++hi) {
    const T h = horizons[hi];
    for (int j = lane; j < S; j += nt) mh[j] = pow(phi[j], h) * m[j];
    __syncwarp();
    for (int a = lane; a < N; a += nt) {
      T mu = 0;
      for (int j = 0; j < S; ++j) mu += mh[j] * Z[a * S + j];
      out[((size_t)b * H + hi) * N + a] = mu;
    }
    __syncwarp();
  }
}

}  // namespace horizonk
