// K8: the Rauch-Tung-Striebel smoother's backward pass, one block per lane.
//
// Replaces the JAX package's device program B5,
// metran_tpu/ops/kalman.py::rts_smoother (the reverse lax.scan over the
// stored moments of kalman_filter(store=True)): the smoother behind the
// single-model products of Metran (state means and variances, simulations,
// decompositions) and the per-draw smoothings of sample_states.
//
// Per lane, from the stored filter (K6 in its store mode) and the diagonal
// transition phi, with the carry (m_s', C_s') the smoothed moments at t+1,
// from (m_f, P_f) at T-1 down to t = 0:
//   L L' = P_p,t+1                          Cholesky, column by column;
//   G    = P_f diag(phi) P_p,t+1^-1         row i of G by two triangular
//                                           solves against row i of
//                                           P_f diag(phi);
//   m_s  = m_f + G (m_s' - m_p,t+1)
//   C_s  = P_f + G (C_s' - P_p,t+1) G'
// A pivot that is not positive (or not finite) makes the step's `ok` false,
// as jnp.linalg.cholesky's NaN does in the JAX function: that step's
// smoothed moments, and the carry, are then the filtered ones.  The last
// step is m_s = m_f, C_s = P_f.  Outputs are lane-major, (L, T, n) and
// (L, T, n, n); cov_s may be null (the mean-only smoothings of the path
// draws), and is then not written.
//
// What bounds it on an H100: latency.  Per step ~n^3/3 + 3 n^3 operations
// on matrices of a few KB, each stage waiting on the last: the Cholesky
// takes one block barrier per column (n per step), the solves a chain of
// n^2 dependent multiply-adds per thread.  The design keeps one lane's
// five n x n matrices (the carry C_s', P_f, L, C_s' - P_p, G) and four
// n-vectors in shared memory, one block per lane (so a draw chunk of 16
// lanes is 16 blocks), with the reverse time loop inside the kernel: one
// smoothing is one launch, and device memory is touched only to read each
// step's stored moments once and to write its outputs once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rts_smoother_kernel(const T* __restrict__ phi, const T* __restrict__ mean_f,
                    const T* __restrict__ cov_f, const T* __restrict__ mean_p,
                    const T* __restrict__ cov_p, T* __restrict__ mean_s,
                    T* __restrict__ cov_s, int t_steps, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nn = n * n;
  T* C = reinterpret_cast<T*>(smem_raw);  // carry: C_s at t+1
  T* Pf = C + nn;
  T* Lc = Pf + nn;  // P_p,t+1, factorized in place; later G D
  T* D = Lc + nn;   // C_s' - P_p,t+1
  T* G = D + nn;
  T* ms = G + nn;  // carry: m_s at t+1
  T* mf = ms + n;
  T* dm = mf + n;  // m_s' - m_p,t+1
  T* ph = dm + n;
  __shared__ int ok;

  const size_t lane_n = (size_t)l * t_steps * n;
  const size_t lane_nn = lane_n * n;
  if (t_steps == 0) return;
  for (int a = tid; a < n; a += kThreads) ph[a] = phi[(size_t)l * n + a];
  // the last step: smoothed = filtered
  {
    const size_t o = lane_n + (size_t)(t_steps - 1) * n;
    for (int a = tid; a < n; a += kThreads) {
      ms[a] = mean_f[o + a];
      mean_s[o + a] = ms[a];
    }
    for (int idx = tid; idx < nn; idx += kThreads) {
      C[idx] = cov_f[o * n + idx];
      if (cov_s != nullptr) cov_s[o * n + idx] = C[idx];
    }
  }
  __syncthreads();

  for (int t = t_steps - 2; t >= 0; --t) {
    const size_t of = lane_n + (size_t)t * n;         // step t
    const size_t op = lane_n + (size_t)(t + 1) * n;   // step t+1
    for (int a = tid; a < n; a += kThreads) {
      mf[a] = mean_f[of + a];
      dm[a] = ms[a] - mean_p[op + a];
    }
    for (int idx = tid; idx < nn; idx += kThreads) {
      Pf[idx] = cov_f[of * n + idx];
      const T pp = cov_p[op * n + idx];
      Lc[idx] = pp;
      D[idx] = C[idx] - pp;
    }
    if (tid == 0) ok = 1;
    __syncthreads();

    // Cholesky, left-looking: for column j every thread forms the pivot
    // d = a_jj - sum L_jk^2 itself; thread i > j forms its entry of the
    // column, (a_ij - sum L_ik L_jk) / sqrt(d).  One barrier per column.
    for (int j = 0; j < n; ++j) {
      T d = Lc[j * n + j];
      for (int k = 0; k < j; ++k) d -= Lc[j * n + k] * Lc[j * n + k];
      const bool good = d > T(0) && isfinite(d);
      const T piv = good ? sqrt(d) : T(1);
      for (int i = j + 1 + tid; i < n; i += kThreads) {
        T s = Lc[i * n + j];
        for (int k = 0; k < j; ++k) s -= Lc[i * n + k] * Lc[j * n + k];
        const T v = s / piv;
        Lc[i * n + j] = v;
        if (!isfinite(v)) ok = 0;
      }
      __syncthreads();
      if (tid == 0) {
        if (!good) ok = 0;
        Lc[j * n + j] = piv;
      }
      __syncthreads();
    }

    if (ok) {
      // row i of G: solve L y = a_i, then L' g_i = y, with
      // a_i = row i of P_f diag(phi)
      for (int i = tid; i < n; i += kThreads) {
        T* g = G + i * n;
        for (int k = 0; k < n; ++k) {
          T s = Pf[i * n + k] * ph[k];
          for (int m = 0; m < k; ++m) s -= Lc[k * n + m] * g[m];
          g[k] = s / Lc[k * n + k];
        }
        for (int k = n - 1; k >= 0; --k) {
          T s = g[k];
          for (int m = k + 1; m < n; ++m) s -= Lc[m * n + k] * g[m];
          g[k] = s / Lc[k * n + k];
        }
      }
      __syncthreads();
      // m_s = m_f + G dm; W = G D into Lc (L is no longer needed)
      for (int a = tid; a < n; a += kThreads) {
        T s = mf[a];
        for (int b = 0; b < n; ++b) s += G[a * n + b] * dm[b];
        mf[a] = s;
      }
      for (int idx = tid; idx < nn; idx += kThreads) {
        const int a = idx / n, b = idx % n;
        T s = 0;
        for (int k = 0; k < n; ++k) s += G[a * n + k] * D[k * n + b];
        Lc[idx] = s;
      }
      __syncthreads();
      // C_s = P_f + W G'
      for (int idx = tid; idx < nn; idx += kThreads) {
        const int a = idx / n, b = idx % n;
        T s = 0;
        for (int k = 0; k < n; ++k) s += Lc[a * n + k] * G[b * n + k];
        C[idx] = Pf[idx] + s;
      }
    } else {
      for (int idx = tid; idx < nn; idx += kThreads) C[idx] = Pf[idx];
    }
    __syncthreads();
    for (int a = tid; a < n; a += kThreads) {
      ms[a] = mf[a];
      mean_s[of + a] = mf[a];
    }
    if (cov_s != nullptr)
      for (int idx = tid; idx < nn; idx += kThreads)
        cov_s[of * n + idx] = C[idx];
    __syncthreads();
  }
}

template <typename T>
int launch_rts_smoother(const void* phi, const void* mean_f, const void* cov_f,
                        const void* mean_p, const void* cov_p, void* mean_s,
                        void* cov_s, int L, int t_steps, int n, void* stream) {
  const size_t smem = (size_t)(5 * n * n + 4 * n) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rts_smoother_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (L == 0 || t_steps == 0) return 0;
  rts_smoother_kernel<T><<<L, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)phi, (const T*)mean_f, (const T*)cov_f, (const T*)mean_p,
      (const T*)cov_p, (T*)mean_s, (T*)cov_s, t_steps, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int metran_rts_smoother_f32(const void* phi, const void* mean_f,
                            const void* cov_f, const void* mean_p,
                            const void* cov_p, void* mean_s, void* cov_s,
                            int L, int t_steps, int n, void* stream) {
  return launch_rts_smoother<float>(phi, mean_f, cov_f, mean_p, cov_p, mean_s,
                                    cov_s, L, t_steps, n, stream);
}

int metran_rts_smoother_f64(const void* phi, const void* mean_f,
                            const void* cov_f, const void* mean_p,
                            const void* cov_p, void* mean_s, void* cov_s,
                            int L, int t_steps, int n, void* stream) {
  return launch_rts_smoother<double>(phi, mean_f, cov_f, mean_p, cov_p,
                                     mean_s, cov_s, L, t_steps, n, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
