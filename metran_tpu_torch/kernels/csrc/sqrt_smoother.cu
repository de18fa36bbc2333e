// K10: the factored Rauch-Tung-Striebel smoother, one block per lane.
//
// Replaces the JAX package's device program B6 in metran_tpu/ops/kalman.py,
// sqrt_rts_smoother (the reverse lax.scan of the square-root engine over
// the factors of sqrt_kalman_filter(store=True)): the smoother behind the
// single-model products of Metran on engine="sqrt" and the per-draw
// smoothings of sample_states(engine="sqrt").
//
// Per lane, from (m_f, S_f) at T-1 down to t = 0, with the carry
// (m_s', S_s') the smoothed moments at t+1 and (m_p, S_p) the predicted
// ones at t+1 (K9's store):
//   ok   = every diag(S_p) > 0 and every entry of S_p finite;
//   G    = P_f diag(phi) (S_p S_p')^-1, row i by two triangular solves
//          against S_p (P_f = S_f S_f');
//   m_s  = m_f + G (m_s' - m_p);
//   S_s  = tria([(I - G diag(phi)) S_f | G diag(sqrt q) | G S_s'])
//          (QR of the 3n x n transpose, sign-normalised; the Joseph-like
//          sum of three PSD terms, PSD by construction);
//   if not ok: (m_s, S_s) = (m_f, S_f), carry included.
// The last step is (m_f, S_f).  With chol_s null (the mean-only smoothings
// of the path draws) the tria is skipped: the mean recursion never reads
// S_s, so this is exact.
//
// Layouts, lane-major: phi, q (L, n) (q the diagonal of Q); mean_f,
// mean_p (L, T, n); chol_f, chol_p (L, T, n, n); outputs mean_s (L, T, n),
// chol_s (L, T, n, n).
//
// What bounds it on an H100: latency.  Per step three n^3 products, two
// chains of n^2 dependent multiply-adds per thread (the solves) and n
// Householder stages over 3n rows, one block barrier each.  One lane's
// matrices (S_f, S_p, P_f, G, the carry S_s', the 3n x n stack) live in
// shared memory, one block per lane, the reverse time loop inside the
// kernel: one smoothing is one launch, and device memory is touched only
// to read each step's stored factors once and write the outputs once.

#include "sqrt_qr.cuh"

namespace {

constexpr int kThreads = 128;

__host__ __device__ inline size_t smem_elems(int n) {
  return (size_t)5 * n * n + (size_t)sqrtqr::odd_ld(3 * n) * n + 6 * n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sqrt_smoother_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                     const T* __restrict__ mean_f, const T* __restrict__ chol_f,
                     const T* __restrict__ mean_p, const T* __restrict__ chol_p,
                     T* __restrict__ mean_s, T* __restrict__ chol_s,
                     int t_steps, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nn = n * n;
  const int ld3 = sqrtqr::odd_ld(3 * n);
  T* Cf = reinterpret_cast<T*>(smem_raw);  // S_f at t
  T* Sp = Cf + nn;                          // S_p at t+1
  T* Pf = Sp + nn;                          // S_f S_f'
  T* G = Pf + nn;
  T* Cn = G + nn;                           // carry: S_s at t+1
  T* M = Cn + nn;                           // the 3n x n stack, column-major
  T* ms = M + (size_t)ld3 * n;              // carry: m_s at t+1
  T* mf = ms + n;
  T* dm = mf + n;
  T* ph = dm + n;
  T* qs = ph + n;
  T* dg = qs + n;
  __shared__ int bad;
  const bool want_cov = chol_s != nullptr;

  if (t_steps == 0) return;
  for (int a = tid; a < n; a += kThreads) {
    ph[a] = phi[(size_t)l * n + a];
    const T qa = q[(size_t)l * n + a];
    qs[a] = sqrt(qa > T(0) ? qa : T(0));
  }
  const size_t lane_n = (size_t)l * t_steps * n;
  {  // the last step: smoothed = filtered
    const size_t o = lane_n + (size_t)(t_steps - 1) * n;
    for (int a = tid; a < n; a += kThreads) {
      ms[a] = mean_f[o + a];
      mean_s[o + a] = ms[a];
    }
    for (int idx = tid; idx < nn; idx += kThreads) {
      Cn[idx] = chol_f[o * n + idx];
      if (want_cov) chol_s[o * n + idx] = Cn[idx];
    }
  }
  __syncthreads();

  for (int t = t_steps - 2; t >= 0; --t) {
    const size_t of = lane_n + (size_t)t * n;
    const size_t op = lane_n + (size_t)(t + 1) * n;
    for (int a = tid; a < n; a += kThreads) {
      mf[a] = mean_f[of + a];
      dm[a] = ms[a] - mean_p[op + a];
    }
    if (tid == 0) bad = 0;
    __syncthreads();
    for (int idx = tid; idx < nn; idx += kThreads) {
      Cf[idx] = chol_f[of * n + idx];
      const T v = chol_p[op * n + idx];
      Sp[idx] = v;
      if (!isfinite(v) || (idx / n == idx % n && !(v > T(0)))) bad = 1;
    }
    __syncthreads();
    if (!bad) {
      for (int idx = tid; idx < nn; idx += kThreads) {  // P_f = S_f S_f'
        const int a = idx / n, b = idx % n;
        T s = 0;
        for (int k = 0; k < n; ++k) s += Cf[a * n + k] * Cf[b * n + k];
        Pf[idx] = s;
      }
      __syncthreads();
      // row i of G: S_p y = diag(phi) P_f[:, i], then S_p' g_i = y
      for (int i = tid; i < n; i += kThreads) {
        T* g = G + i * n;
        for (int k = 0; k < n; ++k) {
          T s = ph[k] * Pf[k * n + i];
          for (int j = 0; j < k; ++j) s -= Sp[k * n + j] * g[j];
          g[k] = s / Sp[k * n + k];
        }
        for (int k = n - 1; k >= 0; --k) {
          T s = g[k];
          for (int j = k + 1; j < n; ++j) s -= Sp[j * n + k] * g[j];
          g[k] = s / Sp[k * n + k];
        }
      }
      __syncthreads();
      for (int a = tid; a < n; a += kThreads) {  // m_s = m_f + G dm
        T s = mf[a];
        for (int b = 0; b < n; ++b) s += G[a * n + b] * dm[b];
        mf[a] = s;
      }
      if (want_cov) {
        // M' (3n x n): rows r < n  ((I - G Phi) S_f)[c, r]
        //              rows n + r  G[c, r] sqrt(q_r)
        //              rows 2n + r (G S_s')[c, r]
        for (int idx = tid; idx < 3 * nn; idx += kThreads) {
          const int c = idx / (3 * n), row = idx % (3 * n);
          T v;
          if (row < n) {
            v = Cf[c * n + row];
            for (int k = 0; k < n; ++k)
              v -= G[c * n + k] * ph[k] * Cf[k * n + row];
          } else if (row < 2 * n) {
            v = G[c * n + row - n] * qs[row - n];
          } else {
            const int rr = row - 2 * n;
            v = T(0);
            for (int k = 0; k < n; ++k) v += G[c * n + k] * Cn[k * n + rr];
          }
          M[c * ld3 + row] = v;
        }
        __syncthreads();
        sqrtqr::house_qr<T, kThreads>(M, ld3, 3 * n, n, 0, 3 * n, dg);
        for (int idx = tid; idx < nn; idx += kThreads) {
          const int a = idx / n, b = idx % n;  // S_s[a, b] = sign_b R[b, a]
          T v = T(0);
          if (a == b)
            v = dg[b] * sqrtqr::row_sign(dg[b]);
          else if (a > b)
            v = M[a * ld3 + b] * sqrtqr::row_sign(dg[b]);
          Cn[idx] = v;
        }
      }
    } else {
      for (int idx = tid; idx < nn; idx += kThreads) Cn[idx] = Cf[idx];
    }
    __syncthreads();
    for (int a = tid; a < n; a += kThreads) {
      ms[a] = mf[a];
      mean_s[of + a] = mf[a];
    }
    if (want_cov)
      for (int idx = tid; idx < nn; idx += kThreads)
        chol_s[of * n + idx] = Cn[idx];
    __syncthreads();
  }
}

template <typename T>
int launch_sqrt_smoother(const void* phi, const void* q, const void* mean_f,
                         const void* chol_f, const void* mean_p,
                         const void* chol_p, void* mean_s, void* chol_s, int L,
                         int t_steps, int n, void* stream) {
  const size_t smem = smem_elems(n) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sqrt_smoother_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (L == 0 || t_steps == 0) return 0;
  sqrt_smoother_kernel<T><<<L, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)phi, (const T*)q, (const T*)mean_f, (const T*)chol_f,
      (const T*)mean_p, (const T*)chol_p, (T*)mean_s, (T*)chol_s, t_steps, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int metran_sqrt_smoother_f32(const void* phi, const void* q,
                             const void* mean_f, const void* chol_f,
                             const void* mean_p, const void* chol_p,
                             void* mean_s, void* chol_s, int L, int t_steps,
                             int n, void* stream) {
  return launch_sqrt_smoother<float>(phi, q, mean_f, chol_f, mean_p, chol_p,
                                     mean_s, chol_s, L, t_steps, n, stream);
}

int metran_sqrt_smoother_f64(const void* phi, const void* q,
                             const void* mean_f, const void* chol_f,
                             const void* mean_p, const void* chol_p,
                             void* mean_s, void* chol_s, int L, int t_steps,
                             int n, void* stream) {
  return launch_sqrt_smoother<double>(phi, q, mean_f, chol_f, mean_p, chol_p,
                                      mean_s, chol_s, L, t_steps, n, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
