// K11: the closed-form reverse sweep of the batch-layout deviance, one
// thread block per model.
//
// Replaces the JAX package's device program B7,
// metran_tpu/ops/adjoint.py::_terms_bwd (its replay_step and step_bwd,
// over the segments _run_segments keeps), which the JAX package runs per
// model under vmap as the custom-vjp backward of every batch-layout fit.
// For each model and each segment of `seg` steps, last segment first:
//   replay   from the segment's boundary carry (m, P) (a square-root
//            boundary S enters as P = S S', once), the covariance-form
//            joint predict + update of every step,
//              m_p = phi o m,  P_p = (phi phi') o P + diag(q),
//              F = Z_m P_p Z_m' + diag(r o mask + 1 - mask) = L L',
//              K' = F^-1 (Z_m P_p),  e = F^-1 v,  L^-1 Z_m,
//              m_f = m_p + K v,  P_f = P_p - K (Z_m P_p)',
//            keeping per step the pre-predict (m, P), K', L^-1 Z_m, e and
//            ok in a global scratch buffer (one segment per model);
//   sweep    back over the segment with the adjoints (u, S) of the
//            filtered moments and the step's cotangents (sb, db),
//              w = Z_m'e,  A'u = u - Z_m'(K'u),  SA = S - (S K) Z_m,
//              A'SA = SA - Z_m'(K' SA),
//              u_p = A'u - 2 sb w,
//              S_p = A'SA + db (L^-1 Z_m)'(L^-1 Z_m) - sb w w' + (A'u) w',
//            then the diagonal-predict adjoint
//              phibar += u_p o m + (S_p o P) phi + (S_p o P)' phi,
//              qbar += diag S_p,  u = u_p o phi,  S = S_p o (phi phi').
// `ok` is JAX's rule and K1's: a Cholesky pivot that is not positive and
// finite, or a factor entry that is not finite, makes the step degraded;
// a degraded step (and a step with no observed slot, whose sweep is the
// identity exactly) passes (u, S) through.  Outputs: phibar, qbar (B, n).
//
// What bounds it on an H100: latency, as K1.  A step is ~0.2 MFLOP at the
// flagship shape (n = 21 states, N = 20 series) over a few KB of state: a
// chain of dependent block-wide phases (a right-looking Cholesky, two
// triangular solves on a combined right-hand side [Z_m P_p | Z_m | v]
// with one barrier per column, then about a dozen small matrix products),
// ~4N + 16 barriers a step.  The design keeps one model's constants and
// every work matrix in shared memory and the time loop inside the kernel,
// so a fleet's backward pass is one launch; device memory sees the data,
// the boundaries and the cotangents once, and the replay scratch
// (n + n^2 + 2nN + N + 1 values a step) is written once and read once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Smem {
  T *zs, *rr, *ph, *qd;         // Z (N x n), r (N), phi, q (n)
  T *P, *S, *SA, *P0, *W;       // n x n: carry, adjoint, S A, p0, S_p
  T *PZ, *KT, *LZ, *SK, *KS;    // P_p Z_m', S K (n x N); K', L^-1 Z_m,
                                // K' SA (N x n)
  T *L;                         // N x N: F, then its Cholesky factor
  T *m, *m0, *u, *w, *au, *up;  // n
  T *phib, *qb;                 // n
  T *v, *e, *ku, *msk, *rd;     // N
};

// the layout of one block's dynamic shared memory (with s null, only its
// size): returns the bytes it takes; mirrors smem_bytes in the wrapper
template <typename T>
__host__ __device__ size_t carve(unsigned char* base, int N, int n,
                                 Smem<T>* s) {
  const size_t nn = (size_t)n * n, nN = (size_t)n * N, NN = (size_t)N * N;
  constexpr int kBufs = 26;
  const size_t counts[kBufs] = {nN, (size_t)N, (size_t)n, (size_t)n,
                                nn, nn, nn, nn, nn,
                                nN, nN, nN, nN, nN,
                                NN,
                                (size_t)n, (size_t)n, (size_t)n, (size_t)n,
                                (size_t)n, (size_t)n, (size_t)n, (size_t)n,
                                (size_t)N, (size_t)N, (size_t)N};
  size_t used = 0;
  T* p = reinterpret_cast<T*>(base);
  for (int k = 0; k < kBufs; ++k) {
    if (s != nullptr) {
      T** slots[kBufs] = {&s->zs, &s->rr, &s->ph, &s->qd, &s->P, &s->S,
                          &s->SA, &s->P0, &s->W, &s->PZ, &s->KT, &s->LZ,
                          &s->SK, &s->KS, &s->L, &s->m, &s->m0, &s->u,
                          &s->w, &s->au, &s->up, &s->phib, &s->qb, &s->v,
                          &s->e, &s->ku};
      *slots[k] = p + used;
    }
    used += counts[k];
  }
  if (s != nullptr) {
    s->msk = p + used;
    s->rd = p + used + N;
  }
  used += 2 * (size_t)N;  // msk, rd
  return used * sizeof(T);
}

// right-looking Cholesky of the N x N matrix in L (lower triangle), K1's
// algorithm; returns the block-uniform verdict (every pivot positive and
// finite, every entry of the factor finite)
template <typename T>
__device__ bool block_cholesky(T* L, int N, int* ok_s) {
  const int tid = threadIdx.x;
  if (tid == 0) *ok_s = 1;
  __syncthreads();
  for (int c = 0; c < N; ++c) {
    const T d = L[c * N + c];
    if (!(d > T(0)) || !isfinite(d)) {  // block-uniform verdict
      if (tid == 0) *ok_s = 0;
      break;
    }
    const T sq = sqrt(d);
    for (int rr = c + 1 + tid; rr < N; rr += kThreads) L[rr * N + c] /= sq;
    __syncthreads();
    if (tid == 0) L[c * N + c] = sq;
    const int n2 = N - c - 1;
    for (int idx = tid; idx < n2 * n2; idx += kThreads) {
      const int rr = c + 1 + idx / n2, cc = c + 1 + idx % n2;
      if (cc <= rr) L[rr * N + cc] -= L[rr * N + c] * L[cc * N + c];
    }
    __syncthreads();
  }
  __syncthreads();
  for (int idx = tid; idx < N * N; idx += kThreads) {
    const int a = idx / N, c = idx - a * N;
    if (c <= a && !isfinite(L[idx])) *ok_s = 0;
  }
  __syncthreads();
  return *ok_s != 0;
}

// the column `col` of the combined right-hand side [K' | L^-1 Z_m | e]
// (N x (2n + 1)), row a
template <typename T>
__device__ __forceinline__ T& rhs(const Smem<T>& s, int n, int a, int col) {
  return col < n ? s.KT[a * n + col]
                 : (col < 2 * n ? s.LZ[a * n + col - n] : s.e[a]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
joint_adjoint_kernel(const T* __restrict__ phi, const T* __restrict__ qdiag,
                     const T* __restrict__ z, const T* __restrict__ r,
                     const T* __restrict__ y, const uint8_t* __restrict__ mask,
                     const T* __restrict__ bounds_mean,
                     const T* __restrict__ bounds_cov,
                     const T* __restrict__ sb, const T* __restrict__ db,
                     T* __restrict__ scratch, T* __restrict__ phibar,
                     T* __restrict__ qbar, int t_steps, int N, int n,
                     int seg, int factored) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> s;
  carve<T>(smem_raw, N, n, &s);
  __shared__ int ok_s, has_obs_s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nn = n * n, nN = n * N;
  const int n_seg = (t_steps + seg - 1) / seg;
  const int seg_len = seg < t_steps ? seg : t_steps;
  const int stride = n + nn + 2 * nN + N + 1;
  T* scr = scratch + (size_t)b * seg_len * stride;

  for (int idx = tid; idx < nN; idx += kThreads)
    s.zs[idx] = z[(size_t)b * nN + idx];  // z[b, a, i], idx = a * n + i
  for (int a = tid; a < N; a += kThreads) s.rr[a] = r[(size_t)b * N + a];
  for (int i = tid; i < n; i += kThreads) {
    s.ph[i] = phi[(size_t)b * n + i];
    s.qd[i] = qdiag[(size_t)b * n + i];
    s.u[i] = T(0);
    s.phib[i] = T(0);
    s.qb[i] = T(0);
  }
  for (int idx = tid; idx < nn; idx += kThreads) s.S[idx] = T(0);
  __syncthreads();

  for (int k = n_seg - 1; k >= 0; --k) {
    const int t0 = k * seg;
    const int t1 = t0 + seg < t_steps ? t0 + seg : t_steps;
    // ---- the segment's boundary carry
    const T* bm = bounds_mean + ((size_t)b * n_seg + k) * n;
    const T* bc = bounds_cov + ((size_t)b * n_seg + k) * nn;
    for (int i = tid; i < n; i += kThreads) s.m[i] = bm[i];
    for (int idx = tid; idx < nn; idx += kThreads) {
      if (factored) {  // P = S S'
        const int i = idx / n, j = idx - i * n;
        T acc = 0;
        for (int l = 0; l < n; ++l) acc += bc[i * n + l] * bc[j * n + l];
        s.P[idx] = acc;
      } else {
        s.P[idx] = bc[idx];
      }
    }
    __syncthreads();

    // ---- replay the segment forward, keeping what the sweep reads
    for (int t = t0; t < t1; ++t) {
      T* st = scr + (size_t)(t - t0) * stride;
      const size_t row = ((size_t)b * t_steps + t) * N;
      if (tid == 0) has_obs_s = 0;
      // the pre-predict carry, then the predict in place (each thread
      // owns its entries)
      for (int i = tid; i < n; i += kThreads) {
        st[i] = s.m[i];
        s.m[i] = s.ph[i] * s.m[i];
      }
      for (int idx = tid; idx < nn; idx += kThreads) {
        const int i = idx / n, j = idx - i * n;
        st[n + idx] = s.P[idx];
        s.P[idx] = s.ph[i] * s.P[idx] * s.ph[j] + (i == j ? s.qd[i] : T(0));
      }
      for (int a = tid; a < N; a += kThreads)
        s.msk[a] = mask[row + a] ? T(1) : T(0);
      __syncthreads();
      // innovation (Z unmasked, as the JAX replay) and P_p Z_m'
      for (int a = tid; a < N; a += kThreads) {
        T acc = 0;
        for (int j = 0; j < n; ++j) acc += s.zs[a * n + j] * s.m[j];
        s.v[a] = mask[row + a] ? y[row + a] - acc : T(0);
        if (mask[row + a]) has_obs_s = 1;
      }
      for (int idx = tid; idx < nN; idx += kThreads) {
        const int i = idx / N, a = idx - i * N;
        T acc = 0;
        for (int j = 0; j < n; ++j)
          acc += s.P[i * n + j] * (s.zs[a * n + j] * s.msk[a]);
        s.PZ[idx] = acc;
      }
      __syncthreads();
      if (!has_obs_s) {  // block-uniform: the update is the identity
        if (tid == 0) st[stride - 1] = T(2);
        __syncthreads();
        continue;
      }
      // F = Z_m (P_p Z_m') + diag(r o mask + 1 - mask)
      for (int idx = tid; idx < N * N; idx += kThreads) {
        const int a = idx / N, c = idx - a * N;
        T acc = 0;
        for (int i = 0; i < n; ++i)
          acc += (s.zs[a * n + i] * s.msk[a]) * s.PZ[i * N + c];
        if (a == c)
          acc += (s.msk[a] != T(0) ? s.rr[a] : T(0)) + (T(1) - s.msk[a]);
        s.L[idx] = acc;
      }
      __syncthreads();
      if (!block_cholesky(s.L, N, &ok_s)) {  // degraded: m_p, P_p carry
        if (tid == 0) st[stride - 1] = T(0);
        __syncthreads();
        continue;
      }
      // the right-hand side [(P_p Z_m')' | Z_m | v] and the reciprocal
      // pivots
      for (int idx = tid; idx < nN; idx += kThreads) {
        const int a = idx / n, i = idx - a * n;
        s.KT[idx] = s.PZ[i * N + a];
        s.LZ[idx] = s.zs[idx] * s.msk[a];
      }
      for (int a = tid; a < N; a += kThreads) {
        s.e[a] = s.v[a];
        s.rd[a] = T(1) / s.L[a * N + a];
      }
      __syncthreads();
      // forward substitution L Y = X, right-looking, unnormalised rows:
      // one barrier per column, then every row divided by its pivot
      const int ncol = 2 * n + 1;
      for (int c = 0; c < N - 1; ++c) {
        const int rows = N - 1 - c;
        for (int idx = tid; idx < rows * ncol; idx += kThreads) {
          const int a = c + 1 + idx / ncol, col = idx % ncol;
          rhs(s, n, a, col) -= s.L[a * N + c] * s.rd[c] * rhs(s, n, c, col);
        }
        __syncthreads();
      }
      for (int idx = tid; idx < N * ncol; idx += kThreads) {
        const int a = idx / ncol, col = idx % ncol;
        rhs(s, n, a, col) *= s.rd[a];
      }
      __syncthreads();
      // back substitution L' Z = Y on the K' and e columns
      for (int c = N - 1; c > 0; --c) {
        for (int idx = tid; idx < c * (n + 1); idx += kThreads) {
          const int a = idx / (n + 1), cc = idx % (n + 1);
          const int col = cc < n ? cc : 2 * n;
          rhs(s, n, a, col) -= s.L[c * N + a] * s.rd[c] * rhs(s, n, c, col);
        }
        __syncthreads();
      }
      for (int idx = tid; idx < N * (n + 1); idx += kThreads) {
        const int a = idx / (n + 1), cc = idx % (n + 1);
        rhs(s, n, a, cc < n ? cc : 2 * n) *= s.rd[a];
      }
      __syncthreads();
      // m_f = m_p + K v, P_f = P_p - K (P_p Z_m')'; store K', L^-1 Z_m, e
      for (int i = tid; i < n; i += kThreads) {
        T acc = 0;
        for (int a = 0; a < N; ++a) acc += s.KT[a * n + i] * s.v[a];
        s.m[i] = s.m[i] + acc;
      }
      for (int idx = tid; idx < nn; idx += kThreads) {
        const int i = idx / n, j = idx - i * n;
        T acc = 0;
        for (int a = 0; a < N; ++a) acc += s.KT[a * n + i] * s.PZ[j * N + a];
        s.P[idx] = s.P[idx] - acc;
      }
      T* st_k = st + n + nn;
      for (int idx = tid; idx < nN; idx += kThreads) {
        st_k[idx] = s.KT[idx];
        st_k[nN + idx] = s.LZ[idx];
      }
      for (int a = tid; a < N; a += kThreads) st_k[2 * nN + a] = s.e[a];
      if (tid == 0) st[stride - 1] = T(1);
      __syncthreads();
    }

    // ---- sweep the segment backward
    for (int t = t1 - 1; t >= t0; --t) {
      const T* st = scr + (size_t)(t - t0) * stride;
      const size_t row = ((size_t)b * t_steps + t) * N;
      const int okv = (int)st[stride - 1];
      const T sb_t = sb[(size_t)b * t_steps + t];
      const T db_t = db[(size_t)b * t_steps + t];
      for (int i = tid; i < n; i += kThreads) s.m0[i] = st[i];
      for (int idx = tid; idx < nn; idx += kThreads) s.P0[idx] = st[n + idx];
      if (okv == 1) {
        const T* st_k = st + n + nn;
        for (int idx = tid; idx < nN; idx += kThreads) {
          s.KT[idx] = st_k[idx];
          s.LZ[idx] = st_k[nN + idx];
        }
        for (int a = tid; a < N; a += kThreads) {
          s.e[a] = st_k[2 * nN + a];
          s.msk[a] = mask[row + a] ? T(1) : T(0);
        }
      }
      __syncthreads();
      if (okv == 1) {
        // w = Z_m'e, K'u, S K
        for (int i = tid; i < n; i += kThreads) {
          T acc = 0;
          for (int a = 0; a < N; ++a)
            acc += (s.zs[a * n + i] * s.msk[a]) * s.e[a];
          s.w[i] = acc;
        }
        for (int a = tid; a < N; a += kThreads) {
          T acc = 0;
          for (int i = 0; i < n; ++i) acc += s.KT[a * n + i] * s.u[i];
          s.ku[a] = acc;
        }
        for (int idx = tid; idx < nN; idx += kThreads) {
          const int i = idx / N, a = idx - i * N;
          T acc = 0;
          for (int j = 0; j < n; ++j) acc += s.S[i * n + j] * s.KT[a * n + j];
          s.SK[idx] = acc;
        }
        __syncthreads();
        // A'u, S A
        for (int i = tid; i < n; i += kThreads) {
          T acc = 0;
          for (int a = 0; a < N; ++a)
            acc += (s.zs[a * n + i] * s.msk[a]) * s.ku[a];
          s.au[i] = s.u[i] - acc;
        }
        for (int idx = tid; idx < nn; idx += kThreads) {
          const int i = idx / n, j = idx - i * n;
          T acc = 0;
          for (int a = 0; a < N; ++a)
            acc += s.SK[i * N + a] * (s.zs[a * n + j] * s.msk[a]);
          s.SA[idx] = s.S[idx] - acc;
        }
        __syncthreads();
        // K' S A
        for (int idx = tid; idx < nN; idx += kThreads) {
          const int a = idx / n, j = idx - a * n;
          T acc = 0;
          for (int i = 0; i < n; ++i) acc += s.KT[a * n + i] * s.SA[i * n + j];
          s.KS[idx] = acc;
        }
        __syncthreads();
        // S_p and u_p
        for (int idx = tid; idx < nn; idx += kThreads) {
          const int i = idx / n, j = idx - i * n;
          T asa = 0, lzz = 0;
          for (int a = 0; a < N; ++a) {
            asa += (s.zs[a * n + i] * s.msk[a]) * s.KS[a * n + j];
            lzz += s.LZ[a * n + i] * s.LZ[a * n + j];
          }
          s.W[idx] = (s.SA[idx] - asa) + db_t * lzz - sb_t * (s.w[i] * s.w[j]) +
                     s.au[i] * s.w[j];
        }
        for (int i = tid; i < n; i += kThreads)
          s.up[i] = s.au[i] - T(2) * sb_t * s.w[i];
      } else {  // degraded or unobserved: (u, S) pass through
        for (int idx = tid; idx < nn; idx += kThreads) s.W[idx] = s.S[idx];
        for (int i = tid; i < n; i += kThreads) s.up[i] = s.u[i];
      }
      __syncthreads();
      // the predict's adjoint
      for (int i = tid; i < n; i += kThreads) {
        T r1 = 0, r2 = 0;
        for (int j = 0; j < n; ++j) {
          r1 += s.W[i * n + j] * s.P0[i * n + j] * s.ph[j];
          r2 += s.W[j * n + i] * s.P0[j * n + i] * s.ph[j];
        }
        s.phib[i] = s.phib[i] + s.up[i] * s.m0[i] + r1 + r2;
        s.qb[i] = s.qb[i] + s.W[i * n + i];
        s.u[i] = s.up[i] * s.ph[i];
      }
      for (int idx = tid; idx < nn; idx += kThreads) {
        const int i = idx / n, j = idx - i * n;
        s.S[idx] = s.W[idx] * s.ph[i] * s.ph[j];
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < n; i += kThreads) {
    phibar[(size_t)b * n + i] = s.phib[i];
    qbar[(size_t)b * n + i] = s.qb[i];
  }
}

template <typename T>
int launch_joint_adjoint(const void* phi, const void* qdiag, const void* z,
                         const void* r, const void* y, const void* mask,
                         const void* bounds_mean, const void* bounds_cov,
                         const void* sb, const void* db, void* scratch,
                         void* phibar, void* qbar, int B, int t_steps, int N,
                         int n, int seg, int factored, void* stream) {
  const size_t smem = carve<T>(nullptr, N, n, nullptr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        joint_adjoint_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0) return 0;
  if (seg < 1) return (int)cudaErrorInvalidValue;
  if (t_steps == 0) {  // no step: zero adjoints
    cudaError_t e = cudaMemsetAsync(phibar, 0, sizeof(T) * (size_t)B * n,
                                    (cudaStream_t)stream);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(qbar, 0, sizeof(T) * (size_t)B * n,
                          (cudaStream_t)stream);
    return (int)e;
  }
  joint_adjoint_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)phi, (const T*)qdiag, (const T*)z, (const T*)r, (const T*)y,
      (const uint8_t*)mask, (const T*)bounds_mean, (const T*)bounds_cov,
      (const T*)sb, (const T*)db, (T*)scratch, (T*)phibar, (T*)qbar, t_steps,
      N, n, seg, factored);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// phi, qdiag (B, n); z (B, N, n); r (B, N); y, mask (B, T, N);
// bounds_mean (B, n_seg, n); bounds_cov (B, n_seg, n, n) (a factor when
// factored); sb, db (B, T); scratch (B, min(seg, T), n + n^2 + 2nN + N + 1);
// phibar, qbar (B, n)
int metran_joint_adjoint_f32(const void* phi, const void* qdiag,
                             const void* z, const void* r, const void* y,
                             const void* mask, const void* bounds_mean,
                             const void* bounds_cov, const void* sb,
                             const void* db, void* scratch, void* phibar,
                             void* qbar, int B, int t_steps, int N, int n,
                             int seg, int factored, void* stream) {
  return launch_joint_adjoint<float>(phi, qdiag, z, r, y, mask, bounds_mean,
                                     bounds_cov, sb, db, scratch, phibar,
                                     qbar, B, t_steps, N, n, seg, factored,
                                     stream);
}

int metran_joint_adjoint_f64(const void* phi, const void* qdiag,
                             const void* z, const void* r, const void* y,
                             const void* mask, const void* bounds_mean,
                             const void* bounds_cov, const void* sb,
                             const void* db, void* scratch, void* phibar,
                             void* qbar, int B, int t_steps, int N, int n,
                             int seg, int factored, void* stream) {
  return launch_joint_adjoint<double>(phi, qdiag, z, r, y, mask, bounds_mean,
                                      bounds_cov, sb, db, scratch, phibar,
                                      qbar, B, t_steps, N, n, seg, factored,
                                      stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
