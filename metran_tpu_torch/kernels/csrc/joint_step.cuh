// The joint-update filter body of one block, shared by K1
// (joint_filter.cu) and the joint arena update K16 (arena_joint.cu).
//
// filter_block runs the k appended steps of one model (joint_filter.cu
// documents the step and its modes) from the carry in state row `srow`
// of phi, q, z, r, mean0 and cov0, reading the step data and writing the
// per-step terms (and, in the bounds and store modes, the stored moments)
// at dispatch index `b`; K1 passes srow == b, the arena the resident row
// its block gathers.  It leaves the final (m, P) in shared memory
// (layout below) for the caller to write out.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace jointk {

enum Mode { kCarry = 0, kBounds = 1, kStore = 2 };

template <typename T>
struct Smem {
  T *P, *Zs, *KT, *Fm, *L, *Hm, *m, *ph, *v, *w, *msk;
};

// the layout of one block's dynamic shared memory
template <typename T>
__device__ inline Smem<T> carve(unsigned char* raw, int N, int S) {
  Smem<T> s;
  s.P = reinterpret_cast<T*>(raw);  // S*S covariance
  s.Zs = s.P + S * S;                // N*S observation matrix
  s.KT = s.Zs + N * S;               // N*S: Z_m P, then K'
  s.Fm = s.KT + N * S;               // N*N innovation covariance
  s.L = s.Fm + N * N;                // N*N its Cholesky factor
  s.Hm = s.L + N * N;                // S*N: K F (= (K' F)')
  s.m = s.Hm + S * N;                // S mean
  s.ph = s.m + S;                    // S transition diagonal
  s.v = s.ph + S;                    // N innovation
  s.w = s.v + N;                     // N: L^-1 v
  s.msk = s.w + N;                   // N: mask as 0/1
  return s;
}

template <typename T>
__host__ __device__ inline size_t smem_elems(int N, int S) {
  return (size_t)S * S + 2 * (size_t)N * S + 2 * (size_t)N * N +
         (size_t)S * N + 2 * (size_t)S + 3 * (size_t)N;
}

// x0, x1: the segment boundaries (bounds); x0..x3: m_p, P_p, m_f, P_f
// per step (store)
template <typename T, int kMode>
__device__ void filter_block(unsigned char* smem_raw,
                             const T* __restrict__ phi,
                             const T* __restrict__ q,
                             const T* __restrict__ z,
                             const T* __restrict__ r,
                             const T* __restrict__ mean0,
                             const T* __restrict__ cov0,
                             const T* __restrict__ y,
                             const uint8_t* __restrict__ mask,
                             T* __restrict__ sigma_out,
                             T* __restrict__ detf_out, T* __restrict__ x0,
                             T* __restrict__ x1, T* __restrict__ x2,
                             T* __restrict__ x3, int b, int srow, int k,
                             int N, int S, int seg) {
  const Smem<T> s = carve<T>(smem_raw, N, S);
  T* P = s.P;
  T* Zs = s.Zs;
  T* KT = s.KT;
  T* Fm = s.Fm;
  T* L = s.L;
  T* Hm = s.Hm;
  T* m = s.m;
  T* ph = s.ph;
  T* v = s.v;
  T* w = s.w;
  T* msk = s.msk;
  __shared__ int has_obs_s;
  __shared__ int ok_s;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T* qb = q + (size_t)srow * S * S;
  const T* rb = r + (size_t)srow * N;
  // store: the carry leaving step t (read between barriers)
  auto store_filtered = [&](int t) {
    if (kMode != kStore) return;
    const size_t st = (size_t)b * k + t;
    for (int i = tid; i < S; i += nt) x2[st * S + i] = m[i];
    for (int idx = tid; idx < S * S; idx += nt)
      x3[st * S * S + idx] = P[idx];
  };

  for (int i = tid; i < S * S; i += nt)
    P[i] = cov0[(size_t)srow * S * S + i];
  for (int i = tid; i < N * S; i += nt) Zs[i] = z[(size_t)srow * N * S + i];
  for (int i = tid; i < S; i += nt) {
    m[i] = mean0[(size_t)srow * S + i];
    ph[i] = phi[(size_t)srow * S + i];
  }

  for (int t = 0; t < k; ++t) {
    const T* yt = y + ((size_t)b * k + t) * N;
    const uint8_t* mt = mask + ((size_t)b * k + t) * N;
    if (tid == 0) has_obs_s = 0;
    __syncthreads();
    if (kMode == kBounds && t % seg == 0) {  // the carry entering it
      const int n_seg = (k + seg - 1) / seg;
      const size_t sb = (size_t)b * n_seg + t / seg;
      for (int i = tid; i < S; i += nt) x0[sb * S + i] = m[i];
      for (int idx = tid; idx < S * S; idx += nt) x1[sb * S * S + idx] = P[idx];
    }
    // predict (each thread owns its entries)
    for (int i = tid; i < S; i += nt) m[i] = ph[i] * m[i];
    for (int idx = tid; idx < S * S; idx += nt) {
      const int i = idx / S, j = idx - (idx / S) * S;
      P[idx] = ph[i] * P[idx] * ph[j] + qb[idx];
    }
    for (int a = tid; a < N; a += nt) msk[a] = mt[a] ? T(1) : T(0);
    __syncthreads();
    if (kMode == kStore) {  // the predicted moments of step t
      const size_t st = (size_t)b * k + t;
      for (int i = tid; i < S; i += nt) x0[st * S + i] = m[i];
      for (int idx = tid; idx < S * S; idx += nt)
        x1[st * S * S + idx] = P[idx];
    }
    // innovation and the (masked) rows of Z P
    for (int a = tid; a < N; a += nt) {
      T acc = 0;
      for (int j = 0; j < S; ++j) acc += Zs[a * S + j] * m[j];
      v[a] = mt[a] ? yt[a] - acc : T(0);
      if (mt[a]) has_obs_s = 1;
    }
    for (int idx = tid; idx < N * S; idx += nt) {
      const int a = idx / S, i = idx - (idx / S) * S;
      T acc = 0;
      for (int j = 0; j < S; ++j) acc += P[i * S + j] * Zs[a * S + j];
      KT[idx] = msk[a] * acc;
    }
    __syncthreads();
    if (!has_obs_s) {  // block-uniform: nothing observed at this step
      if (tid == 0) {
        sigma_out[(size_t)b * k + t] = 0;
        detf_out[(size_t)b * k + t] = 0;
      }
      store_filtered(t);
      __syncthreads();
      continue;
    }
    // F = Z_m (P Z_m') + diag(r o mask + 1 - mask)
    for (int idx = tid; idx < N * N; idx += nt) {
      const int a = idx / N, c = idx - (idx / N) * N;
      T acc = 0;
      for (int i = 0; i < S; ++i) acc += Zs[a * S + i] * msk[a] * KT[c * S + i];
      if (a == c) acc += (msk[a] != T(0) ? rb[a] : T(0)) + (T(1) - msk[a]);
      Fm[idx] = acc;
      L[idx] = acc;
    }
    if (tid == 0) ok_s = 1;
    __syncthreads();
    // right-looking Cholesky on the lower triangle of L
    for (int c = 0; c < N; ++c) {
      const T d = L[c * N + c];
      if (!(d > T(0)) || !isfinite(d)) {  // block-uniform verdict
        if (tid == 0) ok_s = 0;
        break;
      }
      const T sq = sqrt(d);
      for (int rr = c + 1 + tid; rr < N; rr += nt) L[rr * N + c] /= sq;
      __syncthreads();
      if (tid == 0) L[c * N + c] = sq;
      const int n2 = N - c - 1;
      for (int idx = tid; idx < n2 * n2; idx += nt) {
        const int rr = c + 1 + idx / n2, cc = c + 1 + idx % n2;
        if (cc <= rr) L[rr * N + cc] -= L[rr * N + c] * L[cc * N + c];
      }
      __syncthreads();
    }
    __syncthreads();
    for (int idx = tid; idx < N * N; idx += nt) {
      const int a = idx / N, c = idx - (idx / N) * N;
      if (c <= a && !isfinite(L[idx])) ok_s = 0;
    }
    __syncthreads();
    if (!ok_s) {  // degraded step: carry the predicted moments
      if (tid == 0) {
        sigma_out[(size_t)b * k + t] = 0;
        detf_out[(size_t)b * k + t] = INFINITY;
      }
      store_filtered(t);
      __syncthreads();
      continue;
    }
    // K' = L'^-1 L^-1 (Z_m P): column j of KT per thread; column S is v
    for (int j = tid; j <= S; j += nt) {
      if (j < S) {
        for (int a = 0; a < N; ++a) {
          T acc = KT[a * S + j];
          for (int c = 0; c < a; ++c) acc -= L[a * N + c] * KT[c * S + j];
          KT[a * S + j] = acc / L[a * N + a];
        }
        for (int a = N - 1; a >= 0; --a) {
          T acc = KT[a * S + j];
          for (int c = a + 1; c < N; ++c) acc -= L[c * N + a] * KT[c * S + j];
          KT[a * S + j] = acc / L[a * N + a];
        }
      } else {
        for (int a = 0; a < N; ++a) {
          T acc = v[a];
          for (int c = 0; c < a; ++c) acc -= L[a * N + c] * w[c];
          w[a] = acc / L[a * N + a];
        }
      }
    }
    __syncthreads();
    // m += K v and (K' F)' into Hm; the step's likelihood terms
    for (int i = tid; i < S; i += nt) {
      T acc = 0;
      for (int a = 0; a < N; ++a) acc += KT[a * S + i] * v[a];
      m[i] = m[i] + acc;
    }
    for (int idx = tid; idx < S * N; idx += nt) {
      const int i = idx / N, c = idx - (idx / N) * N;
      T acc = 0;
      for (int a = 0; a < N; ++a) acc += KT[a * S + i] * Fm[a * N + c];
      Hm[idx] = acc;
    }
    if (tid == 0) {
      T sg = 0, lg = 0;
      for (int a = 0; a < N; ++a) {
        sg += w[a] * w[a];
        lg += log(L[a * N + a]);
      }
      sigma_out[(size_t)b * k + t] = sg;
      detf_out[(size_t)b * k + t] = T(2) * lg;
    }
    __syncthreads();
    // P -= (K' F)' K'
    for (int idx = tid; idx < S * S; idx += nt) {
      const int i = idx / S, j = idx - (idx / S) * S;
      T acc = 0;
      for (int c = 0; c < N; ++c) acc += Hm[i * N + c] * KT[c * S + j];
      P[idx] = P[idx] - acc;
    }
    __syncthreads();
    store_filtered(t);
  }
  __syncthreads();
}

}  // namespace jointk
