// K1: joint-update Kalman filter append, one thread block per model.
//
// Replaces the JAX package's device program
// metran_tpu/ops/kalman.py::filter_append(engine="joint") (with
// _predict, _joint_update and the _make_core_step has_obs select), which
// the serving path runs vmapped over a shape bucket, and the same
// recursion in kalman_filter(engine="joint", store=False) that builds a
// fleet's posteriors from N(0, I).
//
// Per model and appended step:
//   predict   m = phi o m,  P = (phi phi') o P + q
//   innovate  v = mask ? y - Z m : 0,  F = Z_m P Z_m' + diag(r o mask + 1 - mask)
//   factor    F = L L'  (right-looking Cholesky, one column per round)
//   gain      K' = F^-1 Z_m P  (two triangular solves per column)
//   update    m += K v,  P -= K F K'  (the JAX form, not Joseph)
//   terms     sigma = |L^-1 v|^2,  detf = 2 sum log diag L
// A non-positive or non-finite pivot (F indefinite in the working
// precision) makes the step a no-op: predicted moments carried, sigma 0,
// detf +inf.  A step with no observed slot carries the predicted moments
// with sigma = detf = 0.
//
// What bounds it on an H100: neither bytes nor FLOPs.  At the flagship
// bucket (N=24, S=32) a step is ~2e5 flops over a few KB of state, so the
// recursion is latency-bound: a chain of dependent block-wide rounds
// (about 2N + 8 __syncthreads per step).  The design keeps the whole state
// (P, Z, F, its factor, the gain) in shared memory for all k steps, so
// device memory sees only y/mask once and the posterior once, and the
// time loop runs inside the kernel: one launch per dispatch, k = 1 or
// k = 5000 alike.  Many models per SM hide the barrier latency.
//
// Three instantiations (a template parameter, not a run-time branch):
//   carry   per step sigma, detf and the final (m, P) — serving and the
//           deviance;
//   bounds  the same, and the carry (m, P) at the start of every segment
//           of `seg` steps, (B, n_seg, S) and (B, n_seg, S, S): the forward
//           of the batch-layout adjoint (metran_tpu/ops/adjoint.py::
//           _run_segments, engine="joint"), whose backward (K11) replays
//           each segment from its boundary.  Each thread stores the
//           entries it then predicts, so the arithmetic is the carry
//           instantiation's, bit for bit;
//   store   per step sigma, detf and the predicted and filtered moments
//           (m_p, P_p, m_f, P_f): (B, k, S), (B, k, S, S) twice — the
//           joint engine's kalman_filter(store=True) (metran_tpu/ops/
//           kalman.py::kalman_filter, engine="joint"), what the RTS
//           smoother K8 and the single-model products read.  The stores
//           read shared memory between the carry instantiation's own
//           barriers, so every stored step is the carry run's, bit for
//           bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum Mode { kCarry = 0, kBounds = 1, kStore = 2 };

// x0, x1: the segment boundaries (bounds); x0..x3: m_p, P_p, m_f, P_f
// per step (store)
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
joint_filter_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                    const T* __restrict__ z, const T* __restrict__ r,
                    const T* __restrict__ mean0, const T* __restrict__ cov0,
                    const T* __restrict__ y, const uint8_t* __restrict__ mask,
                    T* __restrict__ mean_out, T* __restrict__ cov_out,
                    T* __restrict__ sigma_out, T* __restrict__ detf_out,
                    T* __restrict__ x0, T* __restrict__ x1,
                    T* __restrict__ x2, T* __restrict__ x3, int k, int N,
                    int S, int seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* P = reinterpret_cast<T*>(smem_raw);  // S*S covariance
  T* Zs = P + S * S;                       // N*S observation matrix
  T* KT = Zs + N * S;                      // N*S: Z_m P, then K'
  T* Fm = KT + N * S;                      // N*N innovation covariance
  T* L = Fm + N * N;                       // N*N its Cholesky factor
  T* Hm = L + N * N;                       // S*N: K F (= (K' F)')
  T* m = Hm + S * N;                       // S mean
  T* ph = m + S;                           // S transition diagonal
  T* v = ph + S;                           // N innovation
  T* w = v + N;                            // N: L^-1 v
  T* msk = w + N;                          // N: mask as 0/1
  __shared__ int has_obs_s;
  __shared__ int ok_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T* qb = q + (size_t)b * S * S;
  const T* rb = r + (size_t)b * N;
  // store: the carry leaving step t (read between barriers)
  auto store_filtered = [&](int t) {
    if (kMode != kStore) return;
    const size_t st = (size_t)b * k + t;
    for (int i = tid; i < S; i += nt) x2[st * S + i] = m[i];
    for (int idx = tid; idx < S * S; idx += nt)
      x3[st * S * S + idx] = P[idx];
  };

  for (int i = tid; i < S * S; i += nt) P[i] = cov0[(size_t)b * S * S + i];
  for (int i = tid; i < N * S; i += nt) Zs[i] = z[(size_t)b * N * S + i];
  for (int i = tid; i < S; i += nt) {
    m[i] = mean0[(size_t)b * S + i];
    ph[i] = phi[(size_t)b * S + i];
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
      const T s = sqrt(d);
      for (int rr = c + 1 + tid; rr < N; rr += nt) L[rr * N + c] /= s;
      __syncthreads();
      if (tid == 0) L[c * N + c] = s;
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
  if (kMode == kStore) return;  // the last stored step is the carry
  for (int i = tid; i < S * S; i += nt) cov_out[(size_t)b * S * S + i] = P[i];
  for (int i = tid; i < S; i += nt) mean_out[(size_t)b * S + i] = m[i];
}

template <typename T>
size_t joint_filter_smem(int N, int S) {
  return sizeof(T) * ((size_t)S * S + 2 * (size_t)N * S + 2 * (size_t)N * N +
                      (size_t)S * N + 2 * (size_t)S + 3 * (size_t)N);
}

template <typename T, int kMode>
int launch(const void* phi, const void* q, const void* z, const void* r,
           const void* mean0, const void* cov0, const void* y,
           const void* mask, void* mean_out, void* cov_out, void* sigma_out,
           void* detf_out, void* x0, void* x1, void* x2, void* x3, int B,
           int k, int N, int S, int seg, void* stream) {
  const size_t smem = joint_filter_smem<T>(N, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        joint_filter_kernel<T, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0) return 0;
  joint_filter_kernel<T, kMode>
      <<<B, kThreads, smem, (cudaStream_t)stream>>>(
          (const T*)phi, (const T*)q, (const T*)z, (const T*)r,
          (const T*)mean0, (const T*)cov0, (const T*)y, (const uint8_t*)mask,
          (T*)mean_out, (T*)cov_out, (T*)sigma_out, (T*)detf_out, (T*)x0,
          (T*)x1, (T*)x2, (T*)x3, k, N, S, seg);
  return (int)cudaGetLastError();
}

// bounds_mean/bounds_cov null: the carry instantiation (seg unused)
template <typename T>
int launch_joint_filter(const void* phi, const void* q, const void* z,
                        const void* r, const void* mean0, const void* cov0,
                        const void* y, const void* mask, void* mean_out,
                        void* cov_out, void* sigma_out, void* detf_out,
                        void* bounds_mean, void* bounds_cov, int B, int k,
                        int N, int S, int seg, void* stream) {
  if (bounds_mean != nullptr) {
    if (seg < 1) return (int)cudaErrorInvalidValue;
    return launch<T, kBounds>(phi, q, z, r, mean0, cov0, y, mask, mean_out,
                              cov_out, sigma_out, detf_out, bounds_mean,
                              bounds_cov, nullptr, nullptr, B, k, N, S, seg,
                              stream);
  }
  return launch<T, kCarry>(phi, q, z, r, mean0, cov0, y, mask, mean_out,
                           cov_out, sigma_out, detf_out, nullptr, nullptr,
                           nullptr, nullptr, B, k, N, S, 1, stream);
}

}  // namespace

extern "C" {

int metran_joint_filter_f32(const void* phi, const void* q, const void* z,
                            const void* r, const void* mean0,
                            const void* cov0, const void* y, const void* mask,
                            void* mean_out, void* cov_out, void* sigma_out,
                            void* detf_out, void* bounds_mean,
                            void* bounds_cov, int B, int k, int N, int S,
                            int seg, void* stream) {
  return launch_joint_filter<float>(phi, q, z, r, mean0, cov0, y, mask,
                                    mean_out, cov_out, sigma_out, detf_out,
                                    bounds_mean, bounds_cov, B, k, N, S, seg,
                                    stream);
}

int metran_joint_filter_f64(const void* phi, const void* q, const void* z,
                            const void* r, const void* mean0,
                            const void* cov0, const void* y, const void* mask,
                            void* mean_out, void* cov_out, void* sigma_out,
                            void* detf_out, void* bounds_mean,
                            void* bounds_cov, int B, int k, int N, int S,
                            int seg, void* stream) {
  return launch_joint_filter<double>(phi, q, z, r, mean0, cov0, y, mask,
                                     mean_out, cov_out, sigma_out, detf_out,
                                     bounds_mean, bounds_cov, B, k, N, S, seg,
                                     stream);
}

// the store instantiation: per step (m_p, P_p, m_f, P_f), (B, k, S) and
// (B, k, S, S), and sigma, detf (B, k)
int metran_joint_filter_store_f32(const void* phi, const void* q,
                                  const void* z, const void* r,
                                  const void* mean0, const void* cov0,
                                  const void* y, const void* mask,
                                  void* mean_p, void* cov_p, void* mean_f,
                                  void* cov_f, void* sigma_out,
                                  void* detf_out, int B, int k, int N, int S,
                                  void* stream) {
  return launch<float, kStore>(phi, q, z, r, mean0, cov0, y, mask, nullptr,
                               nullptr, sigma_out, detf_out, mean_p, cov_p,
                               mean_f, cov_f, B, k, N, S, 1, stream);
}

int metran_joint_filter_store_f64(const void* phi, const void* q,
                                  const void* z, const void* r,
                                  const void* mean0, const void* cov0,
                                  const void* y, const void* mask,
                                  void* mean_p, void* cov_p, void* mean_f,
                                  void* cov_f, void* sigma_out,
                                  void* detf_out, int B, int k, int N, int S,
                                  void* stream) {
  return launch<double, kStore>(phi, q, z, r, mean0, cov0, y, mask, nullptr,
                                nullptr, sigma_out, detf_out, mean_p, cov_p,
                                mean_f, cov_f, B, k, N, S, 1, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
