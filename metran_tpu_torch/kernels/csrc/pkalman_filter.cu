// K19: the covariance-form associative-scan Kalman filter, one block per
// (model, chunk).
//
// Replaces the JAX package's device program B8 in metran_tpu/ops/
// pkalman.py, parallel_filter (_filter_element, _filter_combine,
// _filter_from_scan, blocked_associative_scan): the engine="parallel"
// filter behind kalman_filter, deviance and the Metran products.
//
// Element of step t (masked observation row Z_t, r_t; y zeroed where
// masked): with P = P1- = diag(phi^2) + Q and phi_e = 0 at t = 0, P = Q
// and phi_e = phi after, S = Z_t P Z_t' + diag(r_t), K = P Z_t' S^-1,
//   A = (I - K Z_t) diag(phi_e),  b = K y,  C = (I - K Z_t) P,
//   J = (Z_t' S^-1 Z_t) o phi_e phi_e',  eta = phi_e o Z_t' S^-1 y;
// a step whose Cholesky of S fails is the no-observation element
// (diag(phi_e), 0, P, 0, 0).  Combine (e1 earlier, e2 later), two LU
// solves with partial pivoting:
//   M = (I + C1 J2)^-1 [A1 | b1 + C1 eta2 | C1],
//   A = A2 M_A,  b = A2 M_b + b2,  C = A2 M_C A2' + C2,
//   W = (I + J2 C1)^-1 [eta2 - J2 b1 | J2],
//   eta = A1' W_0 + eta1,  J = A1' W_J A1 + J1.
// (b, C) of the prefix ending at t is the filtered moment.  The tails:
// the predicted (m_p, P_p) = (phi o m_f, phi P_f phi' + Q) of the step
// before ((0, P1-) at t = 0), the innovation v = y - Z_t m_p (0 where
// masked), F = Z_t P_p Z_t' + diag(r_t), sigma = |L^-1 v|^2 and detf =
// 2 sum log diag L (L = chol F); a failed Cholesky books sigma = 0 and
// detf = +inf.
//
// The up-sweep, carry and down-sweep of pkalman_step.cuh are three
// launches on the caller's stream behind one C entry; the down-sweep
// runs the reduced combine ((b, C) only: one solve with n + 1 right-hand
// sides) and the tails.  With store, every step's (m_p, P_p, m_f, P_f)
// is written; without, only the final (m_f, P_f) and the terms.
//
// The sharded modes (the JAX package's _sharded_associative_scan :737
// behind sequence_sharded_filter :842, the time axis over a device mesh)
// run one shard of the series per launch: total (its full element (A, b,
// C, J, eta)), carry (over the S gathered totals, each shard's incoming
// (b, C)) and prefix (the shard's outputs from its incoming (b, C)).  A
// shard after the first has no origin: its step 0 takes Q and phi_e =
// phi like any step, and its tails predict step 0 from the incoming
// prefix, the previous shard's last filtered moment.
//
// Layouts, batch-major: phi (B, n), q (B, n, n), z (B, N, n), r (B, N),
// y, mask (B, T, N); outputs (B, T, n), (B, T, n, n), (B, T).  Scratch:
// per model (chunks - 1) totals (A, b, C, J, eta) and prefixes (b, C).
//
// What bounds it on an H100: latency.  A combine is ~17 n^3 flops in
// chains of dependent eliminations, one block barrier per pivot; one
// block's matrices live in shared memory.  One long model spreads over
// ~sqrt(3T) blocks, a fleet over one chunk per model.

#include "pkalman_step.cuh"

namespace {

using pk::Bump;
using pk::kThreads;

template <typename T>
struct Smem {
  // the model: phi, Q, P1-, Z, r
  T *ph, *Q, *P1, *Z, *rr;
  // the running prefix and the step's element
  T *Pa, *Pb, *Pc, *Pj, *Pe, *Ea, *Eb, *Ec, *Ej, *Ee;
  // the step's masked row and element work
  T *msk, *yv, *rt, *Zt, *pe, *ZP, *S, *W, *v, *mp;
  // the combine's work
  T *X, *Y, *R, *R2, *T1, *T2, *vb, *ve;
};

template <typename T>
__host__ __device__ size_t carve(unsigned char* raw, int N, int n,
                                 Smem<T>* s) {
  Bump<T> b{raw ? reinterpret_cast<T*>(raw) : nullptr, 0};
  const size_t nn = (size_t)n * n, Nn = (size_t)N * n;
  Smem<T> t;
  t.ph = b.take(n); t.Q = b.take(nn); t.P1 = b.take(nn); t.Z = b.take(Nn);
  t.rr = b.take(N);
  t.Pa = b.take(nn); t.Pb = b.take(n); t.Pc = b.take(nn); t.Pj = b.take(nn);
  t.Pe = b.take(n);
  t.Ea = b.take(nn); t.Eb = b.take(n); t.Ec = b.take(nn); t.Ej = b.take(nn);
  t.Ee = b.take(n);
  t.msk = b.take(N); t.yv = b.take(N); t.rt = b.take(N); t.Zt = b.take(Nn);
  t.pe = b.take(n); t.ZP = b.take(Nn); t.S = b.take((size_t)N * N);
  t.W = b.take((size_t)N * (2 * n + 1)); t.v = b.take(N); t.mp = b.take(n);
  t.X = b.take(nn); t.Y = b.take(nn); t.R = b.take((size_t)n * (2 * n + 1));
  t.R2 = b.take((size_t)n * (n + 1)); t.T1 = b.take(nn); t.T2 = b.take(nn);
  t.vb = b.take(n); t.ve = b.take(n);
  if (s) *s = t;
  return b.used * sizeof(T);
}


template <typename T>
__device__ void load_model(const Smem<T>& s, const T* phi, const T* q,
                           const T* z, const T* r, int bm, int N, int n) {
  const int nn = n * n;
  for (int a = threadIdx.x; a < n; a += kThreads)
    s.ph[a] = phi[(size_t)bm * n + a];
  for (int i = threadIdx.x; i < N; i += kThreads) s.rr[i] = r[(size_t)bm * N + i];
  for (int idx = threadIdx.x; idx < N * n; idx += kThreads)
    s.Z[idx] = z[(size_t)bm * N * n + idx];
  for (int idx = threadIdx.x; idx < nn; idx += kThreads)
    s.Q[idx] = q[(size_t)bm * nn + idx];
  __syncthreads();
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    s.P1[idx] = (a == c ? s.ph[a] * s.ph[a] : T(0)) + s.Q[idx];
  }
  __syncthreads();
}

// the element of the step whose masked row is in (msk, yv, rt, Zt)
template <typename T>
__device__ void element(const Smem<T>& s, bool first, int N, int n) {
  const int nn = n * n, w = 2 * n + 1;
  const T* Cp = first ? s.P1 : s.Q;
  for (int a = threadIdx.x; a < n; a += kThreads)
    s.pe[a] = first ? T(0) : s.ph[a];
  pk::mm(s.ZP, s.Zt, Cp, N, n, n);
  for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
    const int i = idx / N, k = idx - (idx / N) * N;
    T acc = 0;
    for (int c = 0; c < n; ++c) acc += s.ZP[i * n + c] * s.Zt[k * n + c];
    s.S[idx] = acc + (i == k ? s.rt[i] : T(0));
  }
  __syncthreads();
  const bool ok = pk::chol(s.S, N, N);
  if (!ok) {
    for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
      const int a = idx / n, c = idx - (idx / n) * n;
      s.Ea[idx] = a == c ? s.pe[a] : T(0);
      s.Ec[idx] = Cp[idx];
      s.Ej[idx] = 0;
    }
    for (int a = threadIdx.x; a < n; a += kThreads) s.Eb[a] = s.Ee[a] = 0;
    __syncthreads();
    return;
  }
  // W = S^-1 [Z_t P | Z_t | y]
  for (int idx = threadIdx.x; idx < N * w; idx += kThreads) {
    const int i = idx / w, c = idx - (idx / w) * w;
    s.W[idx] = c < n ? s.ZP[i * n + c]
                     : (c < 2 * n ? s.Zt[i * n + c - n] : s.yv[i]);
  }
  __syncthreads();
  pk::tri_solve(s.S, N, N, s.W, w, w, true, true);
  // X = I - K Z_t, K[a][k] = W[k][a]
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T acc = 0;
    for (int k = 0; k < N; ++k) acc += s.W[k * w + a] * s.Zt[k * n + c];
    s.X[idx] = (a == c ? T(1) : T(0)) - acc;
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T bk = 0, e = 0;
    for (int k = 0; k < N; ++k) {
      bk += s.W[k * w + a] * s.yv[k];
      e += s.Zt[k * n + a] * s.W[k * w + 2 * n];
    }
    s.Eb[a] = bk;
    s.Ee[a] = s.pe[a] * e;
  }
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T acc = 0;
    for (int k = 0; k < N; ++k) acc += s.Zt[k * n + a] * s.W[k * w + n + c];
    s.Ej[idx] = acc * (s.pe[a] * s.pe[c]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int c = idx - (idx / n) * n;
    s.Ea[idx] = s.X[idx] * s.pe[c];
  }
  pk::mm(s.Ec, s.X, Cp, n, n, n);
}

// prefix := prefix (x) element, every part
template <typename T>
__device__ void combine_full(const Smem<T>& s, int n) {
  const int nn = n * n, w = 2 * n + 1, w2 = n + 1;
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T x = 0, y = 0;
    for (int k = 0; k < n; ++k) {
      x += s.Pc[a * n + k] * s.Ej[k * n + c];
      y += s.Ej[a * n + k] * s.Pc[k * n + c];
    }
    s.X[idx] = (a == c ? T(1) : T(0)) + x;
    s.Y[idx] = (a == c ? T(1) : T(0)) + y;
  }
  for (int idx = threadIdx.x; idx < n * w; idx += kThreads) {
    const int a = idx / w, c = idx - (idx / w) * w;
    T v;
    if (c < n) {
      v = s.Pa[a * n + c];
    } else if (c == n) {
      T acc = 0;
      for (int k = 0; k < n; ++k) acc += s.Pc[a * n + k] * s.Ee[k];
      v = s.Pb[a] + acc;
    } else {
      v = s.Pc[a * n + c - n - 1];
    }
    s.R[idx] = v;
  }
  for (int idx = threadIdx.x; idx < n * w2; idx += kThreads) {
    const int a = idx / w2, c = idx - (idx / w2) * w2;
    T v;
    if (c == 0) {
      T acc = 0;
      for (int k = 0; k < n; ++k) acc += s.Ej[a * n + k] * s.Pb[k];
      v = s.Ee[a] - acc;
    } else {
      v = s.Ej[a * n + c - 1];
    }
    s.R2[idx] = v;
  }
  __syncthreads();
  pk::lu_solve(s.X, n, s.R, w, w);
  pk::lu_solve(s.Y, n, s.R2, w2, w2);
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T t1 = 0, t2 = 0, x = 0;
    for (int k = 0; k < n; ++k) {
      t1 += s.Ea[a * n + k] * s.R[k * w + c];
      t2 += s.Ea[a * n + k] * s.R[k * w + n + 1 + c];
      x += s.Pa[k * n + a] * s.R2[k * w2 + 1 + c];
    }
    s.T1[idx] = t1;
    s.T2[idx] = t2;
    s.X[idx] = x;  // A1' W_J
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T vb = 0, ve = 0;
    for (int k = 0; k < n; ++k) {
      vb += s.Ea[a * n + k] * s.R[k * w + n];
      ve += s.Pa[k * n + a] * s.R2[k * w2];
    }
    s.vb[a] = vb + s.Eb[a];
    s.ve[a] = ve + s.Pe[a];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T cc = 0, y = 0;
    for (int k = 0; k < n; ++k) {
      cc += s.T2[a * n + k] * s.Ea[c * n + k];
      y += s.X[a * n + k] * s.Pa[k * n + c];
    }
    s.Pc[idx] = cc + s.Ec[idx];
    s.Y[idx] = y + s.Pj[idx];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    s.Pa[idx] = s.T1[idx];
    s.Pj[idx] = s.Y[idx];
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    s.Pb[a] = s.vb[a];
    s.Pe[a] = s.ve[a];
  }
  __syncthreads();
}

// (b, C) of prefix := prefix (x) element: the filtered moment of a
// prefix from the first step (its A, J, eta are never read)
template <typename T>
__device__ void combine_reduced(const Smem<T>& s, int n) {
  const int nn = n * n, w = n + 1;
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T x = 0;
    for (int k = 0; k < n; ++k) x += s.Pc[a * n + k] * s.Ej[k * n + c];
    s.X[idx] = (a == c ? T(1) : T(0)) + x;
  }
  for (int idx = threadIdx.x; idx < n * w; idx += kThreads) {
    const int a = idx / w, c = idx - (idx / w) * w;
    T v;
    if (c == 0) {
      T acc = 0;
      for (int k = 0; k < n; ++k) acc += s.Pc[a * n + k] * s.Ee[k];
      v = s.Pb[a] + acc;
    } else {
      v = s.Pc[a * n + c - 1];
    }
    s.R[idx] = v;
  }
  __syncthreads();
  pk::lu_solve(s.X, n, s.R, w, w);
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T t2 = 0;
    for (int k = 0; k < n; ++k) t2 += s.Ea[a * n + k] * s.R[k * w + 1 + c];
    s.T2[idx] = t2;
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T vb = 0;
    for (int k = 0; k < n; ++k) vb += s.Ea[a * n + k] * s.R[k * w];
    s.vb[a] = vb + s.Eb[a];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T cc = 0;
    for (int k = 0; k < n; ++k) cc += s.T2[a * n + k] * s.Ea[c * n + k];
    s.Pc[idx] = cc + s.Ec[idx];
  }
  for (int a = threadIdx.x; a < n; a += kThreads) s.Pb[a] = s.vb[a];
  __syncthreads();
}

// predicted moments and likelihood terms of step t from the prefix
// before it (the filtered moment of t - 1); (0, P1-) at t = 0
template <typename T>
__device__ void tails(const Smem<T>& s, bool first, int N, int n,
                      T* o_mean_p, T* o_cov_p, T* o_sigma, T* o_detf) {
  const int nn = n * n;
  T* Pp = s.T1;
  for (int a = threadIdx.x; a < n; a += kThreads)
    s.mp[a] = first ? T(0) : s.ph[a] * s.Pb[a];
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    Pp[idx] = first ? s.P1[idx] : s.ph[a] * s.Pc[idx] * s.ph[c] + s.Q[idx];
  }
  __syncthreads();
  if (o_mean_p) {
    for (int a = threadIdx.x; a < n; a += kThreads) o_mean_p[a] = s.mp[a];
    for (int idx = threadIdx.x; idx < nn; idx += kThreads)
      o_cov_p[idx] = Pp[idx];
  }
  pk::mm(s.ZP, s.Zt, Pp, N, n, n);
  for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
    const int i = idx / N, k = idx - (idx / N) * N;
    T acc = 0;
    for (int c = 0; c < n; ++c) acc += s.ZP[i * n + c] * s.Zt[k * n + c];
    s.S[idx] = acc + (i == k ? s.rt[i] : T(0));
  }
  for (int i = threadIdx.x; i < N; i += kThreads) {
    T acc = 0;
    for (int c = 0; c < n; ++c) acc += s.Zt[i * n + c] * s.mp[c];
    s.v[i] = s.msk[i] != T(0) ? s.yv[i] - acc : T(0);
  }
  __syncthreads();
  const bool ok = pk::chol(s.S, N, N);
  if (ok) pk::tri_solve(s.S, N, N, s.v, 1, 1, true, false);
  if (threadIdx.x == 0) {
    T sig = 0, det = 0;
    if (ok) {
      for (int i = 0; i < N; ++i) {
        sig += s.v[i] * s.v[i];
        det += log(s.S[i * N + i]);
      }
      det = T(2) * det;
    } else {
      det = INFINITY;
    }
    *o_sigma = sig;
    *o_detf = det;
  }
  __syncthreads();
}

// K19's Form for the scan schedule of pkalman_step.cuh
template <typename T>
struct Form {
  using Scalar = T;
  using Args = pk::FilterArgs<T>;
  using Shared = Smem<T>;
  static constexpr bool kReverse = false;
  static __host__ __device__ size_t carve(unsigned char* raw, const Args& a,
                                          Shared* s) {
    return ::carve<T>(raw, a.N, a.n, s);
  }
  // (A, b, C, J, eta)
  static __host__ __device__ int parts(const Shared& s, int n,
                                       pk::Part<T>* p) {
    const int nn = n * n;
    p[0] = {s.Ea, s.Pa, nn};
    p[1] = {s.Eb, s.Pb, n};
    p[2] = {s.Ec, s.Pc, nn};
    p[3] = {s.Ej, s.Pj, nn};
    p[4] = {s.Ee, s.Pe, n};
    return 5;
  }
  static __device__ void load(const Shared& s, const Args& a, int bm) {
    load_model(s, a.phi, a.q, a.z, a.r, bm, a.N, a.n);
  }
  static __device__ void row(const Shared& s, const Args& a, int bm, int t) {
    pk::filter_row(s, a, bm, t);
  }
  static __device__ void tails(const Shared& s, const Args& a, int bm,
                               int t) {
    const size_t st = (size_t)bm * a.t_steps + t;
    ::tails(s, a.first(t), a.N, a.n,
            a.store ? a.mean_p + st * a.n : (T*)nullptr,
            a.store ? a.cov_p + st * a.n * a.n : (T*)nullptr, a.sigma + st,
            a.detf + st);
  }
  static __device__ void element(const Shared& s, const Args& a, int,
                                 int t) {
    ::element(s, a.first(t), a.N, a.n);
  }
  static __device__ void combine(const Shared& s, const Args& a, bool full) {
    if (full)
      combine_full(s, a.n);
    else
      combine_reduced(s, a.n);
  }
  static __device__ void write(const Shared& s, const Args& a, int bm,
                               int t) {
    pk::filter_write(a, bm, t, s.Pb, s.Pc);
  }
};

}  // namespace

extern "C" {

// scratch: B * (chunks - 1) * (3 n^2 + 2n + n^2 + n) elements; without
// store, mean_p/cov_p are unused and mean_f/cov_f receive the final
// (m_f, P_f), (B, n) and (B, n, n)
int metran_pkalman_filter_f32(const void* phi, const void* q, const void* z,
                              const void* r, const void* y, const void* mask,
                              void* mean_p, void* cov_p, void* mean_f,
                              void* cov_f, void* sigma, void* detf,
                              void* scratch, int B, int t_steps, int N, int n,
                              int L, int store, void* stream) {
  return pk::run_filter<Form<float>>(phi, q, z, r, y, mask, mean_p, cov_p,
      mean_f, cov_f, sigma, detf, scratch, B, t_steps, N, n, L, store, stream);
}

int metran_pkalman_filter_f64(const void* phi, const void* q, const void* z,
                              const void* r, const void* y, const void* mask,
                              void* mean_p, void* cov_p, void* mean_f,
                              void* cov_f, void* sigma, void* detf,
                              void* scratch, int B, int t_steps, int N, int n,
                              int L, int store, void* stream) {
  return pk::run_filter<Form<double>>(phi, q, z, r, y, mask, mean_p, cov_p,
      mean_f, cov_f, sigma, detf, scratch, B, t_steps, N, n, L, store, stream);
}

// the sharded modes.  total: scratch B * chunks * (3 n^2 + 2 n) chunk
// totals (read again by the shard's prefix launch) and total (B, 3 n^2 +
// 2 n); origin: these steps start the series
#define PK_FILTER_TOTAL(T, SUF)                                             \
  int metran_pkalman_filter_total_##SUF(                                    \
      const void* phi, const void* q, const void* z, const void* r,         \
      const void* y, const void* mask, void* tot, void* total, int B,       \
      int t_steps, int N, int n, int L, int origin, void* stream) {         \
    const pk::FilterArgs<T> a{(const T*)phi, (const T*)q, (const T*)z,      \
        (const T*)r, (const T*)y, (const uint8_t*)mask, nullptr, nullptr,   \
        nullptr, nullptr, nullptr, nullptr, t_steps, N, n, 0, origin};      \
    return pk::run_total<Form<T>>(a, tot, total, B, L, stream);             \
  }
PK_FILTER_TOTAL(float, f32)
PK_FILTER_TOTAL(double, f64)

// carry: totals (B, S, 3 n^2 + 2 n) in time order, pre (B, S - 1, n^2 +
// n): the incoming (b, C) of shards 1 .. S - 1
#define PK_FILTER_CARRY(T, SUF)                                             \
  int metran_pkalman_filter_carry_##SUF(const void* totals, void* pre,      \
                                         int B, int S, int n,               \
                                         void* stream) {                    \
    const pk::FilterArgs<T> a{nullptr, nullptr, nullptr, nullptr, nullptr,  \
        nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,   \
        0, n, 0, 0};                                                        \
    return pk::run_carry<Form<T>>(a, totals, pre, B, S, stream);            \
  }
PK_FILTER_CARRY(float, f32)
PK_FILTER_CARRY(double, f64)

// prefix: tot the shard's chunk totals from its total launch, pre
// scratch B * (chunks - 1) * (n^2 + n), in_pre (B, n^2 + n) the incoming
// (b, C) (null at the origin); outputs as the unsharded entry's
#define PK_FILTER_PREFIX(T, SUF)                                            \
  int metran_pkalman_filter_prefix_##SUF(                                   \
      const void* phi, const void* q, const void* z, const void* r,         \
      const void* y, const void* mask, void* mean_p, void* cov_p,           \
      void* mean_f, void* cov_f, void* sigma, void* detf, const void* tot,  \
      void* pre, const void* in_pre, int B, int t_steps, int N, int n,      \
      int L, int store, int origin, void* stream) {                         \
    const pk::FilterArgs<T> a{(const T*)phi, (const T*)q, (const T*)z,      \
        (const T*)r, (const T*)y, (const uint8_t*)mask, (T*)mean_p,         \
        (T*)cov_p, (T*)mean_f, (T*)cov_f, (T*)sigma, (T*)detf, t_steps, N,  \
        n, store, origin};                                                  \
    return pk::run_prefix<Form<T>>(a, tot, pre, in_pre, B, L, stream);      \
  }
PK_FILTER_PREFIX(float, f32)
PK_FILTER_PREFIX(double, f64)

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
