// K21: the square-root associative-scan Kalman filter, one block per
// (model, chunk).
//
// Replaces the JAX package's device program B8 in metran_tpu/ops/
// pkalman.py, sqrt_parallel_filter (_sqrt_filter_element,
// _sqrt_filter_combine, _sqrt_filter_from_scan): the
// engine="sqrt_parallel" filter behind kalman_filter, deviance and the
// Metran products.
//
// Element of step t (masked row Z_t, r_t; y zeroed where masked): with
// N_p = diag(sqrt(phi^2 + q)) and phi_e = 0 at t = 0, diag(sqrt q) and
// phi after, the sign-normalised QR of
//   [[diag(sqrt r_t), 0], [(Z_t N_p)', N_p]]
// holds the innovation factor F^1/2 (lower, its transpose), Kbar and the
// factor U of the updated covariance; with Zh = F^-1/2 Z_t and
// w = F^-1/2 y,
//   A = (I - Kbar Zh) diag(phi_e),  b = Kbar w,  C = U U',
//   J = (Zh diag(phi_e))' (Zh diag(phi_e)),  eta = phi_e o Zh' w;
// a diagonal of F^1/2 that is not positive, or an entry of R that is not
// finite, gives the no-observation element (diag(phi_e), 0, N_p, 0, 0).
// Combine (e1 earlier, e2 later) through the Cholesky L_s of
// S = I + U1' J2 U1 (>= I) and ju = J2 U1:
//   A = A2 A1 - A2 U1 S^-1 ju' A1,
//   b = A2 m - A2 U1 S^-1 ju' m + b2,  m = b1 + U1 U1' eta2,
//   U = tria([A2 U1 L_s^-T | U2]),
//   eta = A1' (v - ju S^-1 U1' v) + eta1,  v = eta2 - J2 b1,
//   J = sym(A1' (J2 - ju S^-1 ju') A1 + J1).
// (b, U) of the prefix ending at t is the filtered (mean, factor).  The
// tails: the predicted factor tria([phi o S_f | diag(sqrt q)]) of the step
// before (N_p at t = 0), F^1/2 = tria([Z_t S_p | diag(sqrt r_t)]),
// sigma = |F^-1/2 v|^2 and detf = 2 sum log diag F^1/2 (sigma = 0 and
// detf = +inf where that diagonal is not positive or not finite).
//
// tria is the Householder QR of sqrt_qr.cuh (K9/K10's), rows
// sign-normalised as the JAX package's _sign_normalize_rows.  The
// up-sweep, carry and down-sweep of pkalman_step.cuh are three launches
// behind one C entry; the carry and the down-sweep run the reduced
// combine ((b, U) only).
//
// Layouts, batch-major: phi, q (B, n) (q the diagonal of Q), z (B, N, n),
// r (B, N), y, mask (B, T, N); outputs (B, T, n), (B, T, n, n), (B, T).
// Scratch: per model (chunks - 1) totals (A, b, U, J, eta) and prefixes
// (b, U).
//
// What bounds it on an H100: latency.  A down-sweep step runs four QRs
// (the element's (N + n)-square one, the combine's, the predict's and the
// innovation's), a Cholesky and a few n^3 products, one block barrier
// per Householder stage.

#include "pkalman_step.cuh"

namespace {

using pk::Bump;
using pk::kThreads;

template <typename T>
struct Smem {
  T *ph, *qs, *Z, *rr;
  T *Pa, *Pb, *Pu, *Pj, *Pe, *Ea, *Eb, *Eu, *Ej, *Ee;
  T *msk, *yv, *rt, *Zt, *pe, *np, *pre, *dg, *W, *KB, *SF;
  T *mp, *Sp, *ZS, *v, *M;
  T *T1, *T2, *X, *G, *Rb, *JM, *JA, *Na, *U, *t1, *um, *vv, *nb, *ne;
  int ldu, ldm;
};

template <typename T>
__host__ __device__ size_t carve(unsigned char* raw, int N, int n,
                                 Smem<T>* s) {
  Bump<T> b{raw ? reinterpret_cast<T*>(raw) : nullptr, 0};
  const size_t nn = (size_t)n * n, Nn = (size_t)N * n;
  const int ldu = sqrtqr::odd_ld(N + n);
  const int l2 = sqrtqr::odd_ld(2 * n), l3 = sqrtqr::odd_ld(n + N);
  const int ldm = l2 > l3 ? l2 : l3;
  Smem<T> t;
  t.ldu = ldu;
  t.ldm = ldm;
  t.ph = b.take(n); t.qs = b.take(n); t.Z = b.take(Nn); t.rr = b.take(N);
  t.Pa = b.take(nn); t.Pb = b.take(n); t.Pu = b.take(nn); t.Pj = b.take(nn);
  t.Pe = b.take(n);
  t.Ea = b.take(nn); t.Eb = b.take(n); t.Eu = b.take(nn); t.Ej = b.take(nn);
  t.Ee = b.take(n);
  t.msk = b.take(N); t.yv = b.take(N); t.rt = b.take(N); t.Zt = b.take(Nn);
  t.pe = b.take(n); t.np = b.take(n);
  t.pre = b.take((size_t)ldu * (N + n)); t.dg = b.take(N + n);
  t.W = b.take((size_t)N * (n + 1)); t.KB = b.take(Nn);
  t.SF = b.take((size_t)N * N);
  t.mp = b.take(n); t.Sp = b.take(nn); t.ZS = b.take(Nn); t.v = b.take(N);
  t.M = b.take((size_t)ldm * (n > N ? n : N));
  t.T1 = b.take(nn); t.T2 = b.take(nn); t.X = b.take(nn); t.G = b.take(nn);
  t.Rb = b.take((size_t)n * (2 * n + 2)); t.JM = b.take(nn);
  t.JA = b.take(nn); t.Na = b.take(nn); t.U = b.take(nn);
  t.t1 = b.take(n); t.um = b.take(n); t.vv = b.take(n); t.nb = b.take(n);
  t.ne = b.take(n);
  if (s) *s = t;
  return b.used * sizeof(T);
}


template <typename T>
__device__ void load_model(const Smem<T>& s, const T* phi, const T* q,
                           const T* z, const T* r, int bm, int N, int n) {
  for (int a = threadIdx.x; a < n; a += kThreads) {
    s.ph[a] = phi[(size_t)bm * n + a];
    const T qa = q[(size_t)bm * n + a];
    s.qs[a] = sqrt(qa > T(0) ? qa : T(0));
  }
  for (int i = threadIdx.x; i < N; i += kThreads) s.rr[i] = r[(size_t)bm * N + i];
  for (int idx = threadIdx.x; idx < N * n; idx += kThreads)
    s.Z[idx] = z[(size_t)bm * N * n + idx];
  __syncthreads();
}

// the element of the step whose masked row is in (msk, yv, rt, Zt)
template <typename T>
__device__ void element(const Smem<T>& s, bool first, int N, int n) {
  __shared__ int ok_s;
  const int nn = n * n, R = N + n, ldu = s.ldu;
  for (int a = threadIdx.x; a < n; a += kThreads) {
    s.pe[a] = first ? T(0) : s.ph[a];
    s.np[a] = sqrt(first ? s.ph[a] * s.ph[a] + s.qs[a] * s.qs[a]
                         : s.qs[a] * s.qs[a]);
  }
  if (threadIdx.x == 0) ok_s = 1;
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * R; idx += kThreads) {
    const int col = idx / R, row = idx - (idx / R) * R;
    T v;
    if (col < N)
      v = row < N ? (row == col ? sqrt(s.rt[row]) : T(0))
                  : s.Zt[col * n + row - N] * s.np[row - N];
    else
      v = row < N ? T(0) : (row == col ? s.np[row - N] : T(0));
    s.pre[col * ldu + row] = v;
  }
  __syncthreads();
  // rows j+1 .. N-1 of the first N columns are zero throughout
  sqrtqr::house_qr<T, kThreads>(s.pre, ldu, R, R, N, R, s.dg);
  for (int idx = threadIdx.x; idx < R * R; idx += kThreads) {
    const int j = idx / R, k = idx - (idx / R) * R;  // R[j][k], k >= j
    if (k < j) continue;
    const T sg = sqrtqr::row_sign(s.dg[j]);
    const T val = (k == j ? s.dg[j] : s.pre[k * ldu + j]) * sg;
    if (!isfinite(val) || (k == j && j < N && !(val > T(0)))) ok_s = 0;
  }
  __syncthreads();
  const bool ok = ok_s != 0;
  if (!ok) {
    for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
      const int a = idx / n, c = idx - (idx / n) * n;
      s.Ea[idx] = a == c ? s.pe[a] : T(0);
      s.Eu[idx] = a == c ? s.np[a] : T(0);
      s.Ej[idx] = 0;
    }
    for (int a = threadIdx.x; a < n; a += kThreads) s.Eb[a] = s.Ee[a] = 0;
    __syncthreads();
    return;
  }
  // F^1/2 (SF, lower), Kbar (KB, n x N), U (Eu, lower); W = [Z_t | y]
  for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
    const int i = idx / N, j = idx - (idx / N) * N;
    const T sg = sqrtqr::row_sign(s.dg[j]);
    s.SF[idx] = i == j ? s.dg[j] * sg : (i > j ? s.pre[i * ldu + j] * sg : T(0));
  }
  for (int idx = threadIdx.x; idx < N * n; idx += kThreads) {
    const int a = idx / N, j = idx - (idx / N) * N;
    s.KB[idx] = s.pre[(N + a) * ldu + j] * sqrtqr::row_sign(s.dg[j]);
  }
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    const T sg = sqrtqr::row_sign(s.dg[N + c]);
    s.Eu[idx] = a == c ? s.dg[N + c] * sg
                       : (a > c ? s.pre[(N + a) * ldu + N + c] * sg : T(0));
  }
  for (int idx = threadIdx.x; idx < N * (n + 1); idx += kThreads) {
    const int i = idx / (n + 1), c = idx - (idx / (n + 1)) * (n + 1);
    s.W[idx] = c < n ? s.Zt[i * n + c] : s.yv[i];
  }
  __syncthreads();
  pk::tri_solve(s.SF, N, N, s.W, n + 1, n + 1, true, false);
  const int w = n + 1;
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T kz = 0, jj = 0;
    for (int k = 0; k < N; ++k) {
      kz += s.KB[a * N + k] * s.W[k * w + c];
      jj += (s.W[k * w + a] * s.pe[a]) * (s.W[k * w + c] * s.pe[c]);
    }
    s.Ea[idx] = ((a == c ? T(1) : T(0)) - kz) * s.pe[c];
    s.Ej[idx] = jj;
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T bk = 0, e = 0;
    for (int k = 0; k < N; ++k) {
      bk += s.KB[a * N + k] * s.W[k * w + n];
      e += s.W[k * w + a] * s.W[k * w + n];
    }
    s.Eb[a] = bk;
    s.Ee[a] = s.pe[a] * e;
  }
  __syncthreads();
}

// U := tria([G | Eu]) (the combine's factor)
template <typename T>
__device__ void combine_factor(const Smem<T>& s, int n) {
  const int ld = s.ldm;
  for (int idx = threadIdx.x; idx < 2 * n * n; idx += kThreads) {
    const int c = idx / (2 * n), row = idx - (idx / (2 * n)) * (2 * n);
    s.M[c * ld + row] = row < n ? s.G[c * n + row] : s.Eu[c * n + row - n];
  }
  __syncthreads();
  pk::tria(s.M, ld, 2 * n, n, s.dg, s.U);
}

// the combine's common start: T1 = ju = J2 U1, T2 = au = A2 U1,
// X = chol(I + U1' ju), um = b1 + U1 U1' eta2, G = au X^-T; full also
// v = eta2 - J2 b1
template <typename T>
__device__ void combine_head(const Smem<T>& s, int n, bool full) {
  const int nn = n * n;
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T x = 0, y = 0;
    for (int k = 0; k < n; ++k) {
      x += s.Ej[a * n + k] * s.Pu[k * n + c];
      y += s.Ea[a * n + k] * s.Pu[k * n + c];
    }
    s.T1[idx] = x;
    s.T2[idx] = y;
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T acc = 0, vj = 0;
    for (int k = 0; k < n; ++k) {
      acc += s.Pu[k * n + a] * s.Ee[k];
      if (full) vj += s.Ej[a * n + k] * s.Pb[k];
    }
    s.t1[a] = acc;
    if (full) s.vv[a] = s.Ee[a] - vj;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += s.Pu[k * n + a] * s.T1[k * n + c];
    s.X[idx] = (a == c ? T(1) : T(0)) + acc;
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += s.Pu[a * n + k] * s.t1[k];
    s.um[a] = s.Pb[a] + acc;
  }
  __syncthreads();
  pk::chol(s.X, n, n);  // >= I: the JAX combine takes it unguarded
  // G = au X^-T, row by row (forward substitution against X)
  for (int i = threadIdx.x; i < n; i += kThreads)
    for (int k = 0; k < n; ++k) {
      T acc = s.T2[i * n + k];
      for (int p = 0; p < k; ++p) acc -= s.X[k * n + p] * s.G[i * n + p];
      s.G[i * n + k] = acc / s.X[k * n + k];
    }
  __syncthreads();
}

// prefix := prefix (x) element, every part
template <typename T>
__device__ void combine_full(const Smem<T>& s, int n) {
  const int nn = n * n, w = 2 * n + 2;
  combine_head(s, n, true);
  // Rb = S^-1 [ju' A1 | ju' | ju' um | U1' v]
  for (int idx = threadIdx.x; idx < n * w; idx += kThreads) {
    const int a = idx / w, c = idx - (idx / w) * w;
    T v = 0;
    if (c < n) {
      for (int k = 0; k < n; ++k) v += s.T1[k * n + a] * s.Pa[k * n + c];
    } else if (c < 2 * n) {
      v = s.T1[(c - n) * n + a];
    } else if (c == 2 * n) {
      for (int k = 0; k < n; ++k) v += s.T1[k * n + a] * s.um[k];
    } else {
      for (int k = 0; k < n; ++k) v += s.Pu[k * n + a] * s.vv[k];
    }
    s.Rb[idx] = v;
  }
  __syncthreads();
  pk::tri_solve(s.X, n, n, s.Rb, w, w, true, true);
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T aa = 0, as = 0, jm = 0;
    for (int k = 0; k < n; ++k) {
      aa += s.Ea[a * n + k] * s.Pa[k * n + c];
      as += s.T2[a * n + k] * s.Rb[k * w + c];
      jm += s.T1[a * n + k] * s.Rb[k * w + n + c];
    }
    s.Na[idx] = aa - as;
    s.JM[idx] = s.Ej[idx] - jm;
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T au = 0, as = 0, jv = 0;
    for (int k = 0; k < n; ++k) {
      au += s.Ea[a * n + k] * s.um[k];
      as += s.T2[a * n + k] * s.Rb[k * w + 2 * n];
      jv += s.T1[a * n + k] * s.Rb[k * w + 2 * n + 1];
    }
    s.nb[a] = (au - as) + s.Eb[a];
    s.t1[a] = s.vv[a] - jv;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += s.Pa[k * n + a] * s.JM[k * n + c];
    s.JA[idx] = acc;
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += s.Pa[k * n + a] * s.t1[k];
    s.ne[a] = acc + s.Pe[a];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += s.JA[a * n + k] * s.Pa[k * n + c];
    s.JM[idx] = acc + s.Pj[idx];
  }
  __syncthreads();
  combine_factor(s, n);
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    s.Pj[idx] = T(0.5) * (s.JM[idx] + s.JM[c * n + a]);
    s.Pa[idx] = s.Na[idx];
    s.Pu[idx] = s.U[idx];
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    s.Pb[a] = s.nb[a];
    s.Pe[a] = s.ne[a];
  }
  __syncthreads();
}

// (b, U) of prefix := prefix (x) element (a prefix from the first step)
template <typename T>
__device__ void combine_reduced(const Smem<T>& s, int n) {
  const int nn = n * n;
  combine_head(s, n, false);
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += s.T1[k * n + a] * s.um[k];
    s.Rb[a] = acc;
  }
  __syncthreads();
  pk::tri_solve(s.X, n, n, s.Rb, 1, 1, true, true);
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T au = 0, as = 0;
    for (int k = 0; k < n; ++k) {
      au += s.Ea[a * n + k] * s.um[k];
      as += s.T2[a * n + k] * s.Rb[k];
    }
    s.nb[a] = (au - as) + s.Eb[a];
  }
  __syncthreads();
  combine_factor(s, n);
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) s.Pu[idx] = s.U[idx];
  for (int a = threadIdx.x; a < n; a += kThreads) s.Pb[a] = s.nb[a];
  __syncthreads();
}

// predicted (mean, factor) and likelihood terms of step t from the
// prefix before it; (0, N_p) at t = 0
template <typename T>
__device__ void tails(const Smem<T>& s, bool first, int N, int n,
                      T* o_mean_p, T* o_chol_p, T* o_sigma, T* o_detf) {
  __shared__ int ok_s;
  const int nn = n * n, ld = s.ldm;
  for (int a = threadIdx.x; a < n; a += kThreads)
    s.mp[a] = first ? T(0) : s.ph[a] * s.Pb[a];
  if (first) {
    for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
      const int a = idx / n, c = idx - (idx / n) * n;
      s.Sp[idx] = a == c ? sqrt(s.ph[a] * s.ph[a] + s.qs[a] * s.qs[a]) : T(0);
    }
    __syncthreads();
  } else {
    for (int idx = threadIdx.x; idx < 2 * n * n; idx += kThreads) {
      const int c = idx / (2 * n), row = idx - (idx / (2 * n)) * (2 * n);
      s.M[c * ld + row] = row < n ? s.ph[c] * s.Pu[c * n + row]
                                  : (row - n == c ? s.qs[c] : T(0));
    }
    __syncthreads();
    pk::tria(s.M, ld, 2 * n, n, s.dg, s.Sp);
  }
  if (o_mean_p) {
    for (int a = threadIdx.x; a < n; a += kThreads) o_mean_p[a] = s.mp[a];
    for (int idx = threadIdx.x; idx < nn; idx += kThreads)
      o_chol_p[idx] = s.Sp[idx];
  }
  pk::mm(s.ZS, s.Zt, s.Sp, N, n, n);
  const int R = n + N;
  for (int idx = threadIdx.x; idx < R * N; idx += kThreads) {
    const int c = idx / R, row = idx - (idx / R) * R;
    s.M[c * ld + row] = row < n ? s.ZS[c * n + row]
                                : (row - n == c ? sqrt(s.rt[c]) : T(0));
  }
  for (int i = threadIdx.x; i < N; i += kThreads) {
    T acc = 0;
    for (int c = 0; c < n; ++c) acc += s.Zt[i * n + c] * s.mp[c];
    s.v[i] = s.msk[i] != T(0) ? s.yv[i] - acc : T(0);
  }
  if (threadIdx.x == 0) ok_s = 1;
  __syncthreads();
  pk::tria(s.M, ld, R, N, s.dg, s.SF);
  for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
    const int i = idx / N, j = idx - (idx / N) * N;
    if (!isfinite(s.SF[idx]) || (i == j && !(s.SF[idx] > T(0)))) ok_s = 0;
  }
  __syncthreads();
  const bool ok = ok_s != 0;
  if (ok) pk::tri_solve(s.SF, N, N, s.v, 1, 1, true, false);
  if (threadIdx.x == 0) {
    T sig = 0, det = 0;
    if (ok) {
      for (int i = 0; i < N; ++i) {
        sig += s.v[i] * s.v[i];
        det += log(s.SF[i * N + i]);
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

// K21's Form for the scan schedule of pkalman_step.cuh
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
  // (A, b, U, J, eta)
  static __host__ __device__ int parts(const Shared& s, int n,
                                       pk::Part<T>* p) {
    const int nn = n * n;
    p[0] = {s.Ea, s.Pa, nn};
    p[1] = {s.Eb, s.Pb, n};
    p[2] = {s.Eu, s.Pu, nn};
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
    ::tails(s, t == 0, a.N, a.n, a.store ? a.mean_p + st * a.n : (T*)nullptr,
            a.store ? a.cov_p + st * a.n * a.n : (T*)nullptr, a.sigma + st,
            a.detf + st);
  }
  static __device__ void element(const Shared& s, const Args& a, int,
                                 int t) {
    ::element(s, t == 0, a.N, a.n);
  }
  static __device__ void combine(const Shared& s, const Args& a, bool full) {
    if (full)
      combine_full(s, a.n);
    else
      combine_reduced(s, a.n);
  }
  static __device__ void write(const Shared& s, const Args& a, int bm,
                               int t) {
    pk::filter_write(a, bm, t, s.Pb, s.Pu);
  }
};

}  // namespace

extern "C" {

// scratch: B * (chunks - 1) * (3 n^2 + 2n + n^2 + n) elements; without
// store, mean_p/chol_p are unused and mean_f/chol_f receive the final
// (m_f, S_f), (B, n) and (B, n, n)
int metran_sqrt_pkalman_filter_f32(const void* phi, const void* q,
                                   const void* z, const void* r,
                                   const void* y, const void* mask,
                                   void* mean_p, void* chol_p, void* mean_f,
                                   void* chol_f, void* sigma, void* detf,
                                   void* scratch, int B, int t_steps, int N,
                                   int n, int L, int store, void* stream) {
  return pk::run_filter<Form<float>>(phi, q, z, r, y, mask, mean_p, chol_p,
      mean_f, chol_f, sigma, detf, scratch, B, t_steps, N, n, L, store,
      stream);
}

int metran_sqrt_pkalman_filter_f64(const void* phi, const void* q,
                                   const void* z, const void* r,
                                   const void* y, const void* mask,
                                   void* mean_p, void* chol_p, void* mean_f,
                                   void* chol_f, void* sigma, void* detf,
                                   void* scratch, int B, int t_steps, int N,
                                   int n, int L, int store, void* stream) {
  return pk::run_filter<Form<double>>(phi, q, z, r, y, mask, mean_p, chol_p,
      mean_f, chol_f, sigma, detf, scratch, B, t_steps, N, n, L, store,
      stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
