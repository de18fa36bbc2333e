// K22: the square-root associative-scan RTS smoother, one block per
// (model, chunk).
//
// Replaces the JAX package's device program B8 in metran_tpu/ops/
// pkalman.py, sqrt_parallel_smoother (_sqrt_smoother_element,
// _sqrt_smoother_combine): the engine="sqrt_parallel" smoother behind
// rts_smoother on a factored filter result and the Metran products.
//
// Element of step t, from the filter's stored factors (m_f, S_f at t;
// m_p, S_p at t + 1):
//   E = P_f diag(phi) (S_p S_p')^-1  (P_f = S_f S_f', two triangular
//       solves against S_p),  g = m_f - E m_p,
//   D = tria([(I - E diag(phi)) S_f | E diag(sqrt q)]);
// the last step, and a step whose S_p has a diagonal that is not positive
// or an entry that is not finite, are cut: (0, m_f, S_f).  The reverse
// scan composes earlier (x) later as
//   (E_e E_l, E_e g_l + g_e, tria([E_e D_l | D_e])),
// and (g, D) of the suffix starting at t is the smoothed (mean, factor).
//
// The reverse scan runs the forward machinery of pkalman_step.cuh on
// positions p = T - 1 - t, chunked from the last step; the carry and the
// down-sweep run the reduced combine ((g, D) only).
//
// Layouts, batch-major: phi, q (B, n) (q the diagonal of Q); mean_f,
// mean_p (B, T, n); chol_f, chol_p (B, T, n, n); outputs mean_s (B, T, n),
// chol_s (B, T, n, n).  Scratch: per model (chunks - 1) totals (E, g, D)
// and suffixes (g, D).
//
// What bounds it on an H100: latency.  A step runs two QRs of a 2n x n
// stack (the element's and the combine's), two triangular solves with n
// right-hand sides and three n^3 products.

#include "pkalman_step.cuh"

namespace {

using pk::Bump;
using pk::kThreads;

template <typename T>
struct Smem {
  T *ph, *qs, *Pe, *Pg, *Pd, *Ee, *Eg, *Ed, *mf, *Cf, *mpn, *Spn, *H, *T1,
      *M, *dg, *vg;
  int ldm;
};

template <typename T>
__host__ __device__ size_t carve(unsigned char* raw, int n, Smem<T>* s) {
  Bump<T> b{raw ? reinterpret_cast<T*>(raw) : nullptr, 0};
  const size_t nn = (size_t)n * n;
  Smem<T> t;
  t.ldm = sqrtqr::odd_ld(2 * n);
  t.ph = b.take(n); t.qs = b.take(n);
  t.Pe = b.take(nn); t.Pg = b.take(n); t.Pd = b.take(nn);
  t.Ee = b.take(nn); t.Eg = b.take(n); t.Ed = b.take(nn);
  t.mf = b.take(n); t.Cf = b.take(nn); t.mpn = b.take(n); t.Spn = b.take(nn);
  t.H = b.take(nn); t.T1 = b.take(nn); t.M = b.take((size_t)t.ldm * n);
  t.dg = b.take(n); t.vg = b.take(n);
  if (s) *s = t;
  return b.used * sizeof(T);
}


template <typename T>
__device__ void load_model(const Smem<T>& s, const T* phi, const T* q,
                           int bm, int n) {
  for (int a = threadIdx.x; a < n; a += kThreads) {
    s.ph[a] = phi[(size_t)bm * n + a];
    const T qa = q[(size_t)bm * n + a];
    s.qs[a] = sqrt(qa > T(0) ? qa : T(0));
  }
  __syncthreads();
}

// the element of step t (bm: the model)
template <typename T>
__device__ void element(const Smem<T>& s, const T* mean_f, const T* chol_f,
                        const T* mean_p, const T* chol_p, int bm, int t,
                        int t_steps, int n) {
  __shared__ int ok_s;
  const int nn = n * n, ld = s.ldm;
  const bool last = t == t_steps - 1;
  const size_t st = (size_t)bm * t_steps + t;
  for (int a = threadIdx.x; a < n; a += kThreads) {
    s.mf[a] = mean_f[st * n + a];
    if (!last) s.mpn[a] = mean_p[(st + 1) * n + a];
  }
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    s.Cf[idx] = chol_f[st * nn + idx];
    if (!last) s.Spn[idx] = chol_p[(st + 1) * nn + idx];
  }
  if (threadIdx.x == 0) ok_s = last ? 0 : 1;
  __syncthreads();
  if (!last)
    for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
      const int a = idx / n, c = idx - (idx / n) * n;
      const T v = s.Spn[idx];
      if (!isfinite(v) || (a == c && !(v > T(0)))) ok_s = 0;
    }
  __syncthreads();
  const bool ok = ok_s != 0;
  if (!ok) {
    for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
      s.Ee[idx] = 0;
      s.Ed[idx] = s.Cf[idx];
    }
    for (int a = threadIdx.x; a < n; a += kThreads) s.Eg[a] = s.mf[a];
    __syncthreads();
    return;
  }
  // H = diag(phi) S_f S_f', then (S_p S_p')^-1 H; E = H'
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += s.Cf[a * n + k] * s.Cf[c * n + k];
    s.H[idx] = s.ph[a] * acc;
  }
  __syncthreads();
  pk::tri_solve(s.Spn, n, n, s.H, n, n, true, true);
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    s.Ee[idx] = s.H[c * n + a];
  }
  __syncthreads();
  pk::d_minus_mv(s.Eg, s.mf, s.Ee, s.mpn, n, n);
  // the stack [(I - E diag(phi)) S_f | E diag(sqrt q)]', column-major
  for (int idx = threadIdx.x; idx < 2 * nn; idx += kThreads) {
    const int c = idx / (2 * n), row = idx - (idx / (2 * n)) * (2 * n);
    T v;
    if (row < n) {
      v = 0;
      for (int k = 0; k < n; ++k)
        v += ((c == k ? T(1) : T(0)) - s.Ee[c * n + k] * s.ph[k]) *
             s.Cf[k * n + row];
    } else {
      v = s.Ee[c * n + row - n] * s.qs[row - n];
    }
    s.M[c * ld + row] = v;
  }
  __syncthreads();
  pk::tria(s.M, ld, 2 * n, n, s.dg, s.Ed);
}

// suffix := element (x) suffix; full: every part, else (g, D) only
template <typename T>
__device__ void combine(const Smem<T>& s, int n, bool full) {
  const int nn = n * n, ld = s.ldm;
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T t1 = 0, h = 0;
    for (int k = 0; k < n; ++k) {
      if (full) t1 += s.Ee[a * n + k] * s.Pe[k * n + c];
      h += s.Ee[a * n + k] * s.Pd[k * n + c];
    }
    s.T1[idx] = t1;
    s.H[idx] = h;
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += s.Ee[a * n + k] * s.Pg[k];
    s.vg[a] = acc + s.Eg[a];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * nn; idx += kThreads) {
    const int c = idx / (2 * n), row = idx - (idx / (2 * n)) * (2 * n);
    s.M[c * ld + row] = row < n ? s.H[c * n + row] : s.Ed[c * n + row - n];
  }
  for (int a = threadIdx.x; a < n; a += kThreads) s.Pg[a] = s.vg[a];
  if (full)
    for (int idx = threadIdx.x; idx < nn; idx += kThreads) s.Pe[idx] = s.T1[idx];
  __syncthreads();
  pk::tria(s.M, ld, 2 * n, n, s.dg, s.Pd);
}

// K22's Form for the scan schedule of pkalman_step.cuh: a reverse scan
template <typename T>
struct Form {
  using Scalar = T;
  using Args = pk::SmootherArgs<T>;
  using Shared = Smem<T>;
  static constexpr bool kReverse = true;
  static __host__ __device__ size_t carve(unsigned char* raw, const Args& a,
                                          Shared* s) {
    return ::carve<T>(raw, a.n, s);
  }
  // (E, g, D)
  static __host__ __device__ int parts(const Shared& s, int n,
                                       pk::Part<T>* p) {
    const int nn = n * n;
    p[0] = {s.Ee, s.Pe, nn};
    p[1] = {s.Eg, s.Pg, n};
    p[2] = {s.Ed, s.Pd, nn};
    return 3;
  }
  static __device__ void load(const Shared& s, const Args& a, int bm) {
    load_model(s, a.phi, a.q, bm, a.n);
  }
  static __device__ void row(const Shared&, const Args&, int, int) {}
  static __device__ void tails(const Shared&, const Args&, int, int) {}
  static __device__ void element(const Shared& s, const Args& a, int bm,
                                 int t) {
    ::element(s, a.mean_f, a.cov_f, a.mean_p, a.cov_p, bm, t, a.t_steps, a.n);
  }
  static __device__ void combine(const Shared& s, const Args& a, bool full) {
    ::combine(s, a.n, full);
  }
  static __device__ void write(const Shared& s, const Args& a, int bm,
                               int t) {
    pk::smoother_write(a, bm, t, s.Pg, s.Pd);
  }
};

}  // namespace

extern "C" {

// scratch: B * (chunks - 1) * (2 n^2 + n + n^2 + n) elements
int metran_sqrt_pkalman_smoother_f32(const void* phi, const void* q,
                                     const void* mean_f, const void* chol_f,
                                     const void* mean_p, const void* chol_p,
                                     void* mean_s, void* chol_s,
                                     void* scratch, int B, int t_steps, int n,
                                     int L, void* stream) {
  return pk::run_smoother<Form<float>>(phi, q, mean_f, chol_f, mean_p, chol_p,
      mean_s, chol_s, scratch, B, t_steps, n, L, stream);
}

int metran_sqrt_pkalman_smoother_f64(const void* phi, const void* q,
                                     const void* mean_f, const void* chol_f,
                                     const void* mean_p, const void* chol_p,
                                     void* mean_s, void* chol_s,
                                     void* scratch, int B, int t_steps, int n,
                                     int L, void* stream) {
  return pk::run_smoother<Form<double>>(phi, q, mean_f, chol_f, mean_p, chol_p,
      mean_s, chol_s, scratch, B, t_steps, n, L, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
