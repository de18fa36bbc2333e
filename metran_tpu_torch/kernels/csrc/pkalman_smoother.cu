// K20: the covariance-form associative-scan RTS smoother, one block per
// (model, chunk).
//
// Replaces the JAX package's device program B8 in metran_tpu/ops/
// pkalman.py, parallel_smoother (_smoother_element, _smoother_combine,
// _smoother_from_scan): the engine="parallel" smoother behind
// rts_smoother and the Metran products.
//
// Element of step t, from the filter's stored moments: with L_p the
// Cholesky factor of P_p at t + 1,
//   E = P_f diag(phi) P_p^-1,  g = m_f - E m_p,  L = P_f - E P_p E';
// the last step, and a step whose Cholesky fails, are cut: (0, m_f, P_f).
// The reverse scan composes earlier (x) later as
//   (E_e E_l, E_e g_l + g_e, E_e L_l E_e' + L_e),
// and (g, L) of the suffix starting at t is the smoothed moment.
//
// The reverse scan runs the forward machinery of pkalman_step.cuh on
// positions p = T - 1 - t, chunked from the last step (the short chunk is
// the earliest): the up-sweep folds each chunk's elements from its latest
// step back, the carry folds the totals into each chunk's incoming
// suffix, and the down-sweep runs the reduced combine ((g, L) only) and
// writes the smoothed moments.
//
// The sharded modes (the JAX package's _sharded_associative_scan :737 in
// reverse, behind sequence_sharded_filter :842) run one shard per launch:
// total (its full element (E, g, L)), carry (over the S gathered totals,
// the latest shard's first: each shard's incoming suffix (g, L)) and
// prefix (the shard's smoothed moments from its incoming suffix).  Only
// the series' last step is cut: a shard's last step reads the next
// shard's first predicted moment (the halo).
//
// Layouts, batch-major: phi (B, n); mean_f, mean_p (B, T, n); cov_f,
// cov_p (B, T, n, n); outputs mean_s (B, T, n), cov_s (B, T, n, n).
// Scratch: per model (chunks - 1) totals (E, g, L) and suffixes (g, L).
//
// What bounds it on an H100: latency.  A step is a Cholesky of P_p, two
// triangular solves with n right-hand sides and three n^3 products, one
// block barrier each.

#include "pkalman_step.cuh"

namespace {

using pk::Bump;
using pk::kThreads;

template <typename T>
struct Smem {
  T *ph, *Pe, *Pg, *Pl, *Ee, *Eg, *El, *mf, *Pf, *mpn, *Ppn, *Lc, *H, *T1,
      *T2, *vg;
};

template <typename T>
__host__ __device__ size_t carve(unsigned char* raw, int n, Smem<T>* s) {
  Bump<T> b{raw ? reinterpret_cast<T*>(raw) : nullptr, 0};
  const size_t nn = (size_t)n * n;
  Smem<T> t;
  t.ph = b.take(n);
  t.Pe = b.take(nn); t.Pg = b.take(n); t.Pl = b.take(nn);
  t.Ee = b.take(nn); t.Eg = b.take(n); t.El = b.take(nn);
  t.mf = b.take(n); t.Pf = b.take(nn); t.mpn = b.take(n); t.Ppn = b.take(nn);
  t.Lc = b.take(nn); t.H = b.take(nn); t.T1 = b.take(nn); t.T2 = b.take(nn);
  t.vg = b.take(n);
  if (s) *s = t;
  return b.used * sizeof(T);
}


// the element of step t (bm: the model); the next step's predicted
// moment is the halo at the last of these steps, which is cut only when
// it is the series' last (origin)
template <typename T>
__device__ void element(const Smem<T>& s, const pk::SmootherArgs<T>& g,
                        int bm, int t) {
  const int n = g.n, nn = n * n;
  const bool edge = t == g.t_steps - 1;
  const bool last = edge && g.origin;
  const size_t st = (size_t)bm * g.t_steps + t;
  const T* mpn = edge ? g.halo_m + (size_t)bm * n : g.mean_p + (st + 1) * n;
  const T* ppn = edge ? g.halo_c + (size_t)bm * nn
                      : g.cov_p + (st + 1) * nn;
  for (int a = threadIdx.x; a < n; a += kThreads) {
    s.mf[a] = g.mean_f[st * n + a];
    if (!last) s.mpn[a] = mpn[a];
  }
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    s.Pf[idx] = g.cov_f[st * nn + idx];
    if (!last) s.Lc[idx] = s.Ppn[idx] = ppn[idx];
  }
  __syncthreads();
  const bool ok = !last && pk::chol(s.Lc, n, n);
  if (!ok) {
    for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
      s.Ee[idx] = 0;
      s.El[idx] = s.Pf[idx];
    }
    for (int a = threadIdx.x; a < n; a += kThreads) s.Eg[a] = s.mf[a];
    __syncthreads();
    return;
  }
  // H = P_p^-1 (diag(phi) P_f'), E = H'
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    s.H[idx] = s.ph[a] * s.Pf[c * n + a];
  }
  __syncthreads();
  pk::tri_solve(s.Lc, n, n, s.H, n, n, true, true);
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    s.Ee[idx] = s.H[c * n + a];
  }
  __syncthreads();
  pk::d_minus_mv(s.Eg, s.mf, s.Ee, s.mpn, n, n);
  pk::mm(s.T1, s.Ee, s.Ppn, n, n, n);
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += s.T1[a * n + k] * s.Ee[c * n + k];
    s.El[idx] = s.Pf[idx] - acc;
  }
  __syncthreads();
}

// suffix := element (x) suffix; full: every part, else (g, L) only
template <typename T>
__device__ void combine(const Smem<T>& s, int n, bool full) {
  const int nn = n * n;
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T t1 = 0, t2 = 0;
    for (int k = 0; k < n; ++k) {
      if (full) t1 += s.Ee[a * n + k] * s.Pe[k * n + c];
      t2 += s.Ee[a * n + k] * s.Pl[k * n + c];
    }
    s.T1[idx] = t1;
    s.T2[idx] = t2;
  }
  for (int a = threadIdx.x; a < n; a += kThreads) {
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += s.Ee[a * n + k] * s.Pg[k];
    s.vg[a] = acc + s.Eg[a];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int a = idx / n, c = idx - (idx / n) * n;
    T acc = 0;
    for (int k = 0; k < n; ++k) acc += s.T2[a * n + k] * s.Ee[c * n + k];
    s.Pl[idx] = acc + s.El[idx];
    if (full) s.Pe[idx] = s.T1[idx];
  }
  for (int a = threadIdx.x; a < n; a += kThreads) s.Pg[a] = s.vg[a];
  __syncthreads();
}

template <typename T>
__device__ void load_phi(const Smem<T>& s, const T* phi, int bm, int n) {
  for (int a = threadIdx.x; a < n; a += kThreads)
    s.ph[a] = phi[(size_t)bm * n + a];
  __syncthreads();
}

// K20's Form for the scan schedule of pkalman_step.cuh: a reverse scan
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
  // (E, g, L)
  static __host__ __device__ int parts(const Shared& s, int n,
                                       pk::Part<T>* p) {
    const int nn = n * n;
    p[0] = {s.Ee, s.Pe, nn};
    p[1] = {s.Eg, s.Pg, n};
    p[2] = {s.El, s.Pl, nn};
    return 3;
  }
  static __device__ void load(const Shared& s, const Args& a, int bm) {
    load_phi(s, a.phi, bm, a.n);
  }
  static __device__ void row(const Shared&, const Args&, int, int) {}
  static __device__ void tails(const Shared&, const Args&, int, int) {}
  static __device__ void element(const Shared& s, const Args& a, int bm,
                                 int t) {
    ::element(s, a, bm, t);
  }
  static __device__ void combine(const Shared& s, const Args& a, bool full) {
    ::combine(s, a.n, full);
  }
  static __device__ void write(const Shared& s, const Args& a, int bm,
                               int t) {
    pk::smoother_write(a, bm, t, s.Pg, s.Pl);
  }
};

}  // namespace

extern "C" {

// scratch: B * (chunks - 1) * (2 n^2 + n + n^2 + n) elements
int metran_pkalman_smoother_f32(const void* phi, const void* mean_f,
                                const void* cov_f, const void* mean_p,
                                const void* cov_p, void* mean_s, void* cov_s,
                                void* scratch, int B, int t_steps, int n,
                                int L, void* stream) {
  return pk::run_smoother<Form<float>>(phi, nullptr, mean_f, cov_f, mean_p,
      cov_p, mean_s, cov_s, scratch, B, t_steps, n, L, stream);
}

int metran_pkalman_smoother_f64(const void* phi, const void* mean_f,
                                const void* cov_f, const void* mean_p,
                                const void* cov_p, void* mean_s, void* cov_s,
                                void* scratch, int B, int t_steps, int n,
                                int L, void* stream) {
  return pk::run_smoother<Form<double>>(phi, nullptr, mean_f, cov_f, mean_p,
      cov_p, mean_s, cov_s, scratch, B, t_steps, n, L, stream);
}

// the sharded modes.  total: halo_m / halo_c (B, n) / (B, n, n) the next
// shard's first predicted moment (null with origin: these steps end the
// series), tot scratch B * chunks * (2 n^2 + n), total (B, 2 n^2 + n)
#define PK_SMOOTH_TOTAL(T, SUF)                                             \
  int metran_pkalman_smoother_total_##SUF(                                  \
      const void* phi, const void* mean_f, const void* cov_f,               \
      const void* mean_p, const void* cov_p, const void* halo_m,            \
      const void* halo_c, void* tot, void* total, int B, int t_steps,       \
      int n, int L, int origin, void* stream) {                             \
    const pk::SmootherArgs<T> a{(const T*)phi, nullptr, (const T*)mean_f,   \
        (const T*)cov_f, (const T*)mean_p, (const T*)cov_p, nullptr,        \
        nullptr, t_steps, n, origin, (const T*)halo_m, (const T*)halo_c};   \
    return pk::run_total<Form<T>>(a, tot, total, B, L, stream);             \
  }
PK_SMOOTH_TOTAL(float, f32)
PK_SMOOTH_TOTAL(double, f64)

// carry: totals (B, S, 2 n^2 + n) in scan order (the latest shard first),
// pre (B, S - 1, n^2 + n): the incoming (g, L) of the shards after it
#define PK_SMOOTH_CARRY(T, SUF)                                             \
  int metran_pkalman_smoother_carry_##SUF(const void* totals, void* pre,    \
                                           int B, int S, int n,             \
                                           void* stream) {                  \
    const pk::SmootherArgs<T> a{nullptr, nullptr, nullptr, nullptr,         \
        nullptr, nullptr, nullptr, nullptr, 0, n, 0, nullptr, nullptr};     \
    return pk::run_carry<Form<T>>(a, totals, pre, B, S, stream);            \
  }
PK_SMOOTH_CARRY(float, f32)
PK_SMOOTH_CARRY(double, f64)

// prefix: tot the shard's chunk totals from its total launch, pre
// scratch B * (chunks - 1) * (n^2 + n), in_pre (B, n^2 + n) the incoming
// suffix (null with origin)
#define PK_SMOOTH_PREFIX(T, SUF)                                            \
  int metran_pkalman_smoother_prefix_##SUF(                                 \
      const void* phi, const void* mean_f, const void* cov_f,               \
      const void* mean_p, const void* cov_p, const void* halo_m,            \
      const void* halo_c, void* mean_s, void* cov_s, const void* tot,       \
      void* pre, const void* in_pre, int B, int t_steps, int n, int L,      \
      int origin, void* stream) {                                           \
    const pk::SmootherArgs<T> a{(const T*)phi, nullptr, (const T*)mean_f,   \
        (const T*)cov_f, (const T*)mean_p, (const T*)cov_p, (T*)mean_s,     \
        (T*)cov_s, t_steps, n, origin, (const T*)halo_m,                    \
        (const T*)halo_c};                                                  \
    return pk::run_prefix<Form<T>>(a, tot, pre, in_pre, B, L, stream);      \
  }
PK_SMOOTH_PREFIX(float, f32)
PK_SMOOTH_PREFIX(double, f64)

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
