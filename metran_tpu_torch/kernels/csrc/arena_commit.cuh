// The commit half of the exact arena update K16, shared by its three
// engine families (arena_joint.cu, arena_gated.cu, arena_sqrt.cu): the
// on-device integrity gate, the convergence flag, the detection tail,
// the masked in-place scatter of one block's row and, in the horizons
// mode, the commit-time forecast pass of the row as written.
//
// Replaces the tail of the JAX package's B13,
// metran_tpu/serve/engine.py::make_arena_update_fn (:1042) with
// _arena_posterior_ok (:996): after the engine's step body has left the
// appended posterior (m, F) of the block's row in shared memory,
//   ok    = every entry of m, F and the row's per-step sigma and detf
//           finite; covariance rows also |F - F'| <= 1e-4 scale and a
//           finite Cholesky of sym(F) + 1e-4 scale I (scale =
//           max(1, max |F|)), i.e. no eigenvalue below -1e-4 scale;
//           factor rows a finite F F' (PSD by construction);
//   conv  = (steady_tol > 0) every step's mask equals the real-slot
//           pattern and |F_written - F_prior| <= steady_tol entrywise
//           (ops.steady_converged; a rejected row writes its prior);
//   det   = (detection armed) the detector recursion over the block's
//           z-scores from the row's resident state, armed by the
//           resident t_seen against det_min_seen; a rejected row keeps
//           its state bit for bit and books zero counts; the stats are
//           [C+, C-, LB Q] of the written state;
//   write = mean and F into the row only when ok, then t_seen += k and
//           version += 1 (thread 0);
//   hz    = (horizons mode, a template parameter of the families) the
//           (H, N) observation means and variances of the WRITTEN row
//           (a rejected row's prior) at each horizon of the set: the
//           JAX _horizon_pass (:673) of mean_w, fac_w, as K18 computes
//           them (forecastk::gram_block on a factor row, then
//           forecastk::horizons_block) — the posterior from shared
//           memory on a committed row (the very values scattered), from
//           the untouched arena row on a rejected one.  Its scratch
//           reuses the commit's after the scatter (tail_smem).
// Rows of one launch are distinct (the wrapper refuses repeats), so a
// block owns its row: no other block reads or writes it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "detect_step.cuh"
#include "forecast_step.cuh"

namespace arenak {

// the arena leaves, one dispatch's inputs and outputs, and its knobs
template <typename T>
struct UpdateArgs {
  T* mean;          // (B, S)
  T* fac;           // (B, S, S): covariances, or factors (sqrt)
  int32_t* t_seen;  // (B,)
  int32_t* version;  // (B,)
  const T *phi, *q, *z, *r;  // (B, S), (B, S, S), (B, N, S), (B, N)
  T* det;           // (B, 6, N), or null: detection off
  const int32_t* rows;  // (G,)
  const T* y;            // (G, k, N)
  const uint8_t* mask;   // (G, k, N)
  const uint8_t* real;   // (G, N), read with steady_tol > 0
  const T *rail_lo, *rail_hi, *quantum, *scale;  // (G, N), robust
  uint8_t* ok;           // (G,)
  T *sigma, *detf;       // (G, k)
  T* zscore;             // (G, k, N)
  int8_t* verdict;       // (G, k, N)
  int32_t* iters;        // (G, k, N), robust
  int32_t* det_counts;   // (G, 3, N)
  T* det_stats;          // (G, 3, N)
  uint8_t* conv;         // (G,), or null: steady_tol == 0
  const T* horizons;     // (H,), read in the horizons mode
  T *fmeans, *fvars;     // (G, H, N), or null: the horizons mode is off
  double thresh, nu, tol, nonconv_tol, c_floor, eps, steady_tol;
  detectk::Params dp;
  int min_seen, det_min_seen, validate, k, N, S, H;
};

// the integrity verdict of the block's posterior (m (S), F (S, S));
// W: S*S scratch, red: 2 * blockDim.x scratch
template <typename T, bool kSqrt>
__device__ bool posterior_ok(const T* m, const T* F, const T* sig,
                             const T* det, int k, int S, T* W, T* red) {
  __shared__ int bad_s, ok_s;
  __shared__ T scale_s;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (tid == 0) bad_s = 0;
  __syncthreads();
  bool bad = false;
  for (int i = tid; i < S; i += nt) bad |= !isfinite(m[i]);
  for (int t = tid; t < k; t += nt)
    bad |= !isfinite(sig[t]) || !isfinite(det[t]);
  T mx = 0, asym = 0;
  for (int idx = tid; idx < S * S; idx += nt) {
    const int i = idx / S, j = idx - (idx / S) * S;
    const T v = F[idx];
    bad |= !isfinite(v);
    if (kSqrt) {  // the reconstituted covariance must be finite
      T acc = 0;
      for (int c = 0; c < S; ++c) acc += F[i * S + c] * F[j * S + c];
      bad |= !isfinite(acc);
    } else {
      const T av = fabs(v);
      if (av > mx) mx = av;
      const T d = fabs(v - F[j * S + i]);
      if (d > asym) asym = d;
    }
  }
  if (bad) bad_s = 1;
  red[tid] = mx;
  red[nt + tid] = asym;
  __syncthreads();
  if (kSqrt) return bad_s == 0;
  if (tid == 0) {
    T gm = 0, ga = 0;
    for (int t = 0; t < nt; ++t) {
      if (red[t] > gm) gm = red[t];
      if (red[nt + t] > ga) ga = red[nt + t];
    }
    const T scale = gm > T(1) ? gm : T(1);
    scale_s = scale;
    ok_s = bad_s == 0 && ga <= T(1e-4) * scale;
  }
  __syncthreads();
  if (!ok_s) return false;  // block-uniform
  // the jittered Cholesky of sym(F) + 1e-4 scale I, lower triangle of W
  const T jit = T(1e-4) * scale_s;
  for (int idx = tid; idx < S * S; idx += nt) {
    const int i = idx / S, j = idx - (idx / S) * S;
    W[idx] = (F[idx] + F[j * S + i]) * T(0.5) + (i == j ? jit : T(0));
  }
  __syncthreads();
  for (int c = 0; c < S; ++c) {
    const T d = W[c * S + c];
    if (!(d > T(0)) || !isfinite(d)) {  // block-uniform verdict
      if (tid == 0) ok_s = 0;
      break;
    }
    const T sq = sqrt(d);
    for (int rr = c + 1 + tid; rr < S; rr += nt) W[rr * S + c] /= sq;
    __syncthreads();
    if (tid == 0) W[c * S + c] = sq;
    const int n2 = S - c - 1;
    for (int idx = tid; idx < n2 * n2; idx += nt) {
      const int rr = c + 1 + idx / n2, cc = c + 1 + idx % n2;
      if (cc <= rr) W[rr * S + cc] -= W[rr * S + c] * W[cc * S + c];
    }
    __syncthreads();
  }
  __syncthreads();
  for (int idx = tid; idx < S * S; idx += nt) {
    const int i = idx / S, j = idx - (idx / S) * S;
    if (j <= i && !isfinite(W[idx])) ok_s = 0;
  }
  __syncthreads();
  return ok_s != 0;
}

// gate, convergence flag, detection tail and scatter of block b's row
// (its appended posterior m, F in shared memory; t_row the row's t_seen
// before the append); W, red: scratch as posterior_ok's.  Returns the
// block-uniform ok verdict.
template <typename T, bool kSqrt>
__device__ bool commit_block(const UpdateArgs<T>& a, const T* m, const T* F,
                             int b, int row, int t_row, T* W, T* red) {
  __shared__ int conv_s;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int k = a.k, N = a.N, S = a.S;
  const size_t nss = (size_t)S * S;
  const bool ok =
      !a.validate || posterior_ok<T, kSqrt>(m, F, a.sigma + (size_t)b * k,
                                            a.detf + (size_t)b * k, k, S, W,
                                            red);
  T* frow = a.fac + (size_t)row * nss;
  if (a.conv != nullptr) {
    if (tid == 0) conv_s = 1;
    __syncthreads();
    bool c = true;
    const uint8_t* mb = a.mask + (size_t)b * k * N;
    for (int idx = tid; idx < k * N; idx += nt)
      c &= (mb[idx] != 0) == (a.real[(size_t)b * N + idx % N] != 0);
    const T tol = T(a.steady_tol);
    for (int idx = tid; idx < S * S; idx += nt) {
      const T w = ok ? F[idx] : frow[idx];
      c &= fabs(w - frow[idx]) <= tol;
    }
    if (!c) conv_s = 0;
    __syncthreads();
    if (tid == 0) a.conv[b] = conv_s ? 1 : 0;
  }
  if (a.det != nullptr)
    detectk::arena_row<T>(a.det, row, b, a.zscore, a.mask, a.det_counts,
                          a.det_stats, k, N, t_row >= a.det_min_seen, ok,
                          a.dp, tid, nt);
  __syncthreads();
  if (ok) {  // the masked scatter: a rejected row stays as it was
    for (int i = tid; i < S; i += nt) a.mean[(size_t)row * S + i] = m[i];
    for (int idx = tid; idx < S * S; idx += nt) frow[idx] = F[idx];
  }
  if (tid == 0) {
    a.ok[b] = ok ? 1 : 0;
    if (ok) {
      a.t_seen[row] = t_row + k;
      a.version[row] = a.version[row] + 1;
    }
  }
  return ok;
}

// the horizons mode's tail after commit_block: the forecast moments of
// block b's row as written — (m, F) from shared memory when the row
// committed, the untouched arena row when it was rejected (this launch
// never writes it, so the read-only loads are safe).  scratch: the
// commit's, tail_smem elements.
template <typename T, bool kSqrt>
__device__ void horizons_tail(const UpdateArgs<T>& a, const T* m,
                              const T* F, bool ok, int b, int row,
                              unsigned char* scratch) {
  const int N = a.N, S = a.S;
  const size_t nss = (size_t)S * S;
  __syncthreads();  // every use of the commit scratch is over
  const T* meanb = ok ? m : a.mean + (size_t)row * S;
  const T* covb = ok ? F : a.fac + (size_t)row * nss;
  if (kSqrt) {
    T* C = reinterpret_cast<T*>(scratch) + forecastk::smem_elems<T>(N, S);
    forecastk::gram_block<T>(covb, C, S);
    __syncthreads();
    covb = C;
  }
  forecastk::horizons_block<T>(scratch, a.phi + (size_t)row * S,
                               a.q + (size_t)row * nss,
                               a.z + (size_t)row * N * S,
                               a.r + (size_t)row * N, meanb, covb,
                               a.horizons, a.H, a.fmeans, a.fvars, b, N, S);
}

// the scratch the commit needs after a body's shared memory (bytes)
template <typename T>
__host__ __device__ inline size_t commit_smem(int S, int threads) {
  return sizeof(T) * ((size_t)S * S + 2 * (size_t)threads);
}

// the scratch the horizons tail needs in the same place (bytes):
// moments_block's, and the reconstituted covariance of a factor row
template <typename T>
__host__ __device__ inline size_t tail_smem(int N, int S, bool sqrt_rows) {
  return sizeof(T) * (forecastk::smem_elems<T>(N, S) +
                      (sqrt_rows ? (size_t)S * S : 0));
}

// the scratch after a body's shared memory: the commit's, or the
// horizons tail's where that is larger
template <typename T>
__host__ __device__ inline size_t after_body_smem(int N, int S, int threads,
                                                  bool hz, bool sqrt_rows) {
  const size_t c = commit_smem<T>(S, threads);
  const size_t t = hz ? tail_smem<T>(N, S, sqrt_rows) : 0;
  return c > t ? c : t;
}

// `off` rounded up to 16 bytes: where the commit scratch starts
__host__ __device__ inline size_t align16(size_t off) {
  return (off + 15) & ~(size_t)15;
}

template <typename T>
UpdateArgs<T> make_args(void* mean, void* fac, void* t_seen, void* version,
                        const void* phi, const void* q, const void* z,
                        const void* r, void* det, const void* rows,
                        const void* y, const void* mask, const void* real,
                        const void* rail_lo, const void* rail_hi,
                        const void* quantum, const void* scale, void* ok,
                        void* sigma, void* detf, void* zscore, void* verdict,
                        void* iters, void* det_counts, void* det_stats,
                        void* conv, const void* horizons, void* fmeans,
                        void* fvars, double thresh, double nu, double tol,
                        double nonconv_tol, double c_floor, double eps,
                        double steady_tol, double ck, double ch, double lam,
                        double warm, double qbar, double abar, double tiny,
                        int min_seen, int det_min_seen, int validate, int k,
                        int N, int S, int H) {
  UpdateArgs<T> a;
  a.mean = (T*)mean;
  a.fac = (T*)fac;
  a.t_seen = (int32_t*)t_seen;
  a.version = (int32_t*)version;
  a.phi = (const T*)phi;
  a.q = (const T*)q;
  a.z = (const T*)z;
  a.r = (const T*)r;
  a.det = (T*)det;
  a.rows = (const int32_t*)rows;
  a.y = (const T*)y;
  a.mask = (const uint8_t*)mask;
  a.real = (const uint8_t*)real;
  a.rail_lo = (const T*)rail_lo;
  a.rail_hi = (const T*)rail_hi;
  a.quantum = (const T*)quantum;
  a.scale = (const T*)scale;
  a.ok = (uint8_t*)ok;
  a.sigma = (T*)sigma;
  a.detf = (T*)detf;
  a.zscore = (T*)zscore;
  a.verdict = (int8_t*)verdict;
  a.iters = (int32_t*)iters;
  a.det_counts = (int32_t*)det_counts;
  a.det_stats = (T*)det_stats;
  a.conv = (uint8_t*)conv;
  a.horizons = (const T*)horizons;
  a.fmeans = (T*)fmeans;
  a.fvars = (T*)fvars;
  a.thresh = thresh;
  a.nu = nu;
  a.tol = tol;
  a.nonconv_tol = nonconv_tol;
  a.c_floor = c_floor;
  a.eps = eps;
  a.steady_tol = steady_tol;
  a.dp = detectk::Params{ck, ch, lam, warm, qbar, abar, tiny};
  a.min_seen = min_seen;
  a.det_min_seen = det_min_seen;
  a.validate = validate;
  a.k = k;
  a.N = N;
  a.S = S;
  a.H = H;
  return a;
}

// one block per dispatched row
template <typename T, typename Kernel>
int launch_rows(Kernel kernel, const UpdateArgs<T>& a, int G, int threads,
                size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (G == 0) return 0;
  kernel<<<G, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace arenak

// the C signature of every K16 entry point: the arena leaves, the
// dispatch's inputs, its outputs (null where a mode is off: fmeans null
// turns the horizons mode off), the knobs
#define METRAN_ARENA_UPDATE_PARAMS                                           \
  void *mean, void *fac, void *t_seen, void *version, const void *phi,      \
      const void *q, const void *z, const void *r, void *det,               \
      const void *rows, const void *y, const void *mask, const void *real,  \
      const void *rail_lo, const void *rail_hi, const void *quantum,        \
      const void *scale, void *ok, void *sigma, void *detf, void *zscore,   \
      void *verdict, void *iters, void *det_counts, void *det_stats,        \
      void *conv, const void *horizons, void *fmeans, void *fvars,          \
      double thresh, double nu, double tol, double nonconv_tol,             \
      double c_floor, double eps, double steady_tol, double ck, double ch,  \
      double lam, double warm, double qbar, double abar, double tiny,       \
      int min_seen, int det_min_seen, int validate, int mode, int G, int k, \
      int N, int S, int H, void *stream
#define METRAN_ARENA_UPDATE_ARGS(T)                                          \
  arenak::make_args<T>(mean, fac, t_seen, version, phi, q, z, r, det, rows, \
                       y, mask, real, rail_lo, rail_hi, quantum, scale, ok, \
                       sigma, detf, zscore, verdict, iters, det_counts,     \
                       det_stats, conv, horizons, fmeans, fvars, thresh,    \
                       nu, tol, nonconv_tol, c_floor, eps, steady_tol, ck,  \
                       ch, lam, warm, qbar, abar, tiny, min_seen,           \
                       det_min_seen, validate, k, N, S, H)
