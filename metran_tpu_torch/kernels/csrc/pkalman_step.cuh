// The bodies shared by the associative-scan kernels K19-K22
// (pkalman_filter.cu, pkalman_smoother.cu, sqrt_pkalman_filter.cu,
// sqrt_pkalman_smoother.cu): small dense linear algebra on one thread
// block's shared memory, and the chunk bookkeeping of the scan.
//
// The JAX package (metran_tpu/ops/pkalman.py) combines per-step elements
// with an associative operator under lax.associative_scan (blocked above
// 2,048 steps).  Every kernel here runs the same operator over a chunked
// decomposition of the time axis, one thread block per (model, chunk):
//
//   up-sweep    each chunk but the last folds its elements left to right
//               (the full combine) into its total;
//   carry       one block per model folds the totals into every chunk's
//               exclusive prefix (the cross-block steps of
//               blocked_associative_scan);
//   down-sweep  each chunk folds its elements again from its prefix and
//               writes the per-step outputs.
//
// The time axis sharded over a device mesh (the JAX package's
// _sharded_associative_scan, metran_tpu/ops/pkalman.py) runs the same
// pieces as three modes, one shard of the series per launch:
//
//   total       the up-sweep over every chunk, the last included, then one
//               block per model folds the chunk totals into the shard's
//               full total (fold);
//   carry       the carry over the S gathered shard totals: each shard's
//               exclusive prefix (the chunk carry run once at length S);
//   prefix      the carry over the shard's chunk totals (left in scratch
//               by its total launch) from the shard's incoming prefix, and
//               the down-sweep.
//
// A shard that does not hold the series' first step (a reverse scan: its
// last) has no origin: its first step is an ordinary step, its first
// chunk starts from the incoming prefix, and a smoother's last step reads
// the next shard's first predicted moment (the halo).  Only a carry that
// starts at the origin shard's total may run the reduced combine, so a
// shard's total is a full element.
//
// A prefix that starts at the first step (a reverse scan: that ends at
// the last step) is a filtered (smoothed) distribution: its part of the
// combine that the outputs read does not depend on the prefix's other
// parts, so the carry and the down-sweep run the combine's reduced form
// and only the up-sweep the full one.  Values agree with the JAX
// program's to reassociation rounding.  Elements are formed on the fly
// in both sweeps, so device scratch is O(chunks) per model.  The
// schedule is written once at the end of this file over a Form, which
// each kernel source defines from its element, combine and tails.
//
// Conventions: matrices are row-major in shared memory with leading
// dimension equal to their column count unless stated; every helper is
// called by all threads of the block and ends with a barrier; outputs
// never alias inputs.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sqrt_qr.cuh"

namespace pk {

#ifndef PK_THREADS
#define PK_THREADS 128
#endif
constexpr int kThreads = PK_THREADS;

// a bump allocator over a block's dynamic shared memory (a null base
// only counts)
template <typename T>
struct Bump {
  T* base;
  size_t used;
  __host__ __device__ T* take(size_t n) {
    T* r = base ? base + used : nullptr;
    used += n;
    return r;
  }
};

// chunk bookkeeping: chunk k of a scan over t_steps positions with chunk
// length L covers [k L, min(t_steps, (k + 1) L))
__host__ __device__ inline int n_chunks(int t_steps, int L) {
  return (t_steps + L - 1) / L;
}

// C (M x N) = A (M x K) B (K x N)
template <typename T>
__device__ void mm(T* C, const T* A, const T* B, int M, int N, int K) {
  for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
    const int i = idx / N, j = idx - (idx / N) * N;
    T s = 0;
    for (int k = 0; k < K; ++k) s += A[i * K + k] * B[k * N + j];
    C[idx] = s;
  }
  __syncthreads();
}

// y (M) = d - A x for A (M x K)
template <typename T>
__device__ void d_minus_mv(T* y, const T* d, const T* A, const T* x, int M,
                           int K) {
  for (int i = threadIdx.x; i < M; i += kThreads) {
    T s = 0;
    for (int k = 0; k < K; ++k) s += A[i * K + k] * x[k];
    y[i] = d[i] - s;
  }
  __syncthreads();
}

// in-place lower Cholesky of the k x k matrix A (leading dimension ld),
// left-looking by columns; returns whether LAPACK's potrf would have
// succeeded with a finite factor (every pivot > 0, every entry finite).
// The strict upper part is left as it was.
template <typename T>
__device__ bool chol(T* A, int ld, int k) {
  __shared__ int ok;
  const int tid = threadIdx.x;
  if (tid == 0) ok = 1;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    if (tid == 0) {
      T s = A[j * ld + j];
      for (int p = 0; p < j; ++p) s -= A[j * ld + p] * A[j * ld + p];
      if (!(s > T(0))) ok = 0;
      A[j * ld + j] = sqrt(s);
    }
    __syncthreads();
    const T d = A[j * ld + j];
    for (int i = j + 1 + tid; i < k; i += kThreads) {
      T s = A[i * ld + j];
      for (int p = 0; p < j; ++p) s -= A[i * ld + p] * A[j * ld + p];
      A[i * ld + j] = s / d;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < k * k; idx += kThreads) {
    const int i = idx / k, j = idx - (idx / k) * k;
    if (j <= i && !isfinite(A[i * ld + j])) ok = 0;
  }
  __syncthreads();
  const bool res = ok != 0;
  __syncthreads();
  return res;
}

// solves with the lower factor L (k x k) of a Cholesky, column by
// column of the k x nc right-hand side B (leading dimension ldb), in
// place: L B := B (fwd), L' B := B (bwd), L L' B := B (both)
template <typename T>
__device__ void tri_solve(const T* L, int ldl, int k, T* B, int ldb, int nc,
                          bool fwd, bool bwd) {
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    if (fwd)
      for (int i = 0; i < k; ++i) {
        T s = B[i * ldb + c];
        for (int p = 0; p < i; ++p) s -= L[i * ldl + p] * B[p * ldb + c];
        B[i * ldb + c] = s / L[i * ldl + i];
      }
    if (bwd)
      for (int i = k - 1; i >= 0; --i) {
        T s = B[i * ldb + c];
        for (int p = i + 1; p < k; ++p) s -= L[p * ldl + i] * B[p * ldb + c];
        B[i * ldb + c] = s / L[i * ldl + i];
      }
  }
  __syncthreads();
}

// X B := R in place for the n x n matrix X (destroyed) and the n x nr
// right-hand side R (leading dimension ldr): Gaussian elimination with
// partial pivoting (LAPACK's getrf pivot choice: the first entry of
// largest magnitude), then back substitution column by column
template <typename T>
__device__ void lu_solve(T* X, int n, T* R, int ldr, int nr) {
  __shared__ int piv;
  const int tid = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    if (tid == 0) {
      int p = j;
      T best = fabs(X[j * n + j]);
      for (int i = j + 1; i < n; ++i) {
        const T v = fabs(X[i * n + j]);
        if (v > best) {
          best = v;
          p = i;
        }
      }
      piv = p;
    }
    __syncthreads();
    const int p = piv;
    if (p != j) {
      for (int c = tid; c < n; c += kThreads) {
        const T a = X[j * n + c];
        X[j * n + c] = X[p * n + c];
        X[p * n + c] = a;
      }
      for (int c = tid; c < nr; c += kThreads) {
        const T a = R[j * ldr + c];
        R[j * ldr + c] = R[p * ldr + c];
        R[p * ldr + c] = a;
      }
      __syncthreads();
    }
    const T d = X[j * n + j];
    const int wx = n - j - 1;
    const int w = wx + nr;
    for (int idx = tid; idx < wx * w; idx += kThreads) {
      const int i = j + 1 + idx / w, c = idx - (idx / w) * w;
      const T l = X[i * n + j] / d;
      if (c < wx)
        X[i * n + j + 1 + c] -= l * X[j * n + j + 1 + c];
      else
        R[i * ldr + c - wx] -= l * R[j * ldr + c - wx];
    }
    __syncthreads();
  }
  for (int c = tid; c < nr; c += kThreads)
    for (int i = n - 1; i >= 0; --i) {
      T s = R[i * ldr + c];
      for (int k = i + 1; k < n; ++k) s -= X[i * n + k] * R[k * ldr + c];
      R[i * ldr + c] = s / X[i * n + i];
    }
  __syncthreads();
}

// L (n x n lower, row-major) with L L' = B B', where the caller has put
// B' (rows x n, rows >= n) column-major in M (leading dimension ld): the
// Householder QR of sqrt_qr.cuh, rows sign-normalised (the JAX
// package's _tria).  M is destroyed; dg holds n scratch entries.
template <typename T>
__device__ void tria(T* M, int ld, int rows, int n, T* dg, T* L) {
  sqrtqr::house_qr<T, kThreads>(M, ld, rows, n, 0, rows, dg);
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int a = idx / n, b = idx - (idx / n) * n;
    T v = T(0);
    if (a == b)
      v = dg[b] * sqrtqr::row_sign(dg[b]);
    else if (a > b)
      v = M[a * ld + b] * sqrtqr::row_sign(dg[b]);
    L[idx] = v;
  }
  __syncthreads();
}

// the launch's dynamic shared memory above the default 48 KB
inline cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// copy n entries
template <typename T>
__device__ void copy(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  __syncthreads();
}

// the masked observation row of a step (the JAX _masked_obs): msk 0/1,
// the observation with masked slots zeroed (0 * NaN must not reach the
// scan), r_t (unit pseudo-noise where masked) and Z_t = Z o mask
template <typename T>
__device__ void masked_row(const T* Z, const T* r, const T* y,
                           const uint8_t* mk, int N, int n, T* msk, T* yv,
                           T* rt, T* Zt) {
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const bool on = mk[i] != 0;
    msk[i] = on ? T(1) : T(0);
    yv[i] = on ? y[i] : T(0);
    rt[i] = (on ? r[i] : T(0)) + (T(1) - msk[i]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * n; idx += kThreads)
    Zt[idx] = Z[idx] * msk[idx / n];
  __syncthreads();
}


// ---------------------------------------------------------------------
// The chunked scan's schedule, written once over a Form F: a struct of
// static members that a kernel source defines beside its bodies.
//
//   Scalar, Args (FilterArgs or SmootherArgs), Shared (its shared memory
//   layout); kReverse: positions run from the last step back, t = T-1-p;
//   carve(raw, a, Shared*)  lay out the shared memory and return its bytes
//                           (a null raw only counts);
//   parts(s, n, Part*)      the element's slots beside the running
//                           prefix's, in the order of a chunk total, and
//                           their number; parts [kMoment0, kMoment1) are
//                           the moment the outputs read (mean, then
//                           covariance or factor), all the reduced
//                           combine keeps;
//   load(s, a, bm)          model bm's constants;
//   row(s, a, bm, t)        step t's input;
//   tails(s, a, bm, t)      the outputs of step t read off the prefix that
//                           ends before it (a filter's predicted moments
//                           and likelihood terms);
//   element(s, a, bm, t)    step t's element into the element slots;
//   combine(s, a, full)     fold the element into the prefix: every part
//                           (full), or the moment only;
//   write(s, a, bm, t)      the outputs read off the prefix through t.
// ---------------------------------------------------------------------

template <typename T>
struct Part {
  T* e;  // the element's slot
  T* p;  // the running prefix's
  int len;
};
constexpr int kMaxParts = 5;
constexpr int kMoment0 = 1, kMoment1 = 3;

// the filters' arguments; cov_p / cov_f hold factors in the square-root
// form, q its diagonal
// (origin: step 0 of these steps is the series' first)
template <typename T>
struct FilterArgs {
  const T *phi, *q, *z, *r, *y;
  const uint8_t* mask;
  T *mean_p, *cov_p, *mean_f, *cov_f, *sigma, *detf;
  int t_steps, N, n, store, origin;
  // step t is the series' first: the P1- prior and phi_e = 0
  __host__ __device__ bool first(int t) const { return origin && t == 0; }
};

// the smoothers' arguments: the filter's stored moments (factors in the
// square-root form; q the diagonal of Q there, unused by the covariance
// form) and the smoothed outputs; without origin (the last of these
// steps is not the series' last), halo_m / halo_c (B, n) / (B, n, n) hold
// the predicted moment of the step after the last
template <typename T>
struct SmootherArgs {
  const T *phi, *q, *mean_f, *cov_f, *mean_p, *cov_p;
  T *mean_s, *cov_s;
  int t_steps, n, origin;
  const T *halo_m, *halo_c;
};

// the entries of parts [lo, hi)
template <typename T>
__host__ __device__ size_t span(const Part<T>* pt, int lo, int hi) {
  size_t len = 0;
  for (int i = lo; i < hi; ++i) len += pt[i].len;
  return len;
}

// the prefix's parts [lo, hi) := the element's
template <typename T>
__device__ void seed(const Part<T>* pt, int lo, int hi) {
  for (int i = lo; i < hi; ++i)
    for (int idx = threadIdx.x; idx < pt[i].len; idx += kThreads)
      pt[i].p[idx] = pt[i].e[idx];
  __syncthreads();
}

// dst (packed) := the prefix's parts [lo, hi)
template <typename T>
__device__ void pack(T* dst, const Part<T>* pt, int lo, int hi) {
  for (int i = lo; i < hi; dst += pt[i].len, ++i)
    for (int idx = threadIdx.x; idx < pt[i].len; idx += kThreads)
      dst[idx] = pt[i].p[idx];
  __syncthreads();
}

// the element's (to_prefix: the prefix's) parts [lo, hi) := src (packed)
template <typename T>
__device__ void unpack(const Part<T>* pt, int lo, int hi, const T* src,
                       bool to_prefix) {
  for (int i = lo; i < hi; src += pt[i].len, ++i) {
    T* d = to_prefix ? pt[i].p : pt[i].e;
    for (int idx = threadIdx.x; idx < pt[i].len; idx += kThreads)
      d[idx] = src[idx];
  }
  __syncthreads();
}

// a filter's input at step t: its masked observation row
template <class S, typename T>
__device__ void filter_row(const S& s, const FilterArgs<T>& a, int bm,
                           int t) {
  const size_t at = ((size_t)bm * a.t_steps + t) * a.N;
  masked_row(s.Z, s.rr, a.y + at, a.mask + at, a.N, a.n, s.msk, s.yv, s.rt,
             s.Zt);
}

// a filter's filtered (mean, covariance or factor) at step t: every
// step's with store, else the last step's into (B, n) and (B, n, n)
template <typename T>
__device__ void filter_write(const FilterArgs<T>& a, int bm, int t,
                             const T* m, const T* c) {
  const int n = a.n, nn = n * n;
  size_t at = (size_t)bm;
  if (a.store)
    at = (size_t)bm * a.t_steps + t;
  else if (t != a.t_steps - 1)
    return;
  for (int i = threadIdx.x; i < n; i += kThreads) a.mean_f[at * n + i] = m[i];
  for (int idx = threadIdx.x; idx < nn; idx += kThreads)
    a.cov_f[at * nn + idx] = c[idx];
}

// a smoother's smoothed (mean, covariance or factor) at step t
template <typename T>
__device__ void smoother_write(const SmootherArgs<T>& a, int bm, int t,
                               const T* m, const T* c) {
  const int n = a.n, nn = n * n;
  const size_t at = (size_t)bm * a.t_steps + t;
  for (int i = threadIdx.x; i < n; i += kThreads) a.mean_s[at * n + i] = m[i];
  for (int idx = threadIdx.x; idx < nn; idx += kThreads)
    a.cov_s[at * nn + idx] = c[idx];
}

// the up-sweep: block (bm, k) folds chunk k < nt into its total (the
// last chunk may be short); totals (B, nt, parts)
template <class F>
__global__ void __launch_bounds__(kThreads)
up_sweep(const typename F::Args a, typename F::Scalar* __restrict__ tot,
         int L, int nt) {
  using T = typename F::Scalar;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename F::Shared s;
  F::carve(smem_raw, a, &s);
  Part<T> pt[kMaxParts];
  const int np = F::parts(s, a.n, pt);
  const int bm = blockIdx.x / nt, k = blockIdx.x % nt;
  F::load(s, a, bm);
  const int p1 = min(a.t_steps, (k + 1) * L);
  for (int p = k * L; p < p1; ++p) {
    const int t = F::kReverse ? a.t_steps - 1 - p : p;
    F::row(s, a, bm, t);
    F::element(s, a, bm, t);
    if (p == k * L)
      seed(pt, 0, np);
    else
      F::combine(s, a, true);
  }
  pack(tot + ((size_t)bm * nt + k) * span(pt, 0, np), pt, 0, np);
}

// the total mode's fold: block bm folds its nt chunk totals, in scan
// order, into one full element (B, parts)
template <class F>
__global__ void __launch_bounds__(kThreads)
fold(const typename F::Args a, const typename F::Scalar* __restrict__ tot,
     typename F::Scalar* __restrict__ out, int nt) {
  using T = typename F::Scalar;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename F::Shared s;
  F::carve(smem_raw, a, &s);
  Part<T> pt[kMaxParts];
  const int np = F::parts(s, a.n, pt);
  const size_t tot_n = span(pt, 0, np);
  const int bm = blockIdx.x;
  for (int k = 0; k < nt; ++k) {
    unpack(pt, 0, np, tot + ((size_t)bm * nt + k) * tot_n, false);
    if (k == 0)
      seed(pt, 0, np);
    else
      F::combine(s, a, true);
  }
  pack(out + (size_t)bm * tot_n, pt, 0, np);
}

// the carry: block bm folds totals 0 .. c - 2 (tstride apart per model)
// into the moment part of every chunk's exclusive prefix, from the
// incoming prefix in_pre (B, moment) when given; prefixes (B, c - 1,
// moment) of chunks 1 .. c - 1
template <class F>
__global__ void __launch_bounds__(kThreads)
carry(const typename F::Args a, const typename F::Scalar* __restrict__ tot,
      int tstride, const typename F::Scalar* __restrict__ in_pre,
      typename F::Scalar* __restrict__ pre, int c) {
  using T = typename F::Scalar;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename F::Shared s;
  F::carve(smem_raw, a, &s);
  Part<T> pt[kMaxParts];
  const int np = F::parts(s, a.n, pt);
  const size_t tot_n = span(pt, 0, np), pre_n = span(pt, kMoment0, kMoment1);
  const int bm = blockIdx.x;
  if (in_pre)
    unpack(pt, kMoment0, kMoment1, in_pre + (size_t)bm * pre_n, true);
  for (int k = 1; k < c; ++k) {
    unpack(pt, 0, np, tot + ((size_t)bm * tstride + k - 1) * tot_n, false);
    if (k == 1 && !in_pre)
      seed(pt, kMoment0, kMoment1);
    else
      F::combine(s, a, false);
    pack(pre + ((size_t)bm * (c - 1) + k - 1) * pre_n, pt, kMoment0,
         kMoment1);
  }
}

// the down-sweep: block (bm, k) folds chunk k from its prefix (chunk 0:
// the incoming prefix, when given) and writes every step's outputs
template <class F>
__global__ void __launch_bounds__(kThreads)
down_sweep(const typename F::Args a,
           const typename F::Scalar* __restrict__ pre,
           const typename F::Scalar* __restrict__ in_pre, int L, int c) {
  using T = typename F::Scalar;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename F::Shared s;
  F::carve(smem_raw, a, &s);
  Part<T> pt[kMaxParts];
  F::parts(s, a.n, pt);
  const size_t pre_n = span(pt, kMoment0, kMoment1);
  const int bm = blockIdx.x / c, k = blockIdx.x % c;
  F::load(s, a, bm);
  if (k > 0)
    unpack(pt, kMoment0, kMoment1,
           pre + ((size_t)bm * (c - 1) + k - 1) * pre_n, true);
  else if (in_pre)
    unpack(pt, kMoment0, kMoment1, in_pre + (size_t)bm * pre_n, true);
  const int p1 = min(a.t_steps, (k + 1) * L);
  for (int p = k * L; p < p1; ++p) {
    const int t = F::kReverse ? a.t_steps - 1 - p : p;
    F::row(s, a, bm, t);
    F::tails(s, a, bm, t);
    F::element(s, a, bm, t);
    if (p == 0 && !in_pre)
      seed(pt, kMoment0, kMoment1);
    else
      F::combine(s, a, false);
    F::write(s, a, bm, t);
  }
}

// the entries of a full element and of its moment part
template <class F>
void part_sizes(const typename F::Args& a, size_t* tot_n, size_t* pre_n) {
  using T = typename F::Scalar;
  typename F::Shared s;
  F::carve(nullptr, a, &s);
  Part<T> pt[kMaxParts];
  const int np = F::parts(s, a.n, pt);
  *tot_n = span(pt, 0, np);
  *pre_n = span(pt, kMoment0, kMoment1);
}

// the dynamic shared memory of every launch of F, above the default
// 48 KB where needed; returns the bytes through smem
template <class F>
cudaError_t prepare(const typename F::Args& a, size_t* smem) {
  typename F::Shared s;
  *smem = F::carve(nullptr, a, &s);
  cudaError_t e;
  if ((e = allow_smem((const void*)up_sweep<F>, *smem)) != cudaSuccess ||
      (e = allow_smem((const void*)fold<F>, *smem)) != cudaSuccess ||
      (e = allow_smem((const void*)carry<F>, *smem)) != cudaSuccess ||
      (e = allow_smem((const void*)down_sweep<F>, *smem)) != cudaSuccess)
    return e;
  return cudaSuccess;
}

// the three launches on the caller's stream over B models in chunks of L
// steps; scratch holds B (chunks - 1) totals, then as many prefixes
template <class F>
int run(const typename F::Args& a, void* scratch, int B, int L,
        void* stream) {
  using T = typename F::Scalar;
  size_t smem, tot_n, pre_n;
  cudaError_t e = prepare<F>(a, &smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || a.t_steps == 0) return 0;
  part_sizes<F>(a, &tot_n, &pre_n);
  const int c = n_chunks(a.t_steps, L);
  T* tot = (T*)scratch;
  T* pre = tot + (size_t)B * (c - 1) * tot_n;
  cudaStream_t st = (cudaStream_t)stream;
  if (c > 1) {
    up_sweep<F><<<B * (c - 1), kThreads, smem, st>>>(a, tot, L, c - 1);
    carry<F><<<B, kThreads, smem, st>>>(a, tot, c - 1, nullptr, pre, c);
  }
  down_sweep<F><<<B * c, kThreads, smem, st>>>(a, pre, nullptr, L, c);
  return (int)cudaGetLastError();
}

// the total mode: the up-sweep of every chunk into tot (B, chunks,
// parts), then their fold into total (B, parts)
template <class F>
int run_total(const typename F::Args& a, void* tot, void* total, int B,
              int L, void* stream) {
  using T = typename F::Scalar;
  size_t smem;
  cudaError_t e = prepare<F>(a, &smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || a.t_steps == 0) return 0;
  const int c = n_chunks(a.t_steps, L);
  cudaStream_t st = (cudaStream_t)stream;
  up_sweep<F><<<B * c, kThreads, smem, st>>>(a, (T*)tot, L, c);
  fold<F><<<B, kThreads, smem, st>>>(a, (const T*)tot, (T*)total, c);
  return (int)cudaGetLastError();
}

// the carry mode: over S totals (B, S, parts) in scan order, the
// exclusive prefixes (B, S - 1, moment) of shards 1 .. S - 1
template <class F>
int run_carry(const typename F::Args& a, const void* totals, void* pre,
              int B, int S, void* stream) {
  using T = typename F::Scalar;
  size_t smem;
  cudaError_t e = prepare<F>(a, &smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || S < 2) return 0;
  carry<F><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      a, (const T*)totals, S, nullptr, (T*)pre, S);
  return (int)cudaGetLastError();
}

// the prefix mode: the carry over the chunk totals tot (B, chunks, parts)
// of this shard's total launch from in_pre (B, moment; null at the
// origin) into pre (B, chunks - 1, moment), then the down-sweep
template <class F>
int run_prefix(const typename F::Args& a, const void* tot, void* pre,
               const void* in_pre, int B, int L, void* stream) {
  using T = typename F::Scalar;
  size_t smem;
  cudaError_t e = prepare<F>(a, &smem);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || a.t_steps == 0) return 0;
  const int c = n_chunks(a.t_steps, L);
  cudaStream_t st = (cudaStream_t)stream;
  if (c > 1)
    carry<F><<<B, kThreads, smem, st>>>(a, (const T*)tot, c,
                                         (const T*)in_pre, (T*)pre, c);
  down_sweep<F><<<B * c, kThreads, smem, st>>>(a, (const T*)pre,
                                               (const T*)in_pre, L, c);
  return (int)cudaGetLastError();
}

// a filter's C entry: F over FilterArgs built from the raw pointers
template <class F>
int run_filter(const void* phi, const void* q, const void* z, const void* r,
               const void* y, const void* mask, void* mean_p, void* cov_p,
               void* mean_f, void* cov_f, void* sigma, void* detf,
               void* scratch, int B, int t_steps, int N, int n, int L,
               int store, void* stream) {
  using T = typename F::Scalar;
  const FilterArgs<T> a{(const T*)phi, (const T*)q, (const T*)z,
                        (const T*)r, (const T*)y, (const uint8_t*)mask,
                        (T*)mean_p, (T*)cov_p, (T*)mean_f, (T*)cov_f,
                        (T*)sigma, (T*)detf, t_steps, N, n, store, 1};
  return run<F>(a, scratch, B, L, stream);
}

// a smoother's C entry (q null for the covariance form)
template <class F>
int run_smoother(const void* phi, const void* q, const void* mean_f,
                 const void* cov_f, const void* mean_p, const void* cov_p,
                 void* mean_s, void* cov_s, void* scratch, int B,
                 int t_steps, int n, int L, void* stream) {
  using T = typename F::Scalar;
  const SmootherArgs<T> a{(const T*)phi, (const T*)q, (const T*)mean_f,
                          (const T*)cov_f, (const T*)mean_p,
                          (const T*)cov_p, (T*)mean_s, (T*)cov_s, t_steps,
                          n, 1, nullptr, nullptr};
  return run<F>(a, scratch, B, L, stream);
}

}  // namespace pk
