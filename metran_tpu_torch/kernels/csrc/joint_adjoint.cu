// K11: the closed-form reverse sweep of the batch-layout deviance, one
// thread block per model, warp-specialised.
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
//              Y = L^-1 (Z_m P_p),  m_f = m_p + Y'(L^-1 v),
//              P_f = P_p - Y'Y,  K' = L^-T Y,  e = F^-1 v,  L^-1 Z_m,
//            keeping per step the pre-predict (m, P), K', L^-1 Z_m, e and
//            ok in a record of n + n^2 + 2nN + N + 1 values;
//   sweep    back over the segment with the adjoints (u, S) of the
//            filtered moments and the step's cotangents (sb, db), with
//            A = I - K Z_m and w = Z_m'e,
//              u_p = A'u - 2 sb w,
//              S_p = A'(S A) + db (L^-1 Z_m)'(L^-1 Z_m) - sb w w' + (A'u) w',
//            then the diagonal-predict adjoint
//              phibar += u_p o m + (S_p o P) phi + (S_p o P)' phi,
//              qbar += diag S_p,  u = u_p o phi,  S = S_p o (phi phi').
// `ok` is JAX's rule and K1's: a Cholesky pivot that is not positive and
// finite, or a factor entry that is not finite, makes the step degraded;
// a degraded step (and a step with no observed slot, whose sweep is the
// identity exactly) passes (u, S) through.  Outputs: phibar, qbar (B, n).
//
// What bounds it on an H100: latency.  A replayed step is ~40 k FMAs at
// the flagship shape (n = 21 states, N = 20 series) and a swept step ~35
// k, over a few KB of state: one model's work is a chain of small
// dependent products, where a warp waits on shared memory far more than
// it computes.  Only the sweep is serial across segments — each
// segment's replay starts from a boundary the forward already wrote — so
// the block splits in two roles that run at once:
//   R replay groups  each own a slot of a ring of R segment records in
//                    device memory and replay segments i = group,
//                    group + R, ... (counted from the last) into it.  A
//                    group is one warp (the compact block) or two (the
//                    wide one), synced by __syncwarp or a named barrier
//                    of its own, its verdicts warp votes or barrier
//                    reductions.  The group's first warp factors F in
//                    shared memory, rows spread over its lanes, two warp
//                    barriers a column; the triangular solves run a
//                    column per thread of the group on
//                    [Z_m P_p | v | Z_m], no barrier.
//   S sweep warps    take the segments last-first as each slot fills.  A
//                    slot hands over through a pair of Hopper mbarriers
//                    (full: the group's threads arrive; empty: the sweep
//                    threads arrive once the slot is copied out).  The
//                    sweep runs two phases a step between named barriers
//                    of its own threads (bar.sync 1, 32 S), so a replay
//                    group never waits on them:
//                      alpha  A'u, S A and w of step t; A of step t-1;
//                             the phibar terms of step t+1's S_p o P;
//                      beta   A'(S A), the rank-N term, S_p, u_p, the
//                             predict adjoint of step t; copies of later
//                             records in flight (cp.async).
// The serial chain is one segment's replay plus T swept steps of two
// barriers each, fed by R replays at once.  The compact block (R + 4
// warps) fits four to an SM in f32 and fills the card at a 512-model
// fleet; the wide block (2 R + 8 warps, one an SM) spends the SMs a small
// fleet leaves idle on each model.  The block's only __syncthreads is
// before the roles split.  Every work matrix lives in shared memory; a
// shape whose layout does not fit (the `spill` instantiation, compact
// block) keeps the same layout in a device-memory workspace of the
// block's own, so every (N, n) runs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRing = 4;      // replay groups and ring slots at most
constexpr int kMaxGroup = 2;     // warps a replay group at most
constexpr int kMaxSweep = 8;     // sweep warps at most
constexpr int kMaxThreads = 32 * (kMaxRing * kMaxGroup + kMaxSweep);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSweepBar = 1;     // named barrier of the sweep warps; the
                                 // replay groups take 2, 3, ...

// the register budget of each block shape: the compact block (R + 4
// warps) at 4 blocks an SM in f32 (64 registers a thread) and 2 in f64
// (128); the wide one (2R + 8 warps) at one block an SM (128)
template <typename T, bool kWide>
struct Budget {
  static constexpr int kThreads = kWide ? kMaxThreads : 32 * (kMaxRing + 4);
  static constexpr int kBlocks = kWide ? 1 : (sizeof(T) == 4 ? 4 : 2);
};

// ---- Hopper barriers and asynchronous copies
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// waits for the phase of `parity` to complete; a handoff that never
// comes (a fault in the schedule) aborts the launch once the wait has
// lasted `limit` cycles, instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity,
                                          long long limit) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > limit) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// a named barrier of `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// a named barrier of `count` threads that ORs (or ANDs) their predicates
__device__ __forceinline__ bool named_any(int id, int count, bool pred) {
  uint32_t out;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, %3, p;\n"
      "selp.u32 %0, 1, 0, q;\n"
      "}\n"
      : "=r"(out)
      : "r"((uint32_t)pred), "r"(id), "r"(count)
      : "memory");
  return out != 0;
}

__device__ __forceinline__ bool named_all(int id, int count, bool pred) {
  uint32_t out;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.and.pred q, %2, %3, p;\n"
      "selp.u32 %0, 1, 0, q;\n"
      "}\n"
      : "=r"(out)
      : "r"((uint32_t)pred), "r"(id), "r"(count)
      : "memory");
  return out != 0;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// a replay group: `warps` warps (one or two) that replay a segment
// together; thread `t` of `count`, synced by its own named barrier (by
// __syncwarp when it is one warp)
struct Team {
  int t, count, bar;
  __device__ void sync() const {
    if (count == 32) {
      __syncwarp();
    } else {
      named_sync(bar, count);
    }
  }
  // a barrier of the group that also ORs (ANDs) the threads' predicates
  __device__ bool any(bool pred) const {
    if (count != 32) return named_any(bar, count, pred);
    __syncwarp();
    return __any_sync(kFull, pred) != 0;
  }
  __device__ bool all(bool pred) const {
    if (count != 32) return named_all(bar, count, pred);
    __syncwarp();
    return __all_sync(kFull, pred) != 0;
  }
};

// ---- the layout: one block's work matrices, in this order (with base
// null, only the count); mirrors _layout in the wrapper
template <typename T>
struct Common {
  T *zs, *rr, *ph, *qd;  // Z (N x n), r (N), phi, q (n)
};

template <typename T>
struct Sweep {
  T *S, *SA, *C, *A;          // n x n: adjoint, S A, S_p o P; A of two
                              // steps (2 n x n, by the step's parity)
  T *u, *au, *w, *phib, *qb;  // n
  T* KT;                      // K' of the next step's A (N x n)
  T* stg;                     // two staged steps (by parity), each
                              // L^-1 Z_m (N x n), P (n x n), m (n), e (N),
                              // mask (N), ok (1), (sb, db) (2)
};

template <typename T>
struct Replay {
  T *P, *L;       // n x n carry; F, then its factor (N rows of N + 1)
  T *KT, *LZ;     // Z_m P_p, then Y, then K'; Z_m, then L^-1 Z_m (N x n)
  T *m, *e, *msk, *rd;  // n; v, then L^-1 v, then e (N); mask; reciprocal
                        // pivots
};

struct Bump {
  size_t used = 0;
  template <typename T>
  __host__ __device__ T* take(T* base, size_t count) {
    T* p = base == nullptr ? nullptr : base + used;
    used += count;
    return p;
  }
};

__host__ __device__ inline size_t staged_values(int N, int n) {
  return (size_t)N * n + (size_t)n * n + n + 2 * (size_t)N + 3;
}

// carves the common and sweep buffers from base and returns where the R
// replay workspaces start
template <typename T>
__host__ __device__ size_t carve(T* base, int N, int n, Common<T>* c,
                                 Sweep<T>* s) {
  const size_t nn = (size_t)n * n, nN = (size_t)n * N;
  Bump b;
  c->zs = b.take(base, nN);
  c->rr = b.take(base, N);
  c->ph = b.take(base, n);
  c->qd = b.take(base, n);
  s->S = b.take(base, nn);
  s->SA = b.take(base, nn);
  s->C = b.take(base, nn);
  s->A = b.take(base, 2 * nn);
  s->u = b.take(base, n);
  s->au = b.take(base, n);
  s->w = b.take(base, n);
  s->phib = b.take(base, n);
  s->qb = b.take(base, n);
  s->KT = b.take(base, nN);
  s->stg = b.take(base, 2 * (nN + nn + n + 2 * (size_t)N + 3));
  return b.used;
}

template <typename T>
__host__ __device__ Replay<T> replay_ws(T* base, int N, int n, size_t* count) {
  Replay<T> w;
  Bump b;
  w.P = b.take(base, (size_t)n * n);
  w.L = b.take(base, (size_t)N * (N + 1));
  w.KT = b.take(base, (size_t)N * n);
  w.LZ = b.take(base, (size_t)N * n);
  w.m = b.take(base, n);
  w.e = b.take(base, N);
  w.msk = b.take(base, N);
  w.rd = b.take(base, N);
  *count = b.used;
  return w;
}

template <typename T>
__host__ __device__ size_t replay_values(int N, int n) {
  size_t count;
  replay_ws<T>(nullptr, N, n, &count);
  return count;
}

template <typename T>
__host__ __device__ size_t layout_values(int N, int n, int R) {
  Common<T> c;
  Sweep<T> s;
  return carve<T>(nullptr, N, n, &c, &s) + R * replay_values<T>(N, n);
}

// (row, col) of a walk over a row-major matrix of `cols` columns in
// steps of `step` elements, without a division per element
struct Walk {
  int i, j, di, dj, cols;
  __device__ Walk(int start, int step, int cols_)
      : i(start / cols_), j(start % cols_), di(step / cols_),
        dj(step % cols_), cols(cols_) {}
  __device__ void next() {
    i += di;
    j += dj;
    if (j >= cols) {
      j -= cols;
      ++i;
    }
  }
};

// the first index of a vector job that starts `off` threads into the
// sweep's `count`, so that small jobs land on different threads
__device__ __forceinline__ int rotated(int ts, int off, int count) {
  const int o = ((off % count) + count) % count;
  return ts >= o ? ts - o : ts - o + count;
}

// sum_k a[k sa] b[k sb] over len terms, in four partial sums
template <typename T>
__device__ __forceinline__ T dot(const T* a, int sa, const T* b, int sb,
                                 int len) {
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int k = 0;
  for (; k + 3 < len; k += 4, a += 4 * sa, b += 4 * sb) {
    s0 += a[0] * b[0];
    s1 += a[sa] * b[sb];
    s2 += a[2 * sa] * b[2 * sb];
    s3 += a[3 * sa] * b[3 * sb];
  }
  for (; k < len; ++k, a += sa, b += sb) s0 += a[0] * b[0];
  return (s0 + s1) + (s2 + s3);
}

// sum_k a[k sa] b[k sb] over the terms whose `skip` entry is not 0 (a
// mask the same for every thread; a left-out term adds an exact zero)
template <typename T>
__device__ __forceinline__ T dot_skip(const T* a, int sa, const T* b, int sb,
                                      const T* skip, int len) {
  T s0 = T(0), s1 = T(0);
  for (int k = 0; k < len; ++k, a += sa, b += sb) {
    if (skip[k] == T(0)) continue;
    if (k & 1) {
      s1 += a[0] * b[0];
    } else {
      s0 += a[0] * b[0];
    }
  }
  return s0 + s1;
}

// the replay's first half, both paths: record the pre-predict carry at
// st, predict in place (each thread owns its entries), mask the row (row
// tm.t from the prefetched bit); returns whether a slot is observed
template <typename T>
__device__ __forceinline__ bool replay_predict(const Team& tm,
                                               const Common<T> c,
                                               const Replay<T> w, T* st,
                                               const uint8_t* m_row,
                                               bool mk_own, int N, int n) {
  for (int i = tm.t; i < n; i += tm.count) {
    st[i] = w.m[i];
    w.m[i] = c.ph[i] * w.m[i];
  }
  for (Walk k(tm.t, tm.count, n); k.i < n; k.next()) {
    const int idx = k.i * n + k.j;
    st[n + idx] = w.P[idx];
    w.P[idx] = c.ph[k.i] * w.P[idx] * c.ph[k.j] +
               (k.i == k.j ? c.qd[k.i] : T(0));
  }
  bool obs = false;
  for (int a = tm.t; a < N; a += tm.count) {
    const bool mk = a == tm.t ? mk_own : m_row[a] != 0;
    w.msk[a] = mk ? T(1) : T(0);
    obs = obs || mk;
  }
  obs = tm.any(obs);
  tm.sync();
  return obs;
}

// v (Z unmasked, as the JAX replay) into e, Z_m P_p into KT, then F =
// Z_m P_p Z_m' + diag(r o mask + 1 - mask), lower triangle, into L
template <typename T>
__device__ __forceinline__ void replay_gram(const Team& tm, const Common<T> c,
                                            const Replay<T> w,
                                            const T* y_row, T y_own, int N,
                                            int n) {
  const int ld = N + 1;
  for (int a = tm.t; a < N; a += tm.count)
    w.e[a] = w.msk[a] != T(0)
                 ? (a == tm.t ? y_own : y_row[a]) -
                       dot(c.zs + a * n, 1, w.m, 1, n)
                 : T(0);
  for (Walk k(tm.t, tm.count, n); k.i < N; k.next())
    w.KT[k.i * n + k.j] =
        w.msk[k.i] * dot(c.zs + k.i * n, 1, w.P + k.j * n, 1, n);
  tm.sync();
  const int tri = N * (N + 1) / 2;
  for (int x = tm.t; x < tri; x += tm.count) {
    int a = (int)((sqrtf(8.f * x + 1.f) - 1.f) * 0.5f);
    while (a * (a + 1) / 2 > x) --a;
    while ((a + 1) * (a + 2) / 2 <= x) ++a;
    const int cc = x - a * (a + 1) / 2;
    const T ma = w.msk[a];
    T acc = ma * dot(c.zs + a * n, 1, w.KT + cc * n, 1, n);
    if (a == cc) acc += (ma != T(0) ? c.rr[a] : T(0)) + (T(1) - ma);
    w.L[a * ld + cc] = acc;
  }
  tm.sync();
}

// the update: a right-looking Cholesky in shared memory on the group's
// first warp (rows of F spread over the lanes), two warp barriers a
// column, then the triangular solves a column per thread of the group,
// no barrier, on the combined right-hand side [Z_m P_p | v | Z_m]:
//   Y = L^-1 Z_m P_p,  m_f = m_p + Y'(L^-1 v),  P_f = P_p - Y'Y,
//   K' = L^-T Y,  e = L^-T L^-1 v,  L^-1 Z_m.
// Writes K', L^-1 Z_m and e to the record; returns the verdict (every
// pivot positive and finite, every entry of the factor finite).
template <typename T>
__device__ __forceinline__ bool replay_update(const Team& tm,
                                              const Common<T> c,
                                              const Replay<T> w, T* st,
                                              int N, int n) {
  const int nn = n * n, nN = n * N, ld = N + 1;
  bool ok = true;
  if (tm.t < 32) {
    const int lane = tm.t;
    for (int cc = 0; cc < N && ok; ++cc) {
      const T d = w.L[cc * ld + cc];  // every lane reads the same pivot
      ok = d > T(0) && isfinite(d);
      if (!ok) break;
      const T sq = sqrt(d);
      for (int r = cc + 1 + lane; r < N; r += 32) w.L[r * ld + cc] /= sq;
      if (lane == 0) {
        w.L[cc * ld + cc] = sq;
        w.rd[cc] = T(1) / sq;
      }
      __syncwarp();
      for (int r = cc + 1 + lane; r < N; r += 32) {
        const T lr = w.L[r * ld + cc];
        for (int c2 = cc + 1; c2 <= r; ++c2)
          w.L[r * ld + c2] -= lr * w.L[c2 * ld + cc];
      }
      __syncwarp();
    }
    bool fin = true;
    for (int r = lane; ok && r < N; r += 32)
      for (int cc = 0; cc <= r; ++cc) fin = fin && isfinite(w.L[r * ld + cc]);
    ok = ok && __all_sync(kFull, fin);
  }
  if (!tm.all(ok)) return false;
  // Z_m into LZ, then forward substitution, a column per thread: Y = L^-1
  // (Z_m P_p), L^-1 v, L^-1 Z_m (columns 0..n-1, n, n+1..2n)
  for (Walk k(tm.t, tm.count, n); k.i < N; k.next())
    w.LZ[k.i * n + k.j] = c.zs[k.i * n + k.j] * w.msk[k.i];
  tm.sync();
  for (int col = tm.t; col < 2 * n + 1; col += tm.count) {
    T* X = col < n ? w.KT + col : (col == n ? w.e : w.LZ + (col - n - 1));
    const int s = col == n ? 1 : n;
    for (int a = 0; a < N; ++a)
      X[a * s] = (X[a * s] - dot(w.L + a * ld, 1, X, s, a)) * w.rd[a];
  }
  tm.sync();
  // m_f = m_p + Y'(L^-1 v), P_f = P_p - Y'Y
  for (int i = tm.t; i < n; i += tm.count)
    w.m[i] += dot(w.KT + i, n, w.e, 1, N);
  for (Walk k(tm.t, tm.count, n); k.i < n; k.next())
    w.P[k.i * n + k.j] -= dot(w.KT + k.i, n, w.KT + k.j, n, N);
  tm.sync();
  // back substitution, a column per thread: K' = L^-T Y, e = L^-T L^-1 v
  for (int col = tm.t; col < n + 1; col += tm.count) {
    T* X = col < n ? w.KT + col : w.e;
    const int s = col < n ? n : 1;
    for (int a = N - 1; a >= 0; --a)
      X[a * s] = (X[a * s] - dot(w.L + (a + 1) * ld + a, ld, X + (a + 1) * s,
                                 s, N - 1 - a)) *
                 w.rd[a];
  }
  tm.sync();
  T* st_k = st + n + nn;
  for (int idx = tm.t; idx < nN; idx += tm.count) {
    st_k[idx] = w.KT[idx];
    st_k[nN + idx] = w.LZ[idx];
  }
  for (int a = tm.t; a < N; a += tm.count) st_k[2 * nN + a] = w.e[a];
  return true;
}

// one replay step: record, predict, update; leaves the filtered (or,
// when the step passes through, the predicted) carry in w.m, w.P and
// the step's ok code (1 updated, 0 degraded, 2 nothing observed) last in
// its record.  mk_own, y_own: row tm.t's mask bit and datum, loaded a
// step ahead.
template <typename T>
__device__ __forceinline__ void replay_step(const Team& tm, const Common<T> c,
                                            const Replay<T> w, T* st,
                                            const T* y_row,
                                            const uint8_t* m_row, bool mk_own,
                                            T y_own, int N, int n,
                                            int stride) {
  T code = T(2);
  if (replay_predict(tm, c, w, st, m_row, mk_own, N, n)) {
    replay_gram(tm, c, w, y_row, y_own, N, n);
    code = replay_update(tm, c, w, st, N, n) ? T(1) : T(0);
  }
  if (tm.t == 0) st[stride - 1] = code;
}

// stage `count` values from the ring into the sweep's buffers: an
// asynchronous copy into shared memory, or a plain one in the spill
// instantiation
template <typename T, bool kSpill>
__device__ __forceinline__ void stage(T* dst, const T* src, int count, int ts,
                                      int nts) {
  for (int i = ts; i < count; i += nts) {
    if constexpr (kSpill) {
      dst[i] = src[i];
    } else {
      cp_async(dst + i, src + i);
    }
  }
}

template <typename T, bool kSpill, bool kWide>
__global__ void __launch_bounds__(Budget<T, kWide>::kThreads,
                                  Budget<T, kWide>::kBlocks)
joint_adjoint_kernel(const T* __restrict__ phi, const T* __restrict__ qdiag,
                     const T* __restrict__ z, const T* __restrict__ r,
                     const T* __restrict__ y, const uint8_t* __restrict__ mask,
                     const T* __restrict__ bounds_mean,
                     const T* __restrict__ bounds_cov,
                     const T* __restrict__ sb, const T* __restrict__ db,
                     T* ring, T* spill, T* __restrict__ phibar,
                     T* __restrict__ qbar, int t_steps, int N, int n,
                     int seg, int factored, int R, int G, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxRing], empty[kMaxRing];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nn = n * n, nN = n * N;
  const int n_seg = (t_steps + seg - 1) / seg;
  const int seg_len = seg < t_steps ? seg : t_steps;
  const int stride = n + nn + 2 * nN + N + 1;
  const int n_replay = 32 * G * R, nts = 32 * S;  // threads of each role
  // the cycles a handoff may take before it counts as lost: a wait spans
  // at most the replay and sweep of R + 1 segments, and each of their
  // steps is allowed 2^24 cycles (~8 ms, hundreds of times a step's
  // time even in the device-memory layout), on top of 2^35 (~17 s)
  const long long patience =
      (1ll << 35) + (long long)(R + 2) * seg_len * (1ll << 24);
  T* base = kSpill ? spill + (size_t)b * layout_values<T>(N, n, R)
                   : reinterpret_cast<T*>(smem_raw);
  Common<T> c;
  Sweep<T> s;
  T* replay_base = base + carve<T>(base, N, n, &c, &s);
  T* ring_b = ring + (size_t)b * R * seg_len * stride;

  for (int idx = tid; idx < nN; idx += blockDim.x)
    c.zs[idx] = z[(size_t)b * nN + idx];  // z[b, a, i], idx = a * n + i
  for (int a = tid; a < N; a += blockDim.x) c.rr[a] = r[(size_t)b * N + a];
  for (int i = tid; i < n; i += blockDim.x) {
    c.ph[i] = phi[(size_t)b * n + i];
    c.qd[i] = qdiag[(size_t)b * n + i];
    s.u[i] = T(0);
    s.phib[i] = T(0);
    s.qb[i] = T(0);
  }
  for (int idx = tid; idx < nn; idx += blockDim.x) s.S[idx] = T(0);
  if (tid == 0) {
    for (int k = 0; k < R; ++k) {
      mbar_init(&full[k], 32 * G);
      mbar_init(&empty[k], nts);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the block's only one: the roles split here

  if (tid < n_replay) {
    // ============ replay group `grp`: segments grp, grp + R, ... (from the
    // last), into ring slot `grp`
    const int grp = tid / (32 * G);
    const Team tm{tid - grp * 32 * G, 32 * G, 2 + grp};
    size_t per_group;
    replay_ws<T>(nullptr, N, n, &per_group);
    const Replay<T> w = replay_ws<T>(replay_base + grp * per_group, N, n,
                                     &per_group);
    T* slot = ring_b + (size_t)grp * seg_len * stride;
    for (int i = grp; i < n_seg; i += R) {
      const int k = n_seg - 1 - i, fill = i / R;
      if (fill > 0) mbar_wait(&empty[grp], (fill - 1) & 1, patience);
      const int t0 = k * seg;
      const int t1 = t0 + seg < t_steps ? t0 + seg : t_steps;
      const T* bm = bounds_mean + ((size_t)b * n_seg + k) * n;
      const T* bc = bounds_cov + ((size_t)b * n_seg + k) * nn;
      for (int i2 = tm.t; i2 < n; i2 += tm.count) w.m[i2] = bm[i2];
      for (Walk q(tm.t, tm.count, n); q.i < n; q.next())
        w.P[q.i * n + q.j] = factored ? dot(bc + q.i * n, 1, bc + q.j * n, 1, n)
                                      : bc[q.i * n + q.j];  // P = S S'
      tm.sync();
      // row tm.t of the data a step ahead
      const size_t row0 = ((size_t)b * t_steps + t0) * N;
      bool mk_next = tm.t < N && mask[row0 + tm.t] != 0;
      T y_next = mk_next ? y[row0 + tm.t] : T(0);
      for (int t = t0; t < t1; ++t) {
        const size_t row = ((size_t)b * t_steps + t) * N;
        const bool mk_own = mk_next;
        const T y_own = y_next;
        if (t + 1 < t1) {
          mk_next = tm.t < N && mask[row + N + tm.t] != 0;
          y_next = mk_next ? y[row + N + tm.t] : T(0);
        }
        replay_step<T>(
            tm, c, w, slot + (size_t)(t - t0) * stride, y + row, mask + row,
            mk_own, y_own, N, n, stride);
        tm.sync();
      }
      __threadfence_block();
      mbar_arrive(&full[grp]);  // release: the records are visible
    }
    return;
  }

  // =================== the sweep warps
  const int ts = tid - n_replay;
  const int n_stg = (int)staged_values(N, n);
  auto sweep_sync = [&] { named_sync(kSweepBar, nts); };
  // the record of step t in the ring
  auto record = [&](int t) -> const T* {
    const int k = t / seg, i = n_seg - 1 - k;
    return ring_b + ((size_t)(i % R) * seg_len + (t - k * seg)) * stride;
  };
  auto slot_of = [&](int t) { return (n_seg - 1 - t / seg) % R; };
  auto fill_of = [&](int t) { return (n_seg - 1 - t / seg) / R; };
  // a staged step's buffers, by the step's parity
  auto st_lz = [&](int t) { return s.stg + (t & 1) * n_stg; };
  auto st_p0 = [&](int t) { return st_lz(t) + nN; };
  auto st_m0 = [&](int t) { return st_p0(t) + nn; };
  auto st_e = [&](int t) { return st_m0(t) + n; };
  auto st_msk = [&](int t) { return st_e(t) + N; };
  auto st_ok = [&](int t) { return st_msk(t) + N; };  // ok, sb, db

  for (int t = t_steps + 1; t >= 0; --t) {
    const bool step = t < t_steps;
    const int okv = step ? (int)st_ok(t)[0] : 0;
    const T* A = s.A + (t & 1) * nn;
    // ---------------- phase alpha
    if (step && okv == 1) {
      for (int j = rotated(ts, nts - n, nts); j < n; j += nts)
        s.au[j] = dot(A + j, n, s.u, 1, n);  // (A'u)_j
      for (int i = rotated(ts, nts - 2 * n, nts); i < n; i += nts)
        s.w[i] = dot_skip(st_e(t), 1, c.zs + i, n, st_msk(t), N);
      for (Walk k(ts, nts, n); k.i < n; k.next())
        s.SA[k.i * n + k.j] = dot(s.S + k.i * n, 1, A + k.j, n, n);
    }
    if (t + 1 < t_steps) {  // step t+1's (S_p o P) phi + (S_p o P)' phi
      for (int i = rotated(ts, nts - 3 * n, nts); i < n; i += nts)
        s.phib[i] = s.phib[i] + dot(s.C + i * n, 1, c.ph, 1, n) +
                    dot(s.C + i, n, c.ph, 1, n);
    }
    if (t >= 1 && t - 1 < t_steps && (int)st_ok(t - 1)[0] == 1) {
      // A = I - K Z_m of step t-1, from its staged K' and mask
      T* An = s.A + ((t - 1) & 1) * nn;
      for (Walk k(ts, nts, n); k.i < n; k.next())
        An[k.i * n + k.j] =
            (k.i == k.j ? T(1) : T(0)) -
            dot_skip(s.KT + k.i, n, c.zs + k.j, n, st_msk(t - 1), N);
    }
    sweep_sync();

    // ---------------- phase beta
    // the copies in flight: step t-1's L^-1 Z_m, P, m (and its sb, db),
    // step t-2's K', e, ok (and its mask)
    const int r2 = t - 1, r1 = t - 2;
    T sb_v = 0, db_v = 0;
    uint8_t mk_v = 0;
    if (r2 >= 0 && r2 < t_steps) {
      const T* st = record(r2);
      stage<T, kSpill>(st_lz(r2), st + n + nn + nN, nN, ts, nts);
      stage<T, kSpill>(st_p0(r2), st + n, nn, ts, nts);
      stage<T, kSpill>(st_m0(r2), st, n, ts, nts);
      if (ts == 0) sb_v = sb[(size_t)b * t_steps + r2];
      if (ts == 1) db_v = db[(size_t)b * t_steps + r2];
      if (r2 % seg == 0) {  // the segment's first step: its slot is read
        if constexpr (!kSpill) cp_async_wait_all();
        mbar_arrive(&empty[slot_of(r2)]);
      }
    }
    if (r1 >= 0 && r1 < t_steps) {
      if (r1 == t_steps - 1 || (r1 + 1) % seg == 0)  // a segment's last step
        mbar_wait(&full[slot_of(r1)], fill_of(r1) & 1, patience);
      const T* st = record(r1);
      stage<T, kSpill>(s.KT, st + n + nn, nN, ts, nts);
      stage<T, kSpill>(st_e(r1), st + n + nn + 2 * nN, N, ts, nts);
      stage<T, kSpill>(st_ok(r1), st + stride - 1, 1, ts, nts);
      if (ts < N) mk_v = mask[((size_t)b * t_steps + r1) * N + ts];
    }
    if (step) {
      const T sbt = st_ok(t)[1], dbt = st_ok(t)[2];
      const T* P0 = st_p0(t);
      const T* m0 = st_m0(t);
      if (okv == 1) {
        const T* LZ = st_lz(t);
        for (Walk k(ts, nts, n); k.i < n; k.next()) {
          const int i = k.i, j = k.j, idx = i * n + j;
          const T W = dot(A + i, n, s.SA + j, n, n) +
                      dbt * dot(LZ + i, n, LZ + j, n, N) -
                      sbt * (s.w[i] * s.w[j]) + s.au[i] * s.w[j];
          s.C[idx] = W * P0[idx];
          s.S[idx] = W * c.ph[i] * c.ph[j];
          if (i == j) s.qb[i] = s.qb[i] + W;
        }
        for (int i = rotated(ts, nts - n, nts); i < n; i += nts) {
          const T up = s.au[i] - T(2) * sbt * s.w[i];
          s.phib[i] = s.phib[i] + up * m0[i];
          s.u[i] = up * c.ph[i];
        }
      } else {  // degraded or unobserved: (u, S) pass through the update
        for (Walk k(ts, nts, n); k.i < n; k.next()) {
          const int i = k.i, j = k.j, idx = i * n + j;
          const T W = s.S[idx];
          s.C[idx] = W * P0[idx];
          s.S[idx] = W * c.ph[i] * c.ph[j];
          if (i == j) s.qb[i] = s.qb[i] + W;
        }
        for (int i = rotated(ts, nts - n, nts); i < n; i += nts) {
          const T up = s.u[i];
          s.phib[i] = s.phib[i] + up * m0[i];
          s.u[i] = up * c.ph[i];
        }
      }
    }
    if (r2 >= 0 && r2 < t_steps) {
      if (ts == 0) st_ok(r2)[1] = sb_v;
      if (ts == 1) st_ok(r2)[2] = db_v;
    }
    if (r1 >= 0 && r1 < t_steps) {
      if (ts < N) st_msk(r1)[ts] = mk_v ? T(1) : T(0);
      for (int a = ts + nts; a < N; a += nts)
        st_msk(r1)[a] = mask[((size_t)b * t_steps + r1) * N + a] ? T(1) : T(0);
    }
    if constexpr (!kSpill) cp_async_wait_all();
    sweep_sync();
  }
  // step 0's (S_p o P) phi + (S_p o P)' phi, then the outputs
  for (int i = ts; i < n; i += nts) {
    phibar[(size_t)b * n + i] = s.phib[i] + dot(s.C + i * n, 1, c.ph, 1, n) +
                                dot(s.C + i, n, c.ph, 1, n);
    qbar[(size_t)b * n + i] = s.qb[i];
  }
}

template <typename T, bool kSpill, bool kWide>
int launch_kernel(const void* phi, const void* qdiag, const void* z,
                  const void* r, const void* y, const void* mask,
                  const void* bounds_mean, const void* bounds_cov,
                  const void* sb, const void* db, void* ring, void* spill,
                  void* phibar, void* qbar, int B, int t_steps, int N, int n,
                  int seg, int factored, int R, int G, int S,
                  cudaStream_t stream) {
  const size_t smem = kSpill ? 0 : layout_values<T>(N, n, R) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        joint_adjoint_kernel<T, kSpill, kWide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  joint_adjoint_kernel<T, kSpill, kWide>
      <<<B, 32 * (R * G + S), smem, stream>>>(
          (const T*)phi, (const T*)qdiag, (const T*)z, (const T*)r,
          (const T*)y, (const uint8_t*)mask, (const T*)bounds_mean,
          (const T*)bounds_cov, (const T*)sb, (const T*)db, (T*)ring,
          (T*)spill, (T*)phibar, (T*)qbar, t_steps, N, n, seg, factored, R,
          G, S);
  return (int)cudaGetLastError();
}

// the instantiation for a block of (R, G, S): the compact budget (R + 4
// warps at most) unless a group has two warps or the sweep more than four
inline bool wide_block(int G, int S) { return G > 1 || S > 4; }

template <typename T>
int launch_joint_adjoint(const void* phi, const void* qdiag, const void* z,
                         const void* r, const void* y, const void* mask,
                         const void* bounds_mean, const void* bounds_cov,
                         const void* sb, const void* db, void* ring,
                         void* spill, void* phibar, void* qbar, int B,
                         int t_steps, int N, int n, int seg, int factored,
                         int R, int G, int S, void* stream) {
  if (B == 0) return 0;
  if (seg < 1 || R < 1 || R > kMaxRing || G < 1 || G > kMaxGroup || S < 1 ||
      S > kMaxSweep)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (t_steps == 0) {  // no step: zero adjoints
    cudaError_t e = cudaMemsetAsync(phibar, 0, sizeof(T) * (size_t)B * n, st);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(qbar, 0, sizeof(T) * (size_t)B * n, st);
    return (int)e;
  }
  const bool wide = wide_block(G, S);
  if (spill != nullptr) {  // the spilled layout runs in the compact block
    if (wide) return (int)cudaErrorInvalidValue;
    return launch_kernel<T, true, false>(phi, qdiag, z, r, y, mask,
                                         bounds_mean, bounds_cov, sb, db, ring,
                                         spill, phibar, qbar, B, t_steps, N, n,
                                         seg, factored, R, G, S, st);
  }
  auto fn =
      wide ? launch_kernel<T, false, true> : launch_kernel<T, false, false>;
  return fn(phi, qdiag, z, r, y, mask, bounds_mean, bounds_cov, sb, db, ring,
            spill, phibar, qbar, B, t_steps, N, n, seg, factored, R, G, S, st);
}

template <typename T, bool kSpill, bool kWide>
int occupancy_of(int N, int n, int R, int G, int S, int* blocks) {
  const size_t smem = kSpill ? 0 : layout_values<T>(N, n, R) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        joint_adjoint_kernel<T, kSpill, kWide>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, joint_adjoint_kernel<T, kSpill, kWide>, 32 * (R * G + S), smem);
}

template <typename T>
int occupancy(int N, int n, int R, int G, int S, int spill, int* blocks) {
  const bool wide = wide_block(G, S);
  if (spill)
    return wide ? (int)cudaErrorInvalidValue
                : occupancy_of<T, true, false>(N, n, R, G, S, blocks);
  return wide ? occupancy_of<T, false, true>(N, n, R, G, S, blocks)
              : occupancy_of<T, false, false>(N, n, R, G, S, blocks);
}

}  // namespace

extern "C" {

// phi, qdiag (B, n); z (B, N, n); r (B, N); y, mask (B, T, N);
// bounds_mean (B, n_seg, n); bounds_cov (B, n_seg, n, n) (a factor when
// factored); sb, db (B, T); ring (B, R, min(seg, T), n + n^2 + 2nN + N +
// 1); spill null, or (B, layout values) for a layout that does not fit
// shared memory; phibar, qbar (B, n); R the ring depth (1..4), G the
// warps of a replay group (1..2), S the sweep warps (1..8)
int metran_joint_adjoint_f32(const void* phi, const void* qdiag,
                             const void* z, const void* r, const void* y,
                             const void* mask, const void* bounds_mean,
                             const void* bounds_cov, const void* sb,
                             const void* db, void* ring, void* spill,
                             void* phibar, void* qbar, int B, int t_steps,
                             int N, int n, int seg, int factored, int R,
                             int G, int S, void* stream) {
  return launch_joint_adjoint<float>(phi, qdiag, z, r, y, mask, bounds_mean,
                                     bounds_cov, sb, db, ring, spill, phibar,
                                     qbar, B, t_steps, N, n, seg, factored, R,
                                     G, S, stream);
}

int metran_joint_adjoint_f64(const void* phi, const void* qdiag,
                             const void* z, const void* r, const void* y,
                             const void* mask, const void* bounds_mean,
                             const void* bounds_cov, const void* sb,
                             const void* db, void* ring, void* spill,
                             void* phibar, void* qbar, int B, int t_steps,
                             int N, int n, int seg, int factored, int R,
                             int G, int S, void* stream) {
  return launch_joint_adjoint<double>(phi, qdiag, z, r, y, mask, bounds_mean,
                                      bounds_cov, sb, db, ring, spill, phibar,
                                      qbar, B, t_steps, N, n, seg, factored,
                                      R, G, S, stream);
}

// blocks of K11 resident per SM at (N, n, R, G, S), shared-memory or
// spill layout
int metran_joint_adjoint_occupancy_f32(int N, int n, int R, int G, int S,
                                       int spill, void* blocks) {
  return occupancy<float>(N, n, R, G, S, spill, (int*)blocks);
}

int metran_joint_adjoint_occupancy_f64(int N, int n, int R, int G, int S,
                                       int spill, void* blocks) {
  return occupancy<double>(N, n, R, G, S, spill, (int*)blocks);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
