// K1's step body run by a group of kG warps per model (joint_filter.cu's
// default kernel): one warp, or four on a named barrier of their own.
//
// filter_group runs the k appended steps of model b exactly as
// jointk::filter_block (joint_step.cuh) runs them in a block of 256
// threads: every output entry is computed by the same sequence of
// floating-point operations, so the two kernels agree bit for bit in
// every mode.  Only the mapping of entries to threads differs, and with
// it the synchronisation: a model's threads share its shared memory and
// meet at __syncwarp (one warp) or at a named barrier of the group's own
// (bar.sync id, 32 kG), so the time loop runs without a block-wide
// barrier.  What is kept exactly:
//   - each dot product's terms in the block kernel's order;
//   - the right-looking Cholesky, column by column, with the block
//     kernel's divisions and trailing updates;
//   - the forward and back substitutions with their divisions, one
//     column of K' (and v) a lane;
//   - K F into Hm, then P -= Hm K' (the JAX form);
//   - the has_obs verdict (any slot observed) and the pivot verdicts.
// What a model's few warps need is parallelism they can keep in flight:
// every phase is latency-bound (a shared-memory load, a division and a
// square root each take tens of cycles), and a warp alone on its
// scheduler hides no stall.
// The levers, none of which changes a bit:
//   - a lane owns a column (of P, Z_m P, F, K F) or a row (of L) and each
//     warp of the group a block of the other index, walked in plain loops
//     four rows or four terms at a time, so the loads of the next terms
//     go out ahead of the fma chain;
//   - Z's zero entries are skipped in Z m, Z_m P and F: a term
//     fma(0, x, acc) is acc for finite x, and a sum that starts at +0
//     never becomes -0.  Each row's nonzero columns are kept as a bit mask
//     (a bit a column, taken in column order), built once a model: Z is
//     constant over the steps;
//   - the N logs of det F are taken by N threads before the solves and
//     summed by one thread in the block kernel's order;
//   - step t + 1's row of y and mask is loaded into registers while
//     step t runs.
// P, Z_m P (S | 1) and L (N | 1) are stored with odd row strides, so a
// lane-per-column or lane-per-row access hits distinct banks, while a
// model with them fits kMaxSmem; past that with strides S and N.  L is
// dead once the solves have read it and K F is written after them, so
// the two share one piece: a model takes no more shared memory than the
// block kernel's layout wherever N < S, so the warp kernel takes every
// bucket the block kernel (and the joint arena update) takes.
//
// A block holds up to kMaxModels models, each on its own carve of the
// block's dynamic shared memory (model_bytes each).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "joint_step.cuh"

namespace jointw {

using jointk::kBounds;
using jointk::kCarry;
using jointk::kStore;

constexpr int kLanes = 32;
// models one block holds at most, and warps a model at most
constexpr int kMaxModels = 8;
constexpr int kMaxGroup = 4;
// the dynamic shared memory one H100 block may use (bytes)
constexpr size_t kMaxSmem = 232448;
// entries of the next step's row a thread prefetches into registers:
// a = thread + 32 kG u for u < kPrefetch (rows past that load late)
constexpr int kPrefetch = 4;

template <typename T>
struct Smem {
  T *P, *Zs, *KT, *Fm, *L, *Hm, *m, *ph, *v, *w, *msk, *ys, *lg;
  uint32_t* zbits;
  int* flags;
  int sp, lp, nw;  // row strides of P and KT, of L; words a row of zbits
};

// hands out consecutive pieces of one model's shared memory
struct Carver {
  unsigned char* base;
  size_t used;
  template <typename U>
  __host__ __device__ U* take(size_t count) {
    U* out = reinterpret_cast<U*>(base + used);
    used += count * sizeof(U);
    return out;
  }
};

__host__ __device__ inline size_t umax(size_t a, size_t b) {
  return a > b ? a : b;
}

// one model's shared memory with row strides sp (P, KT) and lp (L);
// returns its bytes, rounded up to 16 so that every carve is aligned
template <typename T>
__host__ __device__ inline size_t carve(unsigned char* raw, int N, int S,
                                        int sp, int lp, Smem<T>* s) {
  Carver c{raw, 0};
  s->sp = sp;
  s->lp = lp;
  s->nw = (S + 31) / 32;
  s->P = c.take<T>((size_t)S * sp);          // S*sp covariance
  s->Zs = c.take<T>((size_t)N * S);          // N*S observation matrix
  s->KT = c.take<T>((size_t)N * sp);         // N*sp: Z_m P, then K'
  s->Fm = c.take<T>((size_t)N * N);          // N*N innovation covariance
  // N*lp its Cholesky factor until the solves, then S*N: K F
  s->L = c.take<T>(umax((size_t)N * lp, (size_t)S * N));
  s->Hm = s->L;
  s->m = c.take<T>((size_t)S);               // S mean
  s->ph = c.take<T>((size_t)S);              // S transition diagonal
  s->v = c.take<T>((size_t)N);               // N innovation
  s->w = c.take<T>((size_t)N);               // N: L^-1 v
  s->msk = c.take<T>((size_t)N);             // N: the step's mask as 0/1
  s->ys = c.take<T>((size_t)N);              // N: the step's row of y
  s->lg = c.take<T>((size_t)N);              // N: log diag L
  s->zbits = c.take<uint32_t>((size_t)N * s->nw);  // Z's nonzeros, a bit each
  s->flags = c.take<int>((size_t)kMaxGroup); // a verdict a warp
  return (c.used + 15) / 16 * 16;
}

// the layout of one model's shared memory, its bytes returned: the odd
// row strides S | 1 and N | 1 while they fit kMaxSmem, else S and N
template <typename T>
__host__ __device__ inline size_t layout(unsigned char* raw, int N, int S,
                                         Smem<T>* s) {
  const size_t odd = carve<T>(raw, N, S, S | 1, N | 1, s);
  return odd <= kMaxSmem ? odd : carve<T>(raw, N, S, S, N, s);
}

// one model's bytes (a multiple of 16)
template <typename T>
__host__ __device__ inline size_t model_bytes(int N, int S) {
  Smem<T> s;
  return layout<T>(nullptr, N, S, &s);
}

// f(j) for each nonzero column j of a row of Z (its nw words of bits),
// in column order
template <typename F>
__device__ inline void each_nonzero(const uint32_t* bits, int nw, F f) {
  for (int wd = 0; wd < nw; ++wd)
    for (uint32_t u = bits[wd]; u != 0; u &= u - 1)
      f(wd * 32 + __ffs(u) - 1);
}

// a model's threads: t in [0, 32 kG), its warp and lane, and the named
// barrier the group meets at (kG > 1)
template <int kG>
struct Group {
  int t, warp, lane, bar;
  int* flags;

  __device__ void sync() const {
    if (kG == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(kLanes * kG)
                   : "memory");
  }
  // whether pred holds on any thread of the group; a barrier
  __device__ bool any(int pred) const {
    const int w = __any_sync(0xffffffffu, pred);
    if (kG == 1) return w != 0;
    if (lane == 0) flags[warp] = w;
    sync();
    int r = 0;
#pragma unroll
    for (int i = 0; i < kG; ++i) r |= flags[i];
    sync();
    return r != 0;
  }
  // this warp's share [lo, hi) of n rows
  __device__ void rows(int n, int& lo, int& hi) const {
    lo = n * warp / kG;
    hi = n * (warp + 1) / kG;
  }
};

// The right-looking Cholesky of the lower triangle of L (N x N, row
// stride lp) in place, as jointk::filter_block runs it: column c's pivot
// d = L[c][c] is checked (d > 0 and finite, else the verdict is false),
// sq = sqrt(d), L[r][c] /= sq for r > c, L[c][c] = sq, then L[r][cc] -=
// L[r][c] * L[cc][c] for c < cc <= r; finally every entry of the lower
// triangle must be finite.  A row a lane; with kG warps, warp w takes the
// columns cc = c + 1 + w, c + 1 + w + kG, ... of every row, four loads
// ahead.  Returns the verdict, uniform over the group, with L visible to
// every thread.
template <typename T, int kG>
__device__ inline bool cholesky(T* L, int N, int lp, const Group<kG>& g) {
  for (int c = 0; c < N; ++c) {
    const T d = L[c * lp + c];
    if (!(d > T(0)) || !isfinite(d)) return false;  // group-uniform
    const T sq = sqrt(d);
    for (int r = c + 1 + g.t; r < N; r += kLanes * kG) L[r * lp + c] /= sq;
    g.sync();
    if (g.t == 0) L[c * lp + c] = sq;
    for (int r = c + 1 + g.lane; r < N; r += kLanes) {
      const T lrc = L[r * lp + c];
#pragma unroll 4
      for (int cc = c + 1 + g.warp; cc <= r; cc += kG)
        L[r * lp + cc] -= lrc * L[cc * lp + c];
    }
    g.sync();
  }
  int bad = 0;
  for (int r = g.t; r < N; r += kLanes * kG)
    for (int c = 0; c <= r; ++c)
      if (!isfinite(L[r * lp + c])) bad = 1;
  return !g.any(bad);
}

// row a of the forward solves (solve's first loop), a column a lane
template <typename T>
__device__ inline void forward_row(const T* L, T* KT, const T* v, T* w,
                                   int a, int lp, int S, int sp, int lane) {
  for (int j = lane; j <= S; j += kLanes) {
    const bool col = j < S;
    T* x = col ? KT + j : w;
    const int st = col ? sp : 1;
    T acc = col ? x[a * st] : v[a];
#pragma unroll 4
    for (int c = 0; c < a; ++c) acc -= L[a * lp + c] * x[c * st];
    x[a * st] = acc / L[a * lp + a];
  }
}

// kG > 1: the Cholesky on warps 1..kG-1 (a row a lane, warp w taking the
// columns cc = c + w, c + w + kG - 1, ...), while warp 0 runs the forward
// solves a row behind: row a of L is final once column a is factored, and
// forward row a reads nothing else of L.  The same operations in the same
// order as cholesky() then solve(); only their schedule overlaps.
template <typename T, int kG>
__device__ inline bool factor_forward(T* L, T* KT, const T* v, T* w, int N,
                                      int lp, int S, int sp,
                                      const Group<kG>& g) {
  constexpr int fw = kG - 1;  // the factor's warps
  const int ft = g.t - kLanes;  // a thread's index among them
  for (int c = 0; c <= N; ++c) {
    T sq = 0;
    if (c < N) {
      const T d = L[c * lp + c];
      if (!(d > T(0)) || !isfinite(d)) return false;  // group-uniform
      sq = sqrt(d);
      if (ft >= 0)
        for (int r = c + 1 + ft; r < N; r += kLanes * fw) L[r * lp + c] /= sq;
    }
    if (g.warp == 0 && c > 0)
      forward_row<T>(L, KT, v, w, c - 1, lp, S, sp, g.lane);
    g.sync();
    if (c < N && ft >= 0) {
      if (ft == 0) L[c * lp + c] = sq;
      for (int r = c + 1 + g.lane; r < N; r += kLanes) {
        const T lrc = L[r * lp + c];
#pragma unroll 4
        for (int cc = c + g.warp; cc <= r; cc += fw)
          L[r * lp + cc] -= lrc * L[cc * lp + c];
      }
    }
    g.sync();
  }
  int bad = 0;
  for (int r = g.t; r < N; r += kLanes * kG)
    for (int c = 0; c <= r; ++c)
      if (!isfinite(L[r * lp + c])) bad = 1;
  return !g.any(bad);
}

// The two triangular solves of every column of K' (KT's column j, j < S)
// and the forward solve of v into w (column S), one column a lane of the
// group's first warp, as jointk::filter_block runs them: forward, row a =
// 0..N-1, acc = b[a] less L[a][c] x[c] for c = 0..a-1 in turn, x[a] = acc
// / L[a][a]; back, row a = N-1..0, acc = x[a] less L[c][a] x[c] for c =
// a+1..N-1 in turn, x[a] = acc / L[a][a].  Each dot product's loads run
// four terms ahead of its chain of fmas.
// with `forward` false only the back solves (the forward ones ran beside
// the factor, factor_forward)
template <typename T>
__device__ inline void solve(const T* L, T* KT, const T* v, T* w, int N,
                             int lp, int S, int sp, int lane, bool forward) {
  if (forward)
    for (int a = 0; a < N; ++a) forward_row<T>(L, KT, v, w, a, lp, S, sp, lane);
  for (int j = lane; j < S; j += kLanes) {
    T* x = KT + j;
    const int st = sp;
    for (int a = N - 1; a >= 0; --a) {
      T acc = x[a * st];
#pragma unroll 4
      for (int c = a + 1; c < N; ++c) acc -= L[c * lp + a] * x[c * st];
      x[a * st] = acc / L[a * lp + a];
    }
  }
}

// x0, x1: the segment boundaries (bounds); x0..x3: m_p, P_p, m_f, P_f
// per step (store).  Leaves the final (m, P) in shared memory.
template <typename T, int kMode, int kG>
__device__ void filter_group(unsigned char* smem_raw, const Group<kG>& g,
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
                             T* __restrict__ x3, int b, int k, int N, int S,
                             int seg) {
  constexpr int nt = kLanes * kG;
  Smem<T> s;
  layout<T>(smem_raw, N, S, &s);
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
  T* ys = s.ys;
  T* lg = s.lg;
  const uint32_t* zbits = s.zbits;
  const int nw = s.nw;
  const int tid = g.t;
  const int lane = g.lane;
  const int sp = s.sp;
  const int lp = s.lp;
  const T* qb = q + (size_t)b * S * S;
  const T* rb = r + (size_t)b * N;

  // (m, P) to device memory, unpadded: (S) at xm, (S, S) at xp
  auto write_moments = [&](T* xm, T* xp) {
    for (int i = tid; i < S; i += nt) xm[i] = m[i];
    for (int idx = tid; idx < S * S; idx += nt)
      xp[idx] = P[(idx / S) * sp + idx % S];
  };

  {
    const T* cb = cov0 + (size_t)b * S * S;
    for (int idx = tid; idx < S * S; idx += nt)
      P[(idx / S) * sp + idx % S] = cb[idx];
  }
  for (int i = tid; i < N * S; i += nt) Zs[i] = z[(size_t)b * N * S + i];
  for (int i = tid; i < S; i += nt) {
    m[i] = mean0[(size_t)b * S + i];
    ph[i] = phi[(size_t)b * S + i];
  }
  if (k > 0) {
    const T* y0 = y + (size_t)b * k * N;
    const uint8_t* m0 = mask + (size_t)b * k * N;
    for (int a = tid; a < N; a += nt) {
      ys[a] = y0[a];
      msk[a] = m0[a] ? T(1) : T(0);
    }
  }
  g.sync();
  for (int i = tid; i < N * nw; i += nt) {  // Z's nonzeros, a bit each
    const int a = i / nw, j0 = (i % nw) * 32;
    uint32_t u = 0;
    for (int j = j0; j < S && j < j0 + 32; ++j)
      if (Zs[a * S + j] != T(0)) u |= 1u << (j - j0);
    s.zbits[i] = u;
  }
  g.sync();

  // this warp's rows of P (and of K F), and of Z_m P and F
  int s_lo, s_hi, n_lo, n_hi;
  g.rows(S, s_lo, s_hi);
  g.rows(N, n_lo, n_hi);

  for (int t = 0; t < k; ++t) {
    const size_t st = (size_t)b * k + t;
    // step t + 1's row, into registers while step t runs
    T yn[kPrefetch];
    uint8_t mn[kPrefetch];
    const bool more = t + 1 < k;
    if (more) {
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int a = tid + nt * u;
        if (a < N) {
          yn[u] = y[(st + 1) * N + a];
          mn[u] = mask[(st + 1) * N + a];
        }
      }
    }

    // ---- the step (each `goto done` leaves it with its terms written)
    if (kMode == kBounds && t % seg == 0) {  // the carry entering it
      const int n_seg = (k + seg - 1) / seg;
      const size_t sb = (size_t)b * n_seg + t / seg;
      write_moments(x0 + sb * S, x1 + sb * S * S);
      g.sync();
    }
    // phase: predict (a column of P a lane, a block of rows a warp)
    for (int i = tid; i < S; i += nt) m[i] = ph[i] * m[i];
    for (int j = lane; j < S; j += kLanes) {
      const T phj = ph[j];
#pragma unroll 4
      for (int i = s_lo; i < s_hi; ++i)
        P[i * sp + j] = ph[i] * P[i * sp + j] * phj + qb[i * S + j];
    }
    g.sync();
    if (kMode == kStore) {  // the predicted moments of step t
      write_moments(x0 + st * S, x1 + st * S * S);
    }
    {
      int any = 0;
      for (int a = tid; a < N; a += nt) any |= msk[a] != T(0);
      if (!g.any(any)) {  // nothing observed at this step
        if (tid == 0) {
          sigma_out[st] = 0;
          detf_out[st] = 0;
        }
        goto done;
      }
    }
    // phase: innovation and the (masked) rows of Z P, over Z's nonzeros
    for (int a = tid; a < N; a += nt) {
      T acc = 0;
      each_nonzero(zbits + a * nw, nw,
                   [&](int j) { acc += Zs[a * S + j] * m[j]; });
      v[a] = msk[a] != T(0) ? ys[a] - acc : T(0);
    }
    for (int i = lane; i < S; i += kLanes) {  // a column of Z_m P a lane
#pragma unroll 4
      for (int a = n_lo; a < n_hi; ++a) {
        T acc = 0;
        each_nonzero(zbits + a * nw, nw,
                     [&](int j) { acc += P[i * sp + j] * Zs[a * S + j]; });
        KT[a * sp + i] = msk[a] * acc;
      }
    }
    g.sync();
    // phase: F = Z_m (P Z_m') + diag(r o mask + 1 - mask), a column a lane
    for (int c = lane; c < N; c += kLanes) {
#pragma unroll 4
      for (int a = n_lo; a < n_hi; ++a) {
        T acc = 0;
        each_nonzero(zbits + a * nw, nw, [&](int i) {
          acc += Zs[a * S + i] * msk[a] * KT[c * sp + i];
        });
        if (a == c) acc += (msk[a] != T(0) ? rb[a] : T(0)) + (T(1) - msk[a]);
        Fm[a * N + c] = acc;
        L[a * lp + c] = acc;
      }
    }
    g.sync();
    // phase: right-looking Cholesky on the lower triangle of L (kG > 1:
    // the forward solves beside it)
    bool factored;
    if constexpr (kG == 1)
      factored = cholesky<T, kG>(L, N, lp, g);
    else
      factored = factor_forward<T, kG>(L, KT, v, w, N, lp, S, sp, g);
    if (!factored) {
      if (tid == 0) {  // degraded step: carry the predicted moments
        sigma_out[st] = 0;
        detf_out[st] = INFINITY;
      }
      goto done;
    }
    // phase: solves.  K' = L'^-1 L^-1 (Z_m P): column j of KT a lane of
    // the first warp; column S is v (its forward solve only).  The logs of
    // diag L first.
    for (int a = tid; a < N; a += nt) lg[a] = log(L[a * lp + a]);
    if (g.warp == 0) solve<T>(L, KT, v, w, N, lp, S, sp, lane, kG == 1);
    g.sync();
    // phase: update.  m += K v; K F into Hm, a column a lane, a block of
    // rows a warp, four rows at a time; the step's likelihood terms (the
    // group's last thread, idle in K F while N < 32)
    for (int i = tid; i < S; i += nt) {
      T acc = 0;
#pragma unroll 4
      for (int a = 0; a < N; ++a) acc += KT[a * sp + i] * v[a];
      m[i] = m[i] + acc;
    }
    for (int c = lane; c < N; c += kLanes) {
      int i = s_lo;
      for (; i + 4 <= s_hi; i += 4) {
        T h0 = 0, h1 = 0, h2 = 0, h3 = 0;
        for (int a = 0; a < N; ++a) {
          const T f = Fm[a * N + c];
          const T* kt = KT + a * sp + i;
          h0 += kt[0] * f;
          h1 += kt[1] * f;
          h2 += kt[2] * f;
          h3 += kt[3] * f;
        }
        Hm[i * N + c] = h0;
        Hm[(i + 1) * N + c] = h1;
        Hm[(i + 2) * N + c] = h2;
        Hm[(i + 3) * N + c] = h3;
      }
      for (; i < s_hi; ++i) {
        T acc = 0;
        for (int a = 0; a < N; ++a) acc += KT[a * sp + i] * Fm[a * N + c];
        Hm[i * N + c] = acc;
      }
    }
    if (tid == nt - 1) {
      T sg = 0, lgs = 0;
      for (int a = 0; a < N; ++a) {
        sg += w[a] * w[a];
        lgs += lg[a];
      }
      sigma_out[st] = sg;
      detf_out[st] = T(2) * lgs;
    }
    g.sync();
    // phase: P -= Hm K', a column a lane, a block of rows a warp, four
    // rows at a time
    for (int j = lane; j < S; j += kLanes) {
      int i = s_lo;
      for (; i + 4 <= s_hi; i += 4) {
        T p0 = 0, p1 = 0, p2 = 0, p3 = 0;
        for (int c = 0; c < N; ++c) {
          const T kt = KT[c * sp + j];
          p0 += Hm[i * N + c] * kt;
          p1 += Hm[(i + 1) * N + c] * kt;
          p2 += Hm[(i + 2) * N + c] * kt;
          p3 += Hm[(i + 3) * N + c] * kt;
        }
        P[i * sp + j] = P[i * sp + j] - p0;
        P[(i + 1) * sp + j] = P[(i + 1) * sp + j] - p1;
        P[(i + 2) * sp + j] = P[(i + 2) * sp + j] - p2;
        P[(i + 3) * sp + j] = P[(i + 3) * sp + j] - p3;
      }
      for (; i < s_hi; ++i) {
        T acc = 0;
        for (int c = 0; c < N; ++c) acc += Hm[i * N + c] * KT[c * sp + j];
        P[i * sp + j] = P[i * sp + j] - acc;
      }
    }
    g.sync();
  done:
    // phase: end of step
    if (kMode == kStore) {  // the carry leaving step t
      write_moments(x2 + st * S, x3 + st * S * S);
    }
    if (more) {  // step t + 1's row (this step read its own before F)
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int a = tid + nt * u;
        if (a < N) {
          ys[a] = yn[u];
          msk[a] = mn[u] ? T(1) : T(0);
        }
      }
      for (int a = tid + nt * kPrefetch; a < N; a += nt) {
        ys[a] = y[(st + 1) * N + a];
        msk[a] = mask[(st + 1) * N + a] ? T(1) : T(0);
      }
    }
    g.sync();
  }
}

}  // namespace jointw
