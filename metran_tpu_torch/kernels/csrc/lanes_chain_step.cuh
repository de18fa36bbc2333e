// K3's step on a block per lane: a chain warp and update warps.
//
// The lane-layout sequential filter (lanes::filter_step, run by K3's
// oracle lanes_filter_warp.cu) spends each observed slot on one warp in
// series: z_i.m, d = P z_i over all n columns, two butterflies, n
// divisions, the dense rank-1 update and sigma/log f.  Here that work is
// split between the warps of one block, each entry of P computed by the
// oracle's operations in the oracle's order:
//
//   chain warp    per observed slot only what the next slot waits on: v
//                 and d from z_i's nonzero columns (Z = [I | loadings]
//                 has K + 1 a row, found once as bits), f, k = d/f and m;
//                 then the slot's rank-1 update of the columns the next
//                 observed slot reads (its own and the loadings'), and the
//                 next step's predict of the same columns;
//   update warps  every other column of every update and predict, a few
//                 events behind, from a ring of event records (the gain k,
//                 f, v, the step and the columns the chain keeps) handed
//                 over on Hopper mbarriers (full: the chain published the
//                 record; empty: each update warp is done with it); the
//                 first of them also sums each step's sigma and log f, in
//                 slot order, once the step is closed.
//
// The chain owns a column for an event exactly when the next observed
// slot reads it; before it takes a column that an update warp held for
// the event before, it waits for that event's release.  So every entry
// gets every event once, in order, and a column is complete before a slot
// reads it.  With no update warps the chain warp does all of it in turn.
//
// Bits: every sum keeps the oracle's association.  The row dot d_a runs
// over z_i's nonzero columns in ascending order; z_i.m and z_i'd are the
// oracle's butterfly over the lanes holding nonzero terms, which for at
// most three terms (one or two factors, n <= 32) is one or two additions
// in the butterfly's order (plan_of), else the oracle's warp_sum.  A
// skipped term is an exact zero only while the factor beside it is
// finite, so the chain keeps a bound on |P| and |m| from the gains,
// f and v it computes (|k_a| <= kGainCap); a lane whose bound fails, or
// whose gain, f or v is not finite, stops the update warps and runs the
// rest of its steps by the oracle's own lanes::series_update and
// lanes::filter_step (lanes_filter.cu).
#pragma once

#include "lanes_step.cuh"

namespace chain {

using lanes::kFull;
using lanes::warp_sum;

constexpr int kMaxU = 3;          // update warps, where a block has them
constexpr int kSlots = 4;         // event records in the ring
constexpr int kMaxN = 128;        // series a lane at most
constexpr int kPre = kMaxN / 32;  // a step's data a thread, held a step ahead
constexpr int kFast = 3;          // nonzero columns of a slot's short sums

enum Kind { kPredict = 0, kUpdate = 1, kEnd = 2, kStop = 3 };

// ---- Hopper barriers
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

// waits for the phase of `parity` to complete; a handoff that never comes
// (a fault in the schedule) aborts the launch once the wait has lasted
// `limit` cycles, instead of holding the card
__device__ __forceinline__ uint32_t mbar_test(uint32_t addr, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity,
                                          long long limit) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_test(addr, parity)) return;  // the usual case: already done
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

// ---- the layout: one block's work arrays, in this order (with base
// null, only the count); mirrors lanes.py::chain_smem_bytes
template <typename T>
struct Layout {
  int4* info;               // the ring's records: kind | copy << 2, t, own, i
  T* P;                     // n x ld, row-major (ld = n | 1: odd rows)
  T *Zs, *m, *ph, *qd;      // Z (N x n), m, phi, q (n)
  T *rs, *ys, *sv, *sf;     // r, the step's y, the chain's v and f (N)
  T* kv;                    // the gain of the oracle's step (n)
  T *rk, *rv, *rf;          // the ring: k (kSlots x n), v, f (kSlots)
  T *dv, *df;               // the step's v and f, summed by update warp 0
  uint32_t* bits;           // z_i's nonzero columns, N rows of nw words
  int* plan;                // the short sums' plan of each series (plan_of)
  uint8_t *ms, *dmark;      // the step's mask; the slots dv, df hold
  int ld;
};

struct Bump {
  size_t used = 0;
  template <typename U>
  __host__ __device__ U* take(unsigned char* base, size_t count) {
    U* p = base == nullptr ? nullptr : reinterpret_cast<U*>(base + used);
    used += count * sizeof(U);
    return p;
  }
};

template <typename T>
__host__ __device__ size_t carve(unsigned char* base, int N, int n,
                                 Layout<T>* s) {
  const int nw = (n + 31) / 32;
  const int ld = n | 1;
  Bump c;
  s->info = c.take<int4>(base, kSlots);
  s->P = c.take<T>(base, (size_t)n * ld);
  s->Zs = c.take<T>(base, (size_t)N * n);
  s->m = c.take<T>(base, n);
  s->ph = c.take<T>(base, n);
  s->qd = c.take<T>(base, n);
  s->rs = c.take<T>(base, N);
  s->ys = c.take<T>(base, N);
  s->sv = c.take<T>(base, N);
  s->sf = c.take<T>(base, N);
  s->kv = c.take<T>(base, n);
  s->rk = c.take<T>(base, (size_t)kSlots * n);
  s->rv = c.take<T>(base, kSlots);
  s->rf = c.take<T>(base, kSlots);
  s->dv = c.take<T>(base, N);
  s->df = c.take<T>(base, N);
  s->bits = c.take<uint32_t>(base, (size_t)N * nw);
  s->plan = c.take<int>(base, N);
  s->ms = c.take<uint8_t>(base, N);
  s->dmark = c.take<uint8_t>(base, N);
  s->ld = ld;
  return (c.used + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ size_t layout_bytes(int N, int n) {
  Layout<T> s;
  return carve<T>(nullptr, N, n, &s);
}

// ---- the short sums.  The oracle's warp_sum is a butterfly: lane l's
// partial meets lane l ^ 16 first and lane l ^ 1 last, so the sum is the
// pairwise tree over the lanes in bit-reversed order, and adding a lane's
// exact zero changes nothing.  With three nonzero terms the pair that
// meets first is the one whose bit-reversed lanes differ in the lower
// highest bit.  plan_of: bit 0 the short sums apply (n <= 32, at most
// kFast nonzero columns), bits 1-2 their count, bits 3-4 the pair that
// meets first (0: terms 0 and 1, 1: terms 0 and 2, 2: terms 1 and 2, in
// ascending columns), bits 5-9, 10-14, 15-19 the columns (fewer than
// three padded with the first: their terms are zeros, z = 0).
__device__ __forceinline__ int bitrev5(int x) { return __brev(x) >> 27; }

__device__ __forceinline__ int plan_of(const uint32_t* bits, int nw, int n) {
  if (n > 32) return 0;
  const uint32_t w = nw > 0 ? bits[0] : 0u;
  const int cnt = __popc(w);
  if (cnt > kFast) return 0;
  int col[kFast] = {0, 0, 0};
  uint32_t b = w;
  for (int k = 0; k < cnt; ++k) {
    col[k] = __ffs(b) - 1;
    b &= b - 1u;
  }
  for (int k = cnt; k < kFast; ++k) col[k] = col[0];
  int pair = 0;
  if (cnt == 3) {
    // the terms in bit-reversed order of their lanes
    int o[3] = {0, 1, 2};
    for (int x = 0; x < 3; ++x)
      for (int y = x + 1; y < 3; ++y)
        if (bitrev5(col[o[y]]) < bitrev5(col[o[x]])) {
          const int tmp = o[x];
          o[x] = o[y];
          o[y] = tmp;
        }
    const int g1 = 31 - __clz(bitrev5(col[o[0]]) ^ bitrev5(col[o[1]]));
    const int g2 = 31 - __clz(bitrev5(col[o[1]]) ^ bitrev5(col[o[2]]));
    const int u = g1 < g2 ? o[0] : o[1], v = g1 < g2 ? o[1] : o[2];
    const int lo = u < v ? u : v, hi = u < v ? v : u;
    pair = (lo == 0 && hi == 1) ? 0 : (lo == 0 ? 1 : 2);
  }
  return 1 | cnt << 1 | pair << 3 | col[0] << 5 | col[1] << 10 |
         col[2] << 15;
}

// ---- the oracle's roundings, spelled out, as nvcc compiles
// lanes_step.cuh: its partials are products rounded alone (an fma onto a
// butterfly lane's +0), its row dots fma chains, its butterflies adds of
// values from other lanes; the predict is two products and an add (the
// diagonal's select keeps them apart), the rank-1 update a product k_a k_b
// and an fma of it with f into P, the mean's update an fma.  Written as
// plain expressions, a product could be fused into the add beside it here
// and not there (contraction is the compiler's choice, made apart in each
// kernel), so every rounding the two kernels share is named.
template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b) {
  if constexpr (sizeof(T) == 4) {
    return __fmul_rn(a, b);
  } else {
    return __dmul_rn(a, b);
  }
}

template <typename T>
__device__ __forceinline__ T add_rn(T a, T b) {
  if constexpr (sizeof(T) == 4) {
    return __fadd_rn(a, b);
  } else {
    return __dadd_rn(a, b);
  }
}

template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b) {
  if constexpr (sizeof(T) == 4) {
    return __fsub_rn(a, b);
  } else {
    return __dsub_rn(a, b);
  }
}

template <typename T>
__device__ __forceinline__ T div_rn(T a, T b) {
  if constexpr (sizeof(T) == 4) {
    return __fdiv_rn(a, b);
  } else {
    return __ddiv_rn(a, b);
  }
}

template <typename T>
__device__ __forceinline__ T fma_rn(T a, T b, T c) {
  if constexpr (sizeof(T) == 4) {
    return __fmaf_rn(a, b, c);
  } else {
    return __fma_rn(a, b, c);
  }
}

// the butterfly's sum of three terms (ascending columns; a padded term is
// a zero, which leaves the sum as it was): the pair that meets first, then
// the third, chosen without a branch
template <typename T>
__device__ __forceinline__ T sum3(T x0, T x1, T x2, int pair) {
  const T a = pair == 2 ? x1 : x0;
  const T b = pair == 0 ? x1 : x2;
  const T c = pair == 0 ? x2 : (pair == 1 ? x1 : x0);
  return add_rn(add_rn(a, b), c);
}

// a row's dot with z_i over its three columns c0 < c1 < c2: the first
// product rounded alone, then an fma a term, as the oracle's chain over
// every column leaves it (its zero terms, and a padded one here, add exact
// zeros while P is finite)
template <typename T>
__device__ __forceinline__ T dot3(const T* __restrict__ row, int c0, int c1,
                                  int c2, T z0, T z1, T z2) {
  return fma_rn(row[c2], z2, fma_rn(row[c1], z1, mul_rn(row[c0], z0)));
}

// ---- bounds that keep the skipped terms exact zeros: |P| <= B and
// |m| <= Bm, so every entry of P, m and d = P z stays finite
constexpr double kGainCap = 65536.0;  // |k_a| a slot may take

template <typename T>
struct Guard {
  T phi, q, lim;  // max |phi|, max |q|, the bound B and Bm stay under
  T B, Bm;
  bool safe;
  __device__ void predict() {
    B = phi * phi * B + q;
    Bm = phi * Bm;
    safe = safe && B <= lim && Bm <= lim;
  }
  __device__ void update(bool gains_ok, T f, T v) {
    const T cap = T(kGainCap);
    B = B + cap * cap * fabs(f);
    Bm = Bm + cap * fabs(v);
    safe = safe && gains_ok && B <= lim && Bm <= lim;
  }
};

// ---- the next observed slot after `after` (-1 from the start), or -1
template <int kW>
__device__ __forceinline__ int next_obs(const uint32_t (&obs)[kW],
                                        int after) {
  int found = -1;
#pragma unroll
  for (int r = kW - 1; r >= 0; --r) {
    const int lo = after + 1 - 32 * r;  // first bit of word r wanted
    uint32_t w = obs[r];
    if (lo >= 32) w = 0u;
    else if (lo > 0) w &= ~0u << lo;
    if (w != 0u) found = 32 * r + __ffs(w) - 1;
  }
  return found;
}

// ---- a step's sigma and log f from the v, f of its observed slots (a
// lane a slot, then the sums in slot order, as the oracle adds them)
template <typename T>
__device__ __forceinline__ void close_step(T* v, T* f,
                                           const uint32_t (&mk)[kPre],
                                           int N, int lane, T* sigma,
                                           T* detf, size_t at, bool write) {
#pragma unroll
  for (int r = 0; r < kPre; ++r) {
    const int i = lane + 32 * r;
    if (i < N && (mk[r] >> lane & 1u)) {
      const T vi = v[i], fi = f[i];
      v[i] = div_rn(mul_rn(vi, vi), fi);
      f[i] = log(fi);
    }
  }
  __syncwarp();
  if (lane == 0 && write) {
    T sig = 0, det = 0;
#pragma unroll
    for (int r = 0; r < kPre; ++r) {
      uint32_t w = mk[r];
      while (w != 0u) {
        const int i = 32 * r + __ffs(w) - 1;
        w &= w - 1u;
        sig = add_rn(sig, v[i]);
        det = add_rn(det, f[i]);
      }
    }
    sigma[at] = sig;
    detf[at] = det;
  }
  __syncwarp();
}

// P's predicted entry (a, b) from x = P_ab: the oracle's two products and
// add
template <typename T>
__device__ __forceinline__ T predicted(const Layout<T>& s, T pa, T x, int a,
                                       int b) {
  return add_rn(mul_rn(mul_rn(pa, x), s.ph[b]), a == b ? s.qd[a] : T(0));
}

// ---- the update warps: every event's columns that the chain does not
// keep, rows split over the threads; update warp 0 also closes each step.
// Thread `ut` of U*32 takes column ut % n and every G-th row from ut / n
// (G = U*32 / n), or, where n > U*32, columns ut, ut + U*32, ... whole.
constexpr int kRowBatch = 8;  // rows loaded before their entries are written

template <typename T>
__device__ void update_warp(const Layout<T> s, int u, int U, int lane,
                            uint64_t* full, uint64_t* empty, T* bcov,
                            T* sigma, T* detf, int l, int L, int t_steps,
                            int N, int n, int seg, long long patience) {
  const int nw = (n + 31) / 32;
  const int ld = s.ld;
  const int ut = u * 32 + lane, nt = U * 32;
  int b0, bstep, a0, astep;
  if (n <= nt) {
    const int G = nt / n;
    b0 = ut < G * n ? ut % n : n;
    bstep = n;
    a0 = ut / n;
    astep = G;
  } else {
    b0 = ut;
    bstep = nt;
    a0 = 0;
    astep = 1;
  }
  for (int e = 0;; ++e) {
    const int slot = e % kSlots;
    mbar_wait(&full[slot], (e / kSlots) & 1, patience);
    const int4 inf = s.info[slot];
    const int kind = inf.x & 3;
    if (kind == kStop) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      return;
    }
    const int t = inf.y;
    if (kind == kEnd) {
      if (u == 0) {
        uint32_t mk[kPre];
#pragma unroll
        for (int r = 0; r < kPre; ++r)
          mk[r] = __ballot_sync(kFull, lane + 32 * r < N &&
                                           s.dmark[lane + 32 * r]);
        close_step(s.dv, s.df, mk, N, lane, sigma, detf,
                   (size_t)t * L + l, t >= 0 && t < t_steps);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      return;
    }
    const uint32_t* ob = inf.z >= 0 ? s.bits + inf.z * nw : nullptr;
    if (kind == kUpdate) {
      const T f = s.rf[slot];
      const T* __restrict__ k = s.rk + slot * n;
      if (u == 0 && lane == 0) {
        s.dv[inf.w] = s.rv[slot];
        s.df[inf.w] = f;
        s.dmark[inf.w] = 1;
      }
#pragma unroll 1
      for (int b = b0; b < n; b += bstep) {
        if (ob != nullptr && (ob[b >> 5] >> (b & 31) & 1u)) continue;
        const T kb = k[b];
        T* __restrict__ Pb = s.P + b;
        // rows a0, a0 + astep, ...: kRowBatch loaded before they are
        // written, the last batch guarded
#pragma unroll 1
        for (int a = a0; a < n; a += kRowBatch * astep) {
          T ka[kRowBatch], p[kRowBatch];
#pragma unroll
          for (int x = 0; x < kRowBatch; ++x) {
            const int r = min(a + x * astep, n - 1);
            ka[x] = k[r];
            p[x] = Pb[r * ld];
          }
#pragma unroll
          for (int x = 0; x < kRowBatch; ++x)
            if (a + x * astep < n)
              Pb[(a + x * astep) * ld] = fma_rn(-f, mul_rn(ka[x], kb), p[x]);
        }
      }
    } else {  // predict, after the copy-out of a segment's start
      const bool copy = (inf.x >> 2) & 1;
      T* bc = copy ? bcov + (size_t)(t / seg) * n * n * L + l : nullptr;
#pragma unroll 1
      for (int b = b0; b < n; b += bstep) {
        if (ob != nullptr && (ob[b >> 5] >> (b & 31) & 1u)) continue;
        T* __restrict__ Pb = s.P + b;
#pragma unroll 1
        for (int a = a0; a < n; a += kRowBatch * astep) {
          T pa[kRowBatch], p[kRowBatch];
#pragma unroll
          for (int x = 0; x < kRowBatch; ++x) {
            const int r = min(a + x * astep, n - 1);
            pa[x] = s.ph[r];
            p[x] = Pb[r * ld];
          }
#pragma unroll
          for (int x = 0; x < kRowBatch; ++x) {
            const int r = a + x * astep;
            if (r < n) {
              if (copy) bc[((size_t)r * n + b) * L] = p[x];
              Pb[r * ld] = predicted(s, pa[x], p[x], r, b);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (kind == kPredict && u == 0 && t > 0) {
      // the step before is closed: its sigma and log f
      uint32_t mk[kPre];
#pragma unroll
      for (int r = 0; r < kPre; ++r)
        mk[r] = __ballot_sync(kFull, lane + 32 * r < N &&
                                         s.dmark[lane + 32 * r]);
      close_step(s.dv, s.df, mk, N, lane, sigma, detf,
                 (size_t)(t - 1) * L + l, t - 1 < t_steps);
#pragma unroll
      for (int r = 0; r < kPre; ++r)
        if (lane + 32 * r < N) s.dmark[lane + 32 * r] = 0;
      __syncwarp();
    }
  }
}

// ---- where the guard stopped the chain warp: the step and the slot it
// did not run (t = -1: it ran to the end); the update warps have then
// released every event
struct Stop {
  int t, i;
};

// a slot's rank-1 update (k in the ring, f) on the chain's columns, own
// rows: the next slot's, by its bits (where both slots take the short sums
// the chain warp does this itself, its gains by shuffle), or every column
// (dense, with no update warps: own < 0)
template <typename T>
__device__ __forceinline__ void chain_update_cols(const Layout<T>& s, int own,
                                                  int nw, const T* k, T f,
                                                  int n, int lane) {
  const int ld = s.ld;
#pragma unroll 1
  for (int a = lane; a < n; a += 32) {
    const T ka = k[a];
    T* __restrict__ Pa = s.P + a * ld;
    if (own < 0) {
#pragma unroll 4
      for (int b = 0; b < n; ++b) Pa[b] = fma_rn(-f, mul_rn(ka, k[b]), Pa[b]);
    } else {
      const uint32_t* cols = s.bits + own * nw;
#pragma unroll 1
      for (int w = 0; w < nw; ++w) {
        uint32_t bw = cols[w];
        while (bw != 0u) {
          const int b = w * 32 + __ffs(bw) - 1;
          bw &= bw - 1u;
          Pa[b] = fma_rn(-f, mul_rn(ka, k[b]), Pa[b]);
        }
      }
    }
  }
}

// the next predict (after the copy-out of a segment's start, bc) on the
// chain's columns, own rows: the next slot's (its plan's three columns, a
// padded one not written; else its bits), or every column (own < 0)
template <typename T>
__device__ __forceinline__ void chain_predict_cols(const Layout<T>& s,
                                                   int own, int nw, T* bc,
                                                   int n, int L, int lane) {
  const int ld = s.ld;
  const int pl = own >= 0 ? s.plan[own] : 0;
#pragma unroll 1
  for (int a = lane; a < n; a += 32) {
    const T pa = s.ph[a];
    T* __restrict__ Pa = s.P + a * ld;
    if (own < 0) {
#pragma unroll 4
      for (int b = 0; b < n; ++b) {
        const T x = Pa[b];
        if (bc != nullptr) bc[((size_t)a * n + b) * L] = x;
        Pa[b] = predicted(s, pa, x, a, b);
      }
    } else if (pl & 1) {
      const int cnt = (pl >> 1) & 3;
      const int c0 = (pl >> 5) & 31, c1 = (pl >> 10) & 31,
                c2 = (pl >> 15) & 31;
      const T x0 = Pa[c0], x1 = Pa[c1], x2 = Pa[c2];
      if (bc != nullptr) {
        if (cnt > 0) bc[((size_t)a * n + c0) * L] = x0;
        if (cnt > 1) bc[((size_t)a * n + c1) * L] = x1;
        if (cnt > 2) bc[((size_t)a * n + c2) * L] = x2;
      }
      if (cnt > 0) Pa[c0] = predicted(s, pa, x0, a, c0);
      if (cnt > 1) Pa[c1] = predicted(s, pa, x1, a, c1);
      if (cnt > 2) Pa[c2] = predicted(s, pa, x2, a, c2);
    } else {
      const uint32_t* cols = s.bits + own * nw;
#pragma unroll 1
      for (int w = 0; w < nw; ++w) {
        uint32_t bw = cols[w];
        while (bw != 0u) {
          const int b = w * 32 + __ffs(bw) - 1;
          bw &= bw - 1u;
          const T x = Pa[b];
          if (bc != nullptr) bc[((size_t)a * n + b) * L] = x;
          Pa[b] = predicted(s, pa, x, a, b);
        }
      }
    }
  }
}

// ---- the chain warp: every event of the run, from (0, I).  Returns where
// the guard stopped it (t = -1: it ran to the end; the update warps have
// then released every event).
template <typename T, int U>
__device__ Stop chain_warp(const Layout<T> s, int lane, uint64_t* full,
                           uint64_t* empty, Guard<T> g,
                           const T* __restrict__ yl,
                           const uint8_t* __restrict__ ml, T* bmean, T* bcov,
                           T* sigma, T* detf, int l, int L, int t_steps,
                           int N, int n, int seg, long long patience) {
  const int nw = (n + 31) / 32;
  const int ld = s.ld;
  const int n_steps = (t_steps + seg - 1) / seg * seg;
  int e = 0;          // events published
  int released = -1;  // the update warps are done through this event
  int own_prev = -1;  // the series whose columns the chain kept last event
  auto release = [&](int x) {  // wait until the update warps are done with x
    if (U > 0 && x > released) {
      mbar_wait(&empty[x % kSlots], (x / kSlots) & 1, patience);
      released = x;
    }
  };
  // an event into the ring: its record (the gains were written already)
  auto publish = [&](int kind, int t, int own, int i, T v, T f) {
    if (U == 0) return;
    if (lane == 0) {
      const int slot = e % kSlots;
      s.info[slot] = make_int4(kind, t, own, i);
      s.rv[slot] = v;
      s.rf[slot] = f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&full[e % kSlots]);
  };

  T yreg[kPre];
  uint8_t mreg[kPre];
  auto fetch = [&](int t) {
#pragma unroll
    for (int r = 0; r < kPre; ++r) {
      const int i = lane + 32 * r;
      yreg[r] = T(0);
      mreg[r] = 0;
      if (i < N && t < t_steps) {
        yreg[r] = yl[(size_t)t * N + i];
        mreg[r] = ml[(size_t)t * N + i];
      }
    }
  };
  fetch(0);
  // the stamps' declarations
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    // phase: step
    uint32_t obs[kPre];
#pragma unroll
    for (int r = 0; r < kPre; ++r) {
      const int i = lane + 32 * r;
      if (i < N) {
        s.ys[i] = yreg[r];
        s.ms[i] = mreg[r];
      }
      obs[r] = __ballot_sync(kFull, i < N && mreg[r] != 0);
    }
    fetch(t + 1);
    __syncwarp();
    int i = next_obs(obs, -1);
    // phase: predict
    const bool copy = bmean != nullptr && t % seg == 0;
    if (U > 0) release(e - kSlots);  // the record's ring slot is free
    publish(kPredict | (copy ? 4 : 0), t, i, -1, T(0), T(0));
    T* bc = copy ? bcov + (size_t)(t / seg) * n * n * L + l : nullptr;
    if (copy)
      for (int a = lane; a < n; a += 32)
        bmean[((size_t)(t / seg) * n + a) * L + l] = s.m[a];
    if (U == 0 || i >= 0) {
      if (U > 0 && i != own_prev) release(e - 1);
      chain_predict_cols(s, U == 0 ? -1 : i, nw, bc, n, L, lane);
    }
    for (int a = lane; a < n; a += 32) s.m[a] = mul_rn(s.m[a], s.ph[a]);
    g.predict();
    own_prev = U == 0 ? -1 : i;
    ++e;
    __syncwarp();
    while (i >= 0) {
      // phase: wait
      if (!g.safe) {  // the oracle's step from here on, alone
        // phase: full
        if (U > 0) {
          release(e - kSlots);
          publish(kStop, t, -1, -1, T(0), T(0));
          ++e;
          release(e - 1);
        }
        return Stop{t, i};
      }
      if (U > 0) release(e - kSlots);
      const int slot = e % kSlots;
      T* __restrict__ k = s.rk + slot * n;
      const int pl = s.plan[i];
      // the next observed slot, this step's or the next step's first: the
      // chain keeps its columns for this slot's event
      const int nxt = next_obs(obs, i);
      int own = nxt;
      if (nxt < 0 && t + 1 < n_steps) {
        uint32_t ahead[kPre];
#pragma unroll
        for (int r = 0; r < kPre; ++r)
          ahead[r] = __ballot_sync(kFull, lane + 32 * r < N &&
                                              mreg[r] != 0);
        own = next_obs(ahead, -1);
      }
      const int pl_own = own >= 0 ? s.plan[own] : 0;
      T kown = 0;  // the fast path's gain of row `lane`
      const T* __restrict__ zi = s.Zs + i * n;
      const T yi = s.ys[i];
      T v, f;
      bool ok = true;
      if (pl & 1) {  // n <= 32, at most three nonzero columns
        // phase: v
        const int cnt = (pl >> 1) & 3, pair = (pl >> 3) & 3;
        const int c0 = (pl >> 5) & 31, c1 = (pl >> 10) & 31,
                  c2 = (pl >> 15) & 31;
        const T z0 = cnt > 0 ? zi[c0] : T(0), z1 = cnt > 1 ? zi[c1] : T(0),
                z2 = cnt > 2 ? zi[c2] : T(0);
        const T x0 = mul_rn(z0, s.m[c0]), x1 = mul_rn(z1, s.m[c1]),
                x2 = mul_rn(z2, s.m[c2]);
        v = sub_rn(yi, sum3(x0, x1, x2, pair));
        // phase: d-and-f
        const T* __restrict__ P = s.P;
        const int row = lane < n ? lane : n - 1;
        const T acc = dot3(P + row * ld, c0, c1, c2, z0, z1, z2);
        const T d0 = dot3(P + c0 * ld, c0, c1, c2, z0, z1, z2);
        const T d1 = dot3(P + c1 * ld, c0, c1, c2, z0, z1, z2);
        const T d2 = dot3(P + c2 * ld, c0, c1, c2, z0, z1, z2);
        const T p0 = mul_rn(z0, d0), p1 = mul_rn(z1, d1),
                p2 = mul_rn(z2, d2);
        f = add_rn(sum3(p0, p1, p2, pair), s.rs[i]);
        // phase: gain
        if (lane < n) {
          kown = acc / f;
          k[lane] = kown;
          ok = fabs(kown) <= T(kGainCap);
        }
      } else {  // the oracle's sums, z_i's zero columns skipped in d
        // phase: v
        T part = 0;
        for (int a = lane; a < n; a += 32) part = fma_rn(zi[a], s.m[a], part);
        v = sub_rn(yi, warp_sum(part));
        // phase: d-and-f
        const uint32_t* zb = s.bits + i * nw;
        T fpart = 0;
        for (int a = lane; a < n; a += 32) {
          const T* __restrict__ Pa = s.P + a * ld;
          T acc = 0;
          for (int w = 0; w < nw; ++w) {
            uint32_t bw = zb[w];
            while (bw != 0u) {
              const int b = w * 32 + __ffs(bw) - 1;
              bw &= bw - 1u;
              acc = fma_rn(Pa[b], zi[b], acc);
            }
          }
          k[a] = acc;
          fpart = fma_rn(zi[a], acc, fpart);
        }
        f = add_rn(warp_sum(fpart), s.rs[i]);
        // phase: gain
        for (int a = lane; a < n; a += 32) {
          k[a] = k[a] / f;
          ok = ok && fabs(k[a]) <= T(kGainCap);
        }
      }
      // phase: publish
      if (lane == 0) {
        s.sv[i] = v;
        s.sf[i] = f;
      }
      publish(kUpdate, t, own, i, v, f);
      // phase: look-ahead
      const bool fast = (pl & 1) && (pl_own & 1);  // n <= 32 here
      __syncwarp();  // every read of m and the gains' writes done
      if (pl & 1) {
        if (lane < n) s.m[lane] = fma_rn(kown, v, s.m[lane]);
      } else {
        for (int a = lane; a < n; a += 32)
          s.m[a] = fma_rn(k[a], v, s.m[a]);
      }
      g.update(__all_sync(kFull, ok), f, v);
      if (U > 0 && fast) {
        // the next slot's columns, their gains by shuffle
        const int cnt = (pl_own >> 1) & 3;
        const int c0 = (pl_own >> 5) & 31, c1 = (pl_own >> 10) & 31,
                  c2 = (pl_own >> 15) & 31;
        const T k0 = __shfl_sync(kFull, kown, c0),
                k1 = __shfl_sync(kFull, kown, c1),
                k2 = __shfl_sync(kFull, kown, c2);
        if (own != own_prev) release(e - 1);
        if (lane < n) {
          T* __restrict__ Pa = s.P + lane * ld;
          const T p0 = Pa[c0], p1 = Pa[c1], p2 = Pa[c2];
          if (cnt > 0) Pa[c0] = fma_rn(-f, mul_rn(kown, k0), p0);
          if (cnt > 1) Pa[c1] = fma_rn(-f, mul_rn(kown, k1), p1);
          if (cnt > 2) Pa[c2] = fma_rn(-f, mul_rn(kown, k2), p2);
        }
      } else if (U == 0 || own >= 0) {
        if (U > 0 && own != own_prev) release(e - 1);
        chain_update_cols(s, U == 0 ? -1 : own, nw, k, f, n, lane);
      }
      own_prev = U == 0 ? -1 : own;
      ++e;
      __syncwarp();
      i = nxt;
      // phase: rest
    }
    if (U == 0)  // the chain closes its own steps
      close_step(s.sv, s.sf, obs, N, lane, sigma, detf, (size_t)t * L + l,
                 t < t_steps);
  }
  if (U > 0) {
    release(e - kSlots);
    publish(kEnd, n_steps - 1, -1, -1, T(0), T(0));
    ++e;
    release(e - 1);  // every column complete
  }
  // the stamps' flush
  return Stop{-1, -1};
}

}  // namespace chain
