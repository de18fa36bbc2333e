// K9's step body run by a group of kG warps per model (sqrt_filter.cu's
// default kernel): two or four warps on a named barrier of their own.
//
// run_group runs the time loop of one lane exactly as sqrtk::run_steps
// (sqrt_step.cuh) runs it in a block of 64 threads: every output entry is
// computed by the same sequence of floating-point operations, so the two
// kernels agree bit for bit in every instantiation (store, carry,
// bounds, the gate's policies, the robust likelihoods).  Only the mapping
// of work to threads differs, and with it the synchronisation: a model's
// threads share its shared memory and meet at a named barrier of the
// group's own (bar.sync id, 32 kG), so the time loop runs without a
// block-wide barrier.  What is kept exactly:
//   - every Householder reflector of sqrtqr::house_qr, its two
//     accumulators (rows r0, r0 + 2, ... and r0 + 1, r0 + 3, ... from the
//     block kernel's r0) and its application, column by column;
//   - each sum of products in the block kernel's order: (Z_o S_p)', the
//     gate's marginal, the innovations, m_f and the forward substitution.
// The levers, none of which changes a bit:
//   - look-ahead: in stage j one thread (the owner, the only thread of
//     the last warp with a column) applies reflector j to column j + 1
//     and forms reflector j + 1 from it (the norm taken as the axpy writes
//     the entries, its reflector kept in registers for the next stage),
//     while the other warps apply reflector j to the later columns, a
//     column a thread with the block kernel's two accumulators;
//     reflector j + 1 is published before the stage's barrier, so no
//     thread forms a norm at the head of a stage;
//   - a row walk loads eight rows (then four, two, one) before their
//     multiply-adds and stores, so a thread waits on one load latency a
//     chunk, not one a row;
//   - the predict pre-array [(phi o S)' ; diag sqrt q] of a carry that is
//     lower triangular and finite (every carry the kernel writes) has
//     column j nonzero below its diagonal in rows n .. n + j only: its
//     reflectors skip rows j + 1 .. n - 1, whose terms are exact zeros
//     (x + 0 is x for a partial sum, which never is -0, and x - 0 u is x
//     while u is finite).  A step whose carry is not (the first step from
//     a given factor, a carry with a non-finite entry) runs the block
//     kernel's rows, and so does the rest of a QR once a reflector's
//     multiplier is not finite (0 u would then be NaN);
//   - Z's zero entries are skipped in (Z_o S_p)', the gate's marginal, the
//     innovations and the robust mean while S_p and m_p are finite (a bit
//     mask a row of Z, built once a launch; where the layout has no room
//     for it, each entry is tested);
//   - the gated modes form (Z S_p)_i once, in the gate, for the update's
//     pre-array too;
//   - the forward substitution (with the log-determinant and sigma) runs
//     on a rider thread a row behind the update QR: row k of
//     w = F^-1/2' \ v needs only what stage k - 1 finished; and m_f takes
//     its term k at stage k + 1, accumulated in m, on the owner's warp;
//   - step t + 1's row of y and of the mask is loaded into registers while
//     step t runs.
//
// A block holds up to kMaxWarps / kG models, each on its own carve of the
// block's dynamic shared memory (model_bytes each).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "implicit_map.cuh"
#include "sqrt_qr.cuh"
#include "sqrt_step.cuh"

namespace sqrtw {

using sqrtk::kHuber;
using sqrtk::kInflate;
using sqrtk::kNoGate;
using sqrtk::kReject;
using sqrtk::kRobust;
using sqrtk::RobustArgs;

constexpr int kLanes = 32;
// warps one block holds at most (models times warps a model), and warps
// a model at least and at most
constexpr int kMaxWarps = 8;
constexpr int kMinGroup = 2;
constexpr int kMaxGroup = 4;
// the dynamic shared memory one H100 block may use (bytes)
constexpr size_t kMaxSmem = 232448;
// entries of the next step's row a thread prefetches into registers
constexpr int kPrefetch = 4;
// a model's flags: set to 1 by any thread, cleared by one (the carry is
// not lower triangular and finite; S_p, m_p not finite; the update is not
// ok; a predict reflector's multiplier was not finite), and the step's
// observed count
enum Flag { kNotTri = 0, kNanSp, kNanMp, kBad, kPoll, kMo, kFlags };

template <typename T>
struct Smem {
  T *zs, *rr, *ph, *qs, *m, *S, *mp, *Sp, *pa, *ua, *dg, *vv, *ys, *wsc,
      *reff;
  int *obs, *hit, *flags;
  uint32_t* zbits;  // null: Z's zeros are found by testing each entry
  int ldp, nw, odd;
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

// one model's shared memory with odd leading dimensions (or not) and
// Z's bit masks (or not); returns its bytes, rounded up to 16
template <typename T>
__host__ __device__ inline size_t carve(unsigned char* raw, int N, int n,
                                        bool odd, bool bits, Smem<T>* s) {
  Carver c{raw, 0};
  const int R = N + n;
  const int ldu = odd ? sqrtqr::odd_ld(R) : R;
  s->odd = odd ? 1 : 0;
  s->ldp = odd ? sqrtqr::odd_ld(2 * n) : 2 * n;
  s->nw = bits ? (n + 31) / 32 : 0;
  s->zs = c.take<T>((size_t)N * n);  // N*n observation matrix
  s->rr = c.take<T>((size_t)N);      // N observation noise
  s->ph = c.take<T>((size_t)n);      // n transition diagonal
  s->qs = c.take<T>((size_t)n);      // n sqrt of the state noise
  s->m = c.take<T>((size_t)n);       // n the carry's mean; m_f builds in it
  s->S = c.take<T>((size_t)n * n);   // n*n the carry's factor
  s->mp = c.take<T>((size_t)n);      // n m_p
  s->Sp = c.take<T>((size_t)n * n);  // n*n S_p
  // the predict pre-array; after S_p the rows (Z S_p)_i of the gated
  // modes (N*n), then the update QR's reflectors (tau, scale: 2 R)
  s->pa = c.take<T>(umax((size_t)s->ldp * n, (size_t)N * n + 2 * (size_t)R));
  // the update pre-array; during the predict QR its reflectors (2 n)
  s->ua = c.take<T>((size_t)ldu * R);
  s->dg = c.take<T>((size_t)R);      // R the QR's diagonal
  s->vv = c.take<T>((size_t)N);      // N the update's innovations
  // N the step's row of y (the gated modes' innovations in place), then w
  s->ys = c.take<T>((size_t)N);
  s->wsc = c.take<T>((size_t)N);     // N the gate's scales
  s->reff = c.take<T>((size_t)N);    // N the gate's noise
  s->obs = c.take<int>((size_t)N);   // N the observed slots, in order
  // N the step's mask row until it is compacted, then the gate's hits
  s->hit = c.take<int>((size_t)N);
  s->flags = c.take<int>((size_t)kFlags);
  s->zbits = bits ? c.take<uint32_t>((size_t)N * s->nw) : nullptr;
  return (c.used + 15) / 16 * 16;
}

// the layout of one model's shared memory, its bytes returned: odd
// leading dimensions and Z's bit masks while they fit kMaxSmem, else
// neither
template <typename T>
__host__ __device__ inline size_t layout(unsigned char* raw, int N, int n,
                                         Smem<T>* s) {
  const size_t full = carve<T>(raw, N, n, true, true, s);
  return full <= kMaxSmem ? full : carve<T>(raw, N, n, false, false, s);
}

// one model's bytes (a multiple of 16)
template <typename T>
__host__ __device__ inline size_t model_bytes(int N, int n) {
  Smem<T> s;
  return layout<T>(nullptr, N, n, &s);
}

// a model's thread t in [0, 32 kG) and the named barrier its group meets
// at
template <int kG>
struct Group {
  static_assert(kG >= kMinGroup && kG <= kMaxGroup, "two to four warps");
  int t, bar;

  __device__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(kLanes * kG)
                 : "memory");
  }
};

// f(b) for each b >= a at which row i of Z is nonzero, in order (every
// b >= a when `all`: a term z * x with x not finite is not 0)
template <typename T, typename F>
__device__ inline void each_term(const Smem<T>& s, int n, int i, int a,
                                 bool all, F f) {
  const T* zi = s.zs + (size_t)i * n;
  if (all) {
    for (int b = a; b < n; ++b) f(b);
  } else if (s.zbits != nullptr) {
    const uint32_t* bits = s.zbits + (size_t)i * s.nw;
    for (int wd = a >> 5; wd < s.nw; ++wd) {
      uint32_t u = bits[wd];
      if (wd == (a >> 5)) u &= ~0u << (a & 31);
      for (; u != 0; u &= u - 1) f(wd * 32 + __ffs(u) - 1);
    }
  } else {
    for (int b = a; b < n; ++b)
      if (zi[b] != T(0)) f(b);
  }
}

// The sums of x[i] y[i] over rows [from, to) into the block kernel's two
// accumulators: d0 takes the rows an even distance from pr, d1 the odd,
// each in row order (rows before `from` are exact zeros).  Eight rows'
// loads go out before their multiply-adds.
template <typename T>
__device__ inline void dot2(const T* x, const T* y, int from, int to, int pr,
                            T& d0, T& d1) {
  int i = from;
  if (i < to && ((i - pr) & 1)) {
    d1 += x[i] * y[i];
    ++i;
  }
  for (; i + 7 < to; i += 8) {
    T xs[8], ys[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      xs[k] = x[i + k];
      ys[k] = y[i + k];
    }
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      d0 += xs[k] * ys[k];
      d1 += xs[k + 1] * ys[k + 1];
    }
  }
  if (i + 3 < to) {
    const T x0 = x[i], x1 = x[i + 1], x2 = x[i + 2], x3 = x[i + 3];
    const T y0 = y[i], y1 = y[i + 1], y2 = y[i + 2], y3 = y[i + 3];
    d0 += x0 * y0;
    d1 += x1 * y1;
    d0 += x2 * y2;
    d1 += x3 * y3;
    i += 4;
  }
  if (i + 1 < to) {
    const T x0 = x[i], x1 = x[i + 1], y0 = y[i], y1 = y[i + 1];
    d0 += x0 * y0;
    d1 += x1 * y1;
    i += 2;
  }
  if (i < to) d0 += x[i] * y[i];
}

// y[i] -= x[i] u over rows [from, to), eight rows' loads ahead of their
// stores; with kNorm the new entries also go into the accumulators s0
// (rows an even distance from pr) and s1 as they come out, in row order
template <typename T, bool kNorm>
__device__ inline void axpy(const T* x, T* y, T u, int from, int to, int pr,
                            T& s0, T& s1) {
  int i = from;
  if (kNorm && i < to && ((i - pr) & 1)) {
    const T v = y[i] - x[i] * u;
    y[i] = v;
    s1 += v * v;
    ++i;
  }
  for (; i + 7 < to; i += 8) {
    T xs[8], ys[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      xs[k] = x[i + k];
      ys[k] = y[i + k];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const T v = ys[k] - xs[k] * u;
      y[i + k] = v;
      if (kNorm) {
        if (k % 2 == 0)
          s0 += v * v;
        else
          s1 += v * v;
      }
    }
  }
  if (i + 3 < to) {
    T xs[4], ys[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xs[k] = x[i + k];
      ys[k] = y[i + k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T v = ys[k] - xs[k] * u;
      y[i + k] = v;
      if (kNorm) {
        if (k % 2 == 0)
          s0 += v * v;
        else
          s1 += v * v;
      }
    }
    i += 4;
  }
  if (i + 1 < to) {
    const T x0 = x[i], x1 = x[i + 1], y0 = y[i], y1 = y[i + 1];
    const T v0 = y0 - x0 * u, v1 = y1 - x1 * u;
    y[i] = v0;
    y[i + 1] = v1;
    if (kNorm) {
      s0 += v0 * v0;
      s1 += v1 * v1;
    }
    i += 2;
  }
  if (i < to) {
    const T v = y[i] - x[i] * u;
    y[i] = v;
    if (kNorm) s0 += v * v;
  }
}

// the reflector of sqrtqr::house_qr from its column's diagonal entry and
// the norm below it
template <typename T>
__device__ inline void reflector(T alpha, T sig, T& beta, T& tau, T& scale) {
  if (sig == T(0)) {  // nothing below the diagonal: H = I
    beta = alpha;
    tau = 0;
    scale = 0;
  } else {
    const T nrm = sqrt(alpha * alpha + sig);
    beta = alpha >= T(0) ? -nrm : nrm;
    tau = (beta - alpha) / beta;
    scale = T(1) / (alpha - beta);
  }
}

// The update QR's riders: the forward substitution (w into ww, the terms
// of sigma and detf in the rider's registers) and m_f, accumulated in m.
template <typename T>
struct Riders {
  const T* vv;
  T* ww;
  T* m;
  int o, n;
  T sig, det;
};

// The threads' roles in the QR: one owner forms the next reflector (the
// first lane of the last warp, whose other lanes are the m_f riders), the
// workers (the other warps) apply the current one to the other columns,
// and the last worker is the forward substitution's rider.
template <int kG>
struct Roles {
  static constexpr int nt = kLanes * kG;
  static constexpr int kOwner = nt - kLanes;
  static constexpr int kWorkers = nt - kLanes;
  static constexpr int kFwd = nt - kLanes - 1;
  static constexpr int kMf0 = nt - kLanes + 1;
  static constexpr int kMfs = kLanes - 1;
};

// The unblocked Householder QR of sqrtqr::house_qr (column j reflects
// rows j and [max(j + 1, lo), min(rows, hi0 + j))) on the group, one
// stage a barrier, with look-ahead: in stage j the owner applies
// reflector j to column j + 1 and forms reflector j + 1, while the
// workers apply reflector j to columns j + 2 ...  skip > 0 (the predict
// QR of a triangular carry): column j is zero in rows j + 1 .. skip - 1,
// which are left out; a reflector whose multiplier is not finite on some
// column sets *poll, and that column and every later stage take the full
// rows.  kUpd (the update QR, lo = o): `bad` collects the ok verdict of
// every entry of R and diagonal, and the riders run.  The reflectors'
// tau and scale go through tau_s and sc_s, the diagonal into diag.
template <typename T, int kG, bool kUpd>
__device__ void qr(T* a, int ld, int rows, int cols, int lo, int hi0,
                   int skip, T* diag, T* tau_s, T* sc_s, int* poll, int& bad,
                   Riders<T>& rd, const Group<kG>& g) {
  using Ro = Roles<kG>;
  const int t = g.t;
  const bool owner = t == Ro::kOwner;
  T own_tau = 0, own_sc = 0;  // the owner's last reflector, kept
  if (owner) {  // column 0's reflector
    const int pr = max(1, lo);
    T s0 = 0, s1 = 0;
    dot2(a, a, max(pr, skip), min(rows, hi0), pr, s0, s1);
    T beta;
    reflector<T>(a[0], s0 + s1, beta, own_tau, own_sc);
    diag[0] = beta;
    tau_s[0] = own_tau;
    sc_s[0] = own_sc;
    if (kUpd && !(isfinite(beta) && (0 >= lo || beta != T(0)))) bad = 1;
  }
  g.sync();
  for (int j = 0; j < cols; ++j) {
    const T tau = owner ? own_tau : tau_s[j];
    const T scale = owner ? own_sc : sc_s[j];
    const bool full = skip == 0 || *poll != 0;
    const int pr = max(j + 1, lo), r1 = min(rows, hi0 + j);
    const int first = full ? pr : max(pr, skip);
    const T* cj = a + (size_t)j * ld;
    // reflector j on column k: the dot product, the pivot row, the
    // multiplier and the rows below; returns whether the column took the
    // full rows
    auto apply = [&](T* ck, T& s0, T& s1, int first1, int pr1,
                     T& alpha) -> bool {
      const T ckj = ck[j];
      bool col_full = full;
      if (tau != T(0)) {
        T d0 = 0, d1 = 0;
        dot2(cj, ck, first, r1, pr, d0, d1);
        const T wk = tau * (ckj + scale * (d0 + d1));
        ck[j] = ckj - wk;
        const T u = scale * wk;
        if (!full && !isfinite(u)) {
          col_full = true;
          *poll = 1;
          if (first1 >= 0) first1 = pr1;
        }
        const int lo_a = col_full ? pr : first;
        if (first1 < 0) {
          axpy<T, false>(cj, ck, u, lo_a, r1, 0, s0, s1);
        } else {  // rows [first1, r1) into the norm as they come out
          if (lo_a < first1) {  // row j + 1: the next reflector's alpha
            alpha = ck[lo_a] - cj[lo_a] * u;
            ck[lo_a] = alpha;
          }
          axpy<T, true>(cj, ck, u, first1, r1, pr1, s0, s1);
        }
      } else if (first1 >= 0) {
        dot2(ck, ck, first1, r1, pr1, s0, s1);
      }
      if (kUpd && !isfinite(ck[j])) bad = 1;
      return col_full;
    };
    if (owner) {
      if (j + 1 < cols) {  // column j + 1, then reflector j + 1
        T* ck = a + (size_t)(j + 1) * ld;
        T alpha = ck[j + 1];
        // the norm of rows [first1, r11) of column j + 1 as reflector j
        // writes them (rows >= r1 it leaves as they were)
        const int pr1 = max(j + 2, lo), r11 = min(rows, hi0 + j + 1);
        T s0 = 0, s1 = 0;
        const bool col_full = apply(ck, s0, s1, full ? pr1 : max(pr1, skip),
                                    pr1, alpha);
        dot2(ck, ck, max(r1, col_full ? pr1 : max(pr1, skip)), r11, pr1, s0,
             s1);
        T beta;
        reflector<T>(alpha, s0 + s1, beta, own_tau, own_sc);
        diag[j + 1] = beta;
        tau_s[j + 1] = own_tau;
        sc_s[j + 1] = own_sc;
        if (kUpd && !(isfinite(beta) && (j + 1 >= lo || beta != T(0))))
          bad = 1;
      }
    } else if (t < Ro::kWorkers) {
      T s0 = 0, s1 = 0, alpha;
      for (int k = j + 2 + t; k < cols; k += Ro::kWorkers)
        apply(a + (size_t)k * ld, s0, s1, -1, 0, alpha);
    }
    if (kUpd) {
      if (t == Ro::kFwd && j < rd.o) {  // forward row j
        T acc = rd.vv[j];
#pragma unroll 4
        for (int i = 0; i < j; ++i) acc -= cj[i] * rd.ww[i];
        const T d = diag[j];
        const T wk = acc / d;
        rd.ww[j] = wk;
        rd.sig += wk * wk;
        const T lg = T(2) * log(fabs(d));
        rd.det += lg;
      }
      if (j >= 1 && j <= rd.o && t >= Ro::kMf0 &&
          t < Ro::kMf0 + Ro::kMfs) {  // m_f's term j - 1
        const T wj = rd.ww[j - 1];
        for (int c = t - Ro::kMf0; c < rd.n; c += Ro::kMfs)
          rd.m[c] += a[(size_t)(rd.o + c) * ld + j - 1] * wj;
      }
    }
    g.sync();
  }
}

// x0, x1: the segment boundaries (bounds); per step m_p, S_p, m_f, S_f
// (store); the final (m, S) stay in shared memory for the caller.
template <typename T, bool kStore, bool kBounds, int kGate, int kG>
__device__ void run_group(Smem<T>& s, const Group<kG>& g,
                          const T* __restrict__ yl,
                          const uint8_t* __restrict__ ml, bool arm,
                          double thresh_d, T* __restrict__ o_mean_p,
                          T* __restrict__ o_chol_p, T* __restrict__ o_mean_f,
                          T* __restrict__ o_chol_f, T* __restrict__ o_sigma,
                          T* __restrict__ o_detf,
                          T* __restrict__ o_bounds_mean,
                          T* __restrict__ o_bounds_chol, T* __restrict__ o_z,
                          int8_t* __restrict__ o_verdict, RobustArgs<T> rob,
                          int l, int t_steps, int N, int n, int seg) {
  constexpr bool kRob = kGate >= kRobust;
  constexpr int kLik = kRob ? kGate - kRobust : 0;
  constexpr int nt = kLanes * kG;
  const int tid = g.t;
  const int nn = n * n;
  const int ldp = s.ldp;
  const T inf = T(INFINITY);
  const T thresh = T(thresh_d);
  int* fl = s.flags;
  // the stamps' declarations

  for (int i = tid; i < N * s.nw; i += nt) {  // Z's nonzeros, a bit each
    const int a = i / s.nw, b0 = (i % s.nw) * 32;
    uint32_t u = 0;
    for (int b = b0; b < n && b < b0 + 32; ++b)
      if (s.zs[a * n + b] != T(0)) u |= 1u << (b - b0);
    s.zbits[i] = u;
  }
  if (t_steps > 0)
    for (int i = tid; i < N; i += nt) {
      s.ys[i] = yl[i];
      s.hit[i] = ml[i] != 0;
    }
  if (tid == 0) {
    fl[kNotTri] = 0;
    fl[kPoll] = 0;
  }
  g.sync();

  for (int t = 0; t < t_steps; ++t) {
    // step t + 1's row, into registers while step t runs
    T yn[kPrefetch];
    uint8_t mn[kPrefetch];
    const bool more = t + 1 < t_steps;
    if (more) {
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int i = tid + nt * u;
        if (i < N) {
          yn[u] = yl[(size_t)(t + 1) * N + i];
          mn[u] = ml[(size_t)(t + 1) * N + i];
        }
      }
    }
    if (kBounds && t % seg == 0) {  // the carry entering this segment
      const size_t sb = (size_t)l * ((t_steps + seg - 1) / seg) + t / seg;
      for (int a = tid; a < n; a += nt) o_bounds_mean[sb * n + a] = s.m[a];
      for (int idx = tid; idx < nn; idx += nt)
        o_bounds_chol[sb * nn + idx] = s.S[idx];
    }
    // phase: predict build: m_p, the pre-array, whether the carry is
    // lower triangular and finite, and the observed slots
    for (int a = tid; a < n; a += nt) s.mp[a] = s.ph[a] * s.m[a];
    {
      int off = 0;
      for (int idx = tid; idx < 2 * n * n; idx += nt) {
        const int c = idx / (2 * n), row = idx % (2 * n);
        const T v = row < n ? s.ph[c] * s.S[c * n + row]
                            : (row - n == c ? s.qs[c] : T(0));
        s.pa[c * ldp + row] = v;
        if (row < n && (!isfinite(v) || (row > c && v != T(0)))) off = 1;
      }
      if (off) fl[kNotTri] = 1;
    }
    if (tid < 32) {  // compact the observed slots, in order (warp 0)
      const size_t row = ((size_t)l * t_steps + t) * N;
      int base = 0;
      for (int i0 = 0; i0 < N; i0 += 32) {
        const int i = i0 + tid;
        const bool on = i < N && s.hit[i] != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, on);
        if (on) s.obs[base + __popc(bal & ((1u << tid) - 1u))] = i;
        base += __popc(bal);
        if (kGate != kNoGate && i < N && !on) {
          o_z[row + i] = T(NAN);
          o_verdict[row + i] = 0;
          if (kRob) rob.iters[row + i] = 0;
        }
      }
      if (tid == 0) {
        fl[kMo] = base;
        fl[kNanSp] = 0;
        fl[kNanMp] = 0;
        fl[kBad] = 0;
      }
    }
    g.sync();
    // phase: QR of the predict pre-array (its reflectors in ua)
    {
      int unused = 0;
      Riders<T> none{};
      qr<T, kG, false>(s.pa, ldp, 2 * n, n, 0, n + 1,
                       fl[kNotTri] ? 0 : n, s.dg, s.ua, s.ua + n,
                       fl + kPoll, unused, none, g);
    }
    // phase: S_p, and whether S_p and m_p are finite
    {
      int nan_sp = 0, nan_mp = 0;
      for (int idx = tid; idx < nn; idx += nt) {
        const int a = idx / n, b = idx % n;  // S_p[a, b] = sign_b R[b, a]
        T v = T(0);
        if (a == b)
          v = s.dg[b] * sqrtqr::row_sign(s.dg[b]);
        else if (a > b)
          v = s.pa[a * ldp + b] * sqrtqr::row_sign(s.dg[b]);
        s.Sp[idx] = v;
        if (!isfinite(v)) nan_sp = 1;
      }
      for (int a = tid; a < n; a += nt)
        if (!isfinite(s.mp[a])) nan_mp = 1;
      if (nan_sp) fl[kNanSp] = 1;
      if (nan_mp) fl[kNanMp] = 1;
    }
    g.sync();
    const bool all_s = fl[kNanSp] != 0, all_m = fl[kNanMp] != 0;
    // the rows (Z S_p)_i: in the gated modes at pa (slot-major), else
    // straight into the update pre-array
    T* zsp = s.pa;
    T* tau_u = s.pa + (size_t)N * n;
    T* sc_u = tau_u + N + n;
    if (kGate != kNoGate) {
      // phase: gate: each observed slot's (Z S_p)_i, then its marginal
      // innovation off S_p, its verdict and the policy's transform
      const int m0 = fl[kMo];
      for (int idx = tid; idx < m0 * n; idx += nt) {
        const int i = s.obs[idx / n], a = idx % n;
        T e = T(0);
        each_term(s, n, i, a, all_s,
                  [&](int b) { e += s.zs[i * n + b] * s.Sp[b * n + a]; });
        zsp[i * n + a] = e;
      }
      g.sync();
      const size_t row = ((size_t)l * t_steps + t) * N;
      for (int k = tid; k < m0; k += nt) {
        const int i = s.obs[k];
        const T yi = s.ys[i];
        T v = yi;
        each_term(s, n, i, 0, all_m,
                  [&](int a) { v -= s.zs[i * n + a] * s.mp[a]; });
        s.ys[i] = v;  // the innovation, for the update
        T f = T(0);
        for (int a = 0; a < n; ++a) {
          const T e = zsp[i * n + a];
          f += e * e;
        }
        const T c = f;  // the slot's marginal prior variance |(Z S_p)_i|^2
        f = f + s.rr[i];
        const T zi = v / sqrt(f);
        const T score = zi * zi;
        o_z[row + i] = zi;
        if (kRob) {
          const size_t pl = (size_t)l * N + i;
          const bool map = arm && imap::flags<T, kLik>(yi, rob.rail_lo[pl],
                                                       rob.rail_hi[pl]);
          s.reff[i] = s.rr[i];
          s.hit[k] = map ? 1 : 0;
          o_verdict[row + i] = 0;
          rob.iters[row + i] = 0;
          if (map) {
            T mu = T(0);
            each_term(s, n, i, 0, all_m,
                      [&](int a) { mu += s.zs[i * n + a] * s.mp[a]; });
            const T cf = T(rob.c_floor);
            const T cs = c < cf ? cf : c;  // NaN passes, as jnp.maximum
            const imap::Solve<T> sol = imap::map_solve<T, kLik>(
                mu, cs, yi, imap::slot_scale(s.rr[i], rob.scale[pl]),
                rob.quantum[pl], rob.rail_lo[pl], rob.rail_hi[pl], rob.nu,
                T(rob.tol), T(rob.nonconv_tol));
            const T wf = imap::mul(T(rob.eps), T(1e-2)) / cs;
            const T w_eff = (sol.w < wf || isnan(wf)) ? wf : sol.w;
            const T r_eff = T(1) / w_eff;
            s.reff[i] = r_eff;
            s.wsc[i] = imap::mul(imap::add(cs, r_eff),
                                 imap::sub(sol.s_hat, mu)) / cs;
            o_verdict[row + i] = sol.nonconv ? imap::kNonconv : imap::kMap;
            rob.iters[row + i] = sol.iters;
          }
        } else {
          const bool hit = arm && score > thresh;
          s.wsc[i] = kGate == kHuber && hit ? sqrt(thresh / score) : T(1);
          s.reff[i] = kGate == kInflate && hit
                          ? s.rr[i] + (v * v / thresh - f) : s.rr[i];
          s.hit[k] = hit ? 1 : 0;
          o_verdict[row + i] = hit ? (kGate == kReject ? 2 : 1) : 0;
        }
      }
      g.sync();
      if (kGate == kReject) {
        if (tid < 32) {  // drop the rejected slots (warp 0)
          int base = 0;
          for (int k0 = 0; k0 < m0; k0 += 32) {
            const int k = k0 + tid;
            const bool keep = k < m0 && s.hit[k] == 0;
            const int i = k < m0 ? s.obs[k] : 0;
            const unsigned bal = __ballot_sync(0xffffffffu, keep);
            if (keep) s.obs[base + __popc(bal & ((1u << tid) - 1u))] = i;
            base += __popc(bal);
          }
          if (tid == 0) fl[kMo] = base;
        }
        g.sync();
      }
    }
    const int o = fl[kMo];
    int bad = 0;
    if (o == 0) {
      // phase: m and S_f: predict-only, S_f = S_p exactly; ok iff S_p is
      // finite
      if (tid == 0) {
        const size_t st = (size_t)l * t_steps + t;
        o_sigma[st] = T(0);
        o_detf[st] = all_s ? inf : T(0);
      }
      for (int a = tid; a < n; a += nt) s.m[a] = s.mp[a];
      for (int idx = tid; idx < nn; idx += nt) s.S[idx] = s.Sp[idx];
    } else {
      const int R = o + n;
      const int ldu = s.odd ? sqrtqr::odd_ld(R) : R;
      // phase: pre-array: the innovations of the observed slots, the
      // compact pre-array (column-major), m_f's start
      for (int k = tid; k < o; k += nt) {
        const int i = s.obs[k];
        T acc = s.ys[i];
        if (kGate == kNoGate)
          each_term(s, n, i, 0, all_m,
                    [&](int a) { acc -= s.zs[i * n + a] * s.mp[a]; });
        s.vv[k] = kGate == kHuber ? s.wsc[i] * acc
                  : (kRob && s.hit[k]) ? s.wsc[i] : acc;  // v_eff
      }
      for (int idx = tid; idx < R * R; idx += nt) {
        const int c = idx / R, row = idx % R;
        T v;
        if (c < o) {
          const int i = s.obs[c];
          if (row < o) {
            v = row == c ? sqrt((kGate == kInflate || kRob) ? s.reff[i]
                                                           : s.rr[i])
                         : T(0);
          } else if (kGate != kNoGate) {
            v = zsp[i * n + row - o];
          } else {  // (Z_o S_p)'[a, c] = sum_b z[i, b] S_p[b, a], b >= a
            const int a = row - o;
            v = T(0);
            each_term(s, n, i, a, all_s,
                      [&](int b) { v += s.zs[i * n + b] * s.Sp[b * n + a]; });
          }
        } else {
          v = row < o ? T(0) : s.Sp[(c - o) * n + (row - o)];
        }
        s.ua[c * ldu + row] = v;
      }
      for (int a = tid; a < n; a += nt) s.m[a] = s.mp[a];
      g.sync();
      // phase: update QR, with the forward substitution and m_f beside it
      Riders<T> rd{s.vv, s.ys, s.m, o, n, T(0), T(0)};
      qr<T, kG, true>(s.ua, ldu, R, R, o, R, 0, s.dg, tau_u, sc_u,
                      fl + kPoll, bad, rd, g);
      if (bad) fl[kBad] = 1;
      g.sync();
      // phase: ok and the step's terms
      bad = fl[kBad];
      if (tid == Roles<kG>::kFwd) {
        const size_t st = (size_t)l * t_steps + t;
        o_sigma[st] = bad ? T(0) : rd.sig;
        o_detf[st] = bad ? inf : rd.det;
      }
      // phase: m and S_f
      if (bad) {
        for (int a = tid; a < n; a += nt) s.m[a] = s.mp[a];
        for (int idx = tid; idx < nn; idx += nt) s.S[idx] = s.Sp[idx];
      } else {
        for (int idx = tid; idx < nn; idx += nt) {
          const int a = idx / n, b = idx % n;  // S_f[a, b] = sign R[o+b, o+a]
          const T d = s.dg[o + b];
          T v = T(0);
          if (a == b)
            v = d * sqrtqr::row_sign(d);
          else if (a > b)
            v = s.ua[(o + a) * ldu + o + b] * sqrtqr::row_sign(d);
          s.S[idx] = v;
        }
      }
    }
    g.sync();
    // phase: end of step: the stores, step t + 1's row
    if (kStore) {
      const size_t st = (size_t)l * t_steps + t;
      for (int a = tid; a < n; a += nt) {
        o_mean_p[st * n + a] = s.mp[a];
        o_mean_f[st * n + a] = s.m[a];
      }
      for (int idx = tid; idx < nn; idx += nt) {
        o_chol_p[st * nn + idx] = s.Sp[idx];
        o_chol_f[st * nn + idx] = s.S[idx];
      }
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int i = tid + nt * u;
        if (i < N) {
          s.ys[i] = yn[u];
          s.hit[i] = mn[u] != 0;
        }
      }
      for (int i = tid + nt * kPrefetch; i < N; i += nt) {
        s.ys[i] = yl[(size_t)(t + 1) * N + i];
        s.hit[i] = ml[(size_t)(t + 1) * N + i] != 0;
      }
    }
    if (tid == 0) {
      fl[kNotTri] = 0;
      fl[kPoll] = 0;
    }
    g.sync();
  }
  // the stamps' flush
}

}  // namespace sqrtw
