// K4: closed-form adjoint of the lane-layout filter, one thread block per
// lane, warp-specialised.
//
// Replaces the JAX package's device program
// metran_tpu/ops/lanes.py::_terms_adjoint_bwd (kernel B2; its replay is
// _run_segments and _adj_step), the backward half of the fleet fit's
// gradient: given the cotangents sb, db of K3's (sigma, detf) and K3's
// segment boundaries, it returns the cotangents phibar, qbar (n, L) of the
// diagonal transition and process noise.
//
// Per lane, segments in reverse:
//   replay   the segment forward from its stored boundary (the same
//            lanes::filter_step as K3), keeping per step a record of the
//            pre-predict carry (mean0, cov0), per observed slot (d, f, v)
//            and the quotients that need no adjoint (2 sb v/f, -sb v^2/f^2
//            + db/f, v/f), and the step's mask;
//   sweep    steps in reverse; per observed slot in reverse order, with
//            u, S the adjoints of the post-update (m, P):
//              vbar = 2 sb v/f + u.d/f
//              fbar = -sb v^2/f^2 + db/f + d'Sd/f^2 - (u.d) v/f^2
//              dvec = -(S + S')d/f + u v/f + fbar z_i
//              S += dvec z_i',  u -= vbar z_i
//            then the predict adjoint:
//              phibar += u o mean0 + sum_j (S o cov0)_kj phi_j
//                                  + sum_i (S o cov0)_ik phi_i
//              qbar += diag(S),  u = u o phi,  S = (phi phi') o S
//
// What bounds it on an H100: latency.  A step is K3's recursion run twice,
// forward and in reverse, each a chain of small dependent products on a few
// KB of state, where a warp waits on its own previous instruction far more
// than it computes (a row walk is a chain of shared loads).
// Only the sweep is serial across segments: each segment's replay starts
// from a boundary K3 already wrote.  So the block splits in two roles that
// run at once (as K11's, joint_adjoint.cu):
//   R replay warps   replay segments i = warp, warp + R, ... (counted from
//                    the last) into slot i % D of a ring of D segment
//                    records in device memory, each step by
//                    lanes::filter_step, so the replayed forward is K3's
//                    instruction for instruction;
//   sweep warps      take the segments last-first as each slot fills; a
//                    slot hands over through a pair of Hopper mbarriers
//                    (full: the replay warp's threads arrive; empty: the
//                    sweep's threads arrive once the slot is read).  With
//                    two, one warp walks S's rows (S d, d'S d, the update),
//                    the other its columns (S' d, u.d), meeting at a named
//                    barrier twice a slot: the shape of fleets the card
//                    keeps resident, where two records are staged.  Past
//                    that, or with fewer staged, one sweep warp does both
//                    in turn, for fewer instructions a lane and more lanes
//                    an SM.  Each step's record is copied into shared
//                    memory by cp.async: into a double buffer a step ahead
//                    (two stages), so no device-memory load waits on the
//                    sweep; or into one buffer once the step before is done
//                    (one stage: less shared memory, more lanes an SM past
//                    the resident fleet); a bucket whose record does not
//                    fit (no stage) reads the records in the ring.
// The sweep computes every entry by the warp kernel's operations in the
// warp kernel's order (lanes_adjoint_warp.cu, its oracle, bit for bit):
// a thread owns the same rows, each sum keeps its order of terms, each
// butterfly its lanes.  What it leaves out are exact no-ops: the rank-1
// update S += dvec z_i' touches only z_i's nonzero columns (K + 1 of them:
// the series' own state and the common factors), found once per lane as
// bits, while dvec is finite (a non-finite dvec takes the full row, as the
// oracle does).  The serial chain is one segment's replay plus T swept
// steps.

#include "lanes_step.cuh"

namespace {

using lanes::kFull;
using lanes::warp_sum;

constexpr int kMaxRing = 4;              // replay warps at most
constexpr int kMaxSlots = kMaxRing + 1;  // ring slots at most
constexpr int kMaxSweep = 2;             // sweep warps at most
constexpr int kSweepBar = 1;             // the sweep warps' named barrier

// the register budget of a block of kMaxRing + kS warps: with two sweep
// warps (fleets the card keeps resident) four blocks an SM in f32 (80
// registers a thread) and two in f64 (168); with one (the fleets past
// that, for many blocks) five in f32 (80) and four in f64 (96), six in
// f64 with no staged record (64: its blocks are then held by registers,
// not shared memory)
template <typename T, int kS, int kStages>
struct Budget {
  static constexpr int kBlocks =
      kS == 2 ? (sizeof(T) == 4 ? 4 : 2)
              : (sizeof(T) == 4 ? 5 : (kStages == 0 ? 6 : 4));
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

// waits for the phase of `parity` to complete; a handoff that never comes
// (a fault in the schedule) aborts the launch once the wait has lasted
// `limit` cycles, instead of holding the card
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

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---- a step's record: [mean0 (n) | cov0 (n n) | d (N n) | f (N) | v (N) |
// 2 sb v/f (N) | -sb v^2/f^2 + db/f (N) | v/f (N) | mask (N)], padded to 16
// bytes in f64 and f32; mirrors lanes.py::record_stride
struct Record {
  int d, f, v, vb, fb, vf, mk, stride;
  __host__ __device__ Record(int N, int n) {
    d = n + n * n;
    f = d + N * n;
    v = f + N;
    vb = v + N;
    fb = vb + N;
    vf = fb + N;
    mk = vf + N;
    stride = (mk + N + 3) / 4 * 4;
  }
};

// ---- the layout: one block's work arrays, in this order (with base null,
// only the count); mirrors lanes.py::_ring_layout
template <typename T>
struct Layout {
  T* stage;                     // the staged records (0, 1 or 2)
  T *Zs, *rs, *ph, *qd;         // Z (N x n), r (N), phi, q (n)
  T *S, *u, *pb, *qb, *sd, *st;  // the sweep: S (n x n), vectors (n)
  T* ud;                        // u.d/f and (u.d) v/f^2 of the slot
  T* rp;                        // the replay warps' workspaces
  uint32_t* bits;               // Z's nonzeros, N rows of nw words
  int per;                      // values of one replay workspace
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

// a replay warp's workspace: P (n x n), m, the gain (n), the step's data
// (N) and mask bytes, in values of T
template <typename T>
__host__ __device__ inline int replay_values(int N, int n) {
  return n * n + 2 * n + N + (N + (int)sizeof(T) - 1) / (int)sizeof(T);
}

template <typename T>
__host__ __device__ size_t carve(unsigned char* base, int N, int n, int R,
                                 int stages, Layout<T>* s) {
  const int nw = (n + 31) / 32;
  Bump c;
  s->stage = c.take<T>(base, stages * (size_t)Record(N, n).stride);
  s->Zs = c.take<T>(base, (size_t)N * n);
  s->rs = c.take<T>(base, N);
  s->ph = c.take<T>(base, n);
  s->qd = c.take<T>(base, n);
  s->S = c.take<T>(base, (size_t)n * n);
  s->u = c.take<T>(base, n);
  s->pb = c.take<T>(base, n);
  s->qb = c.take<T>(base, n);
  s->sd = c.take<T>(base, n);
  s->st = c.take<T>(base, n);
  s->ud = c.take<T>(base, 2);
  s->per = replay_values<T>(N, n);
  s->rp = c.take<T>(base, (size_t)R * s->per);
  s->bits = c.take<uint32_t>(base, (size_t)N * nw);
  return (c.used + 15) / 16 * 16;
}

template <typename T>
__host__ __device__ size_t layout_bytes(int N, int n, int R, int stages) {
  Layout<T> s;
  return carve<T>(nullptr, N, n, R, stages, &s);
}

// ---- the replay warp `w`: segments w, w + R, ... (from the last) into
// their slots, each step's record written as the warp kernel writes its
// scratch, then each observed slot's quotients and the step's mask
template <typename T>
__device__ __forceinline__ void replay(
    const Layout<T> s, int w, int lane, T* ring_l, uint64_t* full,
    uint64_t* empty, const T* __restrict__ y, const uint8_t* __restrict__ mask,
    const int* __restrict__ lane_map, const T* __restrict__ bmean,
    const T* __restrict__ bcov, const T* __restrict__ sb,
    const T* __restrict__ db, int l, int L, int t_steps, int N, int n,
    int seg, int R, int D, long long patience) {
  T* P = s.rp + (size_t)w * s.per;
  T* m = P + n * n;
  T* kv = m + n;
  T* ys = kv + n;
  uint8_t* ms = reinterpret_cast<uint8_t*>(ys + N);
  const Record rc(N, n);
  const int ld = lane_map[l];
  const T* yl = y + (size_t)ld * t_steps * N;
  const uint8_t* ml = mask + (size_t)ld * t_steps * N;
  const int n_seg = (t_steps + seg - 1) / seg;
  // the stamps' declarations
  for (int i = w; i < n_seg; i += R) {
    // phase: replay-wait
    const int g = n_seg - 1 - i, slot = i % D, fill = i / D;
    if (fill > 0) mbar_wait(&empty[slot], (fill - 1) & 1, patience);
    for (int a = lane; a < n; a += 32)
      m[a] = bmean[((size_t)g * n + a) * L + l];
    for (int idx = lane; idx < n * n; idx += 32)
      P[idx] = bcov[((size_t)g * n * n + idx) * L + l];
    __syncwarp();
    T* base = ring_l + (size_t)slot * seg * rc.stride;
    // phase: replay-step
    for (int k = 0; k < seg; ++k) {
      const int t = g * seg + k;
      T* res = base + (size_t)k * rc.stride;
      const T sbt = t < t_steps ? sb[(size_t)t * L + l] : T(0);
      const T dbt = t < t_steps ? db[(size_t)t * L + l] : T(0);
      for (int a = lane; a < n; a += 32) res[a] = m[a];
      for (int idx = lane; idx < n * n; idx += 32) res[n + idx] = P[idx];
      __syncwarp();  // the copy reads rows that predict rewrites
      lanes::load_step(ys, ms, yl, ml, t, t_steps, N, lane);
      T sig, det;
      lanes::filter_step(P, m, kv, s.Zs, s.ph, s.qd, s.rs, ys, ms, N, n,
                         lane, sig, det, res);
      // the warp kernel's sweep terms of each observed slot that need no
      // adjoint, by its expressions (f, v as lane 0 wrote them above)
      for (int a = lane; a < N; a += 32) {
        res[rc.mk + a] = ms[a] ? T(1) : T(0);
        if (ms[a]) {
          const T f = res[rc.f + a];
          const T v = res[rc.v + a];
          res[rc.vb + a] = T(2) * sbt * v / f;
          res[rc.fb + a] = -sbt * v * v / (f * f) + dbt / f;
          res[rc.vf + a] = v / f;
        }
      }
    }
    // phase: replay-wait
    __threadfence();  // the records reach the L2 the sweep copies from
    mbar_arrive(&full[slot]);
  }
  // the stamps' flush
}

// ---- a row walk's sums, each term in the warp kernel's order: kB entries
// loaded before they are used, full batches without a predicate (their
// loads at immediate offsets on a unit stride), then one guarded batch
constexpr int kB = 8;

// sum_b x[b sx] d[b]: the warp kernel's `acc += x * d`
template <typename T>
__device__ __forceinline__ T walk_dot(const T* __restrict__ x, int sx,
                                      const T* __restrict__ d, int n) {
  T acc = 0;
  int b = 0;
#pragma unroll 1
  for (; b + kB <= n; b += kB) {
    T xs[kB], ds[kB];
#pragma unroll
    for (int e = 0; e < kB; ++e) {
      xs[e] = x[(b + e) * sx];
      ds[e] = d[b + e];
    }
#pragma unroll
    for (int e = 0; e < kB; ++e) acc += xs[e] * ds[e];
  }
  if (b < n) {
    T xs[kB], ds[kB];
#pragma unroll
    for (int e = 0; e < kB; ++e) {
      const bool in = b + e < n;
      xs[e] = in ? x[(b + e) * sx] : T(0);
      ds[e] = in ? d[b + e] : T(0);
    }
#pragma unroll
    for (int e = 0; e < kB; ++e)
      if (b + e < n) acc += xs[e] * ds[e];
  }
  return acc;
}

// sum_b x[b sx] p[b sx] h[b]: the warp kernel's `acc += x * p * h`
template <typename T>
__device__ __forceinline__ T walk_dot3(const T* __restrict__ x,
                                       const T* __restrict__ p, int sx,
                                       const T* __restrict__ h, int n) {
  T acc = 0;
  int b = 0;
#pragma unroll 1
  for (; b + kB <= n; b += kB) {
    T xs[kB], ps[kB], hs[kB];
#pragma unroll
    for (int e = 0; e < kB; ++e) {
      xs[e] = x[(b + e) * sx];
      ps[e] = p[(b + e) * sx];
      hs[e] = h[b + e];
    }
#pragma unroll
    for (int e = 0; e < kB; ++e) acc += xs[e] * ps[e] * hs[e];
  }
  if (b < n) {
    T xs[kB], ps[kB], hs[kB];
#pragma unroll
    for (int e = 0; e < kB; ++e) {
      const bool in = b + e < n;
      xs[e] = in ? x[(b + e) * sx] : T(0);
      ps[e] = in ? p[(b + e) * sx] : T(0);
      hs[e] = in ? h[b + e] : T(0);
    }
#pragma unroll
    for (int e = 0; e < kB; ++e)
      if (b + e < n) acc += xs[e] * ps[e] * hs[e];
  }
  return acc;
}

// x[b] = x[b] * pa * h[b] for b in [lo, hi): the warp kernel's rescale
template <typename T>
__device__ __forceinline__ void walk_scale(T* __restrict__ x, T pa,
                                           const T* __restrict__ h, int lo,
                                           int hi) {
  int b = lo;
#pragma unroll 1
  for (; b + kB <= hi; b += kB) {
    T xs[kB], hs[kB];
#pragma unroll
    for (int e = 0; e < kB; ++e) {
      xs[e] = x[b + e];
      hs[e] = h[b + e];
    }
#pragma unroll
    for (int e = 0; e < kB; ++e) x[b + e] = xs[e] * pa * hs[e];
  }
#pragma unroll 1
  for (; b < hi; ++b) x[b] = x[b] * pa * h[b];
}

// ---- the sweep, kS warps: every step of every segment, last first; each
// step the series adjoints in reverse slot order, then the predict
// adjoint, by the warp kernel's arithmetic.  With two warps `role` 0 walks
// S's rows (S d, d'S d, the update) and 1 its columns (S' d, u.d), meeting
// at a named barrier; one warp does both parts in turn.
template <typename T, int kStages, int kS>
__device__ __forceinline__ void sweep(const Layout<T> s, int role, int lane,
                                      const T* ring_l, uint64_t* full,
                                      uint64_t* empty, int t_steps, int N,
                                      int n, int seg, int D,
                                      long long patience) {
  const Record rc(N, n);
  const int nw = (n + 31) / 32;
  const int n_seg = (t_steps + seg - 1) / seg;
  const int chunks = rc.stride * (int)sizeof(T) / 16;
  const int ts = role * 32 + lane;  // thread of the sweep
  T* __restrict__ S = s.S;
  const T* __restrict__ ph = s.ph;
  auto bar = [] {
    if constexpr (kS == 1) {
      __syncwarp();
    } else {
      named_sync(kSweepBar, 32 * kS);
    }
  };
  // the stamps' declarations
  // S' d into st, u.d/f and (u.d) v/f^2 into s.ud (slot i)
  auto cols = [&](const T* __restrict__ rec, int i, T f,
                  const T* __restrict__ dv) {
    const T v = rec[rc.v + i];
    T ud_p = 0;
#pragma unroll 1
    for (int a = lane; a < n; a += 32) {
      s.st[a] = walk_dot(S + a, n, dv, n);  // (S' d)_a
      ud_p += s.u[a] * dv[a];
    }
    const T ud = warp_sum(ud_p);
    if (lane == 0) {
      s.ud[0] = ud / f;
      s.ud[1] = ud * v / (f * f);
    }
  };
  // S d into sd; returns d'S d / f^2
  auto rows = [&](T f, const T* __restrict__ dv) {
    T dsd_p = 0;
#pragma unroll 1
    for (int a = lane; a < n; a += 32) {
      const T sd = walk_dot(S + a * n, 1, dv, n);  // (S d)_a
      s.sd[a] = sd;
      dsd_p += dv[a] * sd;
    }
    // phase: sums
    const T dsd = warp_sum(dsd_p);
    return dsd / (f * f);
  };
  // the series adjoint's update of S and u (slot i)
  auto update = [&](const T* __restrict__ rec, int i, T f, T dsdf) {
    const T* zi = s.Zs + i * n;
    const T vbar = rec[rc.vb + i] + s.ud[0];
    const T fbar = rec[rc.fb + i] + dsdf - s.ud[1];
    // phase: update
    const T vf = rec[rc.vf + i];
    const uint32_t* zb = s.bits + i * nw;
#pragma unroll 1
    for (int a = lane; a < n; a += 32) {
      const T dvec =
          -(s.sd[a] + s.st[a]) / f + s.u[a] * vf + fbar * zi[a];
      T* __restrict__ Sa = S + a * n;
      if (isfinite(dvec)) {  // where z_i is 0 the update adds 0
#pragma unroll 1
        for (int w = 0; w < nw; ++w) {
          uint32_t bits = zb[w];
          while (bits != 0u) {  // two columns at a time
            const int b0 = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1u;
            if (bits != 0u) {
              const int b1 = w * 32 + __ffs(bits) - 1;
              bits &= bits - 1u;
              const T s0 = Sa[b0], s1 = Sa[b1], z0 = zi[b0], z1 = zi[b1];
              Sa[b0] = s0 + dvec * z0;
              Sa[b1] = s1 + dvec * z1;
            } else {
              Sa[b0] = Sa[b0] + dvec * zi[b0];
            }
          }
        }
      } else {  // dvec * 0 is not 0: the full row, as the warp kernel
#pragma unroll 1
        for (int b = 0; b < n; ++b) Sa[b] = Sa[b] + dvec * zi[b];
      }
      s.u[a] = s.u[a] - vbar * zi[a];
    }
  };
  auto step = [&](const T* __restrict__ rec) {
    // the observed slots from the last, a warp ballot of 32 at a time
#pragma unroll 1
    for (int c = (N - 1) / 32; c >= 0; --c) {
      uint32_t obs = __ballot_sync(
          kFull, c * 32 + lane < N && rec[rc.mk + c * 32 + lane] != T(0));
      while (obs != 0u) {
        // phase: sd
        const int j = 31 - __clz(obs);
        obs &= ~(1u << j);
        const int i = c * 32 + j;
        const T f = rec[rc.f + i];
        const T* __restrict__ dv = rec + rc.d + i * n;
        if constexpr (kS == 1) {
          cols(rec, i, f, dv);
          const T dsdf = rows(f, dv);
          bar();  // s.ud in
          update(rec, i, f, dsdf);
        } else if (role == 0) {
          const T dsdf = rows(f, dv);
          bar();  // S' d and u.d are in; every column of S read
          update(rec, i, f, dsdf);
        } else {
          cols(rec, i, f, dv);
          bar();
        }
        bar();  // S and u updated
      }
    }
    // phase: predict
    // (u, S) are the adjoints of the predicted moments; (mean0, cov0) the
    // pre-predict carry in the record; S o cov0 summed along rows (the row
    // warp) and columns (the column warp)
    const T* __restrict__ m0 = rec;
    const T* __restrict__ P0 = rec + n;
#pragma unroll 1
    for (int a = lane; a < n; a += 32) {
      if (kS == 1 || role == 0) {
        s.sd[a] = walk_dot3(S + a * n, P0 + a * n, 1, ph, n);  // s1
        s.qb[a] = s.qb[a] + S[a * n + a];
      }
      if (kS == 1 || role == 1)
        s.st[a] = walk_dot3(S + a, P0 + a, n, ph, n);  // s2
    }
    bar();  // both sums in; every entry of S read
    if (role == 0) {
#pragma unroll 1
      for (int a = lane; a < n; a += 32) {
        const T s1 = s.sd[a], s2 = s.st[a];
        s.pb[a] = s.pb[a] + (s.u[a] * m0[a] + s1 + s2);
        s.u[a] = s.u[a] * ph[a];
      }
    }
    // the rescale, its columns split over the warps
    const int b_lo = role * n / kS, b_hi = (role + 1) * n / kS;
#pragma unroll 1
    for (int a = lane; a < n; a += 32)
      walk_scale(S + a * n, ph[a], ph, b_lo, b_hi);
    bar();
    // phase: rest
  };
  // segment i (from the last) lives in slot i % D, its fill i / D
  auto record = [&](int i, int k) -> const T* {
    return ring_l + ((size_t)(i % D) * seg + k) * rc.stride;
  };
  auto wait_full = [&](int i) {
    mbar_wait(&full[i % D], (i / D) & 1, patience);
  };
  auto release = [&](int i) { mbar_arrive(&empty[i % D]); };
  if constexpr (kStages > 0) {
    // record t staged in buffer t & 1 (two stages) or in the one buffer:
    // copied while step t + 1 runs (two), or once it is done (one)
    auto buffer = [&](int t) {
      return s.stage + (t & (kStages - 1)) * rc.stride;
    };
    auto copy = [&](const T* src, int t) {
      const char* from = reinterpret_cast<const char*>(src);
      char* to = reinterpret_cast<char*>(buffer(t));
      for (int c = ts; c < chunks; c += 32 * kS)
        cp_async16(to + 16 * c, from + 16 * c);
    };
    int t = n_seg * seg - 1;
    if (n_seg > 0) {
      wait_full(0);
      copy(record(0, seg - 1), t);
      cp_async_wait_all();
      bar();
      if (seg == 1) release(0);
    }
    for (int i = 0; i < n_seg; ++i) {
      for (int k = seg - 1; k >= 0; --k, --t) {
        // the next record is copied while this step runs (two stages) or
        // once it is done (one), unless it opens a segment whose replay
        // may still be running
        const bool opens = k == 0 && i + 1 < n_seg;
        // phase: wait
        if (kStages == 2 && k > 0) copy(record(i, k - 1), t - 1);
        // phase: rest
        step(buffer(t));
        // phase: wait
        if (kStages == 1 && k > 0) copy(record(i, k - 1), t - 1);
        if (opens) {
          wait_full(i + 1);
          copy(record(i + 1, seg - 1), t - 1);
        }
        cp_async_wait_all();
        bar();
        // a segment's first step is the last record copied from its slot
        if (k == 1) release(i);
        if (opens && seg == 1) release(i + 1);
        // phase: rest
      }
    }
  } else {
    for (int i = 0; i < n_seg; ++i) {
      // phase: wait
      wait_full(i);
      // phase: rest
      for (int k = seg - 1; k >= 0; --k) step(record(i, k));
      release(i);
    }
  }
  // the stamps' flush
}

template <typename T, int kStages, int kS>
__global__ void __launch_bounds__(32 * (kMaxRing + kS),
                                  Budget<T, kS, kStages>::kBlocks)
lanes_adjoint_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                     const T* __restrict__ z, const T* __restrict__ r,
                     const T* __restrict__ y, const uint8_t* __restrict__ mask,
                     const int* __restrict__ lane_map,
                     const T* __restrict__ bmean, const T* __restrict__ bcov,
                     const T* __restrict__ sb, const T* __restrict__ db,
                     T* ring, T* __restrict__ phibar, T* __restrict__ qbar,
                     int L, int t_steps, int N, int n, int seg, int R, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxSlots], empty[kMaxSlots];
  const int l = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = (n + 31) / 32;
  const Record rc(N, n);
  Layout<T> s;
  carve<T>(smem_raw, N, n, R, kStages, &s);
  // the cycles a handoff may take before it counts as lost: a wait spans
  // at most the replay and sweep of D + 1 segments, and each of their
  // steps is allowed 2^24 cycles (~8 ms), on top of 2^35 (~17 s)
  const long long patience =
      (1ll << 35) + (long long)(D + 2) * seg * (1ll << 24);

  for (int a = tid; a < n; a += blockDim.x) {
    s.ph[a] = phi[(size_t)a * L + l];
    s.qd[a] = q[(size_t)a * L + l];
    s.u[a] = T(0);
    s.pb[a] = T(0);
    s.qb[a] = T(0);
  }
  for (int idx = tid; idx < N * n; idx += blockDim.x)
    s.Zs[idx] = z[(size_t)idx * L + l];
  for (int i = tid; i < N; i += blockDim.x) s.rs[i] = r[(size_t)i * L + l];
  for (int idx = tid; idx < n * n; idx += blockDim.x) s.S[idx] = T(0);
  for (int x = tid; x < N * nw; x += blockDim.x) {  // Z's nonzeros
    const int i = x / nw, w = x % nw;
    uint32_t bits = 0;
    for (int j = 0; j < 32 && w * 32 + j < n; ++j)
      if (z[((size_t)i * n + w * 32 + j) * L + l] != T(0)) bits |= 1u << j;
    s.bits[x] = bits;
  }
  if (tid == 0) {
    for (int k = 0; k < D; ++k) {
      mbar_init(&full[k], 32);
      mbar_init(&empty[k], 32 * kS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the block's only one: the roles split here

  T* ring_l = ring + (size_t)l * D * seg * rc.stride;
  if (warp < R) {
    replay<T>(s, warp, lane, ring_l, full, empty, y, mask, lane_map, bmean,
              bcov, sb, db, l, L, t_steps, N, n, seg, R, D, patience);
  } else {
    sweep<T, kStages, kS>(s, warp - R, lane, ring_l, full, empty, t_steps,
                          N, n, seg, D, patience);
    if (warp == R) {
      for (int a = lane; a < n; a += 32) {
        phibar[(size_t)a * L + l] = s.pb[a];
        qbar[(size_t)a * L + l] = s.qb[a];
      }
    }
  }
}

template <typename T, int kStages, int kS>
int launch_kernel(const void* phi, const void* q, const void* z,
                  const void* r, const void* y, const void* mask,
                  const void* lane_map, const void* bmean, const void* bcov,
                  const void* sb, const void* db, void* ring, void* phibar,
                  void* qbar, int L, int t_steps, int N, int n, int seg,
                  int R, int D, cudaStream_t stream) {
  const size_t smem = layout_bytes<T>(N, n, R, kStages);
  int err =
      lanes::prepare_launch(lanes_adjoint_kernel<T, kStages, kS>, smem);
  if (err != 0) return err;
  lanes_adjoint_kernel<T, kStages, kS><<<L, 32 * (R + kS), smem, stream>>>(
      (const T*)phi, (const T*)q, (const T*)z, (const T*)r, (const T*)y,
      (const uint8_t*)mask, (const int*)lane_map, (const T*)bmean,
      (const T*)bcov, (const T*)sb, (const T*)db, (T*)ring, (T*)phibar,
      (T*)qbar, L, t_steps, N, n, seg, R, D);
  return (int)cudaGetLastError();
}

// the instantiation of (stages, sweep warps): two sweep warps only with
// two stages
template <typename Fn>
Fn pick(int stages, int S, Fn f01, Fn f11, Fn f21, Fn f22) {
  if (stages == 2) return S == 2 ? f22 : f21;
  return stages == 1 ? f11 : f01;
}

template <typename T>
int launch_lanes_adjoint(const void* phi, const void* q, const void* z,
                         const void* r, const void* y, const void* mask,
                         const void* lane_map, const void* bmean,
                         const void* bcov, const void* sb, const void* db,
                         void* ring, void* phibar, void* qbar, int L,
                         int t_steps, int N, int n, int seg, int R, int D,
                         int S, int stages, void* stream) {
  if (L == 0) return 0;
  // D = R (a slot a replay warp) or R + 1 (one spare): a slot's fills then
  // come one phase apart, as its mbarriers' parity waits need
  if (seg < 1 || R < 1 || R > kMaxRing || D < R || D > R + 1 || S < 1 ||
      S > kMaxSweep || stages < 0 || stages > 2 || (S == 2 && stages != 2))
    return (int)cudaErrorInvalidValue;
  auto fn = pick(stages, S, launch_kernel<T, 0, 1>, launch_kernel<T, 1, 1>,
                 launch_kernel<T, 2, 1>, launch_kernel<T, 2, 2>);
  return fn(phi, q, z, r, y, mask, lane_map, bmean, bcov, sb, db, ring,
            phibar, qbar, L, t_steps, N, n, seg, R, D, (cudaStream_t)stream);
}

template <typename T, int kStages, int kS>
int occupancy_of(int N, int n, int R, int* blocks) {
  const size_t smem = layout_bytes<T>(N, n, R, kStages);
  int err =
      lanes::prepare_launch(lanes_adjoint_kernel<T, kStages, kS>, smem);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, lanes_adjoint_kernel<T, kStages, kS>, 32 * (R + kS), smem);
}

template <typename T>
int occupancy(int N, int n, int R, int S, int stages, int* blocks) {
  if (R < 1 || R > kMaxRing || S < 1 || S > kMaxSweep || stages < 0 ||
      stages > 2 || (S == 2 && stages != 2))
    return (int)cudaErrorInvalidValue;
  auto fn = pick(stages, S, occupancy_of<T, 0, 1>, occupancy_of<T, 1, 1>,
                 occupancy_of<T, 2, 1>, occupancy_of<T, 2, 2>);
  return fn(N, n, R, blocks);
}

}  // namespace

extern "C" {

// phi, q (n, L); z (N, n, L); r (N, L); y, mask (D_data, T, N); lane_map
// (L); bounds_mean (n_seg, n, L); bounds_cov (n_seg, n, n, L); sb, db (T,
// L); ring (L, D, seg, record stride); phibar, qbar (n, L); R the replay
// warps (1..4), D the ring's slots (R or R + 1), S the sweep warps (1..2;
// 2 with two stages only), stages the records staged in shared memory (2:
// a step ahead, 1: once the step before is done, 0: read in the ring)
int metran_lanes_adjoint_f32(const void* phi, const void* q, const void* z,
                             const void* r, const void* y, const void* mask,
                             const void* lane_map, const void* bmean,
                             const void* bcov, const void* sb, const void* db,
                             void* ring, void* phibar, void* qbar, int L,
                             int t_steps, int N, int n, int seg, int R, int D,
                             int S, int stages, void* stream) {
  return launch_lanes_adjoint<float>(phi, q, z, r, y, mask, lane_map, bmean,
                                     bcov, sb, db, ring, phibar, qbar, L,
                                     t_steps, N, n, seg, R, D, S, stages,
                                     stream);
}

int metran_lanes_adjoint_f64(const void* phi, const void* q, const void* z,
                             const void* r, const void* y, const void* mask,
                             const void* lane_map, const void* bmean,
                             const void* bcov, const void* sb, const void* db,
                             void* ring, void* phibar, void* qbar, int L,
                             int t_steps, int N, int n, int seg, int R, int D,
                             int S, int stages, void* stream) {
  return launch_lanes_adjoint<double>(phi, q, z, r, y, mask, lane_map, bmean,
                                      bcov, sb, db, ring, phibar, qbar, L,
                                      t_steps, N, n, seg, R, D, S, stages,
                                      stream);
}

// blocks of K4 resident per SM at (N, n) with R replay warps, S sweep
// warps and `stages` staged records
int metran_lanes_adjoint_occupancy_f32(int N, int n, int R, int S,
                                       int stages, void* blocks) {
  return occupancy<float>(N, n, R, S, stages, (int*)blocks);
}

int metran_lanes_adjoint_occupancy_f64(int N, int n, int R, int S,
                                       int stages, void* blocks) {
  return occupancy<double>(N, n, R, S, stages, (int*)blocks);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
