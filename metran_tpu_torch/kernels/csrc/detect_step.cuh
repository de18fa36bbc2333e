// The streaming detector's per-slot recursion, shared by K13 (detect.cu)
// and the detection tails of the arena updates K16 and K17.
//
// scan_slot advances one slot's state [C+, C-, z_prev, S_zz, S_z2,
// n_eff] over k steps of z-scores (detect.cu documents the recursion)
// and books its counts [anomalies, CUSUM alarms, LB alarms]; the caller
// loads and stores the state, so a rejected arena row can keep its own.
// arena_row is the arena updates' detection tail built on it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace detectk {

__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline float add(float a, float b) { return __fadd_rn(a, b); }
__device__ inline float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ inline double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ inline double add(double a, double b) { return __dadd_rn(a, b); }
__device__ inline double div(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__device__ inline T lb_q(T szz, T sz2, T nef, T tiny) {
  const T rho = div(szz, sz2 > tiny ? sz2 : tiny);
  return mul(mul(nef, rho), rho);
}

// the recursion's constants, as the wrapper forms them
struct Params {
  double ck, ch, lam, warm, qbar, abar, tiny;
};

// st: the slot's six state entries (in and out); zs, mask: its k
// z-scores and mask bytes, `stride` apart; cnt: its three counts (out)
template <typename T>
__device__ void scan_slot(T st[6], int cnt[3], const T* __restrict__ zs,
                          const uint8_t* __restrict__ mask, size_t stride,
                          int k, bool arm, const Params& p) {
  const T ck = T(p.ck), ch = T(p.ch), lam = T(p.lam), warm = T(p.warm);
  const T qbar = T(p.qbar), abar = T(p.abar), tiny = T(p.tiny);
  const T zero = T(0), one = T(1);
  T cpos = st[0], cneg = st[1], prev = st[2], szz = st[3];
  T sz2 = st[4], nef = st[5];
  int n_an = 0, n_cp = 0, n_lb = 0;
  for (int t = 0; t < k; ++t) {
    const size_t at = (size_t)t * stride;
    const T z_raw = zs[at];
    const bool obs = mask[at] != 0 && arm && isfinite(z_raw);
    if (!obs) continue;  // every row carried unchanged
    const T z = z_raw;
    if (mul(z, z) > abar) ++n_an;
    T cp = add(add(cpos, z), -ck);
    T cn = add(add(cneg, -z), -ck);
    cp = cp < zero ? zero : cp;  // max(., 0), NaN kept as jnp.maximum
    cn = cn < zero ? zero : cn;
    if (cp > ch || cn > ch) {
      ++n_cp;
      cp = zero;
      cn = zero;
    }
    cpos = cp;
    cneg = cn;
    const bool was = nef >= warm && lb_q(szz, sz2, nef, tiny) > qbar;
    szz = add(mul(lam, szz), mul(z, prev));
    sz2 = add(mul(lam, sz2), mul(z, z));
    nef = add(mul(lam, nef), one);
    prev = z;
    const bool now = nef >= warm && lb_q(szz, sz2, nef, tiny) > qbar;
    if (now && !was) ++n_lb;
  }
  st[0] = cpos;
  st[1] = cneg;
  st[2] = prev;
  st[3] = szz;
  st[4] = sz2;
  st[5] = nef;
  cnt[0] = n_an;
  cnt[1] = n_cp;
  cnt[2] = n_lb;
}

// The arena updates' detection tail (K16's commit, K17): the resident
// detector state of arena row `row` (det: (B, 6, N)) runs over the
// z-scores and mask of dispatch position b ((G, k, N)), armed by `arm`;
// it is written back only when `keep` (the row was assimilated), else it
// stays bit for bit and the row books zero counts.  The stats [C+, C-,
// LB Q] of the state the row now holds go to det_stats (G, 3, N), the
// counts to det_counts (G, 3, N).  Thread tid of nt takes slots tid,
// tid + nt, ...
template <typename T>
__device__ void arena_row(T* det, int row, int b, const T* zscore,
                          const uint8_t* mask, int32_t* det_counts,
                          T* det_stats, int k, int N, bool arm, bool keep,
                          const Params& p, int tid, int nt) {
  const T tiny = T(p.tiny);
  for (int i = tid; i < N; i += nt) {
    T* dr = det + (size_t)row * 6 * N + i;
    T st[6];
    for (int j = 0; j < 6; ++j) st[j] = dr[(size_t)j * N];
    T was[6];
    for (int j = 0; j < 6; ++j) was[j] = st[j];
    int cnt[3];
    const size_t at = (size_t)b * k * N + i;
    scan_slot<T>(st, cnt, zscore + at, mask + at, (size_t)N, k, arm, p);
    if (keep) {
      for (int j = 0; j < 6; ++j) dr[(size_t)j * N] = st[j];
    } else {  // never assimilated: never detected on either
      for (int j = 0; j < 6; ++j) st[j] = was[j];
      cnt[0] = cnt[1] = cnt[2] = 0;
    }
    int32_t* co = det_counts + (size_t)b * 3 * N + i;
    T* so = det_stats + (size_t)b * 3 * N + i;
    for (int j = 0; j < 3; ++j) co[(size_t)j * N] = cnt[j];
    so[0] = st[0];
    so[N] = st[1];
    so[2 * N] = lb_q(st[3], st[4], st[5], tiny);
  }
}

}  // namespace detectk
