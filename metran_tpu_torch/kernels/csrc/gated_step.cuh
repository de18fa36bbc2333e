// The gated sequential-processing filter body of one block, shared by K12
// (gated_filter.cu) and the gated/sequential/robust arena update K16
// (arena_gated.cu).
//
// filter_block runs the k appended steps of one model (gated_filter.cu
// documents the step, the policies and the robust modes) from the carry
// in state row `srow` of phi, q, z, r, mean0 and cov0, reading the step
// data, the robust per-slot parameters and writing every per-step and
// per-slot output at dispatch index `b`; K12 passes srow == b, the arena
// the resident row its block gathers.  It leaves the final (m, P) in
// shared memory (layout below) for the caller to write out.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "implicit_map.cuh"

namespace gatedk {

constexpr int kThreads = 128;
// the gate's policies, then the robust likelihoods (kRobust + the
// likelihood's code in implicit_map.cuh)
enum Policy { kOff = 0, kReject = 1, kHuber = 2, kInflate = 3, kRobust = 4 };

// the robust modes' extra inputs and outputs (unused by the gate)
template <typename T>
struct RobustArgs {
  const T *rail_lo, *rail_hi, *quantum, *scale;  // (B, N)
  double nu, tol, nonconv_tol, c_floor;
  int* iters_out;  // (B, k, N)
};

template <typename T>
struct Smem {
  T *P, *Zs, *m, *ph, *d, *kg;
};

// the layout of one block's dynamic shared memory
template <typename T>
__device__ inline Smem<T> carve(unsigned char* raw, int N, int S) {
  Smem<T> s;
  s.P = reinterpret_cast<T*>(raw);  // S*S covariance
  s.Zs = s.P + S * S;                // N*S observation matrix
  s.m = s.Zs + N * S;                // S mean
  s.ph = s.m + S;                    // S transition diagonal
  s.d = s.ph + S;                    // S: P z_i
  s.kg = s.d + S;                    // S: the gain d / f
  return s;
}

template <typename T>
__host__ __device__ inline size_t smem_elems(int N, int S) {
  return (size_t)S * S + (size_t)N * S + 4 * (size_t)S;
}

// armed_b: the model's armed flag (the gate's, or the robust mode's)
template <typename T, int kPolicy>
__device__ void filter_block(unsigned char* smem_raw,
                             const T* __restrict__ phi,
                             const T* __restrict__ q,
                             const T* __restrict__ z,
                             const T* __restrict__ r,
                             const T* __restrict__ mean0,
                             const T* __restrict__ cov0,
                             const T* __restrict__ y,
                             const uint8_t* __restrict__ mask, bool armed_b,
                             double thresh_d, T* __restrict__ sigma_out,
                             T* __restrict__ detf_out,
                             T* __restrict__ z_out,
                             int8_t* __restrict__ verdict_out,
                             RobustArgs<T> rob, int b, int srow, int k, int N,
                             int S) {
  constexpr bool kRob = kPolicy >= kRobust;
  constexpr int kLik = kRob ? kPolicy - kRobust : 0;
  const Smem<T> sm = carve<T>(smem_raw, N, S);
  T* P = sm.P;
  T* Zs = sm.Zs;
  T* m = sm.m;
  T* ph = sm.ph;
  T* d = sm.d;
  T* kg = sm.kg;
  __shared__ T s_v, s_f, s_sigma, s_detf;
  __shared__ int s_use, s_map;

  const int tid = threadIdx.x;
  const T* qb = q + (size_t)srow * S * S;
  const T* rb = r + (size_t)srow * N;
  const T thresh = T(thresh_d);
  const bool arm = kPolicy != kOff && !kRob && armed_b;  // the gate
  const T nan = T(NAN);

  for (int i = tid; i < S * S; i += kThreads)
    P[i] = cov0[(size_t)srow * S * S + i];
  for (int i = tid; i < N * S; i += kThreads)
    Zs[i] = z[(size_t)srow * N * S + i];
  for (int i = tid; i < S; i += kThreads) {
    m[i] = mean0[(size_t)srow * S + i];
    ph[i] = phi[(size_t)srow * S + i];
  }
  __syncthreads();

  for (int t = 0; t < k; ++t) {
    const size_t row = (size_t)b * k + t;
    const T* yt = y + row * N;
    const uint8_t* mt = mask + row * N;
    // predict (each thread owns its entries)
    for (int i = tid; i < S; i += kThreads) m[i] = ph[i] * m[i];
    for (int idx = tid; idx < S * S; idx += kThreads) {
      const int i = idx / S, j = idx - (idx / S) * S;
      P[idx] = ph[i] * P[idx] * ph[j] + qb[idx];
    }
    if (tid == 0) {
      s_sigma = T(0);
      s_detf = T(0);
    }
    __syncthreads();
    for (int a = 0; a < N; ++a) {
      const size_t zo = row * N + a;
      if (mt[a] == 0) {  // block-uniform: the slot is unobserved
        if (tid == 0) {
          z_out[zo] = nan;
          verdict_out[zo] = 0;
          if (kRob) rob.iters_out[zo] = 0;
        }
        continue;
      }
      const T* za = Zs + a * S;
      for (int i = tid; i < S; i += kThreads) {
        T acc = 0;
        for (int j = 0; j < S; ++j) acc += P[i * S + j] * za[j];
        d[i] = acc;
      }
      __syncthreads();
      if (tid == 0) {
        T zm = 0, zd = 0;
        for (int j = 0; j < S; ++j) zm += za[j] * m[j];
        for (int j = 0; j < S; ++j) zd += za[j] * d[j];
        const T v = yt[a] - zm;
        const T f = zd + rb[a];
        const T zs = v / sqrt(f);
        const T score = zs * zs;
        const bool hit = arm && score > thresh;
        T vv = v, fe = f;
        bool use = true;
        if (kPolicy == kReject) use = !hit;
        if (kPolicy == kHuber) vv = (hit ? sqrt(thresh / score) : T(1)) * v;
        if (kPolicy == kInflate) fe = hit ? v * v / thresh : f;
        // robust: an armed slot that flags is conditioned on its scalar
        // MAP summary; the rank-1 update below then reads d for the gain
        // and (s_hat - mu) / c, w / (1 + c w) for v and f
        const size_t pa = (size_t)b * N + a;
        const bool map = kRob && armed_b &&
                         imap::flags<T, kLik>(yt[a], rob.rail_lo[pa],
                                              rob.rail_hi[pa]);
        if (map) {
          const T mu = yt[a] - v;  // z_i' m, as the JAX update forms it
          const T cf = T(rob.c_floor);
          const T c = zd < cf ? cf : zd;  // NaN passes, as jnp.maximum
          const imap::Solve<T> sol = imap::map_solve<T, kLik>(
              mu, c, yt[a], imap::slot_scale(rb[a], rob.scale[pa]),
              rob.quantum[pa], rob.rail_lo[pa], rob.rail_hi[pa], rob.nu,
              T(rob.tol), T(rob.nonconv_tol));
          const T dev = imap::sub(sol.s_hat, mu);
          vv = dev / c;
          fe = sol.w / imap::add(T(1), imap::mul(c, sol.w));
          s_sigma = imap::add(s_sigma, imap::add(imap::mul(dev, dev) / c,
                                                 imap::mul(T(2), sol.f)));
          s_detf = imap::add(s_detf, imap::m_log1p(imap::mul(c, sol.w)));
          verdict_out[zo] = sol.nonconv ? imap::kNonconv : imap::kMap;
          rob.iters_out[zo] = sol.iters;
        } else {
          if (use) {
            s_sigma = s_sigma + vv * vv / fe;
            s_detf = s_detf + log(fe);
          }
          verdict_out[zo] = hit ? (kPolicy == kReject ? 2 : 1) : 0;
          if (kRob) rob.iters_out[zo] = 0;
        }
        s_v = vv;
        s_f = fe;
        s_use = use ? 1 : 0;
        s_map = map ? 1 : 0;
        z_out[zo] = kPolicy == kOff ? nan : zs;
      }
      __syncthreads();
      if (s_use) {  // block-uniform
        for (int i = tid; i < S; i += kThreads)
          kg[i] = (kRob && s_map) ? d[i] : d[i] / s_f;
        __syncthreads();
        for (int i = tid; i < S; i += kThreads) m[i] = m[i] + kg[i] * s_v;
        for (int idx = tid; idx < S * S; idx += kThreads) {
          const int i = idx / S, j = idx - (idx / S) * S;
          P[idx] = P[idx] - kg[i] * kg[j] * s_f;
        }
      }
      __syncthreads();
    }
    if (tid == 0) {
      sigma_out[row] = s_sigma;
      detf_out[row] = s_detf;
    }
    __syncthreads();
  }
}

}  // namespace gatedk
