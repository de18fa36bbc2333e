// The square-root (QR array) filter body of one block, shared by K9
// (sqrt_filter.cu) and the square-root arena update K16 (arena_sqrt.cu).
//
// run_steps runs the time loop of one lane (sqrt_filter.cu documents the
// step, the gate and the robust modes) from the carry the caller loaded
// into the block's shared memory (s.m, s.S, with the lane's constants in
// s.zs, s.rr, s.ph, s.qs), reading the lane's (t_steps, N) data at yl/ml
// and writing every per-step and per-slot output, and reading the robust
// per-slot parameters, at lane index `l`.  It leaves the final (m, S) in
// s.m and s.S for the caller to write out.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "implicit_map.cuh"
#include "sqrt_qr.cuh"

namespace sqrtk {

constexpr int kThreads = 64;
// the gate's policies, then the robust likelihoods (kRobust + the
// likelihood's code in implicit_map.cuh)
enum Gate { kNoGate = 0, kReject = 1, kHuber = 2, kInflate = 3, kRobust = 4 };

// the robust modes' extra inputs and outputs (unused otherwise)
template <typename T>
struct RobustArgs {
  const T *rail_lo, *rail_hi, *quantum, *scale;  // (L, N)
  double nu, tol, nonconv_tol, c_floor, eps;
  int* iters;  // (L, T, N)
};

template <typename T>
struct Smem {
  T *zs, *rr, *ph, *qs, *m, *S, *mp, *Sp, *pa, *ua, *dg, *vv, *ww, *wsc,
      *reff;
  int *obs, *hit;
};

// the layout of one block's dynamic shared memory (with s null, only
// its size): returns the bytes it takes
template <typename T>
__host__ __device__ size_t carve(unsigned char* base, int N, int n,
                                 Smem<T>* s) {
  const int ldp = sqrtqr::odd_ld(2 * n);
  const int ldu = sqrtqr::odd_ld(N + n);
  const size_t counts[15] = {
      (size_t)N * n, (size_t)N, (size_t)n, (size_t)n, (size_t)n,
      (size_t)n * n, (size_t)n, (size_t)n * n, (size_t)ldp * n,
      (size_t)ldu * (N + n), (size_t)(N + n), (size_t)N, (size_t)N,
      (size_t)N, (size_t)N};
  size_t offs[15];
  size_t used = 0;
  for (int k = 0; k < 15; ++k) {
    offs[k] = used;
    used += counts[k];
  }
  if (s != nullptr) {
    T* p = reinterpret_cast<T*>(base);
    T** slots[15] = {&s->zs, &s->rr, &s->ph, &s->qs, &s->m,  &s->S,
                     &s->mp, &s->Sp, &s->pa, &s->ua, &s->dg, &s->vv,
                     &s->ww, &s->wsc, &s->reff};
    for (int k = 0; k < 15; ++k) *slots[k] = p + offs[k];
    s->obs = reinterpret_cast<int*>(p + used);
    s->hit = s->obs + N;
  }
  return used * sizeof(T) + 2 * (size_t)N * sizeof(int);
}

// arm: the lane's armed flag (the gate's or the robust mode's; never
// read without one)
template <typename T, bool kStore, bool kBounds, int kGate>
__device__ void run_steps(Smem<T>& s, const T* __restrict__ yl,
                          const uint8_t* __restrict__ ml, bool arm,
                          double thresh_d, T* __restrict__ o_mean_p,
                          T* __restrict__ o_chol_p, T* __restrict__ o_mean_f,
                          T* __restrict__ o_chol_f, T* __restrict__ o_sigma,
                          T* __restrict__ o_detf,
                          T* __restrict__ o_bounds_mean,
                          T* __restrict__ o_bounds_chol,
                          T* __restrict__ o_z,
                          int8_t* __restrict__ o_verdict, RobustArgs<T> rob,
                          int l, int t_steps, int N, int n, int seg) {
  constexpr bool kRob = kGate >= kRobust;
  constexpr int kLik = kRob ? kGate - kRobust : 0;
  __shared__ int mo, bad;
  __shared__ T step_sigma, step_detf;
  const int tid = threadIdx.x;
  const int nn = n * n;
  const int ldp = sqrtqr::odd_ld(2 * n);
  const T inf = T(INFINITY);
  const T thresh = T(thresh_d);

  for (int t = 0; t < t_steps; ++t) {
    if (kBounds && t % seg == 0) {  // the carry entering this segment
      const size_t sb = (size_t)l * ((t_steps + seg - 1) / seg) + t / seg;
      for (int a = tid; a < n; a += kThreads)
        o_bounds_mean[sb * n + a] = s.m[a];
      for (int idx = tid; idx < nn; idx += kThreads)
        o_bounds_chol[sb * nn + idx] = s.S[idx];
    }
    // ---- predict: m_p, and the pre-array [(phi o S)' ; diag sqrt q]
    for (int a = tid; a < n; a += kThreads) s.mp[a] = s.ph[a] * s.m[a];
    for (int idx = tid; idx < 2 * n * n; idx += kThreads) {
      const int c = idx / (2 * n), row = idx % (2 * n);
      s.pa[c * ldp + row] = row < n ? s.ph[c] * s.S[c * n + row]
                                    : (row - n == c ? s.qs[c] : T(0));
    }
    if (tid < 32) {  // compact the observed slots, in order (warp 0)
      int base = 0;
      for (int i0 = 0; i0 < N; i0 += 32) {
        const int i = i0 + tid;
        const bool on = i < N && ml[(size_t)t * N + i] != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, on);
        if (on) s.obs[base + __popc(bal & ((1u << tid) - 1u))] = i;
        base += __popc(bal);
      }
      if (tid == 0) {
        mo = base;
        bad = 0;
      }
    }
    __syncthreads();
    // column j of the pre-array is nonzero in rows [j, n + j] only
    sqrtqr::house_qr<T, kThreads>(s.pa, ldp, 2 * n, n, 0, n + 1, s.dg);
    for (int idx = tid; idx < nn; idx += kThreads) {
      const int a = idx / n, b = idx % n;  // S_p[a, b] = sign_b R[b, a]
      T v = T(0);
      if (a == b)
        v = s.dg[b] * sqrtqr::row_sign(s.dg[b]);
      else if (a > b)
        v = s.pa[a * ldp + b] * sqrtqr::row_sign(s.dg[b]);
      s.Sp[idx] = v;
    }
    __syncthreads();
    if (kGate != kNoGate) {
      // the gate, on each observed slot's marginal innovation off S_p
      const size_t row = ((size_t)l * t_steps + t) * N;
      for (int i = tid; i < N; i += kThreads) {
        if (ml[(size_t)t * N + i] == 0) {
          o_z[row + i] = T(NAN);
          o_verdict[row + i] = 0;
          if (kRob) rob.iters[row + i] = 0;
        }
      }
      for (int k = tid; k < mo; k += kThreads) {
        const int i = s.obs[k];
        T v = yl[(size_t)t * N + i];
        for (int a = 0; a < n; ++a) v -= s.zs[i * n + a] * s.mp[a];
        T f = T(0);
        for (int a = 0; a < n; ++a) {
          T e = T(0);
          for (int b = a; b < n; ++b) e += s.zs[i * n + b] * s.Sp[b * n + a];
          f += e * e;
        }
        const T c = f;  // the slot's marginal prior variance |(Z S_p)_i|^2
        f = f + s.rr[i];
        const T zi = v / sqrt(f);
        const T score = zi * zi;
        o_z[row + i] = zi;
        if (kRob) {
          // an armed slot that flags solves its scalar MAP problem off
          // the predicted marginal and enters the QR as the
          // pseudo-observation (r_eff, v_eff); the others keep their row
          const size_t pl = (size_t)l * N + i;
          const T yi = yl[(size_t)t * N + i];
          const bool map = arm && imap::flags<T, kLik>(yi, rob.rail_lo[pl],
                                                       rob.rail_hi[pl]);
          s.reff[i] = s.rr[i];
          s.hit[k] = map ? 1 : 0;
          o_verdict[row + i] = 0;
          rob.iters[row + i] = 0;
          if (map) {
            T mu = T(0);
            for (int a = 0; a < n; ++a) mu += s.zs[i * n + a] * s.mp[a];
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
      __syncthreads();
      if (kGate == kReject && tid < 32) {  // drop the rejected slots
        const int m0 = mo;
        int base = 0;
        for (int k0 = 0; k0 < m0; k0 += 32) {
          const int k = k0 + tid;
          const bool keep = k < m0 && s.hit[k] == 0;
          const int i = k < m0 ? s.obs[k] : 0;
          const unsigned bal = __ballot_sync(0xffffffffu, keep);
          if (keep) s.obs[base + __popc(bal & ((1u << tid) - 1u))] = i;
          base += __popc(bal);
        }
        if (tid == 0) mo = base;
      }
      __syncthreads();
    }
    const int o = mo;

    if (o == 0) {
      // predict-only: S_f = S_p exactly; ok iff S_p is finite
      for (int idx = tid; idx < nn; idx += kThreads)
        if (!isfinite(s.Sp[idx])) bad = 1;
      __syncthreads();
      if (tid == 0) {
        step_sigma = T(0);
        step_detf = bad ? inf : T(0);
      }
      for (int a = tid; a < n; a += kThreads) s.m[a] = s.mp[a];
      for (int idx = tid; idx < nn; idx += kThreads) s.S[idx] = s.Sp[idx];
    } else {
      const int R = o + n;
      const int ldu = sqrtqr::odd_ld(R);
      // innovations of the observed slots
      for (int k = tid; k < o; k += kThreads) {
        const int i = s.obs[k];
        T acc = yl[(size_t)t * N + i];
        for (int a = 0; a < n; ++a) acc -= s.zs[i * n + a] * s.mp[a];
        s.vv[k] = kGate == kHuber ? s.wsc[i] * acc
                  : (kRob && s.hit[k]) ? s.wsc[i] : acc;  // v_eff
      }
      // the compact pre-array, column-major
      for (int idx = tid; idx < R * R; idx += kThreads) {
        const int c = idx / R, row = idx % R;
        T v;
        if (c < o) {
          const int i = s.obs[c];
          if (row < o) {
            v = row == c ? sqrt((kGate == kInflate || kRob) ? s.reff[i]
                                                           : s.rr[i])
                         : T(0);
          } else {  // (Z_o S_p)'[a, c] = sum_b z[i, b] S_p[b, a], b >= a
            const int a = row - o;
            v = T(0);
            for (int b = a; b < n; ++b) v += s.zs[i * n + b] * s.Sp[b * n + a];
          }
        } else {
          v = row < o ? T(0) : s.Sp[(c - o) * n + (row - o)];
        }
        s.ua[c * ldu + row] = v;
      }
      __syncthreads();
      sqrtqr::house_qr<T, kThreads>(s.ua, ldu, R, R, o, R, s.dg);
      // ok: F^1/2 diagonal nonzero (positive once normalised), every
      // entry of R finite; the log terms of detf, one per thread
      for (int c = tid; c < R; c += kThreads) {
        const T d = s.dg[c];
        bool good = isfinite(d) && (c >= o || d != T(0));
        for (int i = 0; i < c; ++i) good = good && isfinite(s.ua[c * ldu + i]);
        if (!good) bad = 1;
        if (c < o) s.ww[c] = T(2) * log(fabs(d));
      }
      __syncthreads();
      if (tid == 0) {
        T det = 0;
        for (int k = 0; k < o; ++k) det += s.ww[k];
        // w = F^-1/2' \ v by forward substitution on the unnormalised R
        // (a row's sign cancels in sigma and in Kbar w)
        T sig = 0;
        for (int k = 0; k < o; ++k) {
          T acc = s.vv[k];
          for (int i = 0; i < k; ++i) acc -= s.ua[k * ldu + i] * s.ww[i];
          const T wk = acc / s.dg[k];
          s.ww[k] = wk;
          sig += wk * wk;
        }
        step_sigma = bad ? T(0) : sig;
        step_detf = bad ? inf : det;
      }
      __syncthreads();
      if (bad) {
        for (int a = tid; a < n; a += kThreads) s.m[a] = s.mp[a];
        for (int idx = tid; idx < nn; idx += kThreads) s.S[idx] = s.Sp[idx];
      } else {
        for (int a = tid; a < n; a += kThreads) {
          T acc = s.mp[a];
          for (int k = 0; k < o; ++k) acc += s.ua[(o + a) * ldu + k] * s.ww[k];
          s.m[a] = acc;
        }
        for (int idx = tid; idx < nn; idx += kThreads) {
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
    __syncthreads();
    // ---- outputs of the step
    const size_t st = (size_t)l * t_steps + t;
    if (tid == 0) {
      o_sigma[st] = step_sigma;
      o_detf[st] = step_detf;
    }
    if (kStore) {
      for (int a = tid; a < n; a += kThreads) {
        o_mean_p[st * n + a] = s.mp[a];
        o_mean_f[st * n + a] = s.m[a];
      }
      for (int idx = tid; idx < nn; idx += kThreads) {
        o_chol_p[st * nn + idx] = s.Sp[idx];
        o_chol_f[st * nn + idx] = s.S[idx];
      }
    }
    __syncthreads();
  }
}

}  // namespace sqrtk
