// K4's warp kernel: the closed-form adjoint of the lane-layout filter,
// one warp per lane, each segment replayed and then swept by the same
// warp.  It is the oracle the ring kernel (lanes_adjoint.cu) is held to
// bit for bit, and the baseline it is timed against; no path launches it
// (the wrapper lanes_adjoint_warp_kernel counts its launches apart).  Its
// own source so that the build compiles it beside the ring kernel.
//
// Replaces the JAX package's device program
// metran_tpu/ops/lanes.py::_terms_adjoint_bwd (kernel B2), the backward
// half of the fleet fit's gradient: given the cotangents sb, db of
// K3's (sigma, detf) and K3's segment boundaries, it returns the
// cotangents phibar, qbar (n, L) of the diagonal transition and process
// noise.
//
// Per lane, segments in reverse:
//   replay   the segment forward from its stored boundary (the same
//            lanes::filter_step as K3), keeping per step the pre-predict
//            carry (mean0, cov0) and per observed slot (d, f, v) in a
//            scratch of seg * (n + n^2 + N n + 2N) values in device memory;
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
// What bounds it on an H100: latency, as K3 (it is K3's recursion run
// twice, forward then in reverse), and second the scratch traffic: each
// replayed step writes and reads back ~(n^2 + N n) values.  The design
// keeps S, P, Z and the vectors of a lane in its warp's slice of shared
// memory (thread `lane` owns rows of P and S; S' d reads columns, hence
// one warp barrier before S is rewritten), and one segment's residuals in
// the scratch, so memory stays O(seg) per lane whatever T is.

#include "lanes_step.cuh"

namespace {

using lanes::kWarps;
using lanes::warp_sum;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lanes_adjoint_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                     const T* __restrict__ z, const T* __restrict__ r,
                     const T* __restrict__ y, const uint8_t* __restrict__ mask,
                     const int* __restrict__ lane_map,
                     const T* __restrict__ bmean, const T* __restrict__ bcov,
                     const T* __restrict__ sb, const T* __restrict__ db,
                     T* __restrict__ scratch, T* __restrict__ phibar,
                     T* __restrict__ qbar, int L, int t_steps, int N, int n,
                     int seg, int welems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * kWarps + w;
  if (l >= L) return;  // warp-uniform; no block-wide barrier follows
  T* S = reinterpret_cast<T*>(smem_raw) + (size_t)w * welems;
  T* P = S + n * n;
  T* Zs = P + n * n;
  T* m = Zs + N * n;
  T* kv = m + n;   // the gain in the replay, S d in the sweep
  T* ph = kv + n;
  T* qd = ph + n;
  T* u = qd + n;
  T* dv = u + n;   // d of the slot being reversed
  T* st = dv + n;  // S' d
  T* pb = st + n;
  T* qb = pb + n;
  T* rs = qb + n;
  T* ys = rs + N;
  uint8_t* ms = reinterpret_cast<uint8_t*>(ys + N);

  lanes::load_lane(ph, qd, Zs, rs, phi, q, z, r, l, L, N, n, lane);
  for (int a = lane; a < n; a += 32) {
    u[a] = 0;
    pb[a] = 0;
    qb[a] = 0;
  }
  for (int idx = lane; idx < n * n; idx += 32) S[idx] = 0;
  __syncwarp();

  const int ld = lane_map[l];
  const T* yl = y + (size_t)ld * t_steps * N;
  const uint8_t* ml = mask + (size_t)ld * t_steps * N;
  const int stride = n + n * n + N * n + 2 * N;
  const int off_f = n + n * n + N * n;
  T* scr = scratch + (size_t)l * seg * stride;
  const int n_seg = (t_steps + seg - 1) / seg;

  for (int g = n_seg - 1; g >= 0; --g) {
    // ---- replay the segment from its boundary, keeping residuals
    for (int a = lane; a < n; a += 32)
      m[a] = bmean[((size_t)g * n + a) * L + l];
    for (int idx = lane; idx < n * n; idx += 32)
      P[idx] = bcov[((size_t)g * n * n + idx) * L + l];
    __syncwarp();
    for (int k = 0; k < seg; ++k) {
      const int t = g * seg + k;
      T* res = scr + (size_t)k * stride;
      for (int a = lane; a < n; a += 32) res[a] = m[a];
      for (int idx = lane; idx < n * n; idx += 32) res[n + idx] = P[idx];
      __syncwarp();  // the copy reads rows that predict rewrites
      lanes::load_step(ys, ms, yl, ml, t, t_steps, N, lane);
      T sig, det;
      lanes::filter_step(P, m, kv, Zs, ph, qd, rs, ys, ms, N, n, lane, sig,
                         det, res);
    }
    // ---- reverse sweep over the segment's steps
    for (int k = seg - 1; k >= 0; --k) {
      const int t = g * seg + k;
      const T* res = scr + (size_t)k * stride;
      const T sbt = t < t_steps ? sb[(size_t)t * L + l] : T(0);
      const T dbt = t < t_steps ? db[(size_t)t * L + l] : T(0);
      lanes::load_step(ys, ms, yl, ml, t, t_steps, N, lane);
      for (int i = N - 1; i >= 0; --i) {
        if (!ms[i]) continue;  // warp-uniform
        const T* zi = Zs + i * n;
        const T f = res[off_f + i];
        const T v = res[off_f + N + i];
        for (int a = lane; a < n; a += 32) dv[a] = res[n + n * n + i * n + a];
        __syncwarp();
        T ud_p = 0, dsd_p = 0;
        for (int a = lane; a < n; a += 32) {
          T sd = 0, sdt = 0;  // (S d)_a, (S' d)_a
          for (int b = 0; b < n; ++b) {
            sd += S[a * n + b] * dv[b];
            sdt += S[b * n + a] * dv[b];
          }
          kv[a] = sd;
          st[a] = sdt;
          ud_p += u[a] * dv[a];
          dsd_p += dv[a] * sd;
        }
        const T ud = warp_sum(ud_p);
        const T dsd = warp_sum(dsd_p);
        const T vbar = T(2) * sbt * v / f + ud / f;
        const T fbar = -sbt * v * v / (f * f) + dbt / f + dsd / (f * f) -
                       ud * v / (f * f);
        __syncwarp();  // every column of S read before rows are rewritten
        for (int a = lane; a < n; a += 32) {
          const T dvec = -(kv[a] + st[a]) / f + u[a] * (v / f) + fbar * zi[a];
          for (int b = 0; b < n; ++b)
            S[a * n + b] = S[a * n + b] + dvec * zi[b];
          u[a] = u[a] - vbar * zi[a];
        }
        __syncwarp();
      }
      // predict adjoint: (u, S) are the adjoints of the predicted moments;
      // (mean0, cov0) the pre-predict carry, brought back into m and P
      for (int a = lane; a < n; a += 32) m[a] = res[a];
      for (int idx = lane; idx < n * n; idx += 32) P[idx] = res[n + idx];
      __syncwarp();
      for (int a = lane; a < n; a += 32) {
        T s1 = 0, s2 = 0;
        for (int b = 0; b < n; ++b) {
          s1 += S[a * n + b] * P[a * n + b] * ph[b];
          s2 += S[b * n + a] * P[b * n + a] * ph[b];
        }
        pb[a] = pb[a] + (u[a] * m[a] + s1 + s2);
        qb[a] = qb[a] + S[a * n + a];
      }
      __syncwarp();  // every column of S read before rows are rescaled
      for (int a = lane; a < n; a += 32) {
        const T pa = ph[a];
        u[a] = u[a] * pa;
        for (int b = 0; b < n; ++b) S[a * n + b] = S[a * n + b] * pa * ph[b];
      }
      __syncwarp();
    }
  }
  for (int a = lane; a < n; a += 32) {
    phibar[(size_t)a * L + l] = pb[a];
    qbar[(size_t)a * L + l] = qb[a];
  }
}

template <typename T>
int launch_lanes_adjoint(const void* phi, const void* q, const void* z,
                         const void* r, const void* y, const void* mask,
                         const void* lane_map, const void* bmean,
                         const void* bcov, const void* sb, const void* db,
                         void* scratch, void* phibar, void* qbar, int L,
                         int t_steps, int N, int n, int seg, void* stream) {
  const int welems = lanes::warp_elems<T>(2, 9, N, n);
  const size_t smem = (size_t)kWarps * welems * sizeof(T);
  int err = lanes::prepare_launch(lanes_adjoint_kernel<T>, smem);
  if (err != 0) return err;
  if (L == 0) return 0;
  const int blocks = (L + kWarps - 1) / kWarps;
  lanes_adjoint_kernel<T><<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)phi, (const T*)q, (const T*)z, (const T*)r, (const T*)y,
      (const uint8_t*)mask, (const int*)lane_map, (const T*)bmean,
      (const T*)bcov, (const T*)sb, (const T*)db, (T*)scratch, (T*)phibar,
      (T*)qbar, L, t_steps, N, n, seg, welems);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int metran_lanes_adjoint_warp_f32(const void* phi, const void* q,
                                  const void* z, const void* r, const void* y,
                                  const void* mask,
                                  const void* lane_map, const void* bmean,
                                  const void* bcov, const void* sb,
                                  const void* db, void* scratch, void* phibar,
                                  void* qbar, int L, int t_steps, int N, int n,
                                  int seg, void* stream) {
  return launch_lanes_adjoint<float>(phi, q, z, r, y, mask, lane_map, bmean,
                                     bcov, sb, db, scratch, phibar, qbar, L,
                                     t_steps, N, n, seg, stream);
}

int metran_lanes_adjoint_warp_f64(const void* phi, const void* q,
                                  const void* z, const void* r, const void* y,
                                  const void* mask,
                                  const void* lane_map, const void* bmean,
                                  const void* bcov, const void* sb,
                                  const void* db, void* scratch, void* phibar,
                                  void* qbar, int L, int t_steps, int N, int n,
                                  int seg, void* stream) {
  return launch_lanes_adjoint<double>(phi, q, z, r, y, mask, lane_map, bmean,
                                      bcov, sb, db, scratch, phibar, qbar, L,
                                      t_steps, N, n, seg, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
