// One step of the lane-layout sequential filter, run by one warp.
//
// Shared by K3's oracle (lanes_filter_warp.cu, a warp per lane) and the
// chain kernel's guard path (lanes_filter.cu, whose chain warp computes
// each entry by these same operations in the same order), the segment
// replays of K4 (the replay warps of lanes_adjoint.cu, a block per lane,
// and of its oracle lanes_adjoint_warp.cu) and K5 (lanes_smooth.cu), and
// K6 (lanes_forward.cu), so a replayed forward is the forward that was
// run, bit for bit: a change to this step moves all of them.
//
// A lane's state lives in its warp's slice of shared memory: P (n x n,
// row-major), Z (N x n, row i = series i), the mean m and the gain k.
// Thread `lane` owns rows a = lane, lane + 32, ...: it alone writes
// them, so a step needs a warp barrier only where a thread reads what
// another wrote (the gain vector, and P between a step's last update and
// a copy-out).  Dot products over the state go through warp_sum.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lanes {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 2;  // lanes (warps) per block of the warp-a-lane
                          // kernels; lanes.py mirrors it

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  // butterfly: every thread ends with the same value (each level adds
  // the same two operands on both partners)
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// predict: m = phi o m, P = (phi phi') o P + diag(q), own rows
template <typename T>
__device__ __forceinline__ void predict(T* P, T* m, const T* ph, const T* qd,
                                        int n, int lane) {
  for (int a = lane; a < n; a += 32) {
    const T pa = ph[a];
    m[a] = pa * m[a];
    for (int b = 0; b < n; ++b)
      P[a * n + b] = pa * P[a * n + b] * ph[b] + (a == b ? qd[a] : T(0));
  }
}

// the step's observations into shared memory; steps past T (the padding
// of the last segment) are all-masked
template <typename T>
__device__ __forceinline__ void load_step(T* ys, uint8_t* ms, const T* yl,
                                          const uint8_t* ml, int t,
                                          int t_steps, int N, int lane) {
  for (int i = lane; i < N; i += 32) {
    if (t < t_steps) {
      ys[i] = yl[(size_t)t * N + i];
      ms[i] = ml[(size_t)t * N + i];
    } else {
      ms[i] = 0;
    }
  }
  __syncwarp();
}

// One observed slot: v = y_i - z_i.m, d = P z_i, f = z_i.d + r_i,
// k = d/f, m += k v, P -= k k' f (the JAX form).  When `res` is given,
// d (own rows), f and v are stored there for the adjoint.
template <typename T>
__device__ __forceinline__ void series_update(T* P, T* m, T* kv, const T* zi,
                                              T yi, T ri, int n, int lane,
                                              T& v_out, T& f_out, T* d_res) {
  T part = 0;
  for (int a = lane; a < n; a += 32) part += zi[a] * m[a];
  const T v = yi - warp_sum(part);
  T fpart = 0;
  for (int a = lane; a < n; a += 32) {
    T acc = 0;
    for (int b = 0; b < n; ++b) acc += P[a * n + b] * zi[b];
    if (d_res != nullptr) d_res[a] = acc;
    kv[a] = acc;
    fpart += zi[a] * acc;
  }
  const T f = warp_sum(fpart) + ri;
  for (int a = lane; a < n; a += 32) kv[a] = kv[a] / f;
  __syncwarp();
  for (int a = lane; a < n; a += 32) {
    const T ka = kv[a];
    m[a] = m[a] + ka * v;
    for (int b = 0; b < n; ++b) P[a * n + b] = P[a * n + b] - ka * kv[b] * f;
  }
  __syncwarp();
  v_out = v;
  f_out = f;
}

// the masked updates of one step on the predicted (m, P); the step's
// v^2/f and log f go to sig and det.  `res` (or nullptr) is the step's
// residual block [mean0 (n) | cov0 (n*n) | d (N*n) | f (N) | v (N)]: d,
// f, v of the observed slots are written (mean0/cov0 are the caller's).
template <typename T>
__device__ __forceinline__ void update_step(T* P, T* m, T* kv, const T* Zs,
                                            const T* rs, const T* ys,
                                            const uint8_t* ms, int N, int n,
                                            int lane, T& sig, T& det, T* res) {
  sig = 0;
  det = 0;
  for (int i = 0; i < N; ++i) {
    if (!ms[i]) continue;  // warp-uniform
    T v, f;
    T* d_res = res != nullptr ? res + n + n * n + i * n : nullptr;
    series_update(P, m, kv, Zs + i * n, ys[i], rs[i], n, lane, v, f, d_res);
    if (res != nullptr && lane == 0) {
      res[n + n * n + N * n + i] = f;
      res[n + n * n + N * n + N + i] = v;
    }
    sig = sig + v * v / f;
    det = det + log(f);
  }
  __syncwarp();
}

// predict plus the masked updates of one step (see update_step)
template <typename T>
__device__ __forceinline__ void filter_step(T* P, T* m, T* kv, const T* Zs,
                                            const T* ph, const T* qd,
                                            const T* rs, const T* ys,
                                            const uint8_t* ms, int N, int n,
                                            int lane, T& sig, T& det, T* res) {
  predict(P, m, ph, qd, n, lane);
  update_step(P, m, kv, Zs, rs, ys, ms, N, n, lane, sig, det, res);
}

// z_i.m and z_i'P z_i of series i (own rows, summed over the warp):
// the projections diag(Z m) and diag(Z P Z') one slot at a time
template <typename T>
__device__ __forceinline__ void project_slot(const T* P, const T* m,
                                             const T* zi, int n, int lane,
                                             T& zm, T& zpz) {
  T pm = 0, pv = 0;
  for (int a = lane; a < n; a += 32) {
    T acc = 0;
    for (int b = 0; b < n; ++b) acc += P[a * n + b] * zi[b];
    pm += zi[a] * m[a];
    pv += zi[a] * acc;
  }
  zm = warp_sum(pm);
  zpz = warp_sum(pv);
}

// a lane's constants into its shared slice: phi, q (n), Z (N x n), r (N)
// from the lane-last (.., L) layouts
template <typename T>
__device__ __forceinline__ void load_lane(T* ph, T* qd, T* Zs, T* rs,
                                          const T* phi, const T* q,
                                          const T* z, const T* r, int l,
                                          int L, int N, int n, int lane) {
  for (int a = lane; a < n; a += 32) {
    ph[a] = phi[(size_t)a * L + l];
    qd[a] = q[(size_t)a * L + l];
  }
  for (int idx = lane; idx < N * n; idx += 32) Zs[idx] = z[(size_t)idx * L + l];
  for (int i = lane; i < N; i += 32) rs[i] = r[(size_t)i * L + l];
}

// values of one warp's slice, rounded up to keep 16-byte alignment;
// lanes.py::_warp_elems mirrors this
template <typename T>
__host__ __device__ inline int warp_elems(int mats, int vecs, int N, int n) {
  const int bytes_mask = (N + (int)sizeof(T) - 1) / (int)sizeof(T);
  const int e = mats * n * n + N * n + vecs * n + 2 * N + bytes_mask;
  return (e + 3) / 4 * 4;
}

template <typename KernelT>
int prepare_launch(KernelT kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace lanes
