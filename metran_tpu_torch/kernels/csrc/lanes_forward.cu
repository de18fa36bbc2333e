// K6: the lane-layout forward filter with per-step outputs, one warp per
// lane.
//
// Replaces the forward half of the JAX package's device program B4 in
// metran_tpu/ops/lanes_products.py: lanes_filter_project (mode 0),
// lanes_innovations (mode 1) and the latch of lanes_forecast (mode 2);
// and, in mode 3, the stored sequential filter of metran_tpu/ops/kalman.py
// (kalman_filter(engine="sequential", store=True), _sequential_update), the
// forward pass under the RTS smoother (B5, K8).
//
// Per lane, from N(0, I), each step is K3's step (lanes::predict, then
// lanes::update_step: the masked sequential rank-1 updates), with:
//   mode 0, project:      after the updates, m_f (n), Z m_f and
//                         max(diag(Z P_f Z'), 0) (N each);
//   mode 1, innovations:  between predict and the updates, the joint
//                         v = y - Z m_p and f = max(diag(Z P_p Z'), 0) + r
//                         (N each; standardizing and masking are the
//                         caller's);
//   mode 2, latch:        the filtered (m, P) after step t_last[l] - 1, the
//                         warp stopping there; a t_last outside [1, T]
//                         keeps the initial N(0, I);
//   mode 3, store:        the predicted (m_p, P_p) after predict, the
//                         filtered (m_f, P_f) after the updates, and the
//                         step's sigma = sum v^2/f and detf = sum log f.
// Outputs are lane-major: (L, T, n) and (L, T, N), or (L, n), (L, n, n); in
// mode 3 (L, T, n), (L, T, n, n) twice, then (L, T) twice.
//
// What bounds it on an H100: latency, as K3 (this is K3's recursion with
// ~N(2n^2) more operations per step for the projections).  One warp per
// lane with P, Z and the vectors in its slice of shared memory; the
// projections of a slot read the thread's own rows of P only, so they
// need no barrier beyond K3's, and each output value is written by the
// thread of its slot (i mod 32).  Mode 3 is a kernel of its own
// (lanes_store_kernel; on an H100, one kernel for all four modes ran modes
// 0-2 4-7% slower, and one kernel per mode ran innovations 15% slower): it
// writes 2 n^2 + 2 n + 2 values per step and lane (17.6 MB per lane at
// n = 21, T = 5,000, f32), copied out with consecutive threads on
// consecutive addresses between two warp barriers (the copy reads rows
// other threads own).

#include "lanes_step.cuh"

namespace {

using lanes::kWarps;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lanes_forward_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                     const T* __restrict__ z, const T* __restrict__ r,
                     const T* __restrict__ y, const uint8_t* __restrict__ mask,
                     const int* __restrict__ lane_map,
                     const int* __restrict__ t_last, T* __restrict__ out0,
                     T* __restrict__ out1, T* __restrict__ out2, int L,
                     int t_steps, int N, int n, int mode, int welems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * kWarps + w;
  if (l >= L) return;  // warp-uniform; no block-wide barrier follows
  T* P = reinterpret_cast<T*>(smem_raw) + (size_t)w * welems;
  T* Zs = P + n * n;
  T* m = Zs + N * n;
  T* kv = m + n;
  T* ph = kv + n;
  T* qd = ph + n;
  T* rs = qd + n;
  T* ys = rs + N;
  uint8_t* ms = reinterpret_cast<uint8_t*>(ys + N);

  lanes::load_lane(ph, qd, Zs, rs, phi, q, z, r, l, L, N, n, lane);
  for (int a = lane; a < n; a += 32) m[a] = 0;
  for (int idx = lane; idx < n * n; idx += 32)
    P[idx] = (idx / n == idx % n) ? T(1) : T(0);
  __syncwarp();

  const int ld = lane_map[l];
  const T* yl = y + (size_t)ld * t_steps * N;
  const uint8_t* ml = mask + (size_t)ld * t_steps * N;
  int stop = t_steps;
  if (mode == 2) {
    const int tl = t_last[l];
    stop = (tl >= 1 && tl <= t_steps) ? tl : 0;
  }
  for (int t = 0; t < stop; ++t) {
    lanes::load_step(ys, ms, yl, ml, t, t_steps, N, lane);
    lanes::predict(P, m, ph, qd, n, lane);
    const size_t o_N = ((size_t)l * t_steps + t) * N;
    if (mode == 1) {
      for (int i = 0; i < N; ++i) {
        T zm, zpz;
        lanes::project_slot(P, m, Zs + i * n, n, lane, zm, zpz);
        if (lane == (i & 31)) {
          out0[o_N + i] = ys[i] - zm;
          out1[o_N + i] = (zpz > T(0) ? zpz : T(0)) + rs[i];
        }
      }
    }
    T sig, det;
    lanes::update_step(P, m, kv, Zs, rs, ys, ms, N, n, lane, sig, det,
                       static_cast<T*>(nullptr));
    if (mode == 0) {
      const size_t o_n = ((size_t)l * t_steps + t) * n;
      for (int a = lane; a < n; a += 32) out0[o_n + a] = m[a];
      for (int i = 0; i < N; ++i) {
        T zm, zpz;
        lanes::project_slot(P, m, Zs + i * n, n, lane, zm, zpz);
        if (lane == (i & 31)) {
          out1[o_N + i] = zm;
          out2[o_N + i] = zpz > T(0) ? zpz : T(0);
        }
      }
    }
  }
  if (mode == 2) {
    for (int a = lane; a < n; a += 32) out0[(size_t)l * n + a] = m[a];
    for (int idx = lane; idx < n * n; idx += 32)
      out1[(size_t)l * n * n + idx] = P[idx];
  }
}

// a lane's (m, P) to dst_m (n) and dst_P (n x n), coalesced
template <typename T>
__device__ __forceinline__ void copy_moments(T* dst_m, T* dst_P, const T* m,
                                             const T* P, int n, int lane) {
  __syncwarp();
  for (int a = lane; a < n; a += 32) dst_m[a] = m[a];
  for (int idx = lane; idx < n * n; idx += 32) dst_P[idx] = P[idx];
  __syncwarp();
}

// mode 3: the stored filter, the same warp slice and steps as above
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lanes_store_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                   const T* __restrict__ z, const T* __restrict__ r,
                   const T* __restrict__ y, const uint8_t* __restrict__ mask,
                   const int* __restrict__ lane_map, T* __restrict__ mean_p,
                   T* __restrict__ cov_p, T* __restrict__ mean_f,
                   T* __restrict__ cov_f, T* __restrict__ sigma,
                   T* __restrict__ detf, int L, int t_steps, int N, int n,
                   int welems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * kWarps + w;
  if (l >= L) return;  // warp-uniform; no block-wide barrier follows
  T* P = reinterpret_cast<T*>(smem_raw) + (size_t)w * welems;
  T* Zs = P + n * n;
  T* m = Zs + N * n;
  T* kv = m + n;
  T* ph = kv + n;
  T* qd = ph + n;
  T* rs = qd + n;
  T* ys = rs + N;
  uint8_t* ms = reinterpret_cast<uint8_t*>(ys + N);

  lanes::load_lane(ph, qd, Zs, rs, phi, q, z, r, l, L, N, n, lane);
  for (int a = lane; a < n; a += 32) m[a] = 0;
  for (int idx = lane; idx < n * n; idx += 32)
    P[idx] = (idx / n == idx % n) ? T(1) : T(0);
  __syncwarp();

  const int ld = lane_map[l];
  const T* yl = y + (size_t)ld * t_steps * N;
  const uint8_t* ml = mask + (size_t)ld * t_steps * N;
  for (int t = 0; t < t_steps; ++t) {
    lanes::load_step(ys, ms, yl, ml, t, t_steps, N, lane);
    lanes::predict(P, m, ph, qd, n, lane);
    const size_t o_t = (size_t)l * t_steps + t;
    copy_moments(mean_p + o_t * n, cov_p + o_t * n * n, m, P, n, lane);
    T sig, det;
    lanes::update_step(P, m, kv, Zs, rs, ys, ms, N, n, lane, sig, det,
                       static_cast<T*>(nullptr));
    copy_moments(mean_f + o_t * n, cov_f + o_t * n * n, m, P, n, lane);
    if (lane == 0) {
      sigma[o_t] = sig;
      detf[o_t] = det;
    }
  }
}

template <typename T>
int launch_lanes_forward(const void* phi, const void* q, const void* z,
                         const void* r, const void* y, const void* mask,
                         const void* lane_map, const void* t_last, void* out0,
                         void* out1, void* out2, void* out3, void* out4,
                         void* out5, int L, int t_steps, int N, int n,
                         int mode, void* stream) {
  const int welems = lanes::warp_elems<T>(1, 4, N, n);
  const size_t smem = (size_t)kWarps * welems * sizeof(T);
  int err = mode == 3 ? lanes::prepare_launch(lanes_store_kernel<T>, smem)
                      : lanes::prepare_launch(lanes_forward_kernel<T>, smem);
  if (err != 0) return err;
  if (L == 0) return 0;
  const int blocks = (L + kWarps - 1) / kWarps;
  if (mode == 3) {
    lanes_store_kernel<T><<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const T*)phi, (const T*)q, (const T*)z, (const T*)r, (const T*)y,
        (const uint8_t*)mask, (const int*)lane_map, (T*)out0, (T*)out1,
        (T*)out2, (T*)out3, (T*)out4, (T*)out5, L, t_steps, N, n, welems);
  } else {
    lanes_forward_kernel<T><<<blocks, kWarps * 32, smem,
                              (cudaStream_t)stream>>>(
        (const T*)phi, (const T*)q, (const T*)z, (const T*)r, (const T*)y,
        (const uint8_t*)mask, (const int*)lane_map, (const int*)t_last,
        (T*)out0, (T*)out1, (T*)out2, L, t_steps, N, n, mode, welems);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int metran_lanes_forward_f32(const void* phi, const void* q, const void* z,
                             const void* r, const void* y, const void* mask,
                             const void* lane_map, const void* t_last,
                             void* out0, void* out1, void* out2, void* out3,
                             void* out4, void* out5, int L, int t_steps,
                             int N, int n, int mode, void* stream) {
  return launch_lanes_forward<float>(phi, q, z, r, y, mask, lane_map, t_last,
                                     out0, out1, out2, out3, out4, out5, L,
                                     t_steps, N, n, mode, stream);
}

int metran_lanes_forward_f64(const void* phi, const void* q, const void* z,
                             const void* r, const void* y, const void* mask,
                             const void* lane_map, const void* t_last,
                             void* out0, void* out1, void* out2, void* out3,
                             void* out4, void* out5, int L, int t_steps,
                             int N, int n, int mode, void* stream) {
  return launch_lanes_forward<double>(phi, q, z, r, y, mask, lane_map, t_last,
                                      out0, out1, out2, out3, out4, out5, L,
                                      t_steps, N, n, mode, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
