// K3's oracle: the lane-layout sequential-processing Kalman filter, one
// warp per lane, kept beside the kernel that replaced it
// (lanes_filter.cu) as its bit-for-bit reference, launched by no path
// (kernels.lanes_filter_warp_kernel; counted apart from the paths').
//
// Replaces the JAX package's device program
// metran_tpu/ops/lanes.py::_run_segments (kernel B1: _adj_step,
// _predict_step, _adj_series_update), which the fleet fit runs for the
// value of every lane, the line search's K trial points, and the forward
// half of the closed-form gradient.
//
// Per lane, from N(0, I), for each of the n_seg * seg steps:
//   predict   m = phi o m,  P = (phi phi') o P + diag(q)
//   per observed slot i, in ascending order (masked slots are no-ops):
//             v = y_i - z_i.m,  d = P z_i,  f = z_i.d + r_i,  k = d/f
//             m += k v,  P -= k k' f,  sigma += v^2/f,  detf += log f
// Steps past T pad the last segment: a predict and nothing else, with no
// output.  Emits sigma and detf (T, L), the final filtered carry and,
// when asked for, the carry at the start of every segment.  Lane l reads
// the data of lane_map[l], so K line-search trials over one fleet are one
// launch that reads one copy of y and mask.
//
// A model is one warp, its P, Z and vectors in the warp's slice of shared
// memory, each thread owning rows of P, every step by lanes::filter_step
// (the step of K4's replay, K5 and K6 too).  The only synchronisation is
// __syncwarp and shuffles (two warp reductions and two warp barriers per
// slot), never a block-wide barrier, and the time loop runs inside the
// kernel: one launch per fleet pass.

#include "lanes_step.cuh"

namespace {

using lanes::kWarps;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lanes_filter_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                    const T* __restrict__ z, const T* __restrict__ r,
                    const T* __restrict__ y, const uint8_t* __restrict__ mask,
                    const int* __restrict__ lane_map, T* __restrict__ sigma,
                    T* __restrict__ detf, T* __restrict__ mean_out,
                    T* __restrict__ cov_out, T* __restrict__ bmean,
                    T* __restrict__ bcov, int L, int t_steps, int N, int n,
                    int seg, int welems) {
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
  const int n_seg = (t_steps + seg - 1) / seg;
  for (int t = 0; t < n_seg * seg; ++t) {
    if (bmean != nullptr && t % seg == 0) {
      const size_t s = t / seg;
      for (int a = lane; a < n; a += 32)
        bmean[(s * n + a) * L + l] = m[a];
      for (int idx = lane; idx < n * n; idx += 32)
        bcov[(s * n * n + idx) * L + l] = P[idx];
      __syncwarp();  // the copy reads rows that predict rewrites
    }
    lanes::load_step(ys, ms, yl, ml, t, t_steps, N, lane);
    T sig, det;
    lanes::filter_step(P, m, kv, Zs, ph, qd, rs, ys, ms, N, n, lane, sig,
                       det, static_cast<T*>(nullptr));
    if (t < t_steps && lane == 0) {
      sigma[(size_t)t * L + l] = sig;
      detf[(size_t)t * L + l] = det;
    }
  }
  for (int a = lane; a < n; a += 32) mean_out[(size_t)a * L + l] = m[a];
  for (int idx = lane; idx < n * n; idx += 32)
    cov_out[(size_t)idx * L + l] = P[idx];
}

template <typename T>
int launch_lanes_filter(const void* phi, const void* q, const void* z,
                        const void* r, const void* y, const void* mask,
                        const void* lane_map, void* sigma, void* detf,
                        void* mean_out, void* cov_out, void* bmean, void* bcov,
                        int L, int t_steps, int N, int n, int seg,
                        void* stream) {
  const int welems = lanes::warp_elems<T>(1, 4, N, n);
  const size_t smem = (size_t)kWarps * welems * sizeof(T);
  int err = lanes::prepare_launch(lanes_filter_kernel<T>, smem);
  if (err != 0) return err;
  if (L == 0) return 0;
  const int blocks = (L + kWarps - 1) / kWarps;
  lanes_filter_kernel<T><<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)phi, (const T*)q, (const T*)z, (const T*)r, (const T*)y,
      (const uint8_t*)mask, (const int*)lane_map, (T*)sigma, (T*)detf,
      (T*)mean_out, (T*)cov_out, (T*)bmean, (T*)bcov, L, t_steps, N, n, seg,
      welems);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int metran_lanes_filter_warp_f32(const void* phi, const void* q, const void* z,
                                 const void* r, const void* y,
                                 const void* mask, const void* lane_map,
                                 void* sigma, void* detf, void* mean_out,
                                 void* cov_out, void* bmean, void* bcov, int L,
                                 int t_steps, int N, int n, int seg,
                                 void* stream) {
  return launch_lanes_filter<float>(phi, q, z, r, y, mask, lane_map, sigma,
                                    detf, mean_out, cov_out, bmean, bcov, L,
                                    t_steps, N, n, seg, stream);
}

int metran_lanes_filter_warp_f64(const void* phi, const void* q, const void* z,
                                 const void* r, const void* y,
                                 const void* mask, const void* lane_map,
                                 void* sigma, void* detf, void* mean_out,
                                 void* cov_out, void* bmean, void* bcov, int L,
                                 int t_steps, int N, int n, int seg,
                                 void* stream) {
  return launch_lanes_filter<double>(phi, q, z, r, y, mask, lane_map, sigma,
                                     detf, mean_out, cov_out, bmean, bcov, L,
                                     t_steps, N, n, seg, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
