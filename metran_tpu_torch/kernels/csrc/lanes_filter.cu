// K3: lane-layout sequential-processing Kalman filter, a block per lane:
// a chain warp and update warps (lanes_chain_step.cuh).
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
// What bounds it on an H100: latency.  A step is ~N(2n^2 + 4n) flops on a
// few KB of state and the slots are strictly sequential.  The oracle, one
// warp a lane (lanes_filter_warp.cu), runs each slot's whole update in
// series.  Here the serial chain of a slot is only what the next slot
// reads: z_i's K + 1 nonzero columns of P, a few loads, one or two adds in
// place of each butterfly, one division a row; the rest of the rank-1
// update, the predict and sigma/log f go to U update warps of the same
// block, behind the chain by a few events (lanes_chain_step.cuh).  U is
// chosen by the wrapper (kernels.lanes.chain_shape): three while every such
// block is resident on the card (a few lanes an SM: the chain's latency is
// the time), else none (the chain warp alone, one warp a lane: many lanes
// an SM, where instruction issue is the time and handoffs only cost).  Bit
// for bit the oracle: each entry is computed by its operations in its
// order, and a lane whose guard on the skipped zeros fails finishes by the
// oracle's step itself (lanes::series_update, lanes::filter_step).

#include "lanes_chain_step.cuh"

namespace {

using chain::Layout;

// the register budget of a block: the chain warp alone (U = 0) 32 blocks
// an SM, with three update warps 4 (the fleet of 512 resident)
template <int U>
struct Budget {
  static constexpr int kBlocks = U == 0 ? 32 : 4;
};

template <typename T>
__device__ __forceinline__ T big_value() {
  if constexpr (sizeof(T) == 4) {
    return T(3.0e38f);
  } else {
    return T(1.0e300);
  }
}

// the guard's constants from the lane's phi, q and Z (the chain warp)
template <typename T>
__device__ chain::Guard<T> guard_of(const Layout<T>& s, int N, int n,
                                    int lane) {
  T pm = 0, qm = 0, zm = 0;
  bool bad = false;
  for (int a = lane; a < n; a += 32) {
    pm = fmax(pm, fabs(s.ph[a]));
    qm = fmax(qm, fabs(s.qd[a]));
    bad = bad || !isfinite(s.ph[a]) || !isfinite(s.qd[a]);
  }
  for (int idx = lane; idx < N * n; idx += 32) {
    zm = fmax(zm, fabs(s.Zs[idx]));
    bad = bad || !isfinite(s.Zs[idx]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    pm = fmax(pm, __shfl_xor_sync(lanes::kFull, pm, o));
    qm = fmax(qm, __shfl_xor_sync(lanes::kFull, qm, o));
    zm = fmax(zm, __shfl_xor_sync(lanes::kFull, zm, o));
  }
  chain::Guard<T> g;
  g.phi = pm;
  g.q = qm;
  g.lim = big_value<T>() / (T(8) * T(n) * fmax(zm, T(1)));
  g.B = T(1);  // P = I
  g.Bm = T(0);
  g.safe = !__any_sync(lanes::kFull, bad);
  return g;
}

// the run from slot `at.i` of step `at.t` on, by the oracle's step, the
// chain warp alone (the update warps have released every event): P from
// rows of ld to rows of n, the step's sigma and log f of the slots the
// chain ran (their v, f in sv, sf) and its other slots by
// lanes::update_step's loop, then every later step by lanes::filter_step
template <typename T>
__device__ void full_rest(const Layout<T>& s, chain::Stop at,
                          const T* __restrict__ yl,
                          const uint8_t* __restrict__ ml, T* bmean, T* bcov,
                          T* sigma, T* detf, int l, int L, int t_steps, int N,
                          int n, int seg, int lane) {
  const int ld = s.ld;
  if (ld != n) {  // rows move down, in ascending order: no row overwrites
    for (int a = 1; a < n; ++a) {  // what a later one reads
      for (int b0 = 0; b0 < n; b0 += 32) {
        const int b = b0 + lane;
        const T x = b < n ? s.P[a * ld + b] : T(0);
        __syncwarp();
        if (b < n) s.P[a * n + b] = x;
        __syncwarp();
      }
    }
  }
  T sig = 0, det = 0;
  for (int i = 0; i < at.i; ++i) {
    if (!s.ms[i]) continue;
    const T v = s.sv[i], f = s.sf[i];
    sig = sig + v * v / f;
    det = det + log(f);
  }
  for (int i = at.i; i < N; ++i) {
    if (!s.ms[i]) continue;  // warp-uniform
    T v, f;
    lanes::series_update(s.P, s.m, s.kv, s.Zs + i * n, s.ys[i], s.rs[i], n,
                         lane, v, f, static_cast<T*>(nullptr));
    sig = sig + v * v / f;
    det = det + log(f);
  }
  __syncwarp();
  if (at.t < t_steps && lane == 0) {
    sigma[(size_t)at.t * L + l] = sig;
    detf[(size_t)at.t * L + l] = det;
  }
  const int n_steps = (t_steps + seg - 1) / seg * seg;
  for (int t = at.t + 1; t < n_steps; ++t) {
    if (bmean != nullptr && t % seg == 0) {
      const size_t g = t / seg;
      for (int a = lane; a < n; a += 32)
        bmean[(g * n + a) * L + l] = s.m[a];
      for (int idx = lane; idx < n * n; idx += 32)
        bcov[(g * n * n + idx) * L + l] = s.P[idx];
      __syncwarp();  // the copy reads rows that predict rewrites
    }
    lanes::load_step(s.ys, s.ms, yl, ml, t, t_steps, N, lane);
    T sg, dt;
    lanes::filter_step(s.P, s.m, s.kv, s.Zs, s.ph, s.qd, s.rs, s.ys, s.ms, N,
                       n, lane, sg, dt, static_cast<T*>(nullptr));
    if (t < t_steps && lane == 0) {
      sigma[(size_t)t * L + l] = sg;
      detf[(size_t)t * L + l] = dt;
    }
  }
}

template <typename T, int U>
__global__ void __launch_bounds__(32 * (U + 1), Budget<U>::kBlocks)
lanes_filter_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                    const T* __restrict__ z, const T* __restrict__ r,
                    const T* __restrict__ y, const uint8_t* __restrict__ mask,
                    const int* __restrict__ lane_map, T* __restrict__ sigma,
                    T* __restrict__ detf, T* __restrict__ mean_out,
                    T* __restrict__ cov_out, T* __restrict__ bmean,
                    T* __restrict__ bcov, int L, int t_steps, int N, int n,
                    int seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[chain::kSlots], empty[chain::kSlots];
  const int l = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = (n + 31) / 32;
  Layout<T> s;
  chain::carve<T>(smem_raw, N, n, &s);
  const int ld = s.ld;
  // the lane's constants, (0, I) and Z's nonzeros
  for (int a = tid; a < n; a += blockDim.x) {
    s.ph[a] = phi[(size_t)a * L + l];
    s.qd[a] = q[(size_t)a * L + l];
    s.m[a] = T(0);
  }
  for (int idx = tid; idx < N * n; idx += blockDim.x)
    s.Zs[idx] = z[(size_t)idx * L + l];
  for (int i = tid; i < N; i += blockDim.x) {
    s.rs[i] = r[(size_t)i * L + l];
    s.dmark[i] = 0;
  }
  for (int idx = tid; idx < n * ld; idx += blockDim.x)
    s.P[idx] = (idx / ld == idx % ld) ? T(1) : T(0);
  for (int x = tid; x < N * nw; x += blockDim.x) {
    const int i = x / nw, w = x % nw;
    uint32_t bits = 0;
    for (int j = 0; j < 32 && w * 32 + j < n; ++j)
      if (z[((size_t)i * n + w * 32 + j) * L + l] != T(0)) bits |= 1u << j;
    s.bits[x] = bits;
  }
  if (tid == 0) {
    for (int k = 0; k < chain::kSlots; ++k) {
      chain::mbar_init(&full[k], 1);
      chain::mbar_init(&empty[k], U > 0 ? U : 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int i = tid; i < N; i += blockDim.x)
    s.plan[i] = chain::plan_of(s.bits + i * nw, nw, n);
  __syncthreads();  // the block's last: the roles split here

  // the cycles a handoff may take before it counts as lost (~17 s)
  const long long patience = 1ll << 35;
  if (warp > 0) {
    chain::update_warp<T>(s, warp - 1, U, lane, full, empty, bcov, sigma,
                          detf, l, L, t_steps, N, n, seg, patience);
    return;
  }
  const int ldat = lane_map[l];
  const T* yl = y + (size_t)ldat * t_steps * N;
  const uint8_t* ml = mask + (size_t)ldat * t_steps * N;
  const chain::Stop at = chain::chain_warp<T, U>(
      s, lane, full, empty, guard_of(s, N, n, lane), yl, ml, bmean, bcov,
      sigma, detf, l, L, t_steps, N, n, seg, patience);
  int ldc = ld;
  if (at.t >= 0) {
    full_rest(s, at, yl, ml, bmean, bcov, sigma, detf, l, L, t_steps, N, n,
              seg, lane);
    ldc = n;
  }
  for (int a = lane; a < n; a += 32) mean_out[(size_t)a * L + l] = s.m[a];
  for (int idx = lane; idx < n * n; idx += 32)
    cov_out[(size_t)idx * L + l] = s.P[(idx / n) * ldc + idx % n];
}

template <typename T, int U>
int launch_kernel(const void* phi, const void* q, const void* z,
                  const void* r, const void* y, const void* mask,
                  const void* lane_map, void* sigma, void* detf,
                  void* mean_out, void* cov_out, void* bmean, void* bcov,
                  int L, int t_steps, int N, int n, int seg,
                  cudaStream_t stream) {
  const size_t smem = chain::layout_bytes<T>(N, n);
  int err = lanes::prepare_launch(lanes_filter_kernel<T, U>, smem);
  if (err != 0) return err;
  lanes_filter_kernel<T, U><<<L, 32 * (U + 1), smem, stream>>>(
      (const T*)phi, (const T*)q, (const T*)z, (const T*)r, (const T*)y,
      (const uint8_t*)mask, (const int*)lane_map, (T*)sigma, (T*)detf,
      (T*)mean_out, (T*)cov_out, (T*)bmean, (T*)bcov, L, t_steps, N, n, seg);
  return (int)cudaGetLastError();
}

// U = 0 or chain::kMaxU update warps
bool takes(int N, int n, int U) {
  return (U == 0 || U == chain::kMaxU) && N >= 0 && N <= chain::kMaxN &&
         n >= 1;
}

template <typename T>
int launch_lanes_filter(const void* phi, const void* q, const void* z,
                        const void* r, const void* y, const void* mask,
                        const void* lane_map, void* sigma, void* detf,
                        void* mean_out, void* cov_out, void* bmean, void* bcov,
                        int L, int t_steps, int N, int n, int seg, int U,
                        void* stream) {
  if (!takes(N, n, U) || seg < 1) return (int)cudaErrorInvalidValue;
  if (L == 0) return 0;
  auto fn = U == 0 ? launch_kernel<T, 0> : launch_kernel<T, chain::kMaxU>;
  return fn(phi, q, z, r, y, mask, lane_map, sigma, detf, mean_out, cov_out,
            bmean, bcov, L, t_steps, N, n, seg, (cudaStream_t)stream);
}

template <typename T, int U>
int occupancy_of(int N, int n, int* blocks) {
  const size_t smem = chain::layout_bytes<T>(N, n);
  int err = lanes::prepare_launch(lanes_filter_kernel<T, U>, smem);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, lanes_filter_kernel<T, U>, 32 * (U + 1), smem);
}

template <typename T>
int occupancy(int N, int n, int U, int* blocks) {
  if (!takes(N, n, U)) return (int)cudaErrorInvalidValue;
  auto fn = U == 0 ? occupancy_of<T, 0> : occupancy_of<T, chain::kMaxU>;
  return fn(N, n, blocks);
}

}  // namespace

extern "C" {

// phi, q (n, L); z (N, n, L); r (N, L); y, mask (D_data, T, N); lane_map
// (L); sigma, detf (T, L); mean (n, L); cov (n, n, L); bounds_mean
// (n_seg, n, L) and bounds_cov (n_seg, n, n, L), or null; U the update
// warps (0 or 3); N at most 128
int metran_lanes_filter_f32(const void* phi, const void* q, const void* z,
                            const void* r, const void* y, const void* mask,
                            const void* lane_map, void* sigma, void* detf,
                            void* mean_out, void* cov_out, void* bmean,
                            void* bcov, int L, int t_steps, int N, int n,
                            int seg, int U, void* stream) {
  return launch_lanes_filter<float>(phi, q, z, r, y, mask, lane_map, sigma,
                                    detf, mean_out, cov_out, bmean, bcov, L,
                                    t_steps, N, n, seg, U, stream);
}

int metran_lanes_filter_f64(const void* phi, const void* q, const void* z,
                            const void* r, const void* y, const void* mask,
                            const void* lane_map, void* sigma, void* detf,
                            void* mean_out, void* cov_out, void* bmean,
                            void* bcov, int L, int t_steps, int N, int n,
                            int seg, int U, void* stream) {
  return launch_lanes_filter<double>(phi, q, z, r, y, mask, lane_map, sigma,
                                     detf, mean_out, cov_out, bmean, bcov, L,
                                     t_steps, N, n, seg, U, stream);
}

// blocks of K3 resident per SM at (N, n) with U update warps
int metran_lanes_filter_occupancy_f32(int N, int n, int U, void* blocks) {
  return occupancy<float>(N, n, U, (int*)blocks);
}

int metran_lanes_filter_occupancy_f64(int N, int n, int U, void* blocks) {
  return occupancy<double>(N, n, U, (int*)blocks);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
