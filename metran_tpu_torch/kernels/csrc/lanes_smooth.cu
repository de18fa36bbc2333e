// K5: the Durbin-Koopman univariate smoother's backward pass, one warp per
// lane.
//
// Replaces the JAX package's device program
// metran_tpu/ops/lanes_products.py::lanes_smooth (kernel B3: _series_bwd,
// _smooth_emit), the smoother behind the fleet's simulate, decompose and
// sample products.  The forward pass is K3 with its segment boundaries.
//
// Per lane, segments in reverse:
//   replay   the segment forward from its stored boundary with the same
//            device functions as K3 (lanes::predict, lanes::update_step),
//            keeping per step the PREDICTED moments (mean_p, cov_p) and per
//            observed slot (d, f, v) in a scratch of seg * (n + n^2 + N n
//            + 2N) values in device memory;
//   sweep    steps in reverse; per observed slot in reverse order, with
//            k = d/f and the adjoints (r, N), N symmetric (one N k):
//              r += z_i (v/f - k.r)
//              N += -z_i (N k)' - (N k) z_i' + z_i z_i' (k'N k + 1/f)
//            then the step's outputs
//              m_s = m_p + P_p r,  Z m_s,
//              max(diag(Z P_p Z') - diag(Z P_p N P_p Z'), 0)
//            and the transition r = phi o r, N = (phi phi') o N.
// With want_cov = 0 the N recursion is skipped and the variances are 0
// (the mean-only smoother of decompose and the path draws).
//
// What bounds it on an H100: latency, as K3/K4: the recursion is strictly
// sequential per lane, a few KB of state per lane.  Per step the cov mode
// adds ~N(2n^2) operations for the projected variances to the replay's
// forward work.  The design keeps P, N, Z and the vectors of a lane in its
// warp's slice of shared memory (thread `lane` owns rows of P and N), one
// segment's residuals in the scratch (memory O(seg) per lane whatever T
// is), and row i of Z P_p is formed one column per thread (consecutive
// shared addresses, no bank conflicts).

#include "lanes_step.cuh"

namespace {

using lanes::kWarps;
using lanes::warp_sum;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lanes_smooth_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                    const T* __restrict__ z, const T* __restrict__ r,
                    const T* __restrict__ y, const uint8_t* __restrict__ mask,
                    const int* __restrict__ lane_map,
                    const T* __restrict__ bmean, const T* __restrict__ bcov,
                    T* __restrict__ scratch, T* __restrict__ mean_s,
                    T* __restrict__ proj_mean, T* __restrict__ proj_var,
                    int L, int t_steps, int N, int n, int seg, int want_cov,
                    int welems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * kWarps + w;
  if (l >= L) return;  // warp-uniform; no block-wide barrier follows
  T* Na = reinterpret_cast<T*>(smem_raw) + (size_t)w * welems;
  T* P = Na + n * n;
  T* Zs = P + n * n;
  T* m = Zs + N * n;
  T* kv = m + n;  // the gain in the replay, k = d/f in the sweep
  T* ph = kv + n;
  T* qd = ph + n;
  T* ra = qd + n;  // the adjoint r
  T* nk = ra + n;  // N k
  T* wv = nk + n;  // row i of Z P_p
  T* rs = wv + n;
  T* ys = rs + N;
  uint8_t* ms = reinterpret_cast<uint8_t*>(ys + N);

  lanes::load_lane(ph, qd, Zs, rs, phi, q, z, r, l, L, N, n, lane);
  for (int a = lane; a < n; a += 32) ra[a] = 0;
  if (want_cov)
    for (int idx = lane; idx < n * n; idx += 32) Na[idx] = 0;
  __syncwarp();

  const int ld = lane_map[l];
  const T* yl = y + (size_t)ld * t_steps * N;
  const uint8_t* ml = mask + (size_t)ld * t_steps * N;
  const int stride = n + n * n + N * n + 2 * N;
  const int off_d = n + n * n;
  const int off_f = off_d + N * n;
  T* scr = scratch + (size_t)l * seg * stride;
  const int n_seg = (t_steps + seg - 1) / seg;

  for (int g = n_seg - 1; g >= 0; --g) {
    // ---- replay the segment from its boundary, keeping the predicted
    // moments and the slots' residuals
    for (int a = lane; a < n; a += 32)
      m[a] = bmean[((size_t)g * n + a) * L + l];
    for (int idx = lane; idx < n * n; idx += 32)
      P[idx] = bcov[((size_t)g * n * n + idx) * L + l];
    __syncwarp();
    for (int k = 0; k < seg; ++k) {
      const int t = g * seg + k;
      T* res = scr + (size_t)k * stride;
      lanes::load_step(ys, ms, yl, ml, t, t_steps, N, lane);
      lanes::predict(P, m, ph, qd, n, lane);
      __syncwarp();  // the copy reads rows other threads predicted
      for (int a = lane; a < n; a += 32) res[a] = m[a];
      for (int idx = lane; idx < n * n; idx += 32) res[n + idx] = P[idx];
      __syncwarp();  // ... before update_step rewrites them
      T sig, det;
      lanes::update_step(P, m, kv, Zs, rs, ys, ms, N, n, lane, sig, det, res);
    }
    // ---- reverse sweep over the segment's steps
    for (int k = seg - 1; k >= 0; --k) {
      const int t = g * seg + k;
      const T* res = scr + (size_t)k * stride;
      lanes::load_step(ys, ms, yl, ml, t, t_steps, N, lane);
      for (int i = N - 1; i >= 0; --i) {
        if (!ms[i]) continue;  // warp-uniform
        const T* zi = Zs + i * n;
        const T f = res[off_f + i];
        const T v = res[off_f + N + i];
        for (int a = lane; a < n; a += 32) kv[a] = res[off_d + i * n + a] / f;
        __syncwarp();
        T kr_p = 0;
        for (int a = lane; a < n; a += 32) kr_p += kv[a] * ra[a];
        const T kr = warp_sum(kr_p);
        if (want_cov) {
          T knk_p = 0;
          for (int a = lane; a < n; a += 32) {
            T acc = 0;
            for (int b = 0; b < n; ++b) acc += Na[a * n + b] * kv[b];
            nk[a] = acc;
            knk_p += kv[a] * acc;
          }
          const T c = warp_sum(knk_p) + T(1) / f;
          __syncwarp();  // N k complete before the rank-2 update reads it
          for (int a = lane; a < n; a += 32) {
            const T za = zi[a];
            const T nka = nk[a];
            for (int b = 0; b < n; ++b)
              Na[a * n + b] =
                  Na[a * n + b] - za * nk[b] - nka * zi[b] + za * zi[b] * c;
          }
        }
        const T vf = v / f - kr;
        for (int a = lane; a < n; a += 32) ra[a] = ra[a] + zi[a] * vf;
        __syncwarp();  // before the next slot rewrites k and N k
      }
      // ---- the step's outputs from the predicted moments and r, N
      for (int a = lane; a < n; a += 32) m[a] = res[a];
      for (int idx = lane; idx < n * n; idx += 32) P[idx] = res[n + idx];
      __syncwarp();
      const bool emit = t < t_steps;
      const size_t o_n = ((size_t)l * t_steps + t) * n;
      const size_t o_N = ((size_t)l * t_steps + t) * N;
      for (int a = lane; a < n; a += 32) {
        T acc = 0;
        for (int b = 0; b < n; ++b) acc += P[a * n + b] * ra[b];
        kv[a] = m[a] + acc;  // m_s, own rows
        if (emit) mean_s[o_n + a] = kv[a];
      }
      for (int i = 0; i < N; ++i) {
        const T* zi = Zs + i * n;
        T part = 0;
        for (int a = lane; a < n; a += 32) part += zi[a] * kv[a];
        const T pm = warp_sum(part);
        T pv = 0;
        if (want_cov) {
          T t1 = 0;
          for (int j = lane; j < n; j += 32) {
            T acc = 0;  // (Z P_p)_ij: column j of P_p
            for (int a = 0; a < n; ++a) acc += zi[a] * P[a * n + j];
            wv[j] = acc;
            t1 += zi[j] * acc;
          }
          __syncwarp();
          T t2 = 0;
          for (int a = lane; a < n; a += 32) {
            T acc = 0;
            for (int b = 0; b < n; ++b) acc += Na[a * n + b] * wv[b];
            t2 += wv[a] * acc;
          }
          pv = warp_sum(t1) - warp_sum(t2);
          pv = pv > T(0) ? pv : T(0);
          __syncwarp();  // every read of wv done before the next row
        }
        if (emit && lane == (i & 31)) {
          proj_mean[o_N + i] = pm;
          proj_var[o_N + i] = pv;
        }
      }
      __syncwarp();  // m_s read every r before r transitions
      for (int a = lane; a < n; a += 32) {
        const T pa = ph[a];
        ra[a] = pa * ra[a];
        if (want_cov)
          for (int b = 0; b < n; ++b)
            Na[a * n + b] = pa * Na[a * n + b] * ph[b];
      }
      __syncwarp();
    }
  }
}

template <typename T>
int launch_lanes_smooth(const void* phi, const void* q, const void* z,
                        const void* r, const void* y, const void* mask,
                        const void* lane_map, const void* bmean,
                        const void* bcov, void* scratch, void* mean_s,
                        void* proj_mean, void* proj_var, int L, int t_steps,
                        int N, int n, int seg, int want_cov, void* stream) {
  const int welems = lanes::warp_elems<T>(2, 7, N, n);
  const size_t smem = (size_t)kWarps * welems * sizeof(T);
  int err = lanes::prepare_launch(lanes_smooth_kernel<T>, smem);
  if (err != 0) return err;
  if (L == 0) return 0;
  const int blocks = (L + kWarps - 1) / kWarps;
  lanes_smooth_kernel<T><<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)phi, (const T*)q, (const T*)z, (const T*)r, (const T*)y,
      (const uint8_t*)mask, (const int*)lane_map, (const T*)bmean,
      (const T*)bcov, (T*)scratch, (T*)mean_s, (T*)proj_mean, (T*)proj_var,
      L, t_steps, N, n, seg, want_cov, welems);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int metran_lanes_smooth_f32(const void* phi, const void* q, const void* z,
                            const void* r, const void* y, const void* mask,
                            const void* lane_map, const void* bmean,
                            const void* bcov, void* scratch, void* mean_s,
                            void* proj_mean, void* proj_var, int L,
                            int t_steps, int N, int n, int seg, int want_cov,
                            void* stream) {
  return launch_lanes_smooth<float>(phi, q, z, r, y, mask, lane_map, bmean,
                                    bcov, scratch, mean_s, proj_mean,
                                    proj_var, L, t_steps, N, n, seg, want_cov,
                                    stream);
}

int metran_lanes_smooth_f64(const void* phi, const void* q, const void* z,
                            const void* r, const void* y, const void* mask,
                            const void* lane_map, const void* bmean,
                            const void* bcov, void* scratch, void* mean_s,
                            void* proj_mean, void* proj_var, int L,
                            int t_steps, int N, int n, int seg, int want_cov,
                            void* stream) {
  return launch_lanes_smooth<double>(phi, q, z, r, y, mask, lane_map, bmean,
                                     bcov, scratch, mean_s, proj_mean,
                                     proj_var, L, t_steps, N, n, seg,
                                     want_cov, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
