// K9's block kernel: the square-root (QR array) Kalman filter, one block of
// 64 threads per lane (sqrt_step.cuh, the body the square-root arena update
// K16 shares).  It is the oracle the group kernel (sqrt_filter.cu,
// sqrt_warp_step.cuh) is held to bit for bit, and the baseline it is timed
// against; no path launches it (the wrappers' *_block functions count its
// launches apart).  The step, the instantiations and the inputs are
// sqrt_filter.cu's; this file keeps the arithmetic that kernel
// reproduces.  Its own source so that the build compiles it beside the
// group kernel, not after it.

#include "sqrt_step.cuh"

namespace {

using sqrtk::kHuber;
using sqrtk::kInflate;
using sqrtk::kNoGate;
using sqrtk::kReject;
using sqrtk::kRobust;
using sqrtk::kThreads;
using sqrtk::RobustArgs;
using sqrtk::Smem;
using sqrtk::carve;

// The time loop is sqrtk::run_steps (sqrt_step.cuh), which the arena
// update shares; this kernel loads a lane's constants from the
// lane-major layout and its carry from (mean0, chol0) or (0, I).
template <typename T, bool kStore, bool kBounds, int kGate>
__global__ void __launch_bounds__(kThreads)
sqrt_filter_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                   const T* __restrict__ z, const T* __restrict__ r,
                   const T* __restrict__ y, const uint8_t* __restrict__ mask,
                   const int* __restrict__ lane_map,
                   const T* __restrict__ mean0, const T* __restrict__ chol0,
                   T* __restrict__ o_mean_p, T* __restrict__ o_chol_p,
                   T* __restrict__ o_mean_f, T* __restrict__ o_chol_f,
                   T* __restrict__ o_sigma, T* __restrict__ o_detf,
                   T* __restrict__ o_bounds_mean,
                   T* __restrict__ o_bounds_chol,
                   const uint8_t* __restrict__ armed, double thresh_d,
                   T* __restrict__ o_z, int8_t* __restrict__ o_verdict,
                   RobustArgs<T> rob, int L, int t_steps, int N, int n,
                   int seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> s;
  carve<T>(smem_raw, N, n, &s);
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const int nn = n * n;
  const bool arm = kGate != kNoGate && armed[l] != 0;  // gate or robust

  for (int idx = tid; idx < N * n; idx += kThreads)
    s.zs[idx] = z[(size_t)idx * L + l];  // z[i, a, l], idx = i * n + a
  for (int i = tid; i < N; i += kThreads) s.rr[i] = r[(size_t)i * L + l];
  for (int a = tid; a < n; a += kThreads) {
    s.ph[a] = phi[(size_t)a * L + l];
    const T qa = q[(size_t)a * L + l];
    s.qs[a] = sqrt(qa > T(0) ? qa : T(0));
    s.m[a] = mean0 ? mean0[(size_t)l * n + a] : T(0);
  }
  for (int idx = tid; idx < nn; idx += kThreads)
    s.S[idx] = chol0 ? chol0[(size_t)l * nn + idx]
                     : (idx / n == idx % n ? T(1) : T(0));
  __syncthreads();

  const int dl = lane_map[l];
  sqrtk::run_steps<T, kStore, kBounds, kGate>(
      s, y + (size_t)dl * t_steps * N, mask + (size_t)dl * t_steps * N, arm,
      thresh_d, o_mean_p, o_chol_p, o_mean_f, o_chol_f, o_sigma, o_detf,
      o_bounds_mean, o_bounds_chol, o_z, o_verdict, rob, l, t_steps, N, n,
      seg);
  if (!kStore) {
    for (int a = tid; a < n; a += kThreads) o_mean_f[(size_t)l * n + a] = s.m[a];
    for (int idx = tid; idx < nn; idx += kThreads)
      o_chol_f[(size_t)l * nn + idx] = s.S[idx];
  }
}

template <typename T, bool kStore, bool kBounds, int kGate>
int launch(const void* phi, const void* q, const void* z, const void* r,
           const void* y, const void* mask, const void* lane_map,
           const void* mean0, const void* chol0, void* out0, void* out1,
           void* out2, void* out3, void* out4, void* out5, void* bounds_mean,
           void* bounds_chol, const void* armed, double thresh, void* o_z,
           void* o_verdict, RobustArgs<T> rob, int L, int t_steps, int N,
           int n, int seg, void* stream) {
  const size_t smem = carve<T>(nullptr, N, n, nullptr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sqrt_filter_kernel<T, kStore, kBounds, kGate>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      (void)cudaGetLastError();  // not left for the next launch to report
      return (int)e;
    }
  }
  if (L == 0) return 0;
  sqrt_filter_kernel<T, kStore, kBounds, kGate>
      <<<L, kThreads, smem, (cudaStream_t)stream>>>(
          (const T*)phi, (const T*)q, (const T*)z, (const T*)r, (const T*)y,
          (const uint8_t*)mask, (const int*)lane_map, (const T*)mean0,
          (const T*)chol0, (T*)out0, (T*)out1, (T*)out2, (T*)out3, (T*)out4,
          (T*)out5, (T*)bounds_mean, (T*)bounds_chol, (const uint8_t*)armed,
          thresh, (T*)o_z, (int8_t*)o_verdict, rob, L, t_steps, N, n, seg);
  return (int)cudaGetLastError();
}

// store and bounds exclude each other; bounds_mean null: no boundaries
template <typename T>
int launch_sqrt_filter(const void* phi, const void* q, const void* z,
                       const void* r, const void* y, const void* mask,
                       const void* lane_map, const void* mean0,
                       const void* chol0, void* out0, void* out1, void* out2,
                       void* out3, void* out4, void* out5, void* bounds_mean,
                       void* bounds_chol, int L, int t_steps, int N, int n,
                       int store, int seg, void* stream) {
  if (store && bounds_mean != nullptr) return (int)cudaErrorInvalidValue;
  const RobustArgs<T> none = {};
  if (store)
    return launch<T, true, false, kNoGate>(
        phi, q, z, r, y, mask, lane_map, mean0, chol0, out0, out1, out2,
        out3, out4, out5, nullptr, nullptr, nullptr, 0.0, nullptr, nullptr,
        none, L, t_steps, N, n, 1, stream);
  if (bounds_mean != nullptr) {
    if (seg < 1) return (int)cudaErrorInvalidValue;
    return launch<T, false, true, kNoGate>(
        phi, q, z, r, y, mask, lane_map, mean0, chol0, out0, out1, out2,
        out3, out4, out5, bounds_mean, bounds_chol, nullptr, 0.0, nullptr,
        nullptr, none, L, t_steps, N, n, seg, stream);
  }
  return launch<T, false, false, kNoGate>(
      phi, q, z, r, y, mask, lane_map, mean0, chol0, out0, out1, out2, out3,
      out4, out5, nullptr, nullptr, nullptr, 0.0, nullptr, nullptr, none, L,
      t_steps, N, n, 1, stream);
}

// the gated instantiations: from a given carry, carry outputs only
template <typename T>
int launch_sqrt_filter_gated(const void* phi, const void* q, const void* z,
                             const void* r, const void* y, const void* mask,
                             const void* lane_map, const void* mean0,
                             const void* chol0, const void* armed,
                             double thresh, void* mean, void* chol,
                             void* sigma, void* detf, void* o_z,
                             void* o_verdict, int L, int t_steps, int N,
                             int n, int policy, void* stream) {
  if (mean0 == nullptr || chol0 == nullptr) return (int)cudaErrorInvalidValue;
  const RobustArgs<T> none = {};
#define METRAN_SQRT_GATED(G)                                                \
  return launch<T, false, false, G>(                                        \
      phi, q, z, r, y, mask, lane_map, mean0, chol0, nullptr, nullptr, mean, \
      chol, sigma, detf, nullptr, nullptr, armed, thresh, o_z, o_verdict,    \
      none, L, t_steps, N, n, 1, stream)
  switch (policy) {
    case kReject: METRAN_SQRT_GATED(kReject);
    case kHuber: METRAN_SQRT_GATED(kHuber);
    case kInflate: METRAN_SQRT_GATED(kInflate);
    default: return (int)cudaErrorInvalidValue;
  }
#undef METRAN_SQRT_GATED
}

// the robust instantiations: from a given carry, carry outputs only
template <typename T>
int launch_sqrt_filter_robust(
    const void* phi, const void* q, const void* z, const void* r,
    const void* y, const void* mask, const void* lane_map, const void* mean0,
    const void* chol0, const void* armed, const void* rail_lo,
    const void* rail_hi, const void* quantum, const void* scale, double nu,
    double tol, double nonconv_tol, double c_floor, double eps, void* mean,
    void* chol, void* sigma, void* detf, void* o_z, void* o_verdict,
    void* o_iters, int L, int t_steps, int N, int n, int likelihood,
    void* stream) {
  if (mean0 == nullptr || chol0 == nullptr) return (int)cudaErrorInvalidValue;
  const RobustArgs<T> rob = {(const T*)rail_lo, (const T*)rail_hi,
                             (const T*)quantum, (const T*)scale, nu, tol,
                             nonconv_tol, c_floor, eps, (int*)o_iters};
#define METRAN_SQRT_ROBUST(G)                                               \
  return launch<T, false, false, kRobust + G>(                              \
      phi, q, z, r, y, mask, lane_map, mean0, chol0, nullptr, nullptr, mean, \
      chol, sigma, detf, nullptr, nullptr, armed, 0.0, o_z, o_verdict, rob,  \
      L, t_steps, N, n, 1, stream)
  switch (likelihood) {
    case imap::kCensored: METRAN_SQRT_ROBUST(imap::kCensored);
    case imap::kQuantized: METRAN_SQRT_ROBUST(imap::kQuantized);
    case imap::kHuberT: METRAN_SQRT_ROBUST(imap::kHuberT);
    default: return (int)cudaErrorInvalidValue;
  }
#undef METRAN_SQRT_ROBUST
}

}  // namespace

extern "C" {

// out0..out5: (mean_p, chol_p, mean_f, chol_f, sigma, detf) with store;
// without, out0/out1 are unused and out2/out3 receive the final (m, S).
// bounds_mean/bounds_chol, when not null (never with store), receive the
// carry at the start of every segment of seg steps.
// mean0/chol0 may be null: the carry then starts from (0, I).
int metran_sqrt_filter_block_f32(const void* phi, const void* q, const void* z,
                           const void* r, const void* y, const void* mask,
                           const void* lane_map, const void* mean0,
                           const void* chol0, void* out0, void* out1,
                           void* out2, void* out3, void* out4, void* out5,
                           void* bounds_mean, void* bounds_chol, int L,
                           int t_steps, int N, int n, int store, int seg,
                           void* stream) {
  return launch_sqrt_filter<float>(phi, q, z, r, y, mask, lane_map, mean0,
                                   chol0, out0, out1, out2, out3, out4, out5,
                                   bounds_mean, bounds_chol, L, t_steps, N, n,
                                   store, seg, stream);
}

int metran_sqrt_filter_block_f64(const void* phi, const void* q, const void* z,
                           const void* r, const void* y, const void* mask,
                           const void* lane_map, const void* mean0,
                           const void* chol0, void* out0, void* out1,
                           void* out2, void* out3, void* out4, void* out5,
                           void* bounds_mean, void* bounds_chol, int L,
                           int t_steps, int N, int n, int store, int seg,
                           void* stream) {
  return launch_sqrt_filter<double>(phi, q, z, r, y, mask, lane_map, mean0,
                                    chol0, out0, out1, out2, out3, out4, out5,
                                    bounds_mean, bounds_chol, L, t_steps, N, n,
                                    store, seg, stream);
}

// policy: 1 reject, 2 huber, 3 inflate; thresh = nsigma^2; armed (L,)
// uint8; zscore (L, T, N), verdict (L, T, N) int8
int metran_sqrt_filter_gated_block_f32(const void* phi, const void* q,
                                 const void* z, const void* r, const void* y,
                                 const void* mask, const void* lane_map,
                                 const void* mean0, const void* chol0,
                                 const void* armed, double thresh, void* mean,
                                 void* chol, void* sigma, void* detf,
                                 void* o_z, void* o_verdict, int L,
                                 int t_steps, int N, int n, int policy,
                                 void* stream) {
  return launch_sqrt_filter_gated<float>(
      phi, q, z, r, y, mask, lane_map, mean0, chol0, armed, thresh, mean,
      chol, sigma, detf, o_z, o_verdict, L, t_steps, N, n, policy, stream);
}

int metran_sqrt_filter_gated_block_f64(const void* phi, const void* q,
                                 const void* z, const void* r, const void* y,
                                 const void* mask, const void* lane_map,
                                 const void* mean0, const void* chol0,
                                 const void* armed, double thresh, void* mean,
                                 void* chol, void* sigma, void* detf,
                                 void* o_z, void* o_verdict, int L,
                                 int t_steps, int N, int n, int policy,
                                 void* stream) {
  return launch_sqrt_filter_gated<double>(
      phi, q, z, r, y, mask, lane_map, mean0, chol0, armed, thresh, mean,
      chol, sigma, detf, o_z, o_verdict, L, t_steps, N, n, policy, stream);
}

// likelihood: 0 censored, 1 quantized, 2 huber_t; armed (L,) uint8;
// rail_lo, rail_hi, quantum, scale (L, N); tol, nonconv_tol: the solve's
// residual bars; c_floor: the floor of a slot's prior variance; eps: the
// type's epsilon (the pseudo-noise floor); zscore (L, T, N), verdict
// (L, T, N) int8, iters (L, T, N) int32
int metran_sqrt_filter_robust_block_f32(
    const void* phi, const void* q, const void* z, const void* r,
    const void* y, const void* mask, const void* lane_map, const void* mean0,
    const void* chol0, const void* armed, const void* rail_lo,
    const void* rail_hi, const void* quantum, const void* scale, double nu,
    double tol, double nonconv_tol, double c_floor, double eps, void* mean,
    void* chol, void* sigma, void* detf, void* o_z, void* o_verdict,
    void* o_iters, int L, int t_steps, int N, int n, int likelihood,
    void* stream) {
  return launch_sqrt_filter_robust<float>(
      phi, q, z, r, y, mask, lane_map, mean0, chol0, armed, rail_lo, rail_hi,
      quantum, scale, nu, tol, nonconv_tol, c_floor, eps, mean, chol, sigma,
      detf, o_z, o_verdict, o_iters, L, t_steps, N, n, likelihood, stream);
}

int metran_sqrt_filter_robust_block_f64(
    const void* phi, const void* q, const void* z, const void* r,
    const void* y, const void* mask, const void* lane_map, const void* mean0,
    const void* chol0, const void* armed, const void* rail_lo,
    const void* rail_hi, const void* quantum, const void* scale, double nu,
    double tol, double nonconv_tol, double c_floor, double eps, void* mean,
    void* chol, void* sigma, void* detf, void* o_z, void* o_verdict,
    void* o_iters, int L, int t_steps, int N, int n, int likelihood,
    void* stream) {
  return launch_sqrt_filter_robust<double>(
      phi, q, z, r, y, mask, lane_map, mean0, chol0, armed, rail_lo, rail_hi,
      quantum, scale, nu, tol, nonconv_tol, c_floor, eps, mean, chol, sigma,
      detf, o_z, o_verdict, o_iters, L, t_steps, N, n, likelihood, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
