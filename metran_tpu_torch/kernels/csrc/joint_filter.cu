// K1: joint-update Kalman filter append, one thread block per model.
//
// Replaces the JAX package's device program
// metran_tpu/ops/kalman.py::filter_append(engine="joint") (with
// _predict, _joint_update and the _make_core_step has_obs select), which
// the serving path runs vmapped over a shape bucket, and the same
// recursion in kalman_filter(engine="joint", store=False) that builds a
// fleet's posteriors from N(0, I).
//
// Per model and appended step:
//   predict   m = phi o m,  P = (phi phi') o P + q
//   innovate  v = mask ? y - Z m : 0,  F = Z_m P Z_m' + diag(r o mask + 1 - mask)
//   factor    F = L L'  (right-looking Cholesky, one column per round)
//   gain      K' = F^-1 Z_m P  (two triangular solves per column)
//   update    m += K v,  P -= K F K'  (the JAX form, not Joseph)
//   terms     sigma = |L^-1 v|^2,  detf = 2 sum log diag L
// A non-positive or non-finite pivot (F indefinite in the working
// precision) makes the step a no-op: predicted moments carried, sigma 0,
// detf +inf.  A step with no observed slot carries the predicted moments
// with sigma = detf = 0.
//
// What bounds it on an H100: neither bytes nor FLOPs.  At the flagship
// bucket (N=24, S=32) a step is ~2e5 flops over a few KB of state, so the
// recursion is latency-bound: a chain of dependent block-wide rounds
// (about 2N + 8 __syncthreads per step).  The design keeps the whole state
// (P, Z, F, its factor, the gain) in shared memory for all k steps, so
// device memory sees only y/mask once and the posterior once, and the
// time loop runs inside the kernel: one launch per dispatch, k = 1 or
// k = 5000 alike.  Many models per SM hide the barrier latency.
//
// Three instantiations (a template parameter, not a run-time branch):
//   carry   per step sigma, detf and the final (m, P) — serving and the
//           deviance;
//   bounds  the same, and the carry (m, P) at the start of every segment
//           of `seg` steps, (B, n_seg, S) and (B, n_seg, S, S): the forward
//           of the batch-layout adjoint (metran_tpu/ops/adjoint.py::
//           _run_segments, engine="joint"), whose backward (K11) replays
//           each segment from its boundary.  Each thread stores the
//           entries it then predicts, so the arithmetic is the carry
//           instantiation's, bit for bit;
//   store   per step sigma, detf and the predicted and filtered moments
//           (m_p, P_p, m_f, P_f): (B, k, S), (B, k, S, S) twice — the
//           joint engine's kalman_filter(store=True) (metran_tpu/ops/
//           kalman.py::kalman_filter, engine="joint"), what the RTS
//           smoother K8 and the single-model products read.  The stores
//           read shared memory between the carry instantiation's own
//           barriers, so every stored step is the carry run's, bit for
//           bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "joint_step.cuh"

namespace {

constexpr int kThreads = 256;
using jointk::kBounds;
using jointk::kCarry;
using jointk::kStore;

// x0, x1: the segment boundaries (bounds); x0..x3: m_p, P_p, m_f, P_f
// per step (store).  The step body is jointk::filter_block
// (joint_step.cuh), which the joint arena update shares.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
joint_filter_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                    const T* __restrict__ z, const T* __restrict__ r,
                    const T* __restrict__ mean0, const T* __restrict__ cov0,
                    const T* __restrict__ y, const uint8_t* __restrict__ mask,
                    T* __restrict__ mean_out, T* __restrict__ cov_out,
                    T* __restrict__ sigma_out, T* __restrict__ detf_out,
                    T* __restrict__ x0, T* __restrict__ x1,
                    T* __restrict__ x2, T* __restrict__ x3, int k, int N,
                    int S, int seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  jointk::filter_block<T, kMode>(smem_raw, phi, q, z, r, mean0, cov0, y,
                                 mask, sigma_out, detf_out, x0, x1, x2, x3,
                                 b, b, k, N, S, seg);
  if (kMode == kStore) return;  // the last stored step is the carry
  const jointk::Smem<T> s = jointk::carve<T>(smem_raw, N, S);
  for (int i = tid; i < S * S; i += nt)
    cov_out[(size_t)b * S * S + i] = s.P[i];
  for (int i = tid; i < S; i += nt) mean_out[(size_t)b * S + i] = s.m[i];
}

template <typename T>
size_t joint_filter_smem(int N, int S) {
  return sizeof(T) * jointk::smem_elems<T>(N, S);
}

template <typename T, int kMode>
int launch(const void* phi, const void* q, const void* z, const void* r,
           const void* mean0, const void* cov0, const void* y,
           const void* mask, void* mean_out, void* cov_out, void* sigma_out,
           void* detf_out, void* x0, void* x1, void* x2, void* x3, int B,
           int k, int N, int S, int seg, void* stream) {
  const size_t smem = joint_filter_smem<T>(N, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        joint_filter_kernel<T, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0) return 0;
  joint_filter_kernel<T, kMode>
      <<<B, kThreads, smem, (cudaStream_t)stream>>>(
          (const T*)phi, (const T*)q, (const T*)z, (const T*)r,
          (const T*)mean0, (const T*)cov0, (const T*)y, (const uint8_t*)mask,
          (T*)mean_out, (T*)cov_out, (T*)sigma_out, (T*)detf_out, (T*)x0,
          (T*)x1, (T*)x2, (T*)x3, k, N, S, seg);
  return (int)cudaGetLastError();
}

// bounds_mean/bounds_cov null: the carry instantiation (seg unused)
template <typename T>
int launch_joint_filter(const void* phi, const void* q, const void* z,
                        const void* r, const void* mean0, const void* cov0,
                        const void* y, const void* mask, void* mean_out,
                        void* cov_out, void* sigma_out, void* detf_out,
                        void* bounds_mean, void* bounds_cov, int B, int k,
                        int N, int S, int seg, void* stream) {
  if (bounds_mean != nullptr) {
    if (seg < 1) return (int)cudaErrorInvalidValue;
    return launch<T, kBounds>(phi, q, z, r, mean0, cov0, y, mask, mean_out,
                              cov_out, sigma_out, detf_out, bounds_mean,
                              bounds_cov, nullptr, nullptr, B, k, N, S, seg,
                              stream);
  }
  return launch<T, kCarry>(phi, q, z, r, mean0, cov0, y, mask, mean_out,
                           cov_out, sigma_out, detf_out, nullptr, nullptr,
                           nullptr, nullptr, B, k, N, S, 1, stream);
}

}  // namespace

extern "C" {

int metran_joint_filter_f32(const void* phi, const void* q, const void* z,
                            const void* r, const void* mean0,
                            const void* cov0, const void* y, const void* mask,
                            void* mean_out, void* cov_out, void* sigma_out,
                            void* detf_out, void* bounds_mean,
                            void* bounds_cov, int B, int k, int N, int S,
                            int seg, void* stream) {
  return launch_joint_filter<float>(phi, q, z, r, mean0, cov0, y, mask,
                                    mean_out, cov_out, sigma_out, detf_out,
                                    bounds_mean, bounds_cov, B, k, N, S, seg,
                                    stream);
}

int metran_joint_filter_f64(const void* phi, const void* q, const void* z,
                            const void* r, const void* mean0,
                            const void* cov0, const void* y, const void* mask,
                            void* mean_out, void* cov_out, void* sigma_out,
                            void* detf_out, void* bounds_mean,
                            void* bounds_cov, int B, int k, int N, int S,
                            int seg, void* stream) {
  return launch_joint_filter<double>(phi, q, z, r, mean0, cov0, y, mask,
                                     mean_out, cov_out, sigma_out, detf_out,
                                     bounds_mean, bounds_cov, B, k, N, S, seg,
                                     stream);
}

// the store instantiation: per step (m_p, P_p, m_f, P_f), (B, k, S) and
// (B, k, S, S), and sigma, detf (B, k)
int metran_joint_filter_store_f32(const void* phi, const void* q,
                                  const void* z, const void* r,
                                  const void* mean0, const void* cov0,
                                  const void* y, const void* mask,
                                  void* mean_p, void* cov_p, void* mean_f,
                                  void* cov_f, void* sigma_out,
                                  void* detf_out, int B, int k, int N, int S,
                                  void* stream) {
  return launch<float, kStore>(phi, q, z, r, mean0, cov0, y, mask, nullptr,
                               nullptr, sigma_out, detf_out, mean_p, cov_p,
                               mean_f, cov_f, B, k, N, S, 1, stream);
}

int metran_joint_filter_store_f64(const void* phi, const void* q,
                                  const void* z, const void* r,
                                  const void* mean0, const void* cov0,
                                  const void* y, const void* mask,
                                  void* mean_p, void* cov_p, void* mean_f,
                                  void* cov_f, void* sigma_out,
                                  void* detf_out, int B, int k, int N, int S,
                                  void* stream) {
  return launch<double, kStore>(phi, q, z, r, mean0, cov0, y, mask, nullptr,
                                nullptr, sigma_out, detf_out, mean_p, cov_p,
                                mean_f, cov_f, B, k, N, S, 1, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
