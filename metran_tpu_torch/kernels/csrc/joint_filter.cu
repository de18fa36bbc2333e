// K1: joint-update Kalman filter append, a group of warps per model.
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
// shape (N=20, S=21) a step is ~2e4 flops over a few KB of state, so the
// recursion is latency-bound: the Cholesky's N dependent columns and the
// substitutions' 2N dependent divisions.  The whole state (P, Z, F, its
// factor, the gain) stays in shared memory for all k steps, so device
// memory sees y/mask once and the posterior once, and the time loop runs
// inside the kernel: one launch per dispatch, k = 1 or k = 5000 alike.
//
// Two kernels compute the same bits:
//   joint_filter_warp_kernel   (the C entries metran_joint_filter_* and
//       metran_joint_filter_store_*): G warps per model
//       (joint_warp_step.cuh), G = 4 on a named barrier of their own
//       while the card holds every such group at once (CUDA's occupancy
//       calculator, metran_joint_filter_occupancy_*), else G = 1 at
//       __syncwarp, W models a block (the wrapper's block_shape): no
//       block-wide barrier in the time loop; the phases split over the
//       warps, the forward solves run beside the factor, Z's zeros are
//       skipped and the next step's data is prefetched;
//   joint_filter_kernel   (metran_joint_filter_block_*,
//       metran_joint_filter_store_block_*): one 256-thread block per
//       model (joint_step.cuh, the body the joint arena update K16
//       shares), about 2N + 8 __syncthreads a step.  It is the card's
//       bit-for-bit oracle for the warp kernel and the baseline it is
//       timed against; nothing chooses it at run time.
//
// Three modes each (a template parameter, not a run-time branch):
//   carry   per step sigma, detf and the final (m, P) — serving and the
//           deviance;
//   bounds  the same, and the carry (m, P) at the start of every segment
//           of `seg` steps, (B, n_seg, S) and (B, n_seg, S, S): the forward
//           of the batch-layout adjoint (metran_tpu/ops/adjoint.py::
//           _run_segments, engine="joint"), whose backward (K11) replays
//           each segment from its boundary.  The stores only read the
//           state, so the arithmetic is the carry mode's, bit for bit;
//   store   per step sigma, detf and the predicted and filtered moments
//           (m_p, P_p, m_f, P_f): (B, k, S), (B, k, S, S) twice — the
//           joint engine's kalman_filter(store=True) (metran_tpu/ops/
//           kalman.py::kalman_filter, engine="joint"), what the RTS
//           smoother K8 and the single-model products read.  Every stored
//           step is the carry run's, bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "joint_step.cuh"
#include "joint_warp_step.cuh"

namespace {

constexpr int kThreads = 256;
using jointk::kBounds;
using jointk::kCarry;
using jointk::kStore;

// The block kernel.  x0, x1: the segment boundaries (bounds); x0..x3:
// m_p, P_p, m_f, P_f per step (store).  The step body is
// jointk::filter_block (joint_step.cuh), which the joint arena update
// shares.
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

// The warp kernel: the kG warps of group w of block x run model x * W +
// w (W = blockDim.x / (32 kG)) on their own carve of the block's shared
// memory, at named barrier 1 + w.  A group past the last model returns at
// once (nothing in the kernel is block-wide).
template <typename T, int kMode, int kG>
__global__ void __launch_bounds__(jointw::kLanes * jointw::kMaxModels)
joint_filter_warp_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                         const T* __restrict__ z, const T* __restrict__ r,
                         const T* __restrict__ mean0,
                         const T* __restrict__ cov0, const T* __restrict__ y,
                         const uint8_t* __restrict__ mask,
                         T* __restrict__ mean_out, T* __restrict__ cov_out,
                         T* __restrict__ sigma_out, T* __restrict__ detf_out,
                         T* __restrict__ x0, T* __restrict__ x1,
                         T* __restrict__ x2, T* __restrict__ x3, int B, int k,
                         int N, int S, int seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nt = jointw::kLanes * kG;
  const int group = threadIdx.x / nt;
  const int b = blockIdx.x * (blockDim.x / nt) + group;
  if (b >= B) return;
  unsigned char* own = smem_raw + group * jointw::model_bytes<T>(N, S);
  jointw::Smem<T> s;
  jointw::layout<T>(own, N, S, &s);
  const int t = threadIdx.x % nt;
  const jointw::Group<kG> g{t, t / jointw::kLanes, t % jointw::kLanes,
                            1 + group, s.flags};
  jointw::filter_group<T, kMode, kG>(own, g, phi, q, z, r, mean0, cov0, y,
                                     mask, sigma_out, detf_out, x0, x1, x2,
                                     x3, b, k, N, S, seg);
  if (kMode == kStore) return;  // the last stored step is the carry
  for (int i = t; i < S; i += nt) mean_out[(size_t)b * S + i] = s.m[i];
  for (int idx = t; idx < S * S; idx += nt)
    cov_out[(size_t)b * S * S + idx] = s.P[(idx / S) * s.sp + idx % S];
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

// the warp kernel with W models a block and kG warps a model
template <typename T, int kMode, int kG>
int launch_group(const void* phi, const void* q, const void* z,
                 const void* r, const void* mean0, const void* cov0,
                 const void* y, const void* mask, void* mean_out,
                 void* cov_out, void* sigma_out, void* detf_out, void* x0,
                 void* x1, void* x2, void* x3, int B, int k, int N, int S,
                 int seg, int W, void* stream) {
  const size_t smem = (size_t)W * jointw::model_bytes<T>(N, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        joint_filter_warp_kernel<T, kMode, kG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0) return 0;
  joint_filter_warp_kernel<T, kMode, kG>
      <<<(B + W - 1) / W, W * kG * jointw::kLanes, smem,
         (cudaStream_t)stream>>>(
          (const T*)phi, (const T*)q, (const T*)z, (const T*)r,
          (const T*)mean0, (const T*)cov0, (const T*)y, (const uint8_t*)mask,
          (T*)mean_out, (T*)cov_out, (T*)sigma_out, (T*)detf_out, (T*)x0,
          (T*)x1, (T*)x2, (T*)x3, B, k, N, S, seg);
  return (int)cudaGetLastError();
}

// blocks of the warp kernel resident per SM with W models a block and kG
// warps a model (CUDA's occupancy calculator)
template <typename T, int kMode, int kG>
int occupancy_of(int N, int S, int W, int* blocks) {
  const size_t smem = (size_t)W * jointw::model_bytes<T>(N, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        joint_filter_warp_kernel<T, kMode, kG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, joint_filter_warp_kernel<T, kMode, kG>,
      W * kG * jointw::kLanes, smem);
}

template <typename T, int kMode>
int occupancy_mode(int N, int S, int W, int G, int* blocks) {
  if (W < 1 || W * G > jointw::kMaxModels) return (int)cudaErrorInvalidValue;
  if (G == 1) return occupancy_of<T, kMode, 1>(N, S, W, blocks);
  if (G == jointw::kMaxGroup)
    return occupancy_of<T, kMode, jointw::kMaxGroup>(N, S, W, blocks);
  return (int)cudaErrorInvalidValue;
}

// mode: kCarry, kBounds or kStore
template <typename T>
int occupancy(int N, int S, int mode, int W, int G, int* blocks) {
  if (mode == kCarry) return occupancy_mode<T, kCarry>(N, S, W, G, blocks);
  if (mode == kBounds) return occupancy_mode<T, kBounds>(N, S, W, G, blocks);
  if (mode == kStore) return occupancy_mode<T, kStore>(N, S, W, G, blocks);
  return (int)cudaErrorInvalidValue;
}

// G = 1: a warp a model, W models a block (W <= kMaxModels); G = 4: four
// warps a model, W models a block (W * 4 <= kMaxModels)
template <typename T, int kMode>
int launch_warp(const void* phi, const void* q, const void* z,
                const void* r, const void* mean0, const void* cov0,
                const void* y, const void* mask, void* mean_out,
                void* cov_out, void* sigma_out, void* detf_out, void* x0,
                void* x1, void* x2, void* x3, int B, int k, int N, int S,
                int seg, int W, int G, void* stream) {
  if (W < 1 || W * G > jointw::kMaxModels) return (int)cudaErrorInvalidValue;
  if (G == 1)
    return launch_group<T, kMode, 1>(phi, q, z, r, mean0, cov0, y, mask,
                                     mean_out, cov_out, sigma_out, detf_out,
                                     x0, x1, x2, x3, B, k, N, S, seg, W,
                                     stream);
  if (G == jointw::kMaxGroup)
    return launch_group<T, kMode, jointw::kMaxGroup>(
        phi, q, z, r, mean0, cov0, y, mask, mean_out, cov_out, sigma_out,
        detf_out, x0, x1, x2, x3, B, k, N, S, seg, W, stream);
  return (int)cudaErrorInvalidValue;
}

// bounds_mean/bounds_cov null: the carry mode (seg unused); W = 0: the
// block kernel, else the warp kernel with W models a block and G warps a
// model
template <typename T>
int launch_joint_filter(const void* phi, const void* q, const void* z,
                        const void* r, const void* mean0, const void* cov0,
                        const void* y, const void* mask, void* mean_out,
                        void* cov_out, void* sigma_out, void* detf_out,
                        void* bounds_mean, void* bounds_cov, int B, int k,
                        int N, int S, int seg, int W, int G, void* stream) {
  const bool bounds = bounds_mean != nullptr;
  if (bounds && seg < 1) return (int)cudaErrorInvalidValue;
  if (W == 0) {
    return bounds ? launch<T, kBounds>(phi, q, z, r, mean0, cov0, y, mask,
                                       mean_out, cov_out, sigma_out,
                                       detf_out, bounds_mean, bounds_cov,
                                       nullptr, nullptr, B, k, N, S, seg,
                                       stream)
                  : launch<T, kCarry>(phi, q, z, r, mean0, cov0, y, mask,
                                      mean_out, cov_out, sigma_out, detf_out,
                                      nullptr, nullptr, nullptr, nullptr, B,
                                      k, N, S, 1, stream);
  }
  return bounds ? launch_warp<T, kBounds>(phi, q, z, r, mean0, cov0, y, mask,
                                          mean_out, cov_out, sigma_out,
                                          detf_out, bounds_mean, bounds_cov,
                                          nullptr, nullptr, B, k, N, S, seg,
                                          W, G, stream)
                : launch_warp<T, kCarry>(phi, q, z, r, mean0, cov0, y, mask,
                                         mean_out, cov_out, sigma_out,
                                         detf_out, nullptr, nullptr, nullptr,
                                         nullptr, B, k, N, S, 1, W, G,
                                         stream);
}

// the store mode: W = 0 the block kernel, else the warp kernel
template <typename T>
int launch_joint_store(const void* phi, const void* q, const void* z,
                       const void* r, const void* mean0, const void* cov0,
                       const void* y, const void* mask, void* mean_p,
                       void* cov_p, void* mean_f, void* cov_f,
                       void* sigma_out, void* detf_out, int B, int k, int N,
                       int S, int W, int G, void* stream) {
  if (W == 0)
    return launch<T, kStore>(phi, q, z, r, mean0, cov0, y, mask, nullptr,
                             nullptr, sigma_out, detf_out, mean_p, cov_p,
                             mean_f, cov_f, B, k, N, S, 1, stream);
  return launch_warp<T, kStore>(phi, q, z, r, mean0, cov0, y, mask, nullptr,
                                nullptr, sigma_out, detf_out, mean_p, cov_p,
                                mean_f, cov_f, B, k, N, S, 1, W, G, stream);
}

}  // namespace

extern "C" {

// the warp kernel: W models a block, G warps a model (G = 1, or
// jointw::kMaxGroup with W * G <= jointw::kMaxModels)
int metran_joint_filter_f32(const void* phi, const void* q, const void* z, const void* r,
    const void* mean0, const void* cov0, const void* y, const void* mask,
    void* mean_out, void* cov_out, void* sigma_out, void* detf_out,
    void* bounds_mean, void* bounds_cov, int B, int k, int N, int S,
    int seg, int W, int G, void* stream) {
  return launch_joint_filter<float>(phi, q, z, r, mean0, cov0, y, mask,
                                 mean_out, cov_out, sigma_out, detf_out,
                                 bounds_mean, bounds_cov, B, k, N, S, seg,
                                 W, G, stream);
}

int metran_joint_filter_f64(const void* phi, const void* q, const void* z, const void* r,
    const void* mean0, const void* cov0, const void* y, const void* mask,
    void* mean_out, void* cov_out, void* sigma_out, void* detf_out,
    void* bounds_mean, void* bounds_cov, int B, int k, int N, int S,
    int seg, int W, int G, void* stream) {
  return launch_joint_filter<double>(phi, q, z, r, mean0, cov0, y, mask,
                                 mean_out, cov_out, sigma_out, detf_out,
                                 bounds_mean, bounds_cov, B, k, N, S, seg,
                                 W, G, stream);
}

// the store mode: per step (m_p, P_p, m_f, P_f), (B, k, S) and
// (B, k, S, S), and sigma, detf (B, k)
int metran_joint_filter_store_f32(const void* phi, const void* q, const void* z, const void* r,
    const void* mean0, const void* cov0, const void* y, const void* mask,
    void* mean_p, void* cov_p, void* mean_f, void* cov_f, void* sigma_out,
    void* detf_out, int B, int k, int N, int S, int W, int G,
    void* stream) {
  return launch_joint_store<float>(phi, q, z, r, mean0, cov0, y, mask, mean_p,
                                cov_p, mean_f, cov_f, sigma_out, detf_out, B,
                                k, N, S, W, G, stream);
}

int metran_joint_filter_store_f64(const void* phi, const void* q, const void* z, const void* r,
    const void* mean0, const void* cov0, const void* y, const void* mask,
    void* mean_p, void* cov_p, void* mean_f, void* cov_f, void* sigma_out,
    void* detf_out, int B, int k, int N, int S, int W, int G,
    void* stream) {
  return launch_joint_store<double>(phi, q, z, r, mean0, cov0, y, mask, mean_p,
                                cov_p, mean_f, cov_f, sigma_out, detf_out, B,
                                k, N, S, W, G, stream);
}

// the block kernel: the warp kernel's oracle and timed baseline
int metran_joint_filter_block_f32(const void* phi, const void* q, const void* z, const void* r,
    const void* mean0, const void* cov0, const void* y, const void* mask,
    void* mean_out, void* cov_out, void* sigma_out, void* detf_out,
    void* bounds_mean, void* bounds_cov, int B, int k, int N, int S,
    int seg, void* stream) {
  return launch_joint_filter<float>(phi, q, z, r, mean0, cov0, y, mask,
                                 mean_out, cov_out, sigma_out, detf_out,
                                 bounds_mean, bounds_cov, B, k, N, S, seg,
                                 0, 0, stream);
}

int metran_joint_filter_block_f64(const void* phi, const void* q, const void* z, const void* r,
    const void* mean0, const void* cov0, const void* y, const void* mask,
    void* mean_out, void* cov_out, void* sigma_out, void* detf_out,
    void* bounds_mean, void* bounds_cov, int B, int k, int N, int S,
    int seg, void* stream) {
  return launch_joint_filter<double>(phi, q, z, r, mean0, cov0, y, mask,
                                 mean_out, cov_out, sigma_out, detf_out,
                                 bounds_mean, bounds_cov, B, k, N, S, seg,
                                 0, 0, stream);
}

int metran_joint_filter_store_block_f32(const void* phi, const void* q, const void* z, const void* r,
    const void* mean0, const void* cov0, const void* y, const void* mask,
    void* mean_p, void* cov_p, void* mean_f, void* cov_f, void* sigma_out,
    void* detf_out, int B, int k, int N, int S, void* stream) {
  return launch_joint_store<float>(phi, q, z, r, mean0, cov0, y, mask, mean_p,
                                cov_p, mean_f, cov_f, sigma_out, detf_out, B,
                                k, N, S, 0, 0, stream);
}

int metran_joint_filter_store_block_f64(const void* phi, const void* q, const void* z, const void* r,
    const void* mean0, const void* cov0, const void* y, const void* mask,
    void* mean_p, void* cov_p, void* mean_f, void* cov_f, void* sigma_out,
    void* detf_out, int B, int k, int N, int S, void* stream) {
  return launch_joint_store<double>(phi, q, z, r, mean0, cov0, y, mask, mean_p,
                                cov_p, mean_f, cov_f, sigma_out, detf_out, B,
                                k, N, S, 0, 0, stream);
}

// the warp kernel's shared memory a model (bytes, a multiple of 16)
int metran_joint_filter_model_bytes_f32(int N, int S) {
  return (int)jointw::model_bytes<float>(N, S);
}

int metran_joint_filter_model_bytes_f64(int N, int S) {
  return (int)jointw::model_bytes<double>(N, S);
}

// blocks of the warp kernel resident per SM at (N, S) in mode (0 carry,
// 1 bounds, 2 store) with W models a block and G warps a model
int metran_joint_filter_occupancy_f32(int N, int S, int mode, int W, int G,
                                      void* blocks) {
  return occupancy<float>(N, S, mode, W, G, (int*)blocks);
}

int metran_joint_filter_occupancy_f64(int N, int S, int mode, int W, int G,
                                      void* blocks) {
  return occupancy<double>(N, S, mode, W, G, (int*)blocks);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
