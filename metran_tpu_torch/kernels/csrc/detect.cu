// K13: the streaming detector, one thread per (model, slot).
//
// Replaces the JAX package's device program B11,
// metran_tpu/ops/detect.py::_detect_scan behind detect_append, which the
// serving path fuses after the gated update (serve/engine.py).  Per slot,
// over the k appended steps, from the carried state
// [C+, C-, z_prev, S_zz, S_z2, n_eff]:
//   obs      = mask && armed && isfinite(z)   (else the state is carried)
//   anomaly  = obs && z^2 > nsigma^2
//   CUSUM    C+ <- max(C+ + z - k, 0),  C- <- max(C- - z - k, 0);
//            alarm when either passes h, and both reset to 0
//   LB drift S_zz <- lam S_zz + z z_prev,  S_z2 <- lam S_z2 + z^2,
//            n_eff <- lam n_eff + 1,  z_prev <- z,  lam = 1 - 1/window;
//            Q = n_eff (S_zz / max(S_z2, tiny))^2; an alarm is a rising
//            edge of (n_eff >= window/2 && Q > q_bar)
// and books the per-slot counts [anomalies, CUSUM alarms, LB alarms].
//
// The arithmetic is spelled with round-to-nearest intrinsics (no fused
// multiply-add), each operation rounded as PyTorch's elementwise kernels
// round it, so the kernel and its plain version agree bit for bit on the
// card and the alarm counts cannot differ on a tie.
//
// What bounds it on an H100: bytes.  The recursion is sequential in k
// but independent across (model, slot): a few dozen flops per step per
// thread, reading one z-score and one mask byte per step and the 6-row
// state once.  The JAX package fuses it into the update executable; here
// it is one launch after K12 or gated K9.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "detect_step.cuh"

namespace {

constexpr int kThreads = 128;

// The recursion is detectk::scan_slot (detect_step.cuh), which the arena
// updates' detection tails share.
template <typename T>
__global__ void __launch_bounds__(kThreads)
detect_kernel(const T* __restrict__ state, const T* __restrict__ zs,
              const uint8_t* __restrict__ mask,
              const uint8_t* __restrict__ armed, T* __restrict__ state_out,
              int32_t* __restrict__ counts, int B, int k, int N,
              detectk::Params p) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= B * N) return;
  const int b = gid / N, i = gid - (gid / N) * N;
  const T* st = state + (size_t)b * 6 * N + i;
  T s[6];
  for (int j = 0; j < 6; ++j) s[j] = st[(size_t)j * N];
  int cnt[3];
  const size_t at = (size_t)b * k * N + i;
  detectk::scan_slot<T>(s, cnt, zs + at, mask + at, (size_t)N, k,
                        armed[b] != 0, p);
  T* so = state_out + (size_t)b * 6 * N + i;
  for (int j = 0; j < 6; ++j) so[(size_t)j * N] = s[j];
  int32_t* co = counts + (size_t)b * 3 * N + i;
  co[0] = cnt[0];
  co[N] = cnt[1];
  co[2 * N] = cnt[2];
}

template <typename T>
int launch_detect(const void* state, const void* zs, const void* mask,
                  const void* armed, void* state_out, void* counts, int B,
                  int k, int N, double ck, double ch, double lam, double warm,
                  double qbar, double abar, double tiny, void* stream) {
  const int total = B * N;
  if (total == 0) return 0;
  const int blocks = (total + kThreads - 1) / kThreads;
  const detectk::Params p = {ck, ch, lam, warm, qbar, abar, tiny};
  detect_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)state, (const T*)zs, (const uint8_t*)mask,
      (const uint8_t*)armed, (T*)state_out, (int32_t*)counts, B, k, N, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// state (B, 6, N), zs (B, k, N), mask (B, k, N) uint8, armed (B,) uint8;
// state_out (B, 6, N), counts (B, 3, N) int32.  ck, ch: the CUSUM
// reference and threshold; lam = 1 - 1/window; warm = window/2; qbar the
// LB threshold; abar = nsigma^2; tiny the dtype's smallest normal.
int metran_detect_f32(const void* state, const void* zs, const void* mask,
                      const void* armed, void* state_out, void* counts,
                      int B, int k, int N, double ck, double ch, double lam,
                      double warm, double qbar, double abar, double tiny,
                      void* stream) {
  return launch_detect<float>(state, zs, mask, armed, state_out, counts, B,
                              k, N, ck, ch, lam, warm, qbar, abar, tiny,
                              stream);
}

int metran_detect_f64(const void* state, const void* zs, const void* mask,
                      const void* armed, void* state_out, void* counts,
                      int B, int k, int N, double ck, double ch, double lam,
                      double warm, double qbar, double abar, double tiny,
                      void* stream) {
  return launch_detect<double>(state, zs, mask, armed, state_out, counts, B,
                               k, N, ck, ch, lam, warm, qbar, abar, tiny,
                               stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
