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

namespace {

constexpr int kThreads = 128;

__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline float add(float a, float b) { return __fadd_rn(a, b); }
__device__ inline float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ inline double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ inline double add(double a, double b) { return __dadd_rn(a, b); }
__device__ inline double div(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__device__ inline T lb_q(T szz, T sz2, T nef, T tiny) {
  const T rho = div(szz, sz2 > tiny ? sz2 : tiny);
  return mul(mul(nef, rho), rho);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
detect_kernel(const T* __restrict__ state, const T* __restrict__ zs,
              const uint8_t* __restrict__ mask,
              const uint8_t* __restrict__ armed, T* __restrict__ state_out,
              int32_t* __restrict__ counts, int B, int k, int N, double ck_d,
              double ch_d, double lam_d, double warm_d, double qbar_d,
              double abar_d, double tiny_d) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= B * N) return;
  const int b = gid / N, i = gid - (gid / N) * N;
  const T ck = T(ck_d), ch = T(ch_d), lam = T(lam_d), warm = T(warm_d);
  const T qbar = T(qbar_d), abar = T(abar_d), tiny = T(tiny_d);
  const T zero = T(0), one = T(1);
  const T* st = state + (size_t)b * 6 * N + i;
  T cpos = st[0], cneg = st[N], prev = st[2 * N], szz = st[3 * N];
  T sz2 = st[4 * N], nef = st[5 * N];
  const bool arm = armed[b] != 0;
  int n_an = 0, n_cp = 0, n_lb = 0;
  for (int t = 0; t < k; ++t) {
    const size_t at = ((size_t)b * k + t) * N + i;
    const T z_raw = zs[at];
    const bool obs = mask[at] != 0 && arm && isfinite(z_raw);
    if (!obs) continue;  // every row carried unchanged
    const T z = z_raw;
    if (mul(z, z) > abar) ++n_an;
    T cp = add(add(cpos, z), -ck);
    T cn = add(add(cneg, -z), -ck);
    cp = cp < zero ? zero : cp;  // max(., 0), NaN kept as jnp.maximum
    cn = cn < zero ? zero : cn;
    if (cp > ch || cn > ch) {
      ++n_cp;
      cp = zero;
      cn = zero;
    }
    cpos = cp;
    cneg = cn;
    const bool was = nef >= warm && lb_q(szz, sz2, nef, tiny) > qbar;
    szz = add(mul(lam, szz), mul(z, prev));
    sz2 = add(mul(lam, sz2), mul(z, z));
    nef = add(mul(lam, nef), one);
    prev = z;
    const bool now = nef >= warm && lb_q(szz, sz2, nef, tiny) > qbar;
    if (now && !was) ++n_lb;
  }
  T* so = state_out + (size_t)b * 6 * N + i;
  so[0] = cpos;
  so[N] = cneg;
  so[2 * N] = prev;
  so[3 * N] = szz;
  so[4 * N] = sz2;
  so[5 * N] = nef;
  int32_t* co = counts + (size_t)b * 3 * N + i;
  co[0] = n_an;
  co[N] = n_cp;
  co[2 * N] = n_lb;
}

template <typename T>
int launch_detect(const void* state, const void* zs, const void* mask,
                  const void* armed, void* state_out, void* counts, int B,
                  int k, int N, double ck, double ch, double lam, double warm,
                  double qbar, double abar, double tiny, void* stream) {
  const int total = B * N;
  if (total == 0) return 0;
  const int blocks = (total + kThreads - 1) / kThreads;
  detect_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)state, (const T*)zs, (const uint8_t*)mask,
      (const uint8_t*)armed, (T*)state_out, (int32_t*)counts, B, k, N, ck, ch,
      lam, warm, qbar, abar, tiny);
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
