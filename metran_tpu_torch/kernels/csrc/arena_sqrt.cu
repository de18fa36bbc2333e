// K16 (square-root family): the exact arena update through K9's body,
// one thread block per dispatched row — gather, the QR array step body
// (ungated, gated or robust), the integrity gate, the detection tail and
// the masked in-place scatter in one launch.
//
// Replaces the JAX package's B13, metran_tpu/serve/engine.py::
// make_arena_update_fn (:1042, with _arena_posterior_ok :996) on the
// "sqrt" engine: mode 0 the plain factored update (sqrt_filter_append),
// modes 1-3 the gate (reject/huber/inflate; detection on an ungated
// registry runs mode 1 never armed, as the JAX package does), modes 4-6
// the robust likelihoods.  Block b reads rows[b] and loads the row's
// constants into K9's shared layout — z and r as they are, phi, and
// sqrt(max(q_aa, 0)) off the diagonal of the resident q — with the
// row's mean and factor as the carry, then runs sqrtk::run_steps
// (sqrt_step.cuh: K9's time loop, the same operations in the same
// order); arenak::commit_block (arena_commit.cuh) then gates (a finite
// factor with a finite F F'), flags convergence, runs K13's recursion
// when det is given, and scatters; in the horizons mode (fmeans given)
// arenak::horizons_tail then forms F F' of the written factor and writes
// the row's forecast moments at the horizon set.
//
// What bounds it on an H100: latency, as K9 — n + (m_o + n) Householder
// stages of one barrier each per step.  Only the row's leaves, the
// observations and the per-step outputs touch device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "arena_commit.cuh"
#include "sqrt_step.cuh"

namespace {

using sqrtk::kThreads;

template <typename T, int kGate, bool kHz>
__global__ void __launch_bounds__(kThreads)
arena_sqrt_kernel(arenak::UpdateArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.N, n = a.S;
  const int nn = n * n;
  sqrtk::Smem<T> s;
  const size_t used = sqrtk::carve<T>(smem_raw, N, n, &s);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int row = a.rows[b];
  const int t_row = a.t_seen[row];
  // the row's constants in K9's layout: zs[i * n + a] = z[row, i, a]
  for (int idx = tid; idx < N * n; idx += kThreads)
    s.zs[idx] = a.z[(size_t)row * N * n + idx];
  for (int i = tid; i < N; i += kThreads) s.rr[i] = a.r[(size_t)row * N + i];
  for (int j = tid; j < n; j += kThreads) {
    s.ph[j] = a.phi[(size_t)row * n + j];
    const T qa = a.q[(size_t)row * nn + (size_t)j * n + j];
    s.qs[j] = sqrt(qa > T(0) ? qa : T(0));
    s.m[j] = a.mean[(size_t)row * n + j];
  }
  for (int idx = tid; idx < nn; idx += kThreads)
    s.S[idx] = a.fac[(size_t)row * nn + idx];
  __syncthreads();
  const bool arm = kGate != sqrtk::kNoGate && t_row >= a.min_seen;
  const sqrtk::RobustArgs<T> rob = {a.rail_lo, a.rail_hi,     a.quantum,
                                    a.scale,   a.nu,          a.tol,
                                    a.nonconv_tol, a.c_floor, a.eps,
                                    a.iters};
  sqrtk::run_steps<T, false, false, kGate>(
      s, a.y + (size_t)b * a.k * N, a.mask + (size_t)b * a.k * N, arm,
      a.thresh, nullptr, nullptr, nullptr, nullptr, a.sigma, a.detf, nullptr,
      nullptr, a.zscore, a.verdict, rob, b, a.k, N, n, 1);
  T* W = reinterpret_cast<T*>(smem_raw + arenak::align16(used));
  const bool ok = arenak::commit_block<T, true>(a, s.m, s.S, b, row, t_row,
                                                W, W + (size_t)nn);
  if (kHz)
    arenak::horizons_tail<T, true>(a, s.m, s.S, ok, b, row,
                                   reinterpret_cast<unsigned char*>(W));
}

template <typename T>
int launch_arena_sqrt(const arenak::UpdateArgs<T>& a, int mode, int G,
                      void* stream) {
  // the detection tail reads real z-scores: an ungated registry runs
  // mode 1 with the gate never armed
  if (mode == 0 && a.det != nullptr) return (int)cudaErrorInvalidValue;
  const bool hz = a.fmeans != nullptr;
  const size_t smem =
      arenak::align16(sqrtk::carve<T>(nullptr, a.N, a.S, nullptr)) +
      arenak::after_body_smem<T>(a.N, a.S, kThreads, hz, true);
#define METRAN_ARENA_SQRT(G_)                                               \
  return hz ? arenak::launch_rows<T>(arena_sqrt_kernel<T, G_, true>, a, G,  \
                                     kThreads, smem, stream)                \
            : arenak::launch_rows<T>(arena_sqrt_kernel<T, G_, false>, a, G, \
                                     kThreads, smem, stream)
  switch (mode) {
    case sqrtk::kNoGate: METRAN_ARENA_SQRT(sqrtk::kNoGate);
    case sqrtk::kReject: METRAN_ARENA_SQRT(sqrtk::kReject);
    case sqrtk::kHuber: METRAN_ARENA_SQRT(sqrtk::kHuber);
    case sqrtk::kInflate: METRAN_ARENA_SQRT(sqrtk::kInflate);
    case sqrtk::kRobust + imap::kCensored:
      METRAN_ARENA_SQRT(sqrtk::kRobust + imap::kCensored);
    case sqrtk::kRobust + imap::kQuantized:
      METRAN_ARENA_SQRT(sqrtk::kRobust + imap::kQuantized);
    case sqrtk::kRobust + imap::kHuberT:
      METRAN_ARENA_SQRT(sqrtk::kRobust + imap::kHuberT);
    default: return (int)cudaErrorInvalidValue;
  }
#undef METRAN_ARENA_SQRT
}

}  // namespace

extern "C" {

// mode: 0 ungated, 1 reject, 2 huber, 3 inflate (thresh = nsigma^2),
// 4 + the robust likelihood (nu, tol, nonconv_tol, c_floor, eps and the
// (G, N) rail_lo, rail_hi, quantum, scale); zscore and verdict are
// written by every gated and robust mode, iters by the robust ones
int metran_arena_sqrt_f32(METRAN_ARENA_UPDATE_PARAMS) {
  return launch_arena_sqrt<float>(METRAN_ARENA_UPDATE_ARGS(float), mode, G,
                                  stream);
}

int metran_arena_sqrt_f64(METRAN_ARENA_UPDATE_PARAMS) {
  return launch_arena_sqrt<double>(METRAN_ARENA_UPDATE_ARGS(double), mode, G,
                                   stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
