// K16 (sequential family): the exact arena update through K12's body,
// one thread block per dispatched row — gather, the gated (or robust)
// sequential step body, the integrity gate, the detection tail and the
// masked in-place scatter in one launch.
//
// Replaces the JAX package's B13, metran_tpu/serve/engine.py::
// make_arena_update_fn (:1042, with _arena_posterior_ok :996), on the
// covariance engines wherever the joint body does not apply: the
// "sequential" engine (the gate off: mode 0), an armed gate on either
// covariance engine (modes 1-3, reject/huber/inflate), detection on an
// ungated registry (mode 1 with the gate never armed, as the JAX package
// runs it: real z-scores, the plain update's posterior), and the robust
// likelihoods (modes 4-6: censored, quantized, huber_t).  Block b reads
// rows[b], computes the row's armed flag from the resident t_seen
// against min_seen, and runs gatedk::filter_block (gated_step.cuh: K12's
// body, the same operations in the same order) straight from the row's
// leaves; arenak::commit_block (arena_commit.cuh) then gates, flags
// convergence, runs K13's recursion over the z-scores when det is given,
// and scatters; in the horizons mode (fmeans given) arenak::horizons_tail
// then writes the row's forecast moments at the horizon set.
//
// What bounds it on an H100: latency, as K12 — N dependent rank-1
// updates of four block barriers each per step, the robust modes' serial
// Newton solves between them — plus the gate's S-column Cholesky.  Only
// the row's leaves, the observations and the (G, k, N) per-slot outputs
// touch device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "arena_commit.cuh"
#include "gated_step.cuh"

namespace {

using gatedk::kThreads;

template <typename T, int kPolicy, bool kHz>
__global__ void __launch_bounds__(kThreads)
arena_gated_kernel(arenak::UpdateArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int row = a.rows[b];
  const int t_row = a.t_seen[row];
  const bool armed_b = kPolicy != gatedk::kOff && t_row >= a.min_seen;
  const gatedk::RobustArgs<T> rob = {a.rail_lo, a.rail_hi, a.quantum,
                                     a.scale,   a.nu,      a.tol,
                                     a.nonconv_tol, a.c_floor, a.iters};
  gatedk::filter_block<T, kPolicy>(smem_raw, a.phi, a.q, a.z, a.r, a.mean,
                                   a.fac, a.y, a.mask, armed_b, a.thresh,
                                   a.sigma, a.detf, a.zscore, a.verdict, rob,
                                   b, row, a.k, a.N, a.S);
  const gatedk::Smem<T> s = gatedk::carve<T>(smem_raw, a.N, a.S);
  T* W = reinterpret_cast<T*>(
      smem_raw + arenak::align16(sizeof(T) * gatedk::smem_elems<T>(a.N, a.S)));
  const bool ok = arenak::commit_block<T, false>(a, s.m, s.P, b, row, t_row,
                                                 W, W + (size_t)a.S * a.S);
  if (kHz)
    arenak::horizons_tail<T, false>(a, s.m, s.P, ok, b, row,
                                    reinterpret_cast<unsigned char*>(W));
}

template <typename T>
int launch_arena_gated(const arenak::UpdateArgs<T>& a, int mode, int G,
                       void* stream) {
  // the detection tail reads real z-scores: an ungated registry runs
  // mode 1 with the gate never armed
  if (mode == 0 && a.det != nullptr) return (int)cudaErrorInvalidValue;
  const bool hz = a.fmeans != nullptr;
  const size_t smem =
      arenak::align16(sizeof(T) * gatedk::smem_elems<T>(a.N, a.S)) +
      arenak::after_body_smem<T>(a.N, a.S, kThreads, hz, false);
#define METRAN_ARENA_GATED(P)                                              \
  return hz ? arenak::launch_rows<T>(arena_gated_kernel<T, P, true>, a, G, \
                                     kThreads, smem, stream)               \
            : arenak::launch_rows<T>(arena_gated_kernel<T, P, false>, a,   \
                                     G, kThreads, smem, stream)
  switch (mode) {
    case gatedk::kOff: METRAN_ARENA_GATED(gatedk::kOff);
    case gatedk::kReject: METRAN_ARENA_GATED(gatedk::kReject);
    case gatedk::kHuber: METRAN_ARENA_GATED(gatedk::kHuber);
    case gatedk::kInflate: METRAN_ARENA_GATED(gatedk::kInflate);
    case gatedk::kRobust + imap::kCensored:
      METRAN_ARENA_GATED(gatedk::kRobust + imap::kCensored);
    case gatedk::kRobust + imap::kQuantized:
      METRAN_ARENA_GATED(gatedk::kRobust + imap::kQuantized);
    case gatedk::kRobust + imap::kHuberT:
      METRAN_ARENA_GATED(gatedk::kRobust + imap::kHuberT);
    default: return (int)cudaErrorInvalidValue;
  }
#undef METRAN_ARENA_GATED
}

}  // namespace

extern "C" {

// mode: 0 off, 1 reject, 2 huber, 3 inflate (thresh = nsigma^2), 4 + the
// robust likelihood (0 censored, 1 quantized, 2 huber_t; nu, tol,
// nonconv_tol, c_floor and the (G, N) rail_lo, rail_hi, quantum, scale);
// zscore and verdict are always written, iters in the robust modes
int metran_arena_gated_f32(METRAN_ARENA_UPDATE_PARAMS) {
  return launch_arena_gated<float>(METRAN_ARENA_UPDATE_ARGS(float), mode, G,
                                   stream);
}

int metran_arena_gated_f64(METRAN_ARENA_UPDATE_PARAMS) {
  return launch_arena_gated<double>(METRAN_ARENA_UPDATE_ARGS(double), mode,
                                    G, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
