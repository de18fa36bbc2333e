// K16 (joint family): the exact arena update on the joint engine, one
// thread block per dispatched row — gather, K1's step body, the
// integrity gate and the masked in-place scatter in one launch.
//
// Replaces the JAX package's B13, metran_tpu/serve/engine.py::
// make_arena_update_fn (:1042, with _arena_posterior_ok :996) where the
// registry's engine is "joint" and neither the gate, detection nor a
// robust likelihood is armed (those run the sequential body,
// arena_gated.cu, as the JAX package does).  Block b reads rows[b] and
// runs jointk::filter_block (joint_step.cuh: K1's body, the same
// operations in the same order) straight from that row of the arena
// leaves — mean, covariance, phi, q, z, r — with the dispatch's (k, N)
// observations; arenak::commit_block (arena_commit.cuh) then gates the
// posterior, writes the conv flag when steady_tol > 0, and writes the row
// back only when it passed, bumping t_seen by k and version by 1; in
// the horizons mode (fmeans given; a template parameter) it then writes
// the row's forecast moments at the horizon set (arenak::horizons_tail).
//
// What bounds it on an H100: latency, as K1 — a chain of block barriers
// per step — plus the gate's S-column Cholesky (S barriers).  Device
// memory sees the row's leaves once in, the posterior once out, and no
// gathered copy of any leaf exists.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "arena_commit.cuh"
#include "joint_step.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kHz>
__global__ void __launch_bounds__(kThreads)
arena_joint_kernel(arenak::UpdateArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int row = a.rows[b];
  const int t_row = a.t_seen[row];
  jointk::filter_block<T, jointk::kCarry>(
      smem_raw, a.phi, a.q, a.z, a.r, a.mean, a.fac, a.y, a.mask, a.sigma,
      a.detf, nullptr, nullptr, nullptr, nullptr, b, row, a.k, a.N, a.S, 1);
  const jointk::Smem<T> s = jointk::carve<T>(smem_raw, a.N, a.S);
  T* W = reinterpret_cast<T*>(
      smem_raw + arenak::align16(sizeof(T) * jointk::smem_elems<T>(a.N, a.S)));
  const bool ok = arenak::commit_block<T, false>(a, s.m, s.P, b, row, t_row,
                                                 W, W + (size_t)a.S * a.S);
  if (kHz)
    arenak::horizons_tail<T, false>(a, s.m, s.P, ok, b, row,
                                    reinterpret_cast<unsigned char*>(W));
}

template <typename T>
int launch_arena_joint(const arenak::UpdateArgs<T>& a, int mode, int G,
                       void* stream) {
  if (mode != 0 || a.det != nullptr) return (int)cudaErrorInvalidValue;
  const bool hz = a.fmeans != nullptr;
  const size_t smem =
      arenak::align16(sizeof(T) * jointk::smem_elems<T>(a.N, a.S)) +
      arenak::after_body_smem<T>(a.N, a.S, kThreads, hz, false);
  if (hz)
    return arenak::launch_rows<T>(arena_joint_kernel<T, true>, a, G,
                                  kThreads, smem, stream);
  return arenak::launch_rows<T>(arena_joint_kernel<T, false>, a, G, kThreads,
                                smem, stream);
}

}  // namespace

extern "C" {

// mode must be 0 (the joint update has no gate and no robust modes);
// det must be null (detection runs the sequential family)
int metran_arena_joint_f32(METRAN_ARENA_UPDATE_PARAMS) {
  return launch_arena_joint<float>(METRAN_ARENA_UPDATE_ARGS(float), mode, G,
                                   stream);
}

int metran_arena_joint_f64(METRAN_ARENA_UPDATE_PARAMS) {
  return launch_arena_joint<double>(METRAN_ARENA_UPDATE_ARGS(double), mode,
                                    G, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
