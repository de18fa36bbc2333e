// K17: the arena steady (frozen-gain) update, one warp per dispatched row
// — gather, K14's mean-only step body, the applied selection, the
// detection tail and the masked in-place mean scatter in one launch.
//
// Replaces the JAX package's B13 steady half, metran_tpu/serve/
// engine.py::make_arena_steady_update_fn (:1337).  Warp b reads rows[b]
// and runs steadyk::filter_warp (steady_step.cuh: K14's body, the same
// operations in the same order, vector or per-slot form) from that row's
// mean, phi, z, frozen gain and innovation variances, with the gate armed
// by the resident t_seen against min_seen.  The row is applied when its
// resident steady flag is set and nothing broke time-invariance (a mask
// that differs from the real slots, a reject/inflate hit, a non-finite
// mean); only then is its mean written back and t_seen += k, version +=
// 1.  The factor leaf is never touched: frozen means frozen.  With det
// given, K13's recursion runs over the z-scores for the applied rows;
// the others keep their detector state bit for bit and book zero counts
// (they replay through the exact update, which accumulates them once).
// In the horizons mode (fmeans given; a template parameter) the warp
// then writes the mean half of the row's commit-time horizon pass from
// the written mean (an unapplied row's prior), horizonk::means_warp
// (horizon_step.cuh, shared with K14), as the JAX
// make_arena_steady_update_fn (:1420) appends it; the variance half is
// the constant the service caches at freeze.
//
// What bounds it on an H100: bytes, as K14 — Z and the gain (2 S N
// words) per row, a few dependent dot products per step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "detect_step.cuh"
#include "horizon_step.cuh"
#include "steady_step.cuh"

namespace {

using steadyk::kWarp;

template <typename T>
struct SteadyArgs {
  T* mean;             // (B, S)
  int32_t* t_seen;     // (B,)
  int32_t* version;    // (B,)
  const T *phi, *z;    // (B, S), (B, N, S)
  const uint8_t* steady;  // (B,)
  const T *kgain, *fdiag;  // (B, S, N), (B, N)
  T* det;              // (B, 6, N), or null: detection off
  const int32_t* rows;    // (G,)
  const uint8_t* real;    // (G, N)
  const T* y;             // (G, k, N)
  const uint8_t* mask;    // (G, k, N)
  uint8_t* applied;       // (G,)
  T *sigma, *detf;        // (G,)
  T* zscore;              // (G, k, N)
  int8_t* verdict;        // (G, k, N)
  int32_t* det_counts;    // (G, 3, N)
  T* det_stats;           // (G, 3, N)
  const T* horizons;      // (H,), read in the horizons mode
  T* fmeans;              // (G, H, N), or null: the horizons mode is off
  double thresh;
  detectk::Params dp;
  int min_seen, det_min_seen, k, N, S, H;
};

template <typename T, int kPolicy, bool kSeq, bool kHz>
__global__ void __launch_bounds__(kWarp)
arena_steady_kernel(SteadyArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const int k = a.k, N = a.N, S = a.S;
  const int row = a.rows[b];
  const int t_row = a.t_seen[row];
  const bool arm = kPolicy != steadyk::kOff && t_row >= a.min_seen;
  const steadyk::Result<T> res = steadyk::filter_warp<T, kPolicy, kSeq>(
      smem_raw, a.phi, a.z, a.kgain, a.fdiag, a.real, a.mean, a.y, a.mask,
      arm, a.thresh, a.zscore, a.verdict, b, row, k, N, S);
  const bool applied = a.steady[row] != 0 && !res.broke;
  __syncwarp();
  if (a.det != nullptr)
    detectk::arena_row<T>(a.det, row, b, a.zscore, a.mask, a.det_counts,
                          a.det_stats, k, N, t_row >= a.det_min_seen,
                          applied, a.dp, lane, kWarp);
  const T* sm = steadyk::smem_mean<T>(smem_raw, N, S);
  if (applied)
    for (int s = lane; s < S; s += kWarp) a.mean[(size_t)row * S + s] = sm[s];
  if (lane == 0) {
    a.sigma[b] = res.sigma;
    a.detf[b] = res.detf;
    a.applied[b] = applied ? 1 : 0;
    if (applied) {
      a.t_seen[row] = t_row + k;
      a.version[row] = a.version[row] + 1;
    }
  }
  if (kHz)  // an unapplied row's mean is the untouched arena row
    horizonk::means_warp<T>(
        a.phi + (size_t)row * S, applied ? sm : a.mean + (size_t)row * S,
        reinterpret_cast<const T*>(smem_raw), a.horizons, a.H,
        reinterpret_cast<T*>(smem_raw) + steadyk::steady_smem<T>(N, S) /
                                             sizeof(T),
        a.fmeans, b, N, S);
}

template <typename T, int kPolicy, bool kSeq, bool kHz>
int launch_mode(const SteadyArgs<T>& a, int G, void* stream) {
  const size_t smem = steadyk::steady_smem<T>(a.N, a.S) +
                      (kHz ? sizeof(T) * horizonk::smem_elems(a.S) : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        arena_steady_kernel<T, kPolicy, kSeq, kHz>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (G == 0) return 0;
  arena_steady_kernel<T, kPolicy, kSeq, kHz>
      <<<G, kWarp, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int kPolicy, bool kSeq>
int launch(const SteadyArgs<T>& a, int G, void* stream) {
  if (a.fmeans != nullptr)
    return launch_mode<T, kPolicy, kSeq, true>(a, G, stream);
  return launch_mode<T, kPolicy, kSeq, false>(a, G, stream);
}

template <typename T>
int dispatch(void* mean, void* t_seen, void* version, const void* phi,
             const void* z, const void* steady, const void* kgain,
             const void* fdiag, void* det, const void* rows,
             const void* real, const void* y, const void* mask,
             void* applied, void* sigma, void* detf, void* zscore,
             void* verdict, void* det_counts, void* det_stats,
             const void* horizons, void* fmeans, double thresh, double ck,
             double ch, double lam, double warm, double qbar, double abar,
             double tiny, int min_seen, int det_min_seen, int policy,
             int sequential, int G, int k, int N, int S, int H,
             void* stream) {
  SteadyArgs<T> a;
  a.mean = (T*)mean;
  a.t_seen = (int32_t*)t_seen;
  a.version = (int32_t*)version;
  a.phi = (const T*)phi;
  a.z = (const T*)z;
  a.steady = (const uint8_t*)steady;
  a.kgain = (const T*)kgain;
  a.fdiag = (const T*)fdiag;
  a.det = (T*)det;
  a.rows = (const int32_t*)rows;
  a.real = (const uint8_t*)real;
  a.y = (const T*)y;
  a.mask = (const uint8_t*)mask;
  a.applied = (uint8_t*)applied;
  a.sigma = (T*)sigma;
  a.detf = (T*)detf;
  a.zscore = (T*)zscore;
  a.verdict = (int8_t*)verdict;
  a.det_counts = (int32_t*)det_counts;
  a.det_stats = (T*)det_stats;
  a.horizons = (const T*)horizons;
  a.fmeans = (T*)fmeans;
  a.thresh = thresh;
  a.dp = detectk::Params{ck, ch, lam, warm, qbar, abar, tiny};
  a.min_seen = min_seen;
  a.det_min_seen = det_min_seen;
  a.k = k;
  a.N = N;
  a.S = S;
  a.H = H;
#define METRAN_ARENA_STEADY(P, Q) return launch<T, P, Q>(a, G, stream)
  if (sequential && policy != steadyk::kOff) {
    switch (policy) {
      case steadyk::kReject: METRAN_ARENA_STEADY(steadyk::kReject, true);
      case steadyk::kHuber: METRAN_ARENA_STEADY(steadyk::kHuber, true);
      case steadyk::kInflate: METRAN_ARENA_STEADY(steadyk::kInflate, true);
    }
  } else {
    switch (policy) {
      case steadyk::kOff: METRAN_ARENA_STEADY(steadyk::kOff, false);
      case steadyk::kReject: METRAN_ARENA_STEADY(steadyk::kReject, false);
      case steadyk::kHuber: METRAN_ARENA_STEADY(steadyk::kHuber, false);
      case steadyk::kInflate: METRAN_ARENA_STEADY(steadyk::kInflate, false);
    }
  }
#undef METRAN_ARENA_STEADY
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// the arena leaves mean, t_seen, version, phi, z, steady, kgain, fdiag,
// det (null: detection off); rows (G,) int32, real (G, N) uint8, y, mask
// (G, k, N); applied (G,) uint8, sigma, detf (G,), zscore, verdict
// (G, k, N), det_counts, det_stats (G, 3, N); horizons (H,) and fmeans
// (G, H, N), fmeans null: the horizons mode off; thresh = nsigma^2, the
// detector's constants; policy 0 off, 1 reject, 2 huber, 3 inflate;
// sequential: the per-slot form (gated policies only)
int metran_arena_steady_f32(
    void* mean, void* t_seen, void* version, const void* phi, const void* z,
    const void* steady, const void* kgain, const void* fdiag, void* det,
    const void* rows, const void* real, const void* y, const void* mask,
    void* applied, void* sigma, void* detf, void* zscore, void* verdict,
    void* det_counts, void* det_stats, const void* horizons, void* fmeans,
    double thresh, double ck, double ch, double lam, double warm,
    double qbar, double abar, double tiny, int min_seen, int det_min_seen,
    int policy, int sequential, int G, int k, int N, int S, int H,
    void* stream) {
  return dispatch<float>(mean, t_seen, version, phi, z, steady, kgain, fdiag,
                         det, rows, real, y, mask, applied, sigma, detf,
                         zscore, verdict, det_counts, det_stats, horizons,
                         fmeans, thresh, ck, ch, lam, warm, qbar, abar, tiny,
                         min_seen, det_min_seen, policy, sequential, G, k, N,
                         S, H, stream);
}

int metran_arena_steady_f64(
    void* mean, void* t_seen, void* version, const void* phi, const void* z,
    const void* steady, const void* kgain, const void* fdiag, void* det,
    const void* rows, const void* real, const void* y, const void* mask,
    void* applied, void* sigma, void* detf, void* zscore, void* verdict,
    void* det_counts, void* det_stats, const void* horizons, void* fmeans,
    double thresh, double ck, double ch, double lam, double warm,
    double qbar, double abar, double tiny, int min_seen, int det_min_seen,
    int policy, int sequential, int G, int k, int N, int S, int H,
    void* stream) {
  return dispatch<double>(mean, t_seen, version, phi, z, steady, kgain,
                          fdiag, det, rows, real, y, mask, applied, sigma,
                          detf, zscore, verdict, det_counts, det_stats,
                          horizons, fmeans, thresh, ck, ch, lam, warm, qbar,
                          abar, tiny, min_seen, det_min_seen, policy,
                          sequential, G, k, N, S, H, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
