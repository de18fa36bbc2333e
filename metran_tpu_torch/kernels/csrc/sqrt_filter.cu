// K9: the square-root (QR array) Kalman filter, a group of warps per lane.
//
// Replaces the JAX package's device program B6 in metran_tpu/ops/kalman.py
// (_sqrt_kalman_filter, _make_sqrt_core_step, _sqrt_qr_update, _tria: the
// engine="sqrt" filter) and the ported half of B9b (sqrt_filter_append, the
// factored serving update).  Per lane and step, carrying the mean m and a
// factor S of the state covariance (P = S S'):
//   predict   m_p = phi o m,  S_p = tria([phi o S | diag(sqrt q)])
//             (QR of the 2n x n transpose; S need not be triangular);
//   update    QR of the pre-array over the step's observed slots only,
//               [[ diag(sqrt r_o)      0   ]
//                [ (Z_o S_p)'        S_p'  ]],
//             whose triangular result holds F^1/2 (upper), Kbar' and S_f';
//             w = F^-1/2' \ v, m_f = m_p + Kbar w, sigma = w.w,
//             detf = 2 sum log diag F^1/2.
// Every factor is sign-normalised to a non-negative diagonal (the unique
// Cholesky factor where it has full rank), so it is held entrywise against
// the plain version.  No Cholesky of a matrix the kernel formed is taken:
// orthogonal transformations only (csrc/sqrt_qr.cuh).
//
// A masked slot's row of the JAX pre-array is e_i and its column is zero
// below the diagonal, so no reflector touches it and its F^1/2 diagonal is
// exactly 1 (log 1 = 0, w_i = 0): the kernel triangularises the m_o + n
// columns of the observed slots and skips the rest, exactly.  A step with
// no observed slot is predict-only (S_f = S_p).  `ok` is the JAX rule:
// every diagonal of F^1/2 > 0 and every entry of the triangular result
// finite (an observed slot with r < 0 gives sqrt(r) = NaN and fails it);
// when it fails the step passes through: m_f = m_p, S_f = S_p, sigma = 0,
// detf = +inf.
//
// The instantiations (template parameters, not a run-time branch):
//   kStore  per step (m_p, S_p, m_f, S_f, sigma, detf): (L, T, n),
//           (L, T, n, n) twice, then (L, T) twice — what the factored
//           smoother K10 reads;
//   carry   per step sigma, detf (L, T) and the final (m, S) (L, n),
//           (L, n, n), from (0, I) or from a given (mean0, chol0) per lane
//           — the deviance, the serving history pass and
//           sqrt_filter_append;
//   kBounds the carry outputs, and the carry (m, S) at the start of every
//           segment of `seg` steps, (L, n_seg, n) and (L, n_seg, n, n): the
//           forward of the batch-layout adjoint
//           (metran_tpu/ops/adjoint.py::_run_segments, engine="sqrt"),
//           whose backward (K11) replays each segment from S S'.  The
//           stores read the carry before the step touches it, so the
//           arithmetic is the carry instantiation's, bit for bit.
//   kGate   the carry outputs from a given carry, each observed slot's
//           marginal innovation tested against an observation gate first
//           (metran_tpu/ops/kalman.py::_make_gated_sqrt_core_step behind
//           gated_sqrt_filter_append, B9b gated): f_i = |(Z S_p)_i|^2 +
//           r_i, z_i = v_i / sqrt(f_i), hit = armed && z_i^2 > t; then the
//           policy pre-transforms the slot's row and the SAME QR update
//           runs — reject drops the slot from the step's observed list,
//           huber scales v_i by sqrt(t) / |z_i|, inflate adds
//           v_i^2 / t - f_i to its r_i.  A slot that does not trip feeds
//           the update exactly the row the ungated instantiation builds,
//           so a step where nothing trips is the given-carry carry
//           instantiation's, bit for bit.  Per step and slot it also
//           writes z_i (NaN where unobserved) and an int8 verdict (2
//           rejected, 1 downweighted, 0 pass), (L, T, N) each.
//   kRobust the gate's outputs from a given carry, one instantiation per
//           likelihood (kRobust + its code in implicit_map.cuh: censored,
//           quantized, huber_t; metran_tpu/ops/implicit_map.py::
//           _make_robust_sqrt_core_step :358 behind
//           implicit_map_sqrt_filter_append, B12's square-root half): an
//           armed observed slot that flags (censored: y_i at or beyond a
//           rail; the others: every reading) solves its scalar MAP
//           problem off the predicted marginal, mu = Z_i m_p and
//           c_i = |(Z S_p)_i|^2 floored at sqrt(tiny), one thread per
//           observed slot, and feeds the SAME QR
//           update its pseudo-observation r_eff = 1 / max(w, 0.01 eps /
//           c_i), v_eff = (c_i + r_eff)(s_hat - mu) / c_i in place of
//           (r_i, v_i); a slot that does not flag keeps its row, so a step
//           where nothing flags is the given-carry carry instantiation's,
//           bit for bit.  Verdicts 3 (MAP) or 4 (the solve missed its
//           residual bar) and the Newton steps, (L, T, N) int32, beside
//           the z-scores.
// The deviance is summed by the caller (deviance_terms), not here: a
// serial float32 sum over thousands of steps would cost about as much as
// the engine's whole f32 precision bar.
//
// Inputs: the lane constants with the lane axis last, phi, q (n, L),
// z (N, n, L), r (N, L); the data (D, T, N) read through lane_map (L,);
// the robust modes' per-slot parameters rail_lo, rail_hi, quantum, scale
// (L, N).
//
// What bounds it on an H100: latency.  A step is a chain of
// n + (m_o + n) Householder stages, one barrier each, plus a few barriers
// for the products; a stage's work is one column norm and one dot product
// and update per trailing column.  The design keeps one lane's constants,
// carry and both work arrays in shared memory with the time loop inside
// the kernel, so one pass is one launch and device memory is touched only
// to read each step's data and write its outputs once.  The robust modes
// add one serial Newton solve per flagged slot, the slots' solves running
// side by side on their own threads before the QR.
//
// The kernel: G warps per lane (sqrt_warp_step.cuh) on a named barrier of
// their own, G = 4 while the card holds every such group at once (CUDA's
// occupancy calculator, metran_sqrt_filter_occupancy_*), else G = 2, W
// lanes a block (the wrapper's launch_shape): no block-wide barrier in the
// time loop, a column a thread in each Householder stage with the next
// reflector formed a stage ahead, the predict QR's zero rows and Z's zeros
// skipped, the forward substitution beside the update QR.  The earlier
// kernel of one block per lane (sqrt_step.cuh) computes the same bits and
// stays beside it as its oracle, in sqrt_filter_block.cu.

#include "sqrt_warp_step.cuh"

namespace {

using sqrtk::kHuber;
using sqrtk::kInflate;
using sqrtk::kNoGate;
using sqrtk::kReject;
using sqrtk::kRobust;
using sqrtk::RobustArgs;

// The group kernel: the kG warps of group w of block x run lane x * W + w
// (W = blockDim.x / (32 kG)) on their own carve of the block's shared
// memory, at named barrier 1 + w.  A group past the last lane returns at
// once (nothing in the kernel is block-wide).
// (two-warp groups, the launch past residency, are held to the registers
// that keep three full blocks an SM: the time is the card's throughput)
template <typename T, bool kStore, bool kBounds, int kGate, int kG>
__global__ void __launch_bounds__(sqrtw::kLanes * sqrtw::kMaxWarps,
                                  kG == sqrtw::kMinGroup ? 3 : 1)
sqrt_filter_group_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                         const T* __restrict__ z, const T* __restrict__ r,
                         const T* __restrict__ y,
                         const uint8_t* __restrict__ mask,
                         const int* __restrict__ lane_map,
                         const T* __restrict__ mean0,
                         const T* __restrict__ chol0,
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
  constexpr int nt = sqrtw::kLanes * kG;
  const int group = threadIdx.x / nt;
  const int l = blockIdx.x * (blockDim.x / nt) + group;
  if (l >= L) return;
  unsigned char* own = smem_raw + group * sqrtw::model_bytes<T>(N, n);
  sqrtw::Smem<T> s;
  sqrtw::layout<T>(own, N, n, &s);
  const int tid = threadIdx.x % nt;
  const sqrtw::Group<kG> g{tid, 1 + group};
  const int nn = n * n;
  const bool arm = kGate != kNoGate && armed[l] != 0;  // gate or robust

  for (int idx = tid; idx < N * n; idx += nt)
    s.zs[idx] = z[(size_t)idx * L + l];  // z[i, a, l], idx = i * n + a
  for (int i = tid; i < N; i += nt) s.rr[i] = r[(size_t)i * L + l];
  for (int a = tid; a < n; a += nt) {
    s.ph[a] = phi[(size_t)a * L + l];
    const T qa = q[(size_t)a * L + l];
    s.qs[a] = sqrt(qa > T(0) ? qa : T(0));
    s.m[a] = mean0 ? mean0[(size_t)l * n + a] : T(0);
  }
  for (int idx = tid; idx < nn; idx += nt)
    s.S[idx] = chol0 ? chol0[(size_t)l * nn + idx]
                     : (idx / n == idx % n ? T(1) : T(0));
  g.sync();

  const int dl = lane_map[l];
  sqrtw::run_group<T, kStore, kBounds, kGate, kG>(
      s, g, y + (size_t)dl * t_steps * N, mask + (size_t)dl * t_steps * N,
      arm, thresh_d, o_mean_p, o_chol_p, o_mean_f, o_chol_f, o_sigma,
      o_detf, o_bounds_mean, o_bounds_chol, o_z, o_verdict, rob, l, t_steps,
      N, n, seg);
  if (!kStore) {
    for (int a = tid; a < n; a += nt) o_mean_f[(size_t)l * n + a] = s.m[a];
    for (int idx = tid; idx < nn; idx += nt)
      o_chol_f[(size_t)l * nn + idx] = s.S[idx];
  }
}

// the group kernel with W lanes a block and kG warps a lane
template <typename T, bool kStore, bool kBounds, int kGate, int kG>
int launch_group(const void* phi, const void* q, const void* z,
                 const void* r, const void* y, const void* mask,
                 const void* lane_map, const void* mean0, const void* chol0,
                 void* out0, void* out1, void* out2, void* out3, void* out4,
                 void* out5, void* bounds_mean, void* bounds_chol,
                 const void* armed, double thresh, void* o_z,
                 void* o_verdict, RobustArgs<T> rob, int L, int t_steps,
                 int N, int n, int seg, int W, void* stream) {
  const size_t smem = (size_t)W * sqrtw::model_bytes<T>(N, n);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sqrt_filter_group_kernel<T, kStore, kBounds, kGate, kG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      (void)cudaGetLastError();  // not left for the next launch to report
      return (int)e;
    }
  }
  if (L == 0) return 0;
  sqrt_filter_group_kernel<T, kStore, kBounds, kGate, kG>
      <<<(L + W - 1) / W, W * kG * sqrtw::kLanes, smem,
         (cudaStream_t)stream>>>(
          (const T*)phi, (const T*)q, (const T*)z, (const T*)r, (const T*)y,
          (const uint8_t*)mask, (const int*)lane_map, (const T*)mean0,
          (const T*)chol0, (T*)out0, (T*)out1, (T*)out2, (T*)out3, (T*)out4,
          (T*)out5, (T*)bounds_mean, (T*)bounds_chol, (const uint8_t*)armed,
          thresh, (T*)o_z, (int8_t*)o_verdict, rob, L, t_steps, N, n, seg);
  return (int)cudaGetLastError();
}

// blocks of the group kernel resident per SM with W lanes a block and kG
// warps a lane (CUDA's occupancy calculator)
template <typename T, bool kStore, bool kBounds, int kGate, int kG>
int occupancy_of(int N, int n, int W, int* blocks) {
  const size_t smem = (size_t)W * sqrtw::model_bytes<T>(N, n);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sqrt_filter_group_kernel<T, kStore, kBounds, kGate, kG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      (void)cudaGetLastError();  // not left for the next launch to report
      return (int)e;
    }
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sqrt_filter_group_kernel<T, kStore, kBounds, kGate, kG>,
      W * kG * sqrtw::kLanes, smem);
}

// One instantiation, launched (blocks null) or asked its occupancy, with W
// lanes a block and G warps a lane (sqrtw::kMinGroup or sqrtw::kMaxGroup,
// W * G <= sqrtw::kMaxWarps)
template <typename T, bool kStore, bool kBounds, int kGate>
int run(const void* phi, const void* q, const void* z, const void* r,
        const void* y, const void* mask, const void* lane_map,
        const void* mean0, const void* chol0, void* out0, void* out1,
        void* out2, void* out3, void* out4, void* out5, void* bounds_mean,
        void* bounds_chol, const void* armed, double thresh, void* o_z,
        void* o_verdict, RobustArgs<T> rob, int L, int t_steps, int N, int n,
        int seg, int W, int G, int* blocks, void* stream) {
  if (W < 1 || W * G > sqrtw::kMaxWarps) return (int)cudaErrorInvalidValue;
#define METRAN_SQRT_GROUP(KG)                                                \
  return blocks != nullptr                                                   \
             ? occupancy_of<T, kStore, kBounds, kGate, KG>(N, n, W, blocks)  \
             : launch_group<T, kStore, kBounds, kGate, KG>(                  \
                   phi, q, z, r, y, mask, lane_map, mean0, chol0, out0,      \
                   out1, out2, out3, out4, out5, bounds_mean, bounds_chol,   \
                   armed, thresh, o_z, o_verdict, rob, L, t_steps, N, n,     \
                   seg, W, stream)
  if (G == sqrtw::kMinGroup) METRAN_SQRT_GROUP(sqrtw::kMinGroup);
  if (G == sqrtw::kMaxGroup) METRAN_SQRT_GROUP(sqrtw::kMaxGroup);
#undef METRAN_SQRT_GROUP
  return (int)cudaErrorInvalidValue;
}

// store and bounds exclude each other; bounds_mean null: no boundaries
template <typename T>
int launch_sqrt_filter(const void* phi, const void* q, const void* z,
                       const void* r, const void* y, const void* mask,
                       const void* lane_map, const void* mean0,
                       const void* chol0, void* out0, void* out1, void* out2,
                       void* out3, void* out4, void* out5, void* bounds_mean,
                       void* bounds_chol, int L, int t_steps, int N, int n,
                       int store, int seg, int W, int G, void* stream) {
  if (store && bounds_mean != nullptr) return (int)cudaErrorInvalidValue;
  const RobustArgs<T> none = {};
  if (store)
    return run<T, true, false, kNoGate>(
        phi, q, z, r, y, mask, lane_map, mean0, chol0, out0, out1, out2,
        out3, out4, out5, nullptr, nullptr, nullptr, 0.0, nullptr, nullptr,
        none, L, t_steps, N, n, 1, W, G, nullptr, stream);
  if (bounds_mean != nullptr) {
    if (seg < 1) return (int)cudaErrorInvalidValue;
    return run<T, false, true, kNoGate>(
        phi, q, z, r, y, mask, lane_map, mean0, chol0, out0, out1, out2,
        out3, out4, out5, bounds_mean, bounds_chol, nullptr, 0.0, nullptr,
        nullptr, none, L, t_steps, N, n, seg, W, G, nullptr, stream);
  }
  return run<T, false, false, kNoGate>(
      phi, q, z, r, y, mask, lane_map, mean0, chol0, out0, out1, out2, out3,
      out4, out5, nullptr, nullptr, nullptr, 0.0, nullptr, nullptr, none, L,
      t_steps, N, n, 1, W, G, nullptr, stream);
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
                             int n, int policy, int W, int G, void* stream) {
  if (mean0 == nullptr || chol0 == nullptr) return (int)cudaErrorInvalidValue;
  const RobustArgs<T> none = {};
#define METRAN_SQRT_GATED(GATE)                                             \
  return run<T, false, false, GATE>(                                        \
      phi, q, z, r, y, mask, lane_map, mean0, chol0, nullptr, nullptr, mean, \
      chol, sigma, detf, nullptr, nullptr, armed, thresh, o_z, o_verdict,    \
      none, L, t_steps, N, n, 1, W, G, nullptr, stream)
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
    void* o_iters, int L, int t_steps, int N, int n, int likelihood, int W,
    int G, void* stream) {
  if (mean0 == nullptr || chol0 == nullptr) return (int)cudaErrorInvalidValue;
  const RobustArgs<T> rob = {(const T*)rail_lo, (const T*)rail_hi,
                             (const T*)quantum, (const T*)scale, nu, tol,
                             nonconv_tol, c_floor, eps, (int*)o_iters};
#define METRAN_SQRT_ROBUST(LIK)                                             \
  return run<T, false, false, kRobust + LIK>(                               \
      phi, q, z, r, y, mask, lane_map, mean0, chol0, nullptr, nullptr, mean, \
      chol, sigma, detf, nullptr, nullptr, armed, 0.0, o_z, o_verdict, rob,  \
      L, t_steps, N, n, 1, W, G, nullptr, stream)
  switch (likelihood) {
    case imap::kCensored: METRAN_SQRT_ROBUST(imap::kCensored);
    case imap::kQuantized: METRAN_SQRT_ROBUST(imap::kQuantized);
    case imap::kHuberT: METRAN_SQRT_ROBUST(imap::kHuberT);
    default: return (int)cudaErrorInvalidValue;
  }
#undef METRAN_SQRT_ROBUST
}

// variant: 0 carry, 1 bounds, 2 store, then the gate's policies (kReject,
// kHuber, kInflate: 3, 4, 5) and the robust likelihoods (6, 7, 8)
template <typename T>
int occupancy(int N, int n, int variant, int W, int G, int* blocks) {
  const RobustArgs<T> none = {};
#define METRAN_SQRT_OCC(STORE, BOUNDS, GATE)                                 \
  return run<T, STORE, BOUNDS, GATE>(                                        \
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, \
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, \
      nullptr, nullptr, 0.0, nullptr, nullptr, none, 0, 0, N, n, 1, W, G,     \
      blocks, nullptr)
  switch (variant) {
    case 0: METRAN_SQRT_OCC(false, false, kNoGate);
    case 1: METRAN_SQRT_OCC(false, true, kNoGate);
    case 2: METRAN_SQRT_OCC(true, false, kNoGate);
    case 3: METRAN_SQRT_OCC(false, false, kReject);
    case 4: METRAN_SQRT_OCC(false, false, kHuber);
    case 5: METRAN_SQRT_OCC(false, false, kInflate);
    case 6: METRAN_SQRT_OCC(false, false, kRobust + imap::kCensored);
    case 7: METRAN_SQRT_OCC(false, false, kRobust + imap::kQuantized);
    case 8: METRAN_SQRT_OCC(false, false, kRobust + imap::kHuberT);
    default: return (int)cudaErrorInvalidValue;
  }
#undef METRAN_SQRT_OCC
}

}  // namespace

extern "C" {

// The group kernel: W lanes a block, G warps a lane (sqrtw::kMinGroup or
// sqrtw::kMaxGroup, W * G <= sqrtw::kMaxWarps).
// out0..out5: (mean_p, chol_p, mean_f, chol_f, sigma, detf) with store;
// without, out0/out1 are unused and out2/out3 receive the final (m, S).
// bounds_mean/bounds_chol, when not null (never with store), receive the
// carry at the start of every segment of seg steps.
// mean0/chol0 may be null: the carry then starts from (0, I).
int metran_sqrt_filter_f32(const void* phi, const void* q, const void* z,
                           const void* r, const void* y, const void* mask,
                           const void* lane_map, const void* mean0,
                           const void* chol0, void* out0, void* out1,
                           void* out2, void* out3, void* out4, void* out5,
                           void* bounds_mean, void* bounds_chol, int L,
                           int t_steps, int N, int n, int store, int seg,
                           int W, int G, void* stream) {
  return launch_sqrt_filter<float>(phi, q, z, r, y, mask, lane_map, mean0,
                                   chol0, out0, out1, out2, out3, out4, out5,
                                   bounds_mean, bounds_chol, L, t_steps, N, n,
                                   store, seg, W, G, stream);
}

int metran_sqrt_filter_f64(const void* phi, const void* q, const void* z,
                           const void* r, const void* y, const void* mask,
                           const void* lane_map, const void* mean0,
                           const void* chol0, void* out0, void* out1,
                           void* out2, void* out3, void* out4, void* out5,
                           void* bounds_mean, void* bounds_chol, int L,
                           int t_steps, int N, int n, int store, int seg,
                           int W, int G, void* stream) {
  return launch_sqrt_filter<double>(phi, q, z, r, y, mask, lane_map, mean0,
                                    chol0, out0, out1, out2, out3, out4, out5,
                                    bounds_mean, bounds_chol, L, t_steps, N, n,
                                    store, seg, W, G, stream);
}

// policy: 1 reject, 2 huber, 3 inflate; thresh = nsigma^2; armed (L,)
// uint8; zscore (L, T, N), verdict (L, T, N) int8
int metran_sqrt_filter_gated_f32(const void* phi, const void* q,
                                 const void* z, const void* r, const void* y,
                                 const void* mask, const void* lane_map,
                                 const void* mean0, const void* chol0,
                                 const void* armed, double thresh, void* mean,
                                 void* chol, void* sigma, void* detf,
                                 void* o_z, void* o_verdict, int L,
                                 int t_steps, int N, int n, int policy, int W,
                                 int G, void* stream) {
  return launch_sqrt_filter_gated<float>(
      phi, q, z, r, y, mask, lane_map, mean0, chol0, armed, thresh, mean,
      chol, sigma, detf, o_z, o_verdict, L, t_steps, N, n, policy, W, G,
      stream);
}

int metran_sqrt_filter_gated_f64(const void* phi, const void* q,
                                 const void* z, const void* r, const void* y,
                                 const void* mask, const void* lane_map,
                                 const void* mean0, const void* chol0,
                                 const void* armed, double thresh, void* mean,
                                 void* chol, void* sigma, void* detf,
                                 void* o_z, void* o_verdict, int L,
                                 int t_steps, int N, int n, int policy, int W,
                                 int G, void* stream) {
  return launch_sqrt_filter_gated<double>(
      phi, q, z, r, y, mask, lane_map, mean0, chol0, armed, thresh, mean,
      chol, sigma, detf, o_z, o_verdict, L, t_steps, N, n, policy, W, G,
      stream);
}

// likelihood: 0 censored, 1 quantized, 2 huber_t; armed (L,) uint8;
// rail_lo, rail_hi, quantum, scale (L, N); tol, nonconv_tol: the solve's
// residual bars; c_floor: the floor of a slot's prior variance; eps: the
// type's epsilon (the pseudo-noise floor); zscore (L, T, N), verdict
// (L, T, N) int8, iters (L, T, N) int32
int metran_sqrt_filter_robust_f32(
    const void* phi, const void* q, const void* z, const void* r,
    const void* y, const void* mask, const void* lane_map, const void* mean0,
    const void* chol0, const void* armed, const void* rail_lo,
    const void* rail_hi, const void* quantum, const void* scale, double nu,
    double tol, double nonconv_tol, double c_floor, double eps, void* mean,
    void* chol, void* sigma, void* detf, void* o_z, void* o_verdict,
    void* o_iters, int L, int t_steps, int N, int n, int likelihood, int W,
    int G, void* stream) {
  return launch_sqrt_filter_robust<float>(
      phi, q, z, r, y, mask, lane_map, mean0, chol0, armed, rail_lo, rail_hi,
      quantum, scale, nu, tol, nonconv_tol, c_floor, eps, mean, chol, sigma,
      detf, o_z, o_verdict, o_iters, L, t_steps, N, n, likelihood, W, G,
      stream);
}

int metran_sqrt_filter_robust_f64(
    const void* phi, const void* q, const void* z, const void* r,
    const void* y, const void* mask, const void* lane_map, const void* mean0,
    const void* chol0, const void* armed, const void* rail_lo,
    const void* rail_hi, const void* quantum, const void* scale, double nu,
    double tol, double nonconv_tol, double c_floor, double eps, void* mean,
    void* chol, void* sigma, void* detf, void* o_z, void* o_verdict,
    void* o_iters, int L, int t_steps, int N, int n, int likelihood, int W,
    int G, void* stream) {
  return launch_sqrt_filter_robust<double>(
      phi, q, z, r, y, mask, lane_map, mean0, chol0, armed, rail_lo, rail_hi,
      quantum, scale, nu, tol, nonconv_tol, c_floor, eps, mean, chol, sigma,
      detf, o_z, o_verdict, o_iters, L, t_steps, N, n, likelihood, W, G,
      stream);
}

// the group kernel's shared memory a lane (bytes, a multiple of 16)
int metran_sqrt_filter_model_bytes_f32(int N, int n) {
  return (int)sqrtw::model_bytes<float>(N, n);
}

int metran_sqrt_filter_model_bytes_f64(int N, int n) {
  return (int)sqrtw::model_bytes<double>(N, n);
}

// blocks of the group kernel resident per SM at (N, n) in `variant` (0
// carry, 1 bounds, 2 store, 3-5 the gate's policies, 6-8 the robust
// likelihoods) with W lanes a block and G warps a lane
int metran_sqrt_filter_occupancy_f32(int N, int n, int variant, int W, int G,
                                     void* blocks) {
  return occupancy<float>(N, n, variant, W, G, (int*)blocks);
}

int metran_sqrt_filter_occupancy_f64(int N, int n, int variant, int W, int G,
                                     void* blocks) {
  return occupancy<double>(N, n, variant, W, G, (int*)blocks);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
