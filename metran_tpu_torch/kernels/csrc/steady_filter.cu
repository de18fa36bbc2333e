// K14: the frozen-gain (steady-state) filter append, one warp per model.
//
// Replaces the JAX package's device program B9b (steady),
// metran_tpu/ops/kalman.py::_steady_filter_append (:1362) behind
// steady_filter_append, which the serving path vmaps over a shape bucket
// for every frozen model (serve/engine.py::make_steady_update_fn).
//
// Per model and appended step, from the carried mean m and the frozen
// gain K (S, N) with its innovation variances f (N,) (f_safe = f where
// f > 0, else 1; log_f = log f_safe on real slots, else 0):
//   predict   m_p = phi o m
//   full      = every slot's mask equals the real-slot pattern
// The vector form (kSeq = false: the joint gain, marginal variances):
//   v_i = mask_i ? y_i - Z_i.m_p : 0,  z_i = v_i / sqrt(f_i)
//   hit_i = armed && mask_i && z_i^2 > t          (never with "off")
//   huber  w_i = hit_i ? sqrt(t / z_i^2) : 1;  reject/inflate: w_i = 1
//          and any hit breaks the step
//   m = m_p + K (w o v),  sigma += sum mask (w v)^2 / f,
//   detf += sum mask log_f
// The per-slot form (kSeq = true, gated policies only: the per-slot
// sequential gains and conditional variances), slot by slot in order
// from m_s = m_p:
//   v = y_i - Z_i.m_s,  z = v / sqrt(f_i), the same hit and weight,
//   if mask_i: m_s += K_i (w v), sigma += (w v)^2 / f_i, detf += log_f_i
// broke (sticky) |= !full || a reject/inflate hit; after the last step
// broke |= any non-finite entry of the mean.  The z-score is NaN where
// unobserved; the verdict is 2 (rejected) or 1 (downweighted) where hit.
//
// The policy and the form are template parameters (as K12's policies
// and K6's modes are), so an instantiation carries no run-time branch
// of the others.
//
// What bounds it on an H100: bytes.  A step is O(S N) operations
// (Z m_p and K (w v)); with k = 1 each model reads Z and K once
// (2 S N words) and the recursion is a few dependent dot products, so
// the launch sets the time at serving shapes.  Design: one warp per
// model; Z and K go to shared memory (read again at every step when
// k > 1); the vector form gives one slot to a lane for v (a serial dot
// over the S states out of shared memory) and one state to a lane for
// the gain product; the per-slot form gives one state to a lane and
// reduces each slot's dot across the warp by shuffles.  Buckets with
// more than 32 states or slots loop the lanes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
enum { kOff = 0, kReject = 1, kHuber = 2, kInflate = 3 };
constexpr int8_t kPass = 0, kDownweighted = 1, kRejected = 2;

template <typename T>
__device__ inline T warp_sum(T x) {
  // butterfly: every lane ends with the same sum (each pairwise add is
  // commutative, so the two lanes of a pair compute the same value)
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T>
size_t steady_smem(int N, int S) {
  return sizeof(T) * (2 * (size_t)N * S + S + 3 * (size_t)N);
}

template <typename T, int kPolicy, bool kSeq>
__global__ void __launch_bounds__(kWarp)
steady_filter_kernel(const T* __restrict__ phi, const T* __restrict__ z,
                     const T* __restrict__ kgain, const T* __restrict__ fdiag,
                     const uint8_t* __restrict__ real,
                     const T* __restrict__ mean0, const T* __restrict__ y,
                     const uint8_t* __restrict__ mask,
                     const uint8_t* __restrict__ armed, double thresh,
                     T* __restrict__ mean_out, T* __restrict__ sigma_out,
                     T* __restrict__ detf_out, uint8_t* __restrict__ broke_out,
                     T* __restrict__ z_out, int8_t* __restrict__ verdict_out,
                     int k, int N, int S) {
  extern __shared__ unsigned char smem_raw[];
  T* sz = reinterpret_cast<T*>(smem_raw);  // Z (N, S)
  T* sk = sz + (size_t)N * S;              // K (S, N)
  T* sm = sk + (size_t)S * N;              // the mean (S)
  T* swv = sm + S;                         // w o v of the step (N)
  T* sf = swv + N;                         // f_safe (N)
  T* slf = sf + N;                         // log_f (N)
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t ns = (size_t)N * S;
  for (size_t e = lane; e < ns; e += kWarp) {
    sz[e] = z[(size_t)b * ns + e];
    sk[e] = kgain[(size_t)b * ns + e];
  }
  for (int s = lane; s < S; s += kWarp) sm[s] = mean0[(size_t)b * S + s];
  for (int i = lane; i < N; i += kWarp) {
    const T f = fdiag[(size_t)b * N + i];
    const T fs = f > T(0) ? f : T(1);
    sf[i] = fs;
    slf[i] = real[(size_t)b * N + i] ? log(fs) : T(0);
  }
  __syncwarp();
  const T t = T(thresh);
  const T zero = T(0), one = T(1), nan = T(NAN);
  const int8_t hit_code = kPolicy == kReject ? kRejected : kDownweighted;
  const bool arm = armed[b] != 0;
  const T* ph = phi + (size_t)b * S;
  T sigma = zero, detf = zero;
  bool broke = false;
  for (int step = 0; step < k; ++step) {
    const size_t row = ((size_t)b * k + step) * N;
    for (int s = lane; s < S; s += kWarp) sm[s] = ph[s] * sm[s];
    __syncwarp();
    bool differs = false;
    for (int i = lane; i < N; i += kWarp)
      differs |= (mask[row + i] != 0) != (real[(size_t)b * N + i] != 0);
    const bool full = !__any_sync(kFull, differs);
    bool gate_break = false;
    if (!kSeq) {
      T part_sig = zero, part_det = zero;
      bool part_hit = false;
      for (int i = lane; i < N; i += kWarp) {
        const bool obs = mask[row + i] != 0;
        T v = zero;
        if (obs) {
          T acc = zero;
          for (int s = 0; s < S; ++s) acc += sz[(size_t)i * S + s] * sm[s];
          v = y[row + i] - acc;
        }
        const T zs = v / sqrt(sf[i]);
        const T score = zs * zs;
        const bool hit = kPolicy != kOff && arm && obs && score > t;
        T w = one;
        if (kPolicy == kHuber && hit) w = sqrt(t / score);
        if (kPolicy == kReject || kPolicy == kInflate) part_hit |= hit;
        const T wv = w * v;
        swv[i] = wv;
        if (obs) {
          part_sig += wv * wv / sf[i];
          part_det += slf[i];
        }
        z_out[row + i] = obs ? zs : nan;
        verdict_out[row + i] = hit ? hit_code : kPass;
      }
      __syncwarp();
      for (int s = lane; s < S; s += kWarp) {
        T acc = zero;
        for (int i = 0; i < N; ++i) acc += sk[(size_t)s * N + i] * swv[i];
        sm[s] = sm[s] + acc;
      }
      sigma += warp_sum(part_sig);
      detf += warp_sum(part_det);
      gate_break = __any_sync(kFull, part_hit);
      __syncwarp();
    } else {
      for (int i = 0; i < N; ++i) {
        const bool obs = mask[row + i] != 0;
        T part = zero;
        for (int s = lane; s < S; s += kWarp)
          part += sz[(size_t)i * S + s] * sm[s];
        const T v = y[row + i] - warp_sum(part);
        const T zs = v / sqrt(sf[i]);
        const T score = zs * zs;
        const bool hit = arm && obs && score > t;
        T w = one;
        if (kPolicy == kHuber) {
          if (hit) w = sqrt(t / score);
        } else {
          gate_break |= hit;
        }
        const T wv = w * v;
        if (obs) {
          for (int s = lane; s < S; s += kWarp)
            sm[s] = sm[s] + sk[(size_t)s * N + i] * wv;
          sigma += wv * wv / sf[i];
          detf += slf[i];
        }
        if (lane == 0) {
          z_out[row + i] = obs ? zs : nan;
          verdict_out[row + i] = hit ? hit_code : kPass;
        }
      }
      __syncwarp();
    }
    broke |= !full || gate_break;
  }
  bool finite = true;
  for (int s = lane; s < S; s += kWarp) {
    finite &= isfinite(sm[s]);
    mean_out[(size_t)b * S + s] = sm[s];
  }
  broke |= !__all_sync(kFull, finite);
  if (lane == 0) {
    sigma_out[b] = sigma;
    detf_out[b] = detf;
    broke_out[b] = broke ? 1 : 0;
  }
}

template <typename T, int kPolicy, bool kSeq>
int launch(const void* phi, const void* z, const void* kgain,
           const void* fdiag, const void* real, const void* mean0,
           const void* y, const void* mask, const void* armed, double thresh,
           void* mean_out, void* sigma_out, void* detf_out, void* broke_out,
           void* z_out, void* verdict_out, int B, int k, int N, int S,
           void* stream) {
  const size_t smem = steady_smem<T>(N, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        steady_filter_kernel<T, kPolicy, kSeq>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0) return 0;
  steady_filter_kernel<T, kPolicy, kSeq>
      <<<B, kWarp, smem, (cudaStream_t)stream>>>(
          (const T*)phi, (const T*)z, (const T*)kgain, (const T*)fdiag,
          (const uint8_t*)real, (const T*)mean0, (const T*)y,
          (const uint8_t*)mask, (const uint8_t*)armed, thresh, (T*)mean_out,
          (T*)sigma_out, (T*)detf_out, (uint8_t*)broke_out, (T*)z_out,
          (int8_t*)verdict_out, k, N, S);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* phi, const void* z, const void* kgain,
             const void* fdiag, const void* real, const void* mean0,
             const void* y, const void* mask, const void* armed,
             double thresh, void* mean_out, void* sigma_out, void* detf_out,
             void* broke_out, void* z_out, void* verdict_out, int B, int k,
             int N, int S, int policy, int sequential, void* stream) {
#define METRAN_STEADY(P, Q)                                                  \
  launch<T, P, Q>(phi, z, kgain, fdiag, real, mean0, y, mask, armed, thresh, \
                  mean_out, sigma_out, detf_out, broke_out, z_out,           \
                  verdict_out, B, k, N, S, stream)
  if (sequential && policy != kOff) {
    switch (policy) {
      case kReject: return METRAN_STEADY(kReject, true);
      case kHuber: return METRAN_STEADY(kHuber, true);
      case kInflate: return METRAN_STEADY(kInflate, true);
    }
  } else {
    switch (policy) {
      case kOff: return METRAN_STEADY(kOff, false);
      case kReject: return METRAN_STEADY(kReject, false);
      case kHuber: return METRAN_STEADY(kHuber, false);
      case kInflate: return METRAN_STEADY(kInflate, false);
    }
  }
#undef METRAN_STEADY
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// phi (B, S), z (B, N, S), kgain (B, S, N), fdiag (B, N), real (B, N)
// uint8, mean0 (B, S), y (B, k, N), mask (B, k, N) uint8, armed (B,)
// uint8, thresh = nsigma^2; mean_out (B, S), sigma/detf (B,), broke (B,)
// uint8, z_out (B, k, N), verdict (B, k, N) int8.  policy: 0 off,
// 1 reject, 2 huber, 3 inflate; sequential: the per-slot form (gated
// policies only).
int metran_steady_filter_f32(const void* phi, const void* z,
                             const void* kgain, const void* fdiag,
                             const void* real, const void* mean0,
                             const void* y, const void* mask,
                             const void* armed, double thresh, void* mean_out,
                             void* sigma_out, void* detf_out,
                             void* broke_out, void* z_out, void* verdict_out,
                             int B, int k, int N, int S, int policy,
                             int sequential, void* stream) {
  return dispatch<float>(phi, z, kgain, fdiag, real, mean0, y, mask, armed,
                         thresh, mean_out, sigma_out, detf_out, broke_out,
                         z_out, verdict_out, B, k, N, S, policy, sequential,
                         stream);
}

int metran_steady_filter_f64(const void* phi, const void* z,
                             const void* kgain, const void* fdiag,
                             const void* real, const void* mean0,
                             const void* y, const void* mask,
                             const void* armed, double thresh, void* mean_out,
                             void* sigma_out, void* detf_out,
                             void* broke_out, void* z_out, void* verdict_out,
                             int B, int k, int N, int S, int policy,
                             int sequential, void* stream) {
  return dispatch<double>(phi, z, kgain, fdiag, real, mean0, y, mask, armed,
                          thresh, mean_out, sigma_out, detf_out, broke_out,
                          z_out, verdict_out, B, k, N, S, policy, sequential,
                          stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
