// The frozen-gain filter body of one warp, shared by K14
// (steady_filter.cu) and the arena steady update K17 (arena_steady.cu).
//
// filter_warp runs the k appended steps of one model (steady_filter.cu
// documents the two forms and the policies) from the mean, gain and
// constants in state row `srow` of phi, z, kgain, fdiag and mean0,
// reading the real-slot flags, the step data and writing the z-scores
// and verdicts at dispatch index `b`; K14 passes srow == b, the arena
// the resident row its warp gathers.  It leaves the final mean in shared
// memory (smem_mean) and returns sigma, detf and the broke flag.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace steadyk {

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
__host__ __device__ inline size_t steady_smem(int N, int S) {
  return sizeof(T) * (2 * (size_t)N * S + S + 3 * (size_t)N);
}

// the result of one warp's append, the same on every lane
template <typename T>
struct Result {
  T sigma, detf;
  bool broke;
};

// the dynamic shared memory of one warp: Z (N, S), K (S, N), the mean
// (S) and three slot vectors; filter_warp leaves the final mean at
// smem_mean
template <typename T>
__device__ inline T* smem_mean(unsigned char* raw, int N, int S) {
  return reinterpret_cast<T*>(raw) + 2 * (size_t)N * S;
}

// arm: the model's gate flag (read only by the gated policies)
template <typename T, int kPolicy, bool kSeq>
__device__ Result<T> filter_warp(unsigned char* smem_raw,
                                 const T* __restrict__ phi,
                                 const T* __restrict__ z,
                                 const T* __restrict__ kgain,
                                 const T* __restrict__ fdiag,
                                 const uint8_t* __restrict__ real,
                                 const T* __restrict__ mean0,
                                 const T* __restrict__ y,
                                 const uint8_t* __restrict__ mask, bool arm,
                                 double thresh, T* __restrict__ z_out,
                                 int8_t* __restrict__ verdict_out, int b,
                                 int srow, int k, int N, int S) {
  T* sz = reinterpret_cast<T*>(smem_raw);  // Z (N, S)
  T* sk = sz + (size_t)N * S;              // K (S, N)
  T* sm = sk + (size_t)S * N;              // the mean (S)
  T* swv = sm + S;                         // w o v of the step (N)
  T* sf = swv + N;                         // f_safe (N)
  T* slf = sf + N;                         // log_f (N)
  const int lane = threadIdx.x;
  const size_t ns = (size_t)N * S;
  for (size_t e = lane; e < ns; e += kWarp) {
    sz[e] = z[(size_t)srow * ns + e];
    sk[e] = kgain[(size_t)srow * ns + e];
  }
  for (int s = lane; s < S; s += kWarp) sm[s] = mean0[(size_t)srow * S + s];
  for (int i = lane; i < N; i += kWarp) {
    const T f = fdiag[(size_t)srow * N + i];
    const T fs = f > T(0) ? f : T(1);
    sf[i] = fs;
    slf[i] = real[(size_t)b * N + i] ? log(fs) : T(0);
  }
  __syncwarp();
  const T t = T(thresh);
  const T zero = T(0), one = T(1), nan = T(NAN);
  const int8_t hit_code = kPolicy == kReject ? kRejected : kDownweighted;
  const T* ph = phi + (size_t)srow * S;
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
  for (int s = lane; s < S; s += kWarp) finite &= isfinite(sm[s]);
  broke |= !__all_sync(kFull, finite);
  return Result<T>{sigma, detf, broke};
}

}  // namespace steadyk
