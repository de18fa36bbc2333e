// K18: the arena forecast, one thread block per dispatched row —
// gather, (on a square-root arena) F F' in the block, and K2's
// closed-form horizon moments for every horizon, read-only.
//
// Replaces the JAX package's B13 read kernel, metran_tpu/serve/
// engine.py::make_arena_forecast_fn (:1473).  Block b reads rows[b],
// reconstitutes the covariance C = F F' of a factor row in shared memory
// (forecastk::gram_block; a covariance row is read as it is), and runs
// forecastk::moments_block (forecast_step.cuh: K2's body, the same
// operations in the same order) once per horizon from the row's mean,
// phi, q, z and r (forecastk::horizons_block).  Nothing in the arena is
// written.  K16's horizons mode calls the same two functions on the row
// it writes, so its snapshot equals this kernel's read bit for bit.
//
// What bounds it on an H100: latency, as K2 — a few block barriers per
// horizon over a few KB of the row's leaves; the F F' of a sqrt row adds
// S^3 multiply-adds spread over the block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "forecast_step.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
arena_forecast_kernel(const T* __restrict__ mean, const T* __restrict__ fac,
                      const T* __restrict__ phi, const T* __restrict__ q,
                      const T* __restrict__ z, const T* __restrict__ r,
                      const int32_t* __restrict__ rows,
                      const T* __restrict__ horizons,
                      T* __restrict__ means_out, T* __restrict__ vars_out,
                      int H, int N, int S, int sqrt_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const size_t row = (size_t)rows[b];
  const T* covb = fac + row * S * S;
  if (sqrt_rows) {  // C = F F' of the row's factor
    T* C = reinterpret_cast<T*>(smem_raw) + forecastk::smem_elems<T>(N, S);
    forecastk::gram_block<T>(covb, C, S);
    __syncthreads();
    covb = C;
  }
  forecastk::horizons_block<T>(smem_raw, phi + row * S, q + row * S * S,
                               z + row * N * S, r + row * N, mean + row * S,
                               covb, horizons, H, means_out, vars_out, b, N,
                               S);
}

template <typename T>
int launch_arena_forecast(const void* mean, const void* fac, const void* phi,
                          const void* q, const void* z, const void* r,
                          const void* rows, const void* horizons,
                          void* means_out, void* vars_out, int G, int H,
                          int N, int S, int sqrt_rows, void* stream) {
  const size_t smem =
      sizeof(T) * (forecastk::smem_elems<T>(N, S) +
                   (sqrt_rows ? (size_t)S * S : 0));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        arena_forecast_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (G == 0 || H == 0) return 0;
  arena_forecast_kernel<T><<<G, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)mean, (const T*)fac, (const T*)phi, (const T*)q, (const T*)z,
      (const T*)r, (const int32_t*)rows, (const T*)horizons, (T*)means_out,
      (T*)vars_out, H, N, S, sqrt_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the arena leaves mean (B, S), fac (B, S, S) (factors when sqrt_rows),
// phi, q, z, r; rows (G,) int32, horizons (H,); means, variances
// (G, H, N)
int metran_arena_forecast_f32(const void* mean, const void* fac,
                              const void* phi, const void* q, const void* z,
                              const void* r, const void* rows,
                              const void* horizons, void* means_out,
                              void* vars_out, int G, int H, int N, int S,
                              int sqrt_rows, void* stream) {
  return launch_arena_forecast<float>(mean, fac, phi, q, z, r, rows, horizons,
                                      means_out, vars_out, G, H, N, S,
                                      sqrt_rows, stream);
}

int metran_arena_forecast_f64(const void* mean, const void* fac,
                              const void* phi, const void* q, const void* z,
                              const void* r, const void* rows,
                              const void* horizons, void* means_out,
                              void* vars_out, int G, int H, int N, int S,
                              int sqrt_rows, void* stream) {
  return launch_arena_forecast<double>(mean, fac, phi, q, z, r, rows,
                                       horizons, means_out, vars_out, G, H, N,
                                       S, sqrt_rows, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
