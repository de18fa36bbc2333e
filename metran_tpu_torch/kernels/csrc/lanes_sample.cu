// K7: the unconditional path draw of the lane-layout simulation smoother,
// one warp per lane.
//
// Replaces the path draw of the JAX package's device program B4,
// metran_tpu/ops/lanes_products.py::lanes_sample (the AR recursion and the
// pseudo-observations), which runs one lane per (model, draw) pair.
//
// Per lane, from standard normals x0 (n), w (T, n) and e (T, N) that the
// caller draws:
//   x_0 = x0,  x_t = phi o x_{t-1} + sqrt(max(q, 0)) o w_t,
//   y*_t = Z x_t + sqrt(max(r, 0)) o e_t,
// emitting xs (T, n) and y* (T, N), lane-major like the inputs.
//
// What bounds it on an H100: the bytes.  Per step a lane reads n + N
// normals and writes n + N values and does ~2(n + N n) operations, and
// the recursion across steps is a chain of one FMA per state.  Thread a
// of the lane's warp owns state a and thread i observation i, so each
// step's loads and stores are contiguous across the warp; the new state
// goes through shared memory (one warp barrier each way) for Z x_t.

#include "lanes_step.cuh"

namespace {

using lanes::kWarps;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lanes_sample_kernel(const T* __restrict__ phi, const T* __restrict__ q,
                    const T* __restrict__ z, const T* __restrict__ r,
                    const T* __restrict__ x0, const T* __restrict__ wn,
                    const T* __restrict__ en, T* __restrict__ xs,
                    T* __restrict__ ystar, int L, int t_steps, int N, int n,
                    int welems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * kWarps + w;
  if (l >= L) return;  // warp-uniform; no block-wide barrier follows
  T* Zs = reinterpret_cast<T*>(smem_raw) + (size_t)w * welems;
  T* x = Zs + N * n;
  T* ph = x + n;
  T* qs = ph + n;
  T* rsd = qs + n;

  for (int a = lane; a < n; a += 32) {
    ph[a] = phi[(size_t)a * L + l];
    const T qa = q[(size_t)a * L + l];
    qs[a] = sqrt(qa > T(0) ? qa : T(0));
    x[a] = x0[(size_t)l * n + a];
  }
  for (int idx = lane; idx < N * n; idx += 32) Zs[idx] = z[(size_t)idx * L + l];
  for (int i = lane; i < N; i += 32) {
    const T ri = r[(size_t)i * L + l];
    rsd[i] = sqrt(ri > T(0) ? ri : T(0));
  }
  __syncwarp();

  const T* wl = wn + (size_t)l * t_steps * n;
  const T* el = en + (size_t)l * t_steps * N;
  T* xl = xs + (size_t)l * t_steps * n;
  T* yl = ystar + (size_t)l * t_steps * N;
  for (int t = 0; t < t_steps; ++t) {
    for (int a = lane; a < n; a += 32) {
      const T xa = ph[a] * x[a] + wl[(size_t)t * n + a] * qs[a];
      x[a] = xa;
      xl[(size_t)t * n + a] = xa;
    }
    __syncwarp();  // the new state before Z x_t reads all of it
    for (int i = lane; i < N; i += 32) {
      T acc = 0;
      for (int a = 0; a < n; ++a) acc += Zs[i * n + a] * x[a];
      yl[(size_t)t * N + i] = acc + el[(size_t)t * N + i] * rsd[i];
    }
    __syncwarp();  // every read of x_t before x_{t+1} overwrites it
  }
}

template <typename T>
int launch_lanes_sample(const void* phi, const void* q, const void* z,
                        const void* r, const void* x0, const void* wn,
                        const void* en, void* xs, void* ystar, int L,
                        int t_steps, int N, int n, void* stream) {
  const int welems = lanes::warp_elems<T>(0, 3, N, n);
  const size_t smem = (size_t)kWarps * welems * sizeof(T);
  int err = lanes::prepare_launch(lanes_sample_kernel<T>, smem);
  if (err != 0) return err;
  if (L == 0) return 0;
  const int blocks = (L + kWarps - 1) / kWarps;
  lanes_sample_kernel<T><<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)phi, (const T*)q, (const T*)z, (const T*)r, (const T*)x0,
      (const T*)wn, (const T*)en, (T*)xs, (T*)ystar, L, t_steps, N, n,
      welems);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int metran_lanes_sample_f32(const void* phi, const void* q, const void* z,
                            const void* r, const void* x0, const void* wn,
                            const void* en, void* xs, void* ystar, int L,
                            int t_steps, int N, int n, void* stream) {
  return launch_lanes_sample<float>(phi, q, z, r, x0, wn, en, xs, ystar, L,
                                    t_steps, N, n, stream);
}

int metran_lanes_sample_f64(const void* phi, const void* q, const void* z,
                            const void* r, const void* x0, const void* wn,
                            const void* en, void* xs, void* ystar, int L,
                            int t_steps, int N, int n, void* stream) {
  return launch_lanes_sample<double>(phi, q, z, r, x0, wn, en, xs, ystar, L,
                                     t_steps, N, n, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
