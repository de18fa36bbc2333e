// K15: the steady-state (DARE) solve and the frozen gains, one thread
// block per model.
//
// Replaces the JAX package's device programs B9b (steady) in
// metran_tpu/ops/kalman.py: dare_solve (:1155) and steady_gains (:1232),
// which the serving layer runs once per model when it freezes it
// (serve/service.py::_compute_steady).
//
// Per model (true dimensions; Z_m = Z with its zero rows kept zero,
// r_eff = r on real slots and 1 on zero-Z-row slots, so such a slot's
// F row is e_i and its gain column exactly zero):
//   lyap(A, B): X = B, M = A; repeat `doubling` times
//               X <- sym(X + (M X) M'),  M <- M M       (sym = (X + X')/2)
//   P = lyap(diag(phi), Q)                               (K = 0)
//   repeat `newton` times (Newton-Kleinman):
//     F = (Z_m P) Z_m' + diag(r_eff),  L = chol(sym(F)),
//     K' = L' \ (L \ (Z_m P)),
//     A = phi o (I - K Z_m),  B = phi o ((K o r_eff) K') o phi' + Q,
//     P = sym(lyap(A, B))
//   (or P = the given p_pred, with no solve)
// then the gains at P: F, L and K' as above, kgain = K (S, N),
// fdiag = diag(F), p_filt = sym(P - (K F) K'), and the per-slot
// sequential recursion from P over the slots in order
//   d = P z_i,  f_i = z_i.d + r_eff_i,  k_i = d / f_i,  P <- P - (k_i k_i') f_i
// giving kgain_seq (S, N) and fdiag_seq (N,).  R^-1 is never formed, so
// the DFM's exact observations (r = 0) are no obstacle.
//
// Every product is the kernel's own (one thread per output element,
// operands in shared memory); the doubling steps, the Newton steps, the
// symmetrisations, the Cholesky factorisation and cho_solve of F, p_filt
// and the per-slot scan all run inside the launch, with no host round
// trip.
//
// What bounds it on an H100: operations.  Each doubling step is three
// S x S products (2 S^3 each), so a model costs about newton x doubling x
// 6 S^3 (43 MFLOP at S = 21, f64): the card's f64 rate sets the floor.
// The design is simple: the (S, S) iterates, Z, Q, F and its factor sit
// in shared memory (about 9 S^2 + 2 N^2 words), each product is a loop
// over the output elements with a serial dot per element, and three
// block barriers separate a doubling step's products.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
size_t dare_smem(int N, int S) {
  const size_t W = N > S ? N : S;
  // Z, KT, ZP (N S each); phi, r_eff, d (S / N / S); Q, M, X, P, A, B,
  // the seq carry (S S each); two work arrays (W W); F and L (N N); and
  // one scalar
  return sizeof(T) * (3 * (size_t)N * S + 2 * (size_t)S + N +
                      7 * (size_t)S * S + 2 * W * W + 2 * (size_t)N * N + 1);
}

// C = A B (transB: A B'), A (I, K), B (K, J) or (J, K); then a barrier
template <typename T>
__device__ void matmul(T* C, const T* A, const T* B, int I, int K, int J,
                       bool transB) {
  for (int e = threadIdx.x; e < I * J; e += blockDim.x) {
    const int i = e / J, j = e - (e / J) * J;
    T acc = T(0);
    if (transB) {
      for (int q = 0; q < K; ++q) acc += A[i * K + q] * B[j * K + q];
    } else {
      for (int q = 0; q < K; ++q) acc += A[i * K + q] * B[q * J + j];
    }
    C[e] = acc;
  }
  __syncthreads();
}

// the fixed point of X = A X A' + B by doubling, into X (A, B kept)
template <typename T>
__device__ void lyap(const T* A, const T* B, T* M, T* X, T* W1, T* W2,
                     int S, int doubling) {
  const int nn = S * S;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    M[e] = A[e];
    X[e] = B[e];
  }
  __syncthreads();
  T* m = M;
  T* w = W1;
  for (int it = 0; it < doubling; ++it) {
    matmul(w, m, X, S, S, S, false);  // M X
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int i = e / S, j = e - (e / S) * S;
      T acc = T(0);
      for (int q = 0; q < S; ++q) acc += w[i * S + q] * m[j * S + q];
      W2[e] = X[e] + acc;  // X + (M X) M'
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int i = e / S, j = e - (e / S) * S;
      X[e] = T(0.5) * (W2[e] + W2[j * S + i]);
      T acc = T(0);
      for (int q = 0; q < S; ++q) acc += m[i * S + q] * m[q * S + j];
      w[e] = acc;  // M M, into the work array
    }
    __syncthreads();
    T* tmp = m;  // the new M is the work array; the old one is free
    m = w;
    w = tmp;
  }
}

// in-place lower Cholesky of the (N, N) matrix L (the upper part is left
// as it was); a non-positive pivot gives NaN, as LAPACK's routine does
template <typename T>
__device__ void cholesky(T* L, int N) {
  for (int j = 0; j < N; ++j) {
    if (threadIdx.x == 0) L[j * N + j] = sqrt(L[j * N + j]);
    __syncthreads();
    for (int i = j + 1 + threadIdx.x; i < N; i += blockDim.x)
      L[i * N + j] = L[i * N + j] / L[j * N + j];
    __syncthreads();
    const int m = N - j - 1;  // the trailing block's order
    for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
      const int i = j + 1 + e / m, c = j + 1 + (e - (e / m) * m);
      if (c <= i) L[i * N + c] -= L[i * N + j] * L[c * N + j];
    }
    __syncthreads();
  }
}

// F, its factor and K' = F^-1 (Z_m P) at the current P: F (N, N) into
// F, sym(F) factored into L, Z_m P into ZP, K' (N, S) into KT
template <typename T>
__device__ void gain(const T* Z, const T* reff, const T* P, T* ZP, T* F,
                     T* L, T* KT, int N, int S) {
  matmul(ZP, Z, P, N, S, S, false);
  matmul(F, ZP, Z, N, S, N, true);
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int i = e / N, j = e - (e / N) * N;
    if (i == j) F[e] += reff[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int i = e / N, j = e - (e / N) * N;
    L[e] = T(0.5) * (F[e] + F[j * N + i]);
  }
  __syncthreads();
  cholesky(L, N);
  // cho_solve: one right-hand side (a column of Z_m P) per thread
  for (int c = threadIdx.x; c < S; c += blockDim.x) {
    for (int i = 0; i < N; ++i) {
      T acc = ZP[i * S + c];
      for (int q = 0; q < i; ++q) acc -= L[i * N + q] * KT[q * S + c];
      KT[i * S + c] = acc / L[i * N + i];
    }
    for (int i = N - 1; i >= 0; --i) {
      T acc = KT[i * S + c];
      for (int q = i + 1; q < N; ++q) acc -= L[q * N + i] * KT[q * S + c];
      KT[i * S + c] = acc / L[i * N + i];
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dare_kernel(const T* __restrict__ phi, const T* __restrict__ q,
            const T* __restrict__ z, const T* __restrict__ r,
            const T* __restrict__ p_given, T* __restrict__ p_pred,
            T* __restrict__ p_filt, T* __restrict__ kgain,
            T* __restrict__ fdiag, T* __restrict__ kgain_seq,
            T* __restrict__ fdiag_seq, int N, int S, int newton,
            int doubling) {
  extern __shared__ unsigned char smem_raw[];
  const int W = N > S ? N : S;
  const int ns = N * S, nn = S * S;
  T* Z = reinterpret_cast<T*>(smem_raw);
  T* KT = Z + ns;
  T* ZP = KT + ns;
  T* ph = ZP + ns;
  T* dv = ph + S;
  T* reff = dv + S;
  T* Q = reff + N;
  T* M = Q + nn;
  T* X = M + nn;
  T* P = X + nn;
  T* A = P + nn;
  T* Bm = A + nn;
  T* Pseq = Bm + nn;
  T* W1 = Pseq + nn;
  T* W2 = W1 + (size_t)W * W;
  T* F = W2 + (size_t)W * W;
  T* L = F + (size_t)N * N;
  T* fs = L + (size_t)N * N;  // one scalar
  const int b = blockIdx.x;
  // the real slots and the masked Z: a slot is real where its Z row has
  // a nonzero entry (thread i scans row i)
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    bool real = false;
    for (int c = 0; c < S; ++c) real |= z[(size_t)b * ns + i * S + c] != T(0);
    reff[i] = real ? r[(size_t)b * N + i] : T(1);
    for (int c = 0; c < S; ++c)
      Z[i * S + c] = real ? z[(size_t)b * ns + i * S + c] : T(0);
  }
  for (int e = threadIdx.x; e < nn; e += blockDim.x)
    Q[e] = q[(size_t)b * nn + e];
  for (int i = threadIdx.x; i < S; i += blockDim.x)
    ph[i] = phi[(size_t)b * S + i];
  __syncthreads();
  if (p_given != nullptr) {
    for (int e = threadIdx.x; e < nn; e += blockDim.x)
      P[e] = p_given[(size_t)b * nn + e];
    __syncthreads();
  } else {
    // K = 0: the stationary prior, lyap(diag(phi), Q)
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int i = e / S, j = e - (e / S) * S;
      A[e] = i == j ? ph[i] : T(0);
    }
    __syncthreads();
    lyap(A, Q, M, P, W1, W2, S, doubling);
    for (int it = 0; it < newton; ++it) {
      gain(Z, reff, P, ZP, F, L, KT, N, S);
      for (int e = threadIdx.x; e < nn; e += blockDim.x) {
        const int i = e / S, j = e - (e / S) * S;
        T kz = T(0), krk = T(0);
        for (int n = 0; n < N; ++n) {
          kz += KT[n * S + i] * Z[n * S + j];
          krk += (KT[n * S + i] * reff[n]) * KT[n * S + j];
        }
        A[e] = ph[i] * ((i == j ? T(1) : T(0)) - kz);
        Bm[e] = ph[i] * krk * ph[j] + Q[e];
      }
      __syncthreads();
      lyap(A, Bm, M, X, W1, W2, S, doubling);
      for (int e = threadIdx.x; e < nn; e += blockDim.x) {
        const int i = e / S, j = e - (e / S) * S;
        P[e] = T(0.5) * (X[e] + X[j * S + i]);
      }
      __syncthreads();
    }
  }
  // the gains at P
  gain(Z, reff, P, ZP, F, L, KT, N, S);
  for (int e = threadIdx.x; e < nn; e += blockDim.x)
    p_pred[(size_t)b * nn + e] = P[e];
  for (int e = threadIdx.x; e < ns; e += blockDim.x) {
    const int s = e / N, n = e - (e / N) * N;
    kgain[(size_t)b * ns + e] = KT[n * S + s];
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    fdiag[(size_t)b * N + i] = F[i * N + i];
  // p_filt = sym(P - (K F) K'): K F (S, N) into W1, then the difference
  for (int e = threadIdx.x; e < ns; e += blockDim.x) {
    const int s = e / N, n = e - (e / N) * N;
    T acc = T(0);
    for (int m = 0; m < N; ++m) acc += KT[m * S + s] * F[m * N + n];
    W1[e] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int i = e / S, j = e - (e / S) * S;
    T acc = T(0);
    for (int m = 0; m < N; ++m) acc += W1[i * N + m] * KT[m * S + j];
    W2[e] = P[e] - acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int i = e / S, j = e - (e / S) * S;
    p_filt[(size_t)b * nn + e] = T(0.5) * (W2[e] + W2[j * S + i]);
    Pseq[e] = P[e];
  }
  __syncthreads();
  // the per-slot sequential recursion at P
  for (int n = 0; n < N; ++n) {
    const T* zi = Z + n * S;
    for (int a = threadIdx.x; a < S; a += blockDim.x) {
      T acc = T(0);
      for (int c = 0; c < S; ++c) acc += Pseq[a * S + c] * zi[c];
      dv[a] = acc;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      T acc = T(0);
      for (int c = 0; c < S; ++c) acc += zi[c] * dv[c];
      fs[0] = acc + reff[n];
      fdiag_seq[(size_t)b * N + n] = fs[0];
    }
    __syncthreads();
    const T f = fs[0];
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int i = e / S, j = e - (e / S) * S;
      const T ki = dv[i] / f, kj = dv[j] / f;
      Pseq[e] = Pseq[e] - (ki * kj) * f;
    }
    for (int a = threadIdx.x; a < S; a += blockDim.x)
      kgain_seq[(size_t)b * ns + a * N + n] = dv[a] / f;
    __syncthreads();
  }
}

template <typename T>
int launch_dare(const void* phi, const void* q, const void* z, const void* r,
                const void* p_given, void* p_pred, void* p_filt, void* kgain,
                void* fdiag, void* kgain_seq, void* fdiag_seq, int B, int N,
                int S, int newton, int doubling, void* stream) {
  const size_t smem = dare_smem<T>(N, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dare_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0) return 0;
  dare_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)phi, (const T*)q, (const T*)z, (const T*)r,
      (const T*)p_given, (T*)p_pred, (T*)p_filt, (T*)kgain, (T*)fdiag,
      (T*)kgain_seq, (T*)fdiag_seq, N, S, newton, doubling);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// phi (B, S), q (B, S, S), z (B, N, S), r (B, N); p_given (B, S, S) or
// null (null: solve the DARE); p_pred, p_filt (B, S, S), kgain,
// kgain_seq (B, S, N), fdiag, fdiag_seq (B, N).
int metran_dare_f32(const void* phi, const void* q, const void* z,
                    const void* r, const void* p_given, void* p_pred,
                    void* p_filt, void* kgain, void* fdiag, void* kgain_seq,
                    void* fdiag_seq, int B, int N, int S, int newton,
                    int doubling, void* stream) {
  return launch_dare<float>(phi, q, z, r, p_given, p_pred, p_filt, kgain,
                            fdiag, kgain_seq, fdiag_seq, B, N, S, newton,
                            doubling, stream);
}

int metran_dare_f64(const void* phi, const void* q, const void* z,
                    const void* r, const void* p_given, void* p_pred,
                    void* p_filt, void* kgain, void* fdiag, void* kgain_seq,
                    void* fdiag_seq, int B, int N, int S, int newton,
                    int doubling, void* stream) {
  return launch_dare<double>(phi, q, z, r, p_given, p_pred, p_filt, kgain,
                             fdiag, kgain_seq, fdiag_seq, B, N, S, newton,
                             doubling, stream);
}

const char* metran_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
