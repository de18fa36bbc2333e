// The orthogonal-transformation step shared by the square-root kernels K9
// (sqrt_filter.cu) and K10 (sqrt_smoother.cu): an unblocked Householder QR
// of a small matrix in shared memory, one thread block, LAPACK's geqr2
// arithmetic (the reflector of dlarfg: beta = -sign(alpha) |x|,
// tau = (beta - alpha) / beta, v = [1, x / (alpha - beta)]), so a factor
// agrees with torch.linalg.qr's (and jnp.linalg.qr's) to roundoff.
//
// The matrix is column-major with leading dimension ld.  Column j is
// known to be zero below the diagonal outside rows [lo_j, hi_j) with
// lo_j = max(j + 1, lo) and hi_j = min(rows, hi0 + j); the reflector of
// column j reads and writes only row j and those rows.  The skipped rows
// are exactly zero in the reflector, so skipping them changes no value
// (the masked slots of the square-root update and the zero block of the
// predict are never touched).
//
// Each thread forms the column norm itself (broadcast reads of one
// shared-memory column), so a stage needs one block barrier: the
// trailing columns are spread over the threads, each applying the
// reflector to its own columns.  On return row j of the upper triangle
// holds R's off-diagonal entries (columns > j) and diag[j] its diagonal,
// both before sign normalisation; the strictly lower part is left as it
// was and must not be read as R.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sqrtqr {

// an odd leading dimension: consecutive threads read columns ld apart,
// which an odd stride spreads over distinct banks (f32 and f64)
__host__ __device__ inline int odd_ld(int rows) { return rows | 1; }

// sign(x) with sign(0) = 1 and sign(NaN) = NaN, the factor the JAX
// package's _sign_normalize_rows multiplies a row of R by
template <typename T>
__device__ inline T row_sign(T x) {
  if (isnan(x)) return x;
  return x < T(0) ? T(-1) : T(1);
}

template <typename T, int kThreads>
__device__ void house_qr(T* a, int ld, int rows, int cols, int lo, int hi0,
                         T* diag) {
  const int tid = threadIdx.x;
  for (int j = 0; j < cols; ++j) {
    const int r0 = max(j + 1, lo);
    const int r1 = min(rows, hi0 + j);
    const T* cj = a + (size_t)j * ld;
    const T alpha = cj[j];
    T s0 = 0, s1 = 0;
    int i = r0;
    for (; i + 1 < r1; i += 2) {
      s0 += cj[i] * cj[i];
      s1 += cj[i + 1] * cj[i + 1];
    }
    if (i < r1) s0 += cj[i] * cj[i];
    const T sig = s0 + s1;
    T beta, tau, scale;
    if (sig == T(0)) {  // nothing below the diagonal: H = I
      beta = alpha;
      tau = 0;
      scale = 0;
    } else {
      const T nrm = sqrt(alpha * alpha + sig);
      beta = alpha >= T(0) ? -nrm : nrm;
      tau = (beta - alpha) / beta;
      scale = T(1) / (alpha - beta);
    }
    if (tid == 0) diag[j] = beta;
    // tau == 0 applies nothing, as LAPACK's dlarf (no 0 * inf here)
    for (int k = j + 1 + tid; tau != T(0) && k < cols; k += kThreads) {
      T* ck = a + (size_t)k * ld;
      T d0 = 0, d1 = 0;
      int ii = r0;
      for (; ii + 1 < r1; ii += 2) {
        d0 += cj[ii] * ck[ii];
        d1 += cj[ii + 1] * ck[ii + 1];
      }
      if (ii < r1) d0 += cj[ii] * ck[ii];
      const T wk = tau * (ck[j] + scale * (d0 + d1));
      ck[j] -= wk;
      const T u = scale * wk;
      for (int i2 = r0; i2 < r1; ++i2) ck[i2] -= cj[i2] * u;
    }
    __syncthreads();
  }
}

}  // namespace sqrtqr
