// Small dense products for one warp working on matrices in shared memory:
// the lanes split the output's entries, each entry is one dot product. The
// building block of the Riccati step (riccati_step.cuh); the sizes are
// compile-time constants, so the inner loops unroll.
#pragma once
#include <cuda_runtime.h>

namespace trajopt {

constexpr unsigned kFullMask = 0xffffffffu;

// C[i*ldc + j] = (add ? add[i*ldadd + j] : 0) + scale · Σ_r A(i,r)·B(r,j)
// for i < P, j < Q, with A(i,r) = A[i*sai + r*sar], B(r,j) = B[r*sbr + j*sbj].
// The sum runs over r ascending and is added to `add` last. C may alias
// `add` (each lane reads only the entry it writes), not A or B. Ends with a
// __syncwarp().
template <int P, int Q, int R>
__device__ __forceinline__ void warp_mm(float* C, int ldc, const float* A,
                                        int sai, int sar, const float* B,
                                        int sbr, int sbj, const float* add,
                                        int ldadd, float scale, int lane) {
  for (int e = lane; e < P * Q; e += 32) {
    const int i = e / Q, j = e % Q;
    float acc = A[i * sai] * B[j * sbj];
#pragma unroll
    for (int r = 1; r < R; ++r)
      acc = acc + A[i * sai + r * sar] * B[r * sbr + j * sbj];
    acc = scale * acc;
    C[i * ldc + j] = add ? add[i * ldadd + j] + acc : acc;
  }
  __syncwarp();
}

// Sum over the warp, the same value on every lane, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFullMask, v, o);
  return v;
}

}  // namespace trajopt
