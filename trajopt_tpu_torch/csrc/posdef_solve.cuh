// Jacobi-equilibrated positive-definite elimination by one warp, on an
// augmented matrix in shared memory.
//
// Counterpart of _posdef_solve_lanes (trajopt_tpu/ops/pallas_riccati.py:84)
// and of the plain version ops/linalg.py::posdef_solve: the elimination
// runs on D·S·D with D = diag(1/sqrt(max(S_ii, 1e-30))) and the solution is
// unscaled. float32 pivot policy in the scaled space: a pivot below -1e-3,
// or a non-finite one, fails; a pivot in (-1e-3, 1e-7) has run out of
// float32 information and is clamped to 1e-7. 1.0f / sqrtf, not rsqrtf.
//
// The TPU kernel applies one masked rank-1 update of the whole lane tile
// per pivot because it is bound by instruction dispatch; here the warp's
// lanes split the entries of the trailing block, and the back-substitution
// gives each right-hand side to one lane.
#pragma once
#include <cuda_runtime.h>

namespace trajopt {

constexpr float kPivotNegTol = 1e-3f;
constexpr float kPivotFloor = 1e-7f;

// aug: M rows of LD floats, [S (M×M) | rhs (M×K)], K <= 32. On return the
// rhs block holds X = S⁻¹ rhs. dscale and piv are M floats of scratch.
// Returns fail, the same on every lane; a failed solve leaves X undefined.
template <int M, int K, int LD>
__device__ __forceinline__ bool posdef_solve_warp(float* aug, float* dscale,
                                                  float* piv, int lane) {
  static_assert(K <= 32 && M <= 32, "one lane per right-hand side and row");
  if (lane < M) dscale[lane] = 1.0f / sqrtf(fmaxf(aug[lane * LD + lane], 1e-30f));
  __syncwarp();
  for (int e = lane; e < M * (M + K); e += 32) {
    const int i = e / (M + K), c = e % (M + K);
    float v = aug[i * LD + c] * dscale[i];
    if (c < M) v = v * dscale[c];
    aug[i * LD + c] = v;
  }
  __syncwarp();

  bool fail = false;
  for (int i = 0; i < M; ++i) {
    float p = aug[i * LD + i];
    fail = fail || (p < -kPivotNegTol) || !isfinite(p);
    p = fmaxf(p, kPivotFloor);
    if (lane == 0) piv[i] = p;
    const float inv = 1.0f / p;
    const int ncols = M + K - 1 - i;
    const int count = (M - 1 - i) * ncols;
    for (int e = lane; e < count; e += 32) {
      const int j = i + 1 + e / ncols, c = i + 1 + e % ncols;
      const float f = aug[j * LD + i] * inv;
      aug[j * LD + c] = aug[j * LD + c] - f * aug[i * LD + c];
    }
    __syncwarp();
  }

  // back-substitution: lane c owns right-hand side c
  if (lane < K) {
    float* x = aug + M + lane;
    for (int i = M - 1; i >= 0; --i) {
      float r = x[i * LD];
      for (int j = i + 1; j < M; ++j) r = r - aug[i * LD + j] * x[j * LD];
      x[i * LD] = r / piv[i];
    }
    for (int i = 0; i < M; ++i) x[i * LD] = x[i * LD] * dscale[i];
  }
  __syncwarp();
  return fail;
}

}  // namespace trajopt
