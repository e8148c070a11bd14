// Jacobi-equilibrated positive-definite elimination by a team of threads
// (the consumer warps of a knot pipeline, or its lone warp), on an
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
// per pivot because it is bound by instruction dispatch; here the team's
// warps split the rows of the scaling and of each trailing update and their
// lanes the columns, and the back-substitution gives each right-hand side
// to one thread. Every entry is computed by the same arithmetic whichever
// thread owns it (explicit __fmaf_rn), so the result does not depend on the
// team's size.
#pragma once
#include <cuda_runtime.h>

namespace trajopt {

constexpr float kPivotNegTol = 1e-3f;
constexpr float kPivotFloor = 1e-7f;

// aug: M rows of LD floats, [S (M×M) | rhs (M×K)], K <= 32. On return the
// rhs block holds X = S⁻¹ rhs. dscale and piv are M floats of scratch.
// Thread t of a team of nt (a multiple of 32) with the barrier `sync`.
// Returns fail, the same on every thread; a failed solve leaves X undefined.
template <int M, int K, int LD, class Sync>
__device__ __forceinline__ bool posdef_solve(float* aug, float* dscale,
                                             float* piv, int t, int nt,
                                             Sync sync) {
  static_assert(K <= 32 && M <= 32, "one thread per right-hand side and row");
  if (t < M) dscale[t] = 1.0f / sqrtf(fmaxf(aug[t * LD + t], 1e-30f));
  sync();
  const int lane = t & 31, warp = t >> 5, nw = nt >> 5;
  for (int i = warp; i < M; i += nw) {
    for (int c = lane; c < M + K; c += 32) {
      float v = __fmul_rn(aug[i * LD + c], dscale[i]);
      if (c < M) v = __fmul_rn(v, dscale[c]);
      aug[i * LD + c] = v;
    }
  }
  sync();

  bool fail = false;
  for (int i = 0; i < M; ++i) {
    float p = aug[i * LD + i];
    fail = fail || (p < -kPivotNegTol) || !isfinite(p);
    p = fmaxf(p, kPivotFloor);
    if (t == 0) piv[i] = p;
    const float inv = 1.0f / p;
    // the trailing update: columns over the lanes, rows over the warps,
    // kRows rows of a warp read before any of them is written (the rows
    // are independent; the compiler cannot tell and would wait for each)
    constexpr int kRows = 4;
    for (int c = i + 1 + lane; c < M + K; c += 32) {
      const float aic = aug[i * LD + c];
      for (int j0 = i + 1 + warp; j0 < M; j0 += kRows * nw) {
        float v[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int j = j0 + q * nw;
          if (j < M)
            v[q] = __fmaf_rn(-__fmul_rn(aug[j * LD + i], inv), aic,
                             aug[j * LD + c]);
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const int j = j0 + q * nw;
          if (j < M) aug[j * LD + c] = v[q];
        }
      }
    }
    sync();
  }

  // back-substitution: thread c owns right-hand side c
  if (t < K) {
    float* x = aug + M + t;
    for (int i = M - 1; i >= 0; --i) {
      float r = x[i * LD];
      for (int j = i + 1; j < M; ++j)
        r = __fmaf_rn(-aug[i * LD + j], x[j * LD], r);
      x[i * LD] = r / piv[i];
    }
    for (int i = 0; i < M; ++i) x[i * LD] = __fmul_rn(x[i * LD], dscale[i]);
  }
  sync();
  return fail;
}

}  // namespace trajopt
