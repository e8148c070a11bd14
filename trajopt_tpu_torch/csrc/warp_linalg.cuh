// Small dense linear algebra for a team of threads working on matrices in
// shared memory: the consumer warps of a knot pipeline (K3, K5, K7a:
// knot_pipeline.cuh), or its lone warp. The threads split the entries of a
// product, each entry one dot product; the sizes are compile-time
// constants, so the inner loops unroll.
#pragma once
#include <cuda_runtime.h>

namespace trajopt {

constexpr unsigned kFullMask = 0xffffffffu;

// Σ_r A[r·sar]·B[r·sbr] for r ascending, rounded as nvcc contracts the
// plain loop `acc = A0·B0; acc = acc + Ar·Br`: A1·B1 rounded on its own
// with A0·B0 fused into it, every later product fused into the sum.
// Written with the intrinsics, an entry rounds the same whichever thread
// computes it and however the caller is inlined.
template <int R>
__device__ __forceinline__ float dot_entry(const float* A, int sar,
                                           const float* B, int sbr) {
  if constexpr (R == 1) {
    return __fmul_rn(A[0], B[0]);
  } else {
    float acc = __fmaf_rn(A[0], B[0], __fmul_rn(A[sar], B[sbr]));
#pragma unroll
    for (int r = 2; r < R; ++r) acc = __fmaf_rn(A[r * sar], B[r * sbr], acc);
    return acc;
  }
}

// add + Σ_r A[r·sar]·B[r·sbr], rounded as nvcc contracts `add + acc` after
// that loop: a single product fused into add, a longer sum added to it
template <int R>
__device__ __forceinline__ float add_dot(float add, const float* A, int sar,
                                        const float* B, int sbr) {
  if constexpr (R == 1) {
    return __fmaf_rn(A[0], B[0], add);
  } else {
    return __fadd_rn(add, dot_entry<R>(A, sar, B, sbr));
  }
}

// The barrier of a team: the warps of a named barrier (bar.sync id,
// threads), which the other warps of the block never touch
struct NamedSync {
  int id, threads;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
  }
};

// v[lane] of a register array with compile-time indices (v[0] on lanes
// past its end), without moving v to local memory
template <int N>
__device__ __forceinline__ float lane_value(const float (&v)[N], int lane) {
  float out = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (lane == i) out = v[i];
  return out;
}

// Sum over the warp, the same value on every lane, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFullMask, v, o);
  return v;
}

}  // namespace trajopt
