// Closed-loop quadrotor rollout, batched over problems (kernel K2).
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_rollout.py::_rollout_kernel
// (front end rollout_closed_loop_pallas) with the quadrotor step inlined:
// quadrotor_step_lanes / quadrotor_dynamics_lanes (RK3 with zero-order
// hold) and quadrotor_state_diff_lanes (quaternion error state). For every
// problem and knot k:
//   u_k = U_k + K_k·δx_k + α d_k,  δx_k = state_diff(x̄_k, X_k)
//   x̄_{k+1} = rk3(x̄_k, u_k, dt)
// A problem dies when |x̄| or |u| reaches its limit or x̄ turns non-finite,
// and then holds its last state; ok reports whether it stayed alive. The
// limits and dt are kernel arguments. The plain twin is
// trajopt_tpu_torch/ops/rollout.py::rollout_closed_loop.
//
// What bounds it on this card: latency. Each problem is a chain of N-1
// dependent RK3 steps (three dynamics evaluations, ~300 flops); the
// main path reads 128 x 100 x (13 + 4 + 48 + 4) floats (~3.5 MB) per
// launch, far below what bandwidth would notice.
//
// Design: one thread per problem; state, control and the gain row live in
// registers, and n = 13, ns = 12 (the quaternion error state) and m = 4
// are compile-time constants. Loads are
// strided across threads (batch-first layout, as the solver holds the
// arrays); a lane-major layout or one warp per problem is later work. No
// fast-math and no rsqrtf: the quaternion norm uses 1.0f / sqrtf, because
// an approximate reciprocal square root compounds over the horizon
// (ops/pallas_rollout.py:53-55).
#include <cuda_runtime.h>

namespace {

constexpr int kN = 13;
constexpr int kNs = 12;
constexpr int kM = 4;

// quadrotor constants (models/zoo.py QUAD_PARAMS), folded in double
constexpr float kMass = 0.5f;
constexpr float kKf = 1.0f;
constexpr float kKm = 0.0245f;
constexpr float kJx = 0.0023f, kJy = 0.0023f, kJz = 0.004f;
constexpr float kJzy = (float)(0.004 - 0.0023);
constexpr float kJxz = (float)(0.0023 - 0.004);
constexpr float kJyx = (float)(0.0023 - 0.0023);
constexpr float kLkf = (float)(0.1750 * 1.0);
constexpr float kG = -9.81f;

__device__ __forceinline__ void quat_mul(float qw, float qx, float qy,
                                         float qz, float pw, float px,
                                         float py, float pz, float& w,
                                         float& x, float& y, float& z) {
  w = qw * pw - qx * px - qy * py - qz * pz;
  x = qw * px + pw * qx + qy * pz - qz * py;
  y = qw * py + pw * qy + qz * px - qx * pz;
  z = qw * pz + pw * qz + qx * py - qy * px;
}

// continuous dynamics (quadrotor_dynamics_lanes)
__device__ __forceinline__ void dynamics(const float* x, const float* u,
                                         float* xd) {
  const float qn =
      1.0f / sqrtf(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]);
  const float qw = x[3] * qn, qx = x[4] * qn, qy = x[5] * qn, qz = x[6] * qn;
  const float wx = x[10], wy = x[11], wz = x[12];

  const float F = kKf * (u[0] + u[1] + u[2] + u[3]);
  const float tx = kLkf * (u[1] - u[3]);
  const float ty = kLkf * (u[2] - u[0]);
  const float tz = kKm * (u[0] - u[1] + u[2] - u[3]);

  float dqw, dqx, dqy, dqz;
  quat_mul(qw, qx, qy, qz, 0.f, wx, wy, wz, dqw, dqx, dqy, dqz);

  xd[0] = x[7];
  xd[1] = x[8];
  xd[2] = x[9];
  xd[3] = 0.5f * dqw;
  xd[4] = 0.5f * dqx;
  xd[5] = 0.5f * dqy;
  xd[6] = 0.5f * dqz;
  xd[7] = 2.0f * (qx * qz + qw * qy) * F / kMass;
  xd[8] = 2.0f * (qy * qz - qw * qx) * F / kMass;
  xd[9] = (1.0f - 2.0f * (qx * qx + qy * qy)) * F / kMass + kG;
  xd[10] = (tx - kJzy * wy * wz) / kJx;
  xd[11] = (ty - kJxz * wz * wx) / kJy;
  xd[12] = (tz - kJyx * wx * wy) / kJz;
}

// RK3 step with zero-order hold (quadrotor_step_lanes)
__device__ __forceinline__ void rk3_step(const float* x, const float* u,
                                         float dt, float* out) {
  float k1[kN], k2[kN], k3[kN], xt[kN];
  dynamics(x, u, k1);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    k1[i] = dt * k1[i];
    xt[i] = x[i] + 0.5f * k1[i];
  }
  dynamics(xt, u, k2);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    k2[i] = dt * k2[i];
    xt[i] = x[i] - k1[i] + 2.0f * k2[i];
  }
  dynamics(xt, u, k3);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    k3[i] = dt * k3[i];
    out[i] = x[i] + (k1[i] + 4.0f * k2[i] + k3[i]) / 6.0f;
  }
}

// δx = state_diff(x, xr) with the cancellation-free quaternion error
// (quadrotor_state_diff_lanes)
__device__ __forceinline__ void state_diff(const float* x, const float* xr,
                                           float* dx) {
  const float rw = xr[3], rx = xr[4], ry = xr[5], rz = xr[6];
  // dq = conj(q_ref) ⊗ (q − q_ref), scalar part += |q_ref|²
  float dw, ex, ey, ez;
  quat_mul(rw, -rx, -ry, -rz, x[3] - rw, x[4] - rx, x[5] - ry, x[6] - rz,
           dw, ex, ey, ez);
  const float nrm = rw * rw + rx * rx + ry * ry + rz * rz;
  float den = nrm + dw;
  // sign-preserving floor at the 180°-error singularity
  if (fabsf(den) < 1e-6f) den = den < 0.f ? -1e-6f : 1e-6f;
  const float inv = 2.0f / den;
  dx[0] = x[0] - xr[0];
  dx[1] = x[1] - xr[1];
  dx[2] = x[2] - xr[2];
  dx[3] = ex * inv;
  dx[4] = ey * inv;
  dx[5] = ez * inv;
#pragma unroll
  for (int i = 6; i < kNs; ++i) dx[i] = x[i + 1] - xr[i + 1];
}

__global__ void rollout_quadrotor_kernel(
    const float* __restrict__ x0, const float* __restrict__ X,
    const float* __restrict__ U, const float* __restrict__ K,
    const float* __restrict__ d, const float* __restrict__ alpha,
    float* __restrict__ Xout, float* __restrict__ Uout,
    unsigned char* __restrict__ ok, int batch, int N, float dt,
    float max_state, float max_control) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int Nm1 = N - 1;
  float x[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    x[i] = x0[(size_t)b * kN + i];
    Xout[(size_t)b * N * kN + i] = x[i];
  }
  const float a = alpha[b];
  bool alive = true;
  for (int k = 0; k < Nm1; ++k) {
    const size_t bk = (size_t)b * Nm1 + k;
    const float* Xk = X + ((size_t)b * N + k) * kN;
    float xr[kN], dx[kNs], u[kM], xn[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) xr[i] = Xk[i];
    state_diff(x, xr, dx);
    const float* Kk = K + bk * kM * kNs;
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      float acc = Kk[i * kNs] * dx[0];
#pragma unroll
      for (int c = 1; c < kNs; ++c) acc = acc + Kk[i * kNs + c] * dx[c];
      u[i] = U[bk * kM + i] + acc + a * d[bk * kM + i];
    }
    rk3_step(x, u, dt, xn);
    bool good = true;
#pragma unroll
    for (int i = 0; i < kN; ++i)
      good = good && fabsf(xn[i]) < max_state && isfinite(xn[i]);
#pragma unroll
    for (int i = 0; i < kM; ++i) good = good && fabsf(u[i]) < max_control;
    alive = alive && good;
    float* Xo = Xout + ((size_t)b * N + k + 1) * kN;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (alive) x[i] = xn[i];
      Xo[i] = x[i];
    }
#pragma unroll
    for (int i = 0; i < kM; ++i) Uout[bk * kM + i] = u[i];
  }
  ok[b] = alive ? 1 : 0;
}

}  // namespace

// C entry point (bound with ctypes from ops/cuda_rollout.py). Batch-first
// contiguous float32: x0 (B,13), X (B,N,13), U (B,N-1,4), K (B,N-1,4,12),
// d (B,N-1,4), alpha (B,) → Xout (B,N,13), Uout (B,N-1,4), ok (B,) bytes.
// Returns the CUDA error of the launch (0 on success).
extern "C" int trajopt_rollout_quadrotor_f32(
    const float* x0, const float* X, const float* U, const float* K,
    const float* d, const float* alpha, float* Xout, float* Uout,
    unsigned char* ok, int batch, int N, float dt, float max_state,
    float max_control, void* stream) {
  if (batch <= 0 || N < 2) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  rollout_quadrotor_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x0, X, U, K, d, alpha, Xout, Uout, ok, batch, N, dt, max_state,
      max_control);
  return (int)cudaGetLastError();
}
