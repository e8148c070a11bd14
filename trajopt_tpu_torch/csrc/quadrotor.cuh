// The quaternion quadrotor's dynamics and RK3 step, and the dual numbers of
// the forward-mode Jacobians, shared by the kernels that inline them: the
// fused AL backward sweep (fused_al_backward.cu) and line search
// (fused_al_forward.cu) directly, and through the model traits of
// models.cuh the closed-loop rollout (rollout.cu) and the fused backward
// sweep and line search (fused_backward.cu, fused_forward.cu).
//
// Counterpart of quadrotor_dynamics_lanes / quadrotor_step_lanes in
// trajopt_tpu/ops/pallas_rollout.py. Templated on the scalar type: float
// for a rollout, Dual (a value and one tangent) for the forward-mode
// Jacobians that the TPU kernel takes with jax.linearize. No fast-math and
// no rsqrtf: the quaternion norm uses 1.0f / sqrtf, because an approximate
// reciprocal square root compounds over the horizon
// (ops/pallas_rollout.py:53-55).
#pragma once
#include <cuda_runtime.h>

namespace trajopt {

constexpr int kQuadN = 13;  // pos(3), quaternion [w,x,y,z](4), vel(3), omega(3)
constexpr int kQuadM = 4;

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

// Forward-mode dual number: v + d·ε.
struct Dual {
  float v, d;
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(float v_) : v(v_), d(0.f) {}
  __device__ __forceinline__ Dual(float v_, float d_) : v(v_), d(d_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return Dual(a.v + b.v, a.d + b.d);
}
__device__ __forceinline__ Dual operator+(Dual a, float b) {
  return Dual(a.v + b, a.d);
}
__device__ __forceinline__ Dual operator+(float a, Dual b) {
  return Dual(a + b.v, b.d);
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return Dual(a.v - b.v, a.d - b.d);
}
__device__ __forceinline__ Dual operator-(Dual a, float b) {
  return Dual(a.v - b, a.d);
}
__device__ __forceinline__ Dual operator-(float a, Dual b) {
  return Dual(a - b.v, -b.d);
}
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ Dual operator*(Dual a, float b) {
  return Dual(a.v * b, a.d * b);
}
__device__ __forceinline__ Dual operator*(float a, Dual b) {
  return Dual(a * b.v, a * b.d);
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, (a.d - q * b.d) / b.v);
}
__device__ __forceinline__ Dual operator/(Dual a, float b) {
  return Dual(a.v / b, a.d / b);
}
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  const float q = a / b.v;
  return Dual(q, -(q * b.d) / b.v);
}
__device__ __forceinline__ float tsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual tsqrt(Dual a) {
  const float s = sqrtf(a.v);
  return Dual(s, a.d / (2.0f * s));
}
// sinf and cosf, never the fast intrinsics: a line-search decision can hinge
// on the last bits of a rollout
__device__ __forceinline__ float tsin(float a) { return sinf(a); }
__device__ __forceinline__ Dual tsin(Dual a) {
  return Dual(sinf(a.v), cosf(a.v) * a.d);
}
__device__ __forceinline__ float tcos(float a) { return cosf(a); }
__device__ __forceinline__ Dual tcos(Dual a) {
  return Dual(cosf(a.v), -(sinf(a.v) * a.d));
}

template <class T>
__device__ __forceinline__ void quat_mul(T qw, T qx, T qy, T qz, T pw, T px,
                                         T py, T pz, T& w, T& x, T& y, T& z) {
  w = qw * pw - qx * px - qy * py - qz * pz;
  x = qw * px + pw * qx + qy * pz - qz * py;
  y = qw * py + pw * qy + qz * px - qx * pz;
  z = qw * pz + pw * qz + qx * py - qy * px;
}

// continuous dynamics (quadrotor_dynamics_lanes): x[13], u[4] -> xd[13]
template <class T>
__device__ __forceinline__ void quad_dynamics(const T* x, const T* u, T* xd) {
  const T qn =
      1.0f / tsqrt(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]);
  const T qw = x[3] * qn, qx = x[4] * qn, qy = x[5] * qn, qz = x[6] * qn;
  const T wx = x[10], wy = x[11], wz = x[12];

  const T F = kKf * (u[0] + u[1] + u[2] + u[3]);
  const T tx = kLkf * (u[1] - u[3]);
  const T ty = kLkf * (u[2] - u[0]);
  const T tz = kKm * (u[0] - u[1] + u[2] - u[3]);

  T dqw, dqx, dqy, dqz;
  quat_mul<T>(qw, qx, qy, qz, T(0.f), wx, wy, wz, dqw, dqx, dqy, dqz);

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
template <class T>
__device__ __forceinline__ void quad_rk3_step(const T* x, const T* u,
                                              float dt, T* out) {
  T k1[kQuadN], k2[kQuadN], k3[kQuadN], xt[kQuadN];
  quad_dynamics<T>(x, u, k1);
#pragma unroll
  for (int i = 0; i < kQuadN; ++i) {
    k1[i] = dt * k1[i];
    xt[i] = x[i] + 0.5f * k1[i];
  }
  quad_dynamics<T>(xt, u, k2);
#pragma unroll
  for (int i = 0; i < kQuadN; ++i) {
    k2[i] = dt * k2[i];
    xt[i] = x[i] - k1[i] + 2.0f * k2[i];
  }
  quad_dynamics<T>(xt, u, k3);
#pragma unroll
  for (int i = 0; i < kQuadN; ++i) {
    k3[i] = dt * k3[i];
    out[i] = x[i] + (k1[i] + 4.0f * k2[i] + k3[i]) / 6.0f;
  }
}

}  // namespace trajopt
