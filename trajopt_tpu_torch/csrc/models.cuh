// The models whose discrete step the kernels inline, behind one trait:
//   NX, NU            state and control widths
//   step<T>(x, u, dt, out)   the RK3 step with zero-order hold
// templated on the scalar type, so float rolls a trajectory out and Dual
// (quadrotor.cuh) carries one tangent through the same code for the
// forward-mode Jacobians of the fused backward sweep.
//
// Counterpart of the lane steps of trajopt_tpu/ops/pallas_rollout.py
// (quadrotor_step_lanes, cartpole_step_lanes and the _rk3_lanes family:
// car, pendulum, double integrator) with the same constants, and of the
// slack step of the infeasible-start model (solvers/altro.py:
// x⁺ = base_step(x, u[:4]) + u[4:]). Each dynamics function keeps the order
// of operations of its plain PyTorch version (models/zoo.py), because a
// divergence guard or a line-search decision can hinge on the last bits.
// No fast-math: sinf, cosf and true division.
//
// The ids are what the C entry points take (ops/cuda_models.py holds the
// same table).
#pragma once
#include <cuda_runtime.h>

#include "quadrotor.cuh"

namespace trajopt {

enum ModelId {
  kModelQuadrotor = 0,
  kModelCartpole = 1,
  kModelCar = 2,
  kModelPendulum = 3,
  kModelDoubleIntegrator = 4,
  kModelQuadrotorSlack = 5,
};

// x⁺ = x + (k1 + 4 k2 + k3)/6 with k1 = dt f(x), k2 = dt f(x + k1/2),
// k3 = dt f(x − k1 + 2 k2); the sums in the order of ops/integration.py::rk3
template <class Dyn, class T>
__device__ __forceinline__ void rk3_step(const T* x, const T* u, float dt,
                                         T* out) {
  constexpr int NX = Dyn::NX;
  T k1[NX], k2[NX], k3[NX], xt[NX];
  Dyn::template dynamics<T>(x, u, k1);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    k1[i] = dt * k1[i];
    xt[i] = x[i] + 0.5f * k1[i];
  }
  Dyn::template dynamics<T>(xt, u, k2);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    k2[i] = dt * k2[i];
    xt[i] = x[i] - k1[i] + 2.0f * k2[i];
  }
  Dyn::template dynamics<T>(xt, u, k3);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    k3[i] = dt * k3[i];
    out[i] = x[i] + (k1[i] + 4.0f * k2[i] + k3[i]) / 6.0f;
  }
}

struct Quadrotor {
  static constexpr int NX = kQuadN, NU = kQuadM;
  template <class T>
  static __device__ __forceinline__ void step(const T* x, const T* u, float dt,
                                              T* out) {
    quad_rk3_step<T>(x, u, dt, out);
  }
};

// the infeasible-start model: 13 slack controls added to the base step
struct QuadrotorSlack {
  static constexpr int NX = kQuadN, NU = kQuadM + kQuadN;
  template <class T>
  static __device__ __forceinline__ void step(const T* x, const T* u, float dt,
                                              T* out) {
    quad_rk3_step<T>(x, u, dt, out);
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = out[i] + u[kQuadM + i];
  }
};

// cart-pole by the manipulator equations, the 2x2 mass-matrix solve written
// as an explicit inverse (cartpole_dynamics_lanes): mc = 1, mp = 0.2,
// l = 0.5, g = 9.81; state [x, theta, v, omega]
struct Cartpole {
  static constexpr int NX = 4, NU = 1;
  template <class T>
  static __device__ __forceinline__ void dynamics(const T* x, const T* u,
                                                  T* xd) {
    constexpr float h11 = (float)(1.0 + 0.2);
    constexpr float mpl = (float)(0.2 * 0.5);
    constexpr float h22 = (float)(0.2 * 0.5 * 0.5);
    constexpr float h11h22 = (float)((1.0 + 0.2) * (0.2 * 0.5 * 0.5));
    constexpr float mgl = (float)(-0.2 * 9.81 * 0.5);
    const T v = x[2], w = x[3];
    const T s = tsin(x[1]), c = tcos(x[1]);
    const T h12 = mpl * c;
    const T det = h11h22 - h12 * h12;
    const T r1 = u[0] + 0.2f * w * 0.5f * s * w;
    const T r2 = mgl * s;
    xd[0] = v;
    xd[1] = w;
    xd[2] = (h22 * r1 - h12 * r2) / det;
    xd[3] = (h11 * r2 - h12 * r1) / det;
  }
  template <class T>
  static __device__ __forceinline__ void step(const T* x, const T* u, float dt,
                                              T* out) {
    rk3_step<Cartpole, T>(x, u, dt, out);
  }
};

// Dubins car: state [x, y, theta], controls [v, omega]
struct Car {
  static constexpr int NX = 3, NU = 2;
  template <class T>
  static __device__ __forceinline__ void dynamics(const T* x, const T* u,
                                                  T* xd) {
    xd[0] = u[0] * tcos(x[2]);
    xd[1] = u[0] * tsin(x[2]);
    xd[2] = u[1];
  }
  template <class T>
  static __device__ __forceinline__ void step(const T* x, const T* u, float dt,
                                              T* out) {
    rk3_step<Car, T>(x, u, dt, out);
  }
};

// damped pendulum: m = 1, b = 0.1, lc = 0.5, I = 0.25, g = 9.81
struct Pendulum {
  static constexpr int NX = 2, NU = 1;
  template <class T>
  static __device__ __forceinline__ void dynamics(const T* x, const T* u,
                                                  T* xd) {
    constexpr float mglc = (float)(1.0 * 9.81 * 0.5);
    xd[0] = x[1];
    xd[1] = (u[0] - mglc * tsin(x[0]) - 0.1f * x[1]) / 0.25f;
  }
  template <class T>
  static __device__ __forceinline__ void step(const T* x, const T* u, float dt,
                                              T* out) {
    rk3_step<Pendulum, T>(x, u, dt, out);
  }
};

struct DoubleIntegrator {
  static constexpr int NX = 2, NU = 1;
  template <class T>
  static __device__ __forceinline__ void dynamics(const T* x, const T* u,
                                                  T* xd) {
    xd[0] = x[1];
    xd[1] = u[0];
  }
  template <class T>
  static __device__ __forceinline__ void step(const T* x, const T* u, float dt,
                                              T* out) {
    rk3_step<DoubleIntegrator, T>(x, u, dt, out);
  }
};

}  // namespace trajopt
