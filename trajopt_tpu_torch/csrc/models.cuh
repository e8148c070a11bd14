// The models whose discrete step the kernels inline, behind one trait:
//   NX, NU            state and control widths
//   step<T>(x, u, dt, out)   the RK3 step with zero-order hold
// templated on the scalar type, so float rolls a trajectory out and Dual (a
// value and one tangent, below) carries one direction through the same code
// for the forward-mode Jacobians of the fused backward sweeps, which the TPU
// kernels take with jax.linearize.
//
// Counterpart of the lane steps of trajopt_tpu/ops/pallas_rollout.py
// (quadrotor_step_lanes, cartpole_step_lanes and the _rk3_lanes family:
// car, pendulum, double integrator) with the same constants, and of the
// slack step of the infeasible-start model (solvers/altro.py:
// x⁺ = base_step(x, u[:m]) + u[m:]), which WithSlack<M> adds to any of them.
// Each dynamics function keeps the order of operations of its plain PyTorch
// version (models/zoo.py), because a divergence guard or a line-search
// decision can hinge on the last bits. No fast-math and no rsqrtf: sinf,
// cosf, true division, and 1.0f / sqrtf for the quaternion norm, because an
// approximate reciprocal square root compounds over the horizon
// (ops/pallas_rollout.py:53-55).
//
// The ids are what the C entry points take (ops/cuda_models.py holds the
// same table): a base model's id, plus kModelSlack for its slack-augmented
// form.
#pragma once
#include <cuda_runtime.h>

namespace trajopt {

enum ModelId {
  kModelQuadrotor = 0,
  kModelCartpole = 1,
  kModelCar = 2,
  kModelPendulum = 3,
  kModelDoubleIntegrator = 4,
  kModelSlack = 5,      // id of WithSlack<M> = id of M + kModelSlack
};


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

// the quaternion quadrotor (quad_dynamics above)
struct Quadrotor {
  static constexpr int NX = kQuadN, NU = kQuadM;
  template <class T>
  static __device__ __forceinline__ void dynamics(const T* x, const T* u,
                                                  T* xd) {
    quad_dynamics<T>(x, u, xd);
  }
  template <class T>
  static __device__ __forceinline__ void step(const T* x, const T* u, float dt,
                                              T* out) {
    rk3_step<Quadrotor, T>(x, u, dt, out);
  }
};

// the infeasible-start model of M: NX slack controls added to the base step
template <class M>
struct WithSlack {
  static constexpr int NX = M::NX, NU = M::NU + M::NX;
  template <class T>
  static __device__ __forceinline__ void step(const T* x, const T* u, float dt,
                                              T* out) {
    M::template step<T>(x, u, dt, out);
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = out[i] + u[M::NU + i];
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
