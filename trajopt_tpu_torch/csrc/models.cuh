// The models whose discrete step the kernels inline, behind one trait:
//   NX, NU            state and control widths
//   step<T>(x, u, dt, out, chain)   the RK3 step with zero-order hold
// templated on the scalar type, so float rolls a trajectory out and Dual (a
// value and one tangent, below) carries one direction through the same code
// for the forward-mode Jacobians of the fused backward sweeps, which the TPU
// kernels take with jax.linearize; and the warp form of the float step, for
// the kernels that give each problem a warp (K2, K4):
//   kChain            whether the step reads a chain table
//   kWarpScratch      floats of shared memory the warp step needs per warp
//   step_warp(x, u, dt, out, tab, scr, lane)
// called on all 32 lanes of a warp with the same x and u on every lane, it
// leaves the same out on every lane. A scalar model's warp step is its step,
// run in registers on every lane (RegisterStep); a chain's is computed by
// the warp together, from its table staged in shared memory
// (stage_chain_table, chain_dynamics_warp).
//
// Counterpart of the lane steps of trajopt_tpu/ops/pallas_rollout.py
// (quadrotor_step_lanes, cartpole_step_lanes and the _rk3_lanes family:
// car, pendulum, double integrator) with the same constants, of the
// rigid-body chain step of trajopt_tpu/models/rigidbody_lanes.py
// (make_chain_step_lanes: Chain<NDOF, NU> below, for the arm and the three
// two-link rigs, which reads its chain from a table in device memory that
// the kernel is handed; the other models take no table and ignore the
// argument), and of the slack step of the
// infeasible-start model (solvers/altro.py: x⁺ = base_step(x, u[:m]) +
// u[m:]), which WithSlack<M> adds to any of them; the rollout kernel K2 alone
// also carries ballonbeam, the Euler-angle quadrotor, the analytic double
// pendulum and acrobot (TwoLink) and the minimum-time form MinTime<M> of
// every model, the chains included (solvers/altro.py:
// x⁺ = [base_step(x[:-1], u[:-1], h²); h], h = u[-1]), which the JAX
// package gives no lane step and never runs fused.
// Each dynamics function keeps the order of operations of its plain PyTorch
// version (models/zoo.py), because a divergence guard or a line-search
// decision can hinge on the last bits. No fast-math and no rsqrtf: sinf,
// cosf, true division, and 1.0f / sqrtf for the quaternion norm, because an
// approximate reciprocal square root compounds over the horizon
// (ops/pallas_rollout.py:53-55).
//
// The ids are what the C entry points take (ops/cuda_models.py holds the
// same table): a base model's id, plus kModelSlack for its slack-augmented
// form, plus kModelMinTime for the minimum-time form of either.
#pragma once
#include <cuda_runtime.h>

#include <type_traits>

#include "warp_linalg.cuh"

namespace trajopt {

struct ChainTable;   // a rigid-body chain's data (below)

enum ModelId {
  kModelQuadrotor = 0,
  kModelCartpole = 1,
  kModelCar = 2,
  kModelPendulum = 3,
  kModelDoubleIntegrator = 4,
  kModelKuka = 5,
  kModelAcrobotUrdf = 6,
  kModelDoublependulumUrdf = 7,
  kModelCartpoleUrdf = 8,
  kModelBallonbeam = 9,
  kModelQuadrotorEuler = 10,
  kModelDoublependulum = 11,
  kModelAcrobot = 12,
  kModelSlack = 13,     // id of WithSlack<M> = id of M + kModelSlack
  kModelMinTime = 26,   // id of MinTime<M> = id of M + kModelMinTime
};

// whether model id `model` (in any of its forms: kModelMinTime is twice
// kModelSlack) is a rigid-body chain, whose kernels need its ChainTable
__host__ __device__ constexpr bool is_chain_model(int model) {
  return model >= 0 && model % kModelSlack >= kModelKuka
         && model % kModelSlack <= kModelCartpoleUrdf;
}


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
// max(a, floor) with the derivative of the branch taken
__device__ __forceinline__ float tmax(float a, float floor) {
  return fmaxf(a, floor);
}
__device__ __forceinline__ Dual tmax(Dual a, float floor) {
  return a.v >= floor ? a : Dual(floor);
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
// k3 = dt f(x − k1 + 2 k2); the sums in the order of ops/integration.py::rk3.
// ctx is what Dyn's dynamics take besides x and u: a chain's table, or the
// warp's context of the warp step (WarpStep)
template <class Dyn, class T, class Ctx>
__device__ __forceinline__ void rk3_step(const T* x, const T* u, float dt,
                                         T* out, Ctx chain) {
  constexpr int NX = Dyn::NX;
  T k1[NX], k2[NX], k3[NX], xt[NX];
  Dyn::template dynamics<T>(x, u, k1, chain);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    k1[i] = dt * k1[i];
    xt[i] = x[i] + 0.5f * k1[i];
  }
  Dyn::template dynamics<T>(xt, u, k2, chain);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    k2[i] = dt * k2[i];
    xt[i] = x[i] - k1[i] + 2.0f * k2[i];
  }
  Dyn::template dynamics<T>(xt, u, k3, chain);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    k3[i] = dt * k3[i];
    out[i] = x[i] + (k1[i] + 4.0f * k2[i] + k3[i]) / 6.0f;
  }
}

// The warp step of a model whose step needs no table: every lane runs the
// float step in registers (Self: the trait itself).
template <class Self>
struct RegisterStep {
  static constexpr bool kChain = false;
  static constexpr int kWarpScratch = 0;
  static __device__ __forceinline__ void step_warp(const float* x,
                                                   const float* u, float dt,
                                                   float* out,
                                                   const ChainTable*, float*,
                                                   int) {
    Self::template step<float>(x, u, dt, out);
  }
};

// the quaternion quadrotor (quad_dynamics above)
struct Quadrotor : RegisterStep<Quadrotor> {
  static constexpr int NX = kQuadN, NU = kQuadM;
  template <class T>
  static __device__ __forceinline__ void dynamics(
      const T* x, const T* u, T* xd, const ChainTable* = nullptr) {
    quad_dynamics<T>(x, u, xd);
  }
  template <class T>
  static __device__ __forceinline__ void step(
      const T* x, const T* u, float dt, T* out,
      const ChainTable* chain = nullptr) {
    rk3_step<Quadrotor, T>(x, u, dt, out, chain);
  }
};

// the infeasible-start model of M: NX slack controls added to the base step
template <class M>
struct WithSlack {
  static constexpr int NX = M::NX, NU = M::NU + M::NX;
  static constexpr bool kChain = M::kChain;
  static constexpr int kWarpScratch = M::kWarpScratch;
  template <class T>
  static __device__ __forceinline__ void step(
      const T* x, const T* u, float dt, T* out,
      const ChainTable* chain = nullptr) {
    M::template step<T>(x, u, dt, out, chain);
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = out[i] + u[M::NU + i];
  }
  static __device__ __forceinline__ void step_warp(const float* x,
                                                   const float* u, float dt,
                                                   float* out,
                                                   const ChainTable* tab,
                                                   float* scr, int lane) {
    M::step_warp(x, u, dt, out, tab, scr, lane);
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = out[i] + u[M::NU + i];
  }
};

// The minimum-time model of M (solvers/altro.py::minimum_time_problem): one
// more control h = u[NU - 1] and one more state that carries it; the step
// is M's with dt = h² (the dt argument is ignored) and x⁺[NX - 1] = h. Over
// WithSlack<M> it is the infeasible-start problem's minimum-time form (the
// slacks come first and h last, as the transforms are applied). K2's warp
// step only. Over a chain it reads M's table and M's warp scratch: M's step
// is computed by the warp together but leaves its result in every lane's
// registers (out[0..M::NX-1], after the step's last __syncwarp), so each
// lane writes the state h into its own out[M::NX] and no lane races another.
template <class M>
struct MinTime {
  static constexpr int NX = M::NX + 1, NU = M::NU + 1;
  static constexpr bool kChain = M::kChain;
  static constexpr int kWarpScratch = M::kWarpScratch;
  static __device__ __forceinline__ void step_warp(const float* x,
                                                   const float* u, float,
                                                   float* out,
                                                   const ChainTable* tab,
                                                   float* scr, int lane) {
    const float h = u[M::NU];
    M::step_warp(x, u, h * h, out, tab, scr, lane);
    out[M::NX] = h;
  }
};

// cart-pole by the manipulator equations, the 2x2 mass-matrix solve written
// as an explicit inverse (cartpole_dynamics_lanes): mc = 1, mp = 0.2,
// l = 0.5, g = 9.81; state [x, theta, v, omega]
struct Cartpole : RegisterStep<Cartpole> {
  static constexpr int NX = 4, NU = 1;
  template <class T>
  static __device__ __forceinline__ void dynamics(
      const T* x, const T* u, T* xd, const ChainTable* = nullptr) {
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
  static __device__ __forceinline__ void step(
      const T* x, const T* u, float dt, T* out,
      const ChainTable* chain = nullptr) {
    rk3_step<Cartpole, T>(x, u, dt, out, chain);
  }
};

// Dubins car: state [x, y, theta], controls [v, omega]
struct Car : RegisterStep<Car> {
  static constexpr int NX = 3, NU = 2;
  template <class T>
  static __device__ __forceinline__ void dynamics(
      const T* x, const T* u, T* xd, const ChainTable* = nullptr) {
    xd[0] = u[0] * tcos(x[2]);
    xd[1] = u[0] * tsin(x[2]);
    xd[2] = u[1];
  }
  template <class T>
  static __device__ __forceinline__ void step(
      const T* x, const T* u, float dt, T* out,
      const ChainTable* chain = nullptr) {
    rk3_step<Car, T>(x, u, dt, out, chain);
  }
};

// damped pendulum: m = 1, b = 0.1, lc = 0.5, I = 0.25, g = 9.81
struct Pendulum : RegisterStep<Pendulum> {
  static constexpr int NX = 2, NU = 1;
  template <class T>
  static __device__ __forceinline__ void dynamics(
      const T* x, const T* u, T* xd, const ChainTable* = nullptr) {
    constexpr float mglc = (float)(1.0 * 9.81 * 0.5);
    xd[0] = x[1];
    xd[1] = (u[0] - mglc * tsin(x[0]) - 0.1f * x[1]) / 0.25f;
  }
  template <class T>
  static __device__ __forceinline__ void step(
      const T* x, const T* u, float dt, T* out,
      const ChainTable* chain = nullptr) {
    rk3_step<Pendulum, T>(x, u, dt, out, chain);
  }
};

struct DoubleIntegrator : RegisterStep<DoubleIntegrator> {
  static constexpr int NX = 2, NU = 1;
  template <class T>
  static __device__ __forceinline__ void dynamics(
      const T* x, const T* u, T* xd, const ChainTable* = nullptr) {
    xd[0] = x[1];
    xd[1] = u[0];
  }
  template <class T>
  static __device__ __forceinline__ void step(
      const T* x, const T* u, float dt, T* out,
      const ChainTable* chain = nullptr) {
    rk3_step<DoubleIntegrator, T>(x, u, dt, out, chain);
  }
};

// ball on beam (ballonbeam_dynamics): g = 9.81, m1 = 0.35, m2 = 2, l = 0.5;
// state [z, theta, zdot, thetadot]
struct Ballonbeam : RegisterStep<Ballonbeam> {
  static constexpr int NX = 4, NU = 1;
  template <class T>
  static __device__ __forceinline__ void dynamics(
      const T* x, const T* u, T* xd, const ChainTable* = nullptr) {
    constexpr float g = 9.81f, m1 = 0.35f, l = 0.5f;
    constexpr float m1x2 = (float)(2.0 * 0.35);
    constexpr float m1g = (float)(0.35 * 9.81);
    constexpr float m2gl = (float)(2.0 * 9.81 * 0.5);
    constexpr float inertia = (float)(2.0 * 0.5 * 0.5 / 3.0);
    const T z = x[0], th = x[1], zd = x[2], thd = x[3];
    const T c = tcos(th);
    xd[0] = zd;
    xd[1] = thd;
    xd[2] = z * (thd * thd) - g * tsin(th);
    xd[3] = (u[0] * l * c - m1x2 * z * zd * thd - m1g * z * c
             - (m2gl * c) / 2.0f)
            / (inertia + m1 * (z * z));
  }
  template <class T>
  static __device__ __forceinline__ void step(
      const T* x, const T* u, float dt, T* out,
      const ChainTable* chain = nullptr) {
    rk3_step<Ballonbeam, T>(x, u, dt, out, chain);
  }
};

// the Euler-angle quadrotor (quadrotor_euler_dynamics): state pos(3),
// rpy(3), vel(3), rpy rates(3); the quaternion model's constants. The rpy
// accelerations are rpÿ = G·pqṙ + Ġ·pqr with G = A(rpy)·R(rpy), Ġ the
// derivative of G along rpẏ, taken by one pass of Dual through G (the
// plain version takes it by torch.func.jvp). Float only: K2's step.
struct QuadrotorEuler : RegisterStep<QuadrotorEuler> {
  static constexpr int NX = 12, NU = 4;
  // R(rpy), row-major (_rpy2rotmat), from the cosines c and sines s of
  // roll, pitch and yaw
  template <class T>
  static __device__ __forceinline__ void rotmat(const T* c, const T* s,
                                                T* R) {
    const T cr = c[0], sr = s[0], cp = c[1], sp = s[1], cy = c[2], sy = s[2];
    R[0] = cy * cp;
    R[1] = cy * sp * sr - sy * cr;
    R[2] = cy * sp * cr + sy * sr;
    R[3] = sy * cp;
    R[4] = sy * sp * sr + cy * cr;
    R[5] = sy * sp * cr - cy * sr;
    R[6] = -sp;
    R[7] = cp * sr;
    R[8] = cp * cr;
  }
  // G(rpy) = A(rpy) R(rpy) (A = _angularvel2rpydot_matrix) in the closed
  // form of the plain version (models/zoo.py::_rpy_g), from the roll's and
  // pitch's cosines c and sines s:
  // [[1, sr tp, cr tp], [0, cr, -sr], [0, sr/cp, cr/cp]]
  template <class T>
  static __device__ __forceinline__ void gmat(const T* c, const T* s,
                                              T* G) {
    const T tp = s[1] / c[1];
    G[0] = T(1.0f);
    G[1] = s[0] * tp;
    G[2] = c[0] * tp;
    G[3] = T(0.0f);
    G[4] = c[0];
    G[5] = -s[0];
    G[6] = T(0.0f);
    G[7] = s[0] / c[1];
    G[8] = c[0] / c[1];
  }
  template <class T>
  static __device__ __forceinline__ void dynamics(
      const T* x, const T* u, T* xd, const ChainTable* = nullptr) {
    static_assert(std::is_same<T, float>::value, "K2's float step only");
    constexpr float m = 0.5f, g = 9.81f, L = 0.1750f, km = 0.0245f;
    constexpr float J0 = 0.0023f, J1 = 0.0023f, J2 = 0.004f;
    constexpr float Ji0 = (float)(1.0 / 0.0023), Ji1 = (float)(1.0 / 0.0023);
    constexpr float Ji2 = (float)(1.0 / 0.004);
    const float* rpy = x + 3;
    const float* rpyd = x + 9;
    // the angles' cosines and sines, once: the latency of the six calls is
    // most of a step (one warp an SM hides none of it)
    float c[3], s[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s[i] = sinf(rpy[i]);
      c[i] = cosf(rpy[i]);
    }
    float R[9];
    rotmat<float>(c, s, R);
    const float F0 = u[0], F1 = u[1], F2 = u[2], F3 = u[3];   // kf = 1
    const float sumF = ((F0 + F1) + F2) + F3;
    // world angular velocity W(rpy) rpẏ (_rpydot2angularvel_matrix), then
    // the body rates pqr = Rᵀ (W rpẏ)
    const float sp = s[1], cp = c[1], sy = s[2], cy = c[2];
    const float w0 = cp * cy * rpyd[0] - sy * rpyd[1];
    const float w1 = cp * sy * rpyd[0] + cy * rpyd[1];
    const float w2 = -sp * rpyd[0] + rpyd[2];
    float pqr[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      pqr[i] = R[i] * w0 + R[3 + i] * w1 + R[6 + i] * w2;
    const float tau0 = L * (F1 - F3), tau1 = L * (F2 - F0);
    const float tau2 = km * F0 - km * F1 + km * F2 - km * F3;
    const float Jp0 = J0 * pqr[0], Jp1 = J1 * pqr[1], Jp2 = J2 * pqr[2];
    const float pd0 = Ji0 * (tau0 - (pqr[1] * Jp2 - pqr[2] * Jp1));
    const float pd1 = Ji1 * (tau1 - (pqr[2] * Jp0 - pqr[0] * Jp2));
    const float pd2 = Ji2 * (tau2 - (pqr[0] * Jp1 - pqr[1] * Jp0));
    // G and Ġ by one Dual pass through G along rpẏ: the roll's and pitch's
    // cosines and sines as Duals (the values and derivatives of tcos and
    // tsin of Dual(rpy, rpẏ))
    Dual cD[2], sD[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cD[i] = Dual(c[i], -(s[i] * rpyd[i]));
      sD[i] = Dual(s[i], c[i] * rpyd[i]);
    }
    Dual G[9];
    gmat<Dual>(cD, sD, G);
#pragma unroll
    for (int i = 0; i < 6; ++i) xd[i] = x[6 + i];
    xd[6] = (R[2] * sumF) / m;
    xd[7] = (R[5] * sumF) / m;
    xd[8] = (-m * g + R[8] * sumF) / m;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      xd[9 + i] = (G[i * 3].v * pd0 + G[i * 3 + 1].v * pd1
                   + G[i * 3 + 2].v * pd2)
                  + (G[i * 3].d * pqr[0] + G[i * 3 + 1].d * pqr[1]
                     + G[i * 3 + 2].d * pqr[2]);
  }
  template <class T>
  static __device__ __forceinline__ void step(
      const T* x, const T* u, float dt, T* out,
      const ChainTable* chain = nullptr) {
    rk3_step<QuadrotorEuler, T>(x, u, dt, out, chain);
  }
};

// the analytic double pendulum (both joints actuated) and acrobot (the elbow
// only: τ = (0, u)), models/zoo.py::_two_link_dynamics: the 2R manipulator
// equations, m1 = m2 = 1, l1 = 1, lc1 = 0.5, lc2 = 1, I1 = 0.083,
// I2 = 0.33, no damping, q from hanging straight down; the 2×2 mass-matrix
// solve written as an explicit inverse, as the cart-pole's (ROADMAP Q3-10).
// State [q1, q2, q̇1, q̇2]. The constants are folded in double in the plain
// version's order; the zero damping and the acrobot's zero shoulder torque
// stay in the sums, as there (0·q̇ and 0 − C are not folded away without
// fast-math).
template <bool kElbowOnly>
struct TwoLink : RegisterStep<TwoLink<kElbowOnly>> {
  static constexpr int NX = 4, NU = kElbowOnly ? 1 : 2;
  template <class T>
  static __device__ __forceinline__ void dynamics(
      const T* x, const T* u, T* xd, const ChainTable* = nullptr) {
    // a = I1 + I2 + m1 lc1² + m2 (l1² + lc2²), b = m2 l1 lc2,
    // d = I2 + m2 lc2²; gravity (m1 lc1 + m2 l1) g and m2 lc2 g
    constexpr float a = (float)(0.083 + 0.33 + 1.0 * 0.5 * 0.5
                                + 1.0 * (1.0 * 1.0 + 1.0 * 1.0));
    constexpr float b = (float)(1.0 * 1.0 * 1.0);
    constexpr float b2 = (float)(2.0 * (1.0 * 1.0 * 1.0));
    constexpr float nb = (float)(-(1.0 * 1.0 * 1.0));
    constexpr float d = (float)(0.33 + 1.0 * 1.0 * 1.0);
    constexpr float g1c = (float)((1.0 * 0.5 + 1.0 * 1.0) * 9.81);
    constexpr float g2c = (float)(1.0 * 1.0 * 9.81);
    constexpr float damp = 0.0f;
    const T q1 = x[0], q2 = x[1], qd1 = x[2], qd2 = x[3];
    const T c2 = tcos(q2), s2 = tsin(q2);
    const T H11 = a + b2 * c2;
    const T H12 = d + b * c2;
    const T C1 = nb * s2 * qd2 * (2.0f * qd1 + qd2);
    const T C2 = b * s2 * qd1 * qd1;
    const T s12 = tsin(q1 + q2);
    const T G1 = g1c * tsin(q1) + g2c * s12;
    const T G2 = g2c * s12;
    const T tau1 = kElbowOnly ? T(0.0f) : u[0];
    const T tau2 = kElbowOnly ? u[0] : u[1];
    const T r1 = tau1 - C1 - G1 - damp * qd1;
    const T r2 = tau2 - C2 - G2 - damp * qd2;
    const T det = H11 * d - H12 * H12;
    xd[0] = qd1;
    xd[1] = qd2;
    xd[2] = (d * r1 - H12 * r2) / det;
    xd[3] = (H11 * r2 - H12 * r1) / det;
  }
  template <class T>
  static __device__ __forceinline__ void step(
      const T* x, const T* u, float dt, T* out,
      const ChainTable* chain = nullptr) {
    rk3_step<TwoLink, T>(x, u, dt, out, chain);
  }
};
using Doublependulum = TwoLink<false>;
using Acrobot = TwoLink<true>;

// ------------------------------------------------------ rigid-body chains
//
// The chain's data, built by models/rigidbody_lanes.py::chain_table in this
// field order, every field a float (integers are exact in float): per joint
// the affine coefficients of Xup(q) = C0 + Cs·sin q + Cc·cos q (C0 + Cs·q for
// a prismatic joint), the motion subspace, the spatial inertia with the
// fixed children folded in; the actuation map τ = Bact·u, the damping, each
// joint's parent (−1: the root) and kind; gravity, the joint and control
// counts. Coefficients below 1e-12 are exact zeros, so the dense sums below
// add exact zeros where the JAX lane code skips a term. The kernels take it
// as a device pointer, like the fk rows' tables of canon.cuh; the
// one-thread dynamics below read it there (every thread of a warp reads the
// same entry at the same time, one cached load), the warp dynamics from the
// block's copy in shared memory (stage_chain_table).
constexpr int kChainMaxDof = 8;

struct ChainTable {
  float C[kChainMaxDof][3][36];
  float S[kChainMaxDof][6];
  float I[kChainMaxDof][36];
  float Bact[kChainMaxDof][kChainMaxDof];
  float damping[kChainMaxDof];
  float parent[kChainMaxDof];
  float prismatic[kChainMaxDof];
  float gravity, ndof, m;
};
constexpr int kChainTableFloats = sizeof(ChainTable) / sizeof(float);

// The block copies the table of a chain model M (WithSlack<M> too) from
// device memory to `dst`, shared memory, and waits for it: called by every
// thread of the block before any of them returns. Returns the copy, or null
// for a model without a chain.
template <class M>
__device__ __forceinline__ const ChainTable* stage_chain_table(
    const ChainTable* src, float* dst) {
  if constexpr (M::kChain) {
    const float* from = reinterpret_cast<const float*>(src);
    for (int e = threadIdx.x; e < kChainTableFloats; e += blockDim.x)
      dst[e] = from[e];
    __syncthreads();
    return reinterpret_cast<const ChainTable*>(dst);
  } else {
    return nullptr;
  }
}

template <class T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// out = A v (A 6×6 row-major), summed over k ascending
template <class T, class M>
__device__ __forceinline__ void mv6(const M* A, const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T acc = A[i * 6] * v[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc = acc + A[i * 6 + k] * v[k];
    out[i] = acc;
  }
}

// out = Aᵀ v, summed over k ascending
template <class T>
__device__ __forceinline__ void mTv6(const T* A, const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T acc = A[i] * v[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc = acc + A[k * 6 + i] * v[k];
    out[i] = acc;
  }
}

// (v ×) w and (v ×*) w, the spatial cross products (_crm_mv, _crf_mv)
template <class T>
__device__ __forceinline__ void crm6(const T* v, const T* w, T* out) {
  T a[3], b[3];
  cross3<T>(v, w, out);
  cross3<T>(v + 3, w, a);
  cross3<T>(v, w + 3, b);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[3 + i] = a[i] + b[i];
}
template <class T>
__device__ __forceinline__ void crf6(const T* v, const T* w, T* out) {
  T a[3], b[3];
  cross3<T>(v, w, a);
  cross3<T>(v + 3, w + 3, b);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = a[i] + b[i];
  cross3<T>(v, w + 3, out + 3);
}

// S X = rhs for an SPD S (M×M, row-major, overwritten) by the equilibrated
// elimination of posdef_solve.cuh, one thread, in the same order: scale by
// D = diag(1/sqrt(max(S_ii, 1e-30))), eliminate with pivots clamped to the
// float32 floor, back-substitute, unscale. The fail flag is dropped, as the
// lane step drops it (rigidbody_lanes.py). rhs becomes X.
template <class T, int M>
__device__ __forceinline__ void posdef_solve_thread(T* S, T* rhs) {
  T dsc[M], piv[M];
#pragma unroll
  for (int i = 0; i < M; ++i)
    dsc[i] = 1.0f / tsqrt(tmax(S[i * M + i], 1e-30f));
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int c = 0; c < M; ++c) S[i * M + c] = S[i * M + c] * dsc[i] * dsc[c];
    rhs[i] = rhs[i] * dsc[i];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    piv[i] = tmax(S[i * M + i], 1e-7f);
    const T inv = 1.0f / piv[i];
#pragma unroll
    for (int j = i + 1; j < M; ++j) {
      const T f = S[j * M + i] * inv;
#pragma unroll
      for (int c = i + 1; c < M; ++c)
        S[j * M + c] = S[j * M + c] - f * S[i * M + c];
      rhs[j] = rhs[j] - f * rhs[i];
    }
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    T r = rhs[i];
#pragma unroll
    for (int j = i + 1; j < M; ++j) r = r - S[i * M + j] * rhs[j];
    rhs[i] = r / piv[i];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) rhs[i] = rhs[i] * dsc[i];
}

// ------------------------------------- the chain's dynamics over one warp
//
// The warp's shared-memory scratch for one evaluation of a chain's
// dynamics: the stage's state and controls, then every intermediate of the
// CRBA and the RNEA (for kuka 784 floats, 3.1 KB).
template <int NDOF>
struct ChainScratch {
  float x[2 * NDOF];       // the stage's state [q; q̇]
  float u[kChainMaxDof];   // the controls
  float sc[NDOF][2];       // sin q, cos q of each joint (q, 0: prismatic)
  float Xup[NDOF][36];
  float Ic[NDOF][36];      // composite inertias
  float XtI[36];           // Xupᵀ Ic of the CRBA's current joint
  float H[NDOF * NDOF];    // the mass matrix, then its elimination
  float v[NDOF][6], a[NDOF][6], f[NDOF][6];
  float vJ[6], Iv[6];      // the RNEA's current joint
  float rhs[NDOF], dsc[NDOF];
};

// what the warp form of a chain's dynamics takes besides x and u: the
// block's table in shared memory, the warp's scratch and the lane
struct WarpStep {
  const ChainTable* tab;
  float* scr;
  int lane;
};

// component c of a × b, as cross3 computes it
__device__ __forceinline__ float cross_c(const float* a, const float* b,
                                         int c) {
  const int c1 = c == 2 ? 0 : c + 1, c2 = c == 0 ? 2 : c - 1;
  return a[c1] * b[c2] - a[c2] * b[c1];
}

// The dynamics of Chain<NDOF, NU>::dynamics below (float), computed by one
// warp together from the state and controls in s.x and s.u (written and
// synced by the caller) and the table `tab` in shared memory; q̈ comes back
// in qdd on every lane. Every entry is summed in the one-thread form's
// order (k ascending, the same pivot clamps 1e-30 and 1e-7), so each value
// is the same float32 arithmetic and only FMA contraction can differ. The
// work over the lanes: Xup for all joints at once (NDOF × 36 entries); each
// 6×6 product of the CRBA's Xupᵀ Ic Xup with one output entry a lane (lanes
// 0–3 take a second); H's columns one a lane once the composite inertias
// are final (each column walks up the chain from its joint: a joint's parent
// has a lower index, so Ic[i] is final when the sequential form uses it);
// the RNEA's 6-vectors on lanes 0–5, the joints in order, as the tree
// requires; the equilibrated NDOF × NDOF solve with row j on lane j (pivots
// in order, row updates in parallel), the back substitution on every lane
// from shared memory, which leaves q̈ in every lane's registers. (Running
// the CRBA and the RNEA on the two halves of the warp side by side was
// measured slower: a warp issues its diverged halves in turn.)
template <int NDOF, int NU>
__device__ __forceinline__ void chain_dynamics_warp(
    const ChainTable* __restrict__ tab, ChainScratch<NDOF>& s, float* qdd,
    int lane) {
  if (lane < NDOF) {
    const bool pri = tab->prismatic[lane] != 0.0f;
    const float q = s.x[lane];
    s.sc[lane][0] = pri ? q : sinf(q);
    s.sc[lane][1] = pri ? 0.0f : cosf(q);
  }
  __syncwarp();
  for (int e = lane; e < NDOF * 36; e += 32) {
    const int k = e / 36, i = e - 36 * k;
    s.Xup[k][i] = tab->C[k][0][i] + tab->C[k][1][i] * s.sc[k][0]
                  + tab->C[k][2][i] * s.sc[k][1];
    s.Ic[k][i] = tab->I[k][i];
  }
  for (int e = lane; e < NDOF * NDOF; e += 32) s.H[e] = 0.0f;
  __syncwarp();

  // CRBA: Ic[p] += Xupᵀ Ic[i] Xup from the leaves in
#pragma unroll 1
  for (int i = NDOF - 1; i >= 0; --i) {
    const int p = (int)tab->parent[i];
    if (p < 0) continue;
    for (int e = lane; e < 36; e += 32) {
      const int ra = e / 6, cb = e - 6 * ra;
      float acc = s.Xup[i][ra] * s.Ic[i][cb];
#pragma unroll
      for (int k = 1; k < 6; ++k)
        acc = acc + s.Xup[i][k * 6 + ra] * s.Ic[i][k * 6 + cb];
      s.XtI[e] = acc;
    }
    __syncwarp();
    for (int e = lane; e < 36; e += 32) {
      const int ra = e / 6, cb = e - 6 * ra;
      float acc = s.XtI[ra * 6] * s.Xup[i][cb];
#pragma unroll
      for (int k = 1; k < 6; ++k)
        acc = acc + s.XtI[ra * 6 + k] * s.Xup[i][k * 6 + cb];
      s.Ic[p][e] = s.Ic[p][e] + acc;
    }
    __syncwarp();
  }
  // H's column i on lane i: F = Ic S, H_ii = S·F, then up the chain
  if (lane < NDOF) {
    const int i = lane;
    float F[6], G[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float acc = s.Ic[i][r * 6] * tab->S[i][0];
#pragma unroll
      for (int c = 1; c < 6; ++c) acc = acc + s.Ic[i][r * 6 + c] * tab->S[i][c];
      F[r] = acc;
    }
    float h = tab->S[i][0] * F[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) h = h + tab->S[i][c] * F[c];
    s.H[i * NDOF + i] = h;
    int j = i;
    while ((int)tab->parent[j] >= 0) {
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        float acc = s.Xup[j][r] * F[0];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc = acc + s.Xup[j][k * 6 + r] * F[k];
        G[r] = acc;
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) F[r] = G[r];
      j = (int)tab->parent[j];
      float hj = tab->S[j][0] * F[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) hj = hj + tab->S[j][c] * F[c];
      s.H[i * NDOF + j] = hj;
      s.H[j * NDOF + i] = hj;
    }
  }

  // RNEA with q̈ = 0, joint by joint, component r of each 6-vector on lane r
  const int r = lane;
#pragma unroll 1
  for (int i = 0; i < NDOF; ++i) {
    const int p = (int)tab->parent[i];
    float ta = 0.0f;
    if (lane < 6) {
      const float vJ = tab->S[i][r] * s.x[NDOF + i];
      const float* A = s.Xup[i] + r * 6;
      if (p >= 0) {
        float tv = A[0] * s.v[p][0];
#pragma unroll
        for (int k = 1; k < 6; ++k) tv = tv + A[k] * s.v[p][k];
        s.v[i][r] = tv + vJ;
        ta = A[0] * s.a[p][0];
#pragma unroll
        for (int k = 1; k < 6; ++k) ta = ta + A[k] * s.a[p][k];
      } else {
        s.v[i][r] = vJ;
        const float g[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, tab->gravity};
        ta = A[0] * g[0];
#pragma unroll
        for (int k = 1; k < 6; ++k) ta = ta + A[k] * g[k];
      }
      s.vJ[r] = vJ;
    }
    __syncwarp();
    // a = Xup a_parent + v × vJ (crm6; each sum written out whole, so that
    // it contracts as the one-thread form's does)
    const float* v = s.v[i];
    if (lane < 3)
      s.a[i][r] = ta + cross_c(v, s.vJ, r);
    else if (lane < 6)
      s.a[i][r] = ta + (cross_c(v + 3, s.vJ, r - 3)
                        + cross_c(v, s.vJ + 3, r - 3));
    __syncwarp();
    float Ia = 0.0f;
    if (lane < 6) {
      const float* Ir = tab->I[i] + r * 6;
      Ia = Ir[0] * s.a[i][0];
      float Iv = Ir[0] * s.v[i][0];
#pragma unroll
      for (int k = 1; k < 6; ++k) {
        Ia = Ia + Ir[k] * s.a[i][k];
        Iv = Iv + Ir[k] * s.v[i][k];
      }
      s.Iv[r] = Iv;
    }
    __syncwarp();
    // f = I a + v ×* (I v) (crf6)
    if (lane < 3)
      s.f[i][r] = Ia + (cross_c(v, s.Iv, r) + cross_c(v + 3, s.Iv + 3, r));
    else if (lane < 6)
      s.f[i][r] = Ia + cross_c(v, s.Iv + 3, r - 3);
    __syncwarp();
  }
#pragma unroll 1
  for (int i = NDOF - 1; i >= 0; --i) {
    const int p = (int)tab->parent[i];
    if (p < 0) continue;
    if (lane < 6) {   // f[p] += Xupᵀ f[i]
      float t = s.Xup[i][r] * s.f[i][0];
#pragma unroll
      for (int k = 1; k < 6; ++k) t = t + s.Xup[i][k * 6 + r] * s.f[i][k];
      s.f[p][r] = s.f[p][r] + t;
    }
    __syncwarp();
  }

  // row i on lane i: rhs = Bact u − bias − damping q̇, the equilibration
  float dsc = 0.0f;
  if (lane < NDOF) {
    const int i = lane;
    float tau = tab->S[i][0] * s.f[i][0];
#pragma unroll
    for (int c = 1; c < 6; ++c) tau = tau + tab->S[i][c] * s.f[i][c];
    float bu = tab->Bact[i][0] * s.u[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) bu = bu + tab->Bact[i][j] * s.u[j];
    s.rhs[i] = bu - tau - tab->damping[i] * s.x[NDOF + i];
    dsc = 1.0f / sqrtf(fmaxf(s.H[i * NDOF + i], 1e-30f));
    s.dsc[i] = dsc;
  }
  __syncwarp();
  if (lane < NDOF) {
    const int i = lane;
#pragma unroll
    for (int c = 0; c < NDOF; ++c)
      s.H[i * NDOF + c] = s.H[i * NDOF + c] * dsc * s.dsc[c];
    s.rhs[i] = s.rhs[i] * dsc;
  }
  __syncwarp();
  // elimination: pivot i in order, rows j > i on their lanes
#pragma unroll 1
  for (int i = 0; i < NDOF - 1; ++i) {
    if (lane > i && lane < NDOF) {
      const int j = lane;
      const float inv = 1.0f / fmaxf(s.H[i * NDOF + i], 1e-7f);
      const float fj = s.H[j * NDOF + i] * inv;
      for (int c = i + 1; c < NDOF; ++c)
        s.H[j * NDOF + c] = s.H[j * NDOF + c] - fj * s.H[i * NDOF + c];
      s.rhs[j] = s.rhs[j] - fj * s.rhs[i];
    }
    __syncwarp();
  }
  // back substitution on every lane (H_ii is final once pivot i is taken)
  float sol[NDOF];
#pragma unroll
  for (int i = NDOF - 1; i >= 0; --i) {
    float acc = s.rhs[i];
#pragma unroll
    for (int j = i + 1; j < NDOF; ++j) acc = acc - s.H[i * NDOF + j] * sol[j];
    sol[i] = acc / fmaxf(s.H[i * NDOF + i], 1e-7f);
  }
#pragma unroll
  for (int i = 0; i < NDOF; ++i) qdd[i] = sol[i] * s.dsc[i];
  __syncwarp();   // the scratch is read: the next evaluation may overwrite it
}

// A rigid-body chain of NDOF joints and NU controls, state [q; q̇]: the
// dynamics of make_chain_dynamics_lanes (Xup from the affine coefficients,
// the CRBA for H, the RNEA with q̈ = 0 for the bias, then the solve),
// written for one thread, and the same dynamics over one warp
// (chain_dynamics_warp) in step_warp, which K2, K4 and K7b call. The
// one-thread form is K3's and K7a's, in Dual, one tangent a lane (K7a runs
// several knots a warp; a warp form of the Dual step measured slower or at
// most 1.23x faster: PERF.md). Not inlined: the RK3 step calls it
// three times, and its ~700 values (7 Xup, 7 composite inertias, v, a, f,
// H) live in local memory whatever the inlining. For the same reason the sweeps over the joints are
// not unrolled (a joint's parent is read from the table): unrolled, the
// Dual form of K3 took nvcc about two minutes.
template <int NDOF, int NU_>
struct Chain {
  static constexpr int NX = 2 * NDOF, NU = NU_;
  static_assert(NDOF <= kChainMaxDof && NU <= kChainMaxDof, "table size");
  static constexpr bool kChain = true;
  static constexpr int kWarpScratch =
      sizeof(ChainScratch<NDOF>) / sizeof(float);

  template <class T>
  static __device__ __noinline__ void dynamics(
      const T* x, const T* u, T* xd, const ChainTable* __restrict__ tab) {
    T Xup[NDOF][36];
#pragma unroll 1
    for (int k = 0; k < NDOF; ++k) {
      const bool pri = tab->prismatic[k] != 0.0f;
      const T s = pri ? x[k] : tsin(x[k]);
      const T co = pri ? T(0.0f) : tcos(x[k]);
#pragma unroll
      for (int e = 0; e < 36; ++e)
        Xup[k][e] = tab->C[k][0][e] + tab->C[k][1][e] * s
                    + tab->C[k][2][e] * co;
    }

    // CRBA: composite inertias from the leaves in, H from its columns
    T Ic[NDOF][36], H[NDOF * NDOF];
#pragma unroll
    for (int i = 0; i < NDOF; ++i) {
#pragma unroll
      for (int e = 0; e < 36; ++e) Ic[i][e] = T(tab->I[i][e]);
#pragma unroll
      for (int j = 0; j < NDOF; ++j) H[i * NDOF + j] = T(0.0f);
    }
#pragma unroll 1
    for (int i = NDOF - 1; i >= 0; --i) {
      const int p = (int)tab->parent[i];
      if (p >= 0) {
        // Ic[p] += Xupᵀ Ic[i] Xup
        T XtI[36];
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
          for (int b = 0; b < 6; ++b) {
            T acc = Xup[i][a] * Ic[i][b];
#pragma unroll
            for (int k = 1; k < 6; ++k)
              acc = acc + Xup[i][k * 6 + a] * Ic[i][k * 6 + b];
            XtI[a * 6 + b] = acc;
          }
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
          for (int b = 0; b < 6; ++b) {
            T acc = XtI[a * 6] * Xup[i][b];
#pragma unroll
            for (int k = 1; k < 6; ++k)
              acc = acc + XtI[a * 6 + k] * Xup[i][k * 6 + b];
            Ic[p][a * 6 + b] = Ic[p][a * 6 + b] + acc;
          }
      }
      // F = Ic S (Σ_a S_a · column a), H_ii = S·F, then up the chain
      T F[6], G[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        T acc = Ic[i][r * 6] * tab->S[i][0];
#pragma unroll
        for (int a = 1; a < 6; ++a)
          acc = acc + Ic[i][r * 6 + a] * tab->S[i][a];
        F[r] = acc;
      }
      T h = tab->S[i][0] * F[0];
#pragma unroll
      for (int a = 1; a < 6; ++a) h = h + tab->S[i][a] * F[a];
      H[i * NDOF + i] = h;
      int j = i;
      while ((int)tab->parent[j] >= 0) {
        mTv6<T>(Xup[j], F, G);
#pragma unroll
        for (int a = 0; a < 6; ++a) F[a] = G[a];
        j = (int)tab->parent[j];
        T hj = tab->S[j][0] * F[0];
#pragma unroll
        for (int a = 1; a < 6; ++a) hj = hj + tab->S[j][a] * F[a];
        H[i * NDOF + j] = hj;
        H[j * NDOF + i] = hj;
      }
    }

    // RNEA with q̈ = 0: velocities and accelerations out, forces back in
    T v[NDOF][6], acc_[NDOF][6], f[NDOF][6];
#pragma unroll 1
    for (int i = 0; i < NDOF; ++i) {
      T vJ[6], t[6], Ia[6], Iv[6];
      const T qd = x[NDOF + i];
#pragma unroll
      for (int a = 0; a < 6; ++a) vJ[a] = tab->S[i][a] * qd;
      const int p = (int)tab->parent[i];
      if (p >= 0) {
        mv6<T, T>(Xup[i], v[p], t);
#pragma unroll
        for (int a = 0; a < 6; ++a) v[i][a] = t[a] + vJ[a];
        mv6<T, T>(Xup[i], acc_[p], t);
      } else {
#pragma unroll
        for (int a = 0; a < 6; ++a) v[i][a] = vJ[a];
        T g[6] = {T(0.0f), T(0.0f), T(0.0f), T(0.0f), T(0.0f),
                  T(tab->gravity)};
        mv6<T, T>(Xup[i], g, t);
      }
      crm6<T>(v[i], vJ, Ia);
#pragma unroll
      for (int a = 0; a < 6; ++a) acc_[i][a] = t[a] + Ia[a];
      mv6<T, float>(tab->I[i], acc_[i], Ia);
      mv6<T, float>(tab->I[i], v[i], Iv);
      crf6<T>(v[i], Iv, t);
#pragma unroll
      for (int a = 0; a < 6; ++a) f[i][a] = Ia[a] + t[a];
    }
    T rhs[NDOF];
#pragma unroll 1
    for (int i = NDOF - 1; i >= 0; --i) {
      T tau = tab->S[i][0] * f[i][0];
#pragma unroll
      for (int a = 1; a < 6; ++a) tau = tau + tab->S[i][a] * f[i][a];
      rhs[i] = tau;
      const int p = (int)tab->parent[i];
      if (p >= 0) {
        T t[6];
        mTv6<T>(Xup[i], f[i], t);
#pragma unroll
        for (int a = 0; a < 6; ++a) f[p][a] = f[p][a] + t[a];
      }
    }

    // q̈ = H⁻¹ (Bact u − bias − damping q̇)
#pragma unroll
    for (int i = 0; i < NDOF; ++i) {
      T tau = tab->Bact[i][0] * u[0];
#pragma unroll
      for (int j = 1; j < NU; ++j) tau = tau + tab->Bact[i][j] * u[j];
      rhs[i] = tau - rhs[i] - tab->damping[i] * x[NDOF + i];
    }
    posdef_solve_thread<T, NDOF>(H, rhs);
#pragma unroll
    for (int i = 0; i < NDOF; ++i) {
      xd[i] = x[NDOF + i];
      xd[NDOF + i] = rhs[i];
    }
  }

  template <class T>
  static __device__ __forceinline__ void step(const T* x, const T* u,
                                              float dt, T* out,
                                              const ChainTable* chain) {
    rk3_step<Chain, T>(x, u, dt, out, chain);
  }

  // The same dynamics over one warp (chain_dynamics_warp), with the
  // one-thread form's interface, so that step_warp is rk3_step itself, and
  // not inlined, as the one-thread form: compiled on its own, its
  // arithmetic and the RK3 combination around the call come out bit for bit
  // as the one-thread step's (on the H100, for every chain; inlined, the
  // compiler contracted the two-link chains' steps otherwise in a few
  // percent of states, which the cartpole rig's chaotic line-search lanes
  // amplify past K4's checks).
  template <class T>
  static __device__ __noinline__ void dynamics(const T* x, const T* u, T* xd,
                                               WarpStep w) {
    ChainScratch<NDOF>& s = *reinterpret_cast<ChainScratch<NDOF>*>(w.scr);
#pragma unroll
    for (int i = 0; i < NX; ++i)
      if (w.lane == i) s.x[i] = x[i];
#pragma unroll
    for (int j = 0; j < NU; ++j)
      if (w.lane == j) s.u[j] = u[j];
    __syncwarp();
    T qdd[NDOF];
    chain_dynamics_warp<NDOF, NU>(w.tab, s, qdd, w.lane);
#pragma unroll
    for (int i = 0; i < NDOF; ++i) {
      xd[i] = x[NDOF + i];
      xd[NDOF + i] = qdd[i];
    }
  }

  // tab is the block's table in shared memory, scr the warp's kWarpScratch
  // floats
  static __device__ __forceinline__ void step_warp(const float* x,
                                                   const float* u, float dt,
                                                   float* out,
                                                   const ChainTable* tab,
                                                   float* scr, int lane) {
    rk3_step<Chain, float>(x, u, dt, out, WarpStep{tab, scr, lane});
  }
};

// the 7-DOF arm (models/robots.py::kuka_model)
using Kuka = Chain<7, 7>;
// the two-link rigs (models/robots.py): the acrobot (elbow actuated) and the
// cartpole (a prismatic slider, the slider actuated) differ only by their
// tables; the double pendulum actuates both joints
using AcrobotUrdf = Chain<2, 1>;
using CartpoleUrdf = Chain<2, 1>;
using DoublependulumUrdf = Chain<2, 2>;

}  // namespace trajopt
