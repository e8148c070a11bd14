// The models whose discrete step the kernels inline, behind one trait:
//   NX, NU            state and control widths
//   step<T>(x, u, dt, out, chain)   the RK3 step with zero-order hold
// templated on the scalar type, so float rolls a trajectory out and Dual (a
// value and one tangent, below) carries one direction through the same code
// for the forward-mode Jacobians of the fused backward sweeps, which the TPU
// kernels take with jax.linearize.
//
// Counterpart of the lane steps of trajopt_tpu/ops/pallas_rollout.py
// (quadrotor_step_lanes, cartpole_step_lanes and the _rk3_lanes family:
// car, pendulum, double integrator) with the same constants, of the
// rigid-body chain step of trajopt_tpu/models/rigidbody_lanes.py
// (make_chain_step_lanes: Chain<NDOF, NU> below, which reads its chain from
// a table in device memory that the kernel is handed; the other models
// take no table and ignore the argument), and of the slack step of the
// infeasible-start model (solvers/altro.py: x⁺ = base_step(x, u[:m]) +
// u[m:]), which WithSlack<M> adds to any of them.
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

struct ChainTable;   // a rigid-body chain's data (below)

enum ModelId {
  kModelQuadrotor = 0,
  kModelCartpole = 1,
  kModelCar = 2,
  kModelPendulum = 3,
  kModelDoubleIntegrator = 4,
  kModelKuka = 5,
  kModelSlack = 6,      // id of WithSlack<M> = id of M + kModelSlack
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
// k3 = dt f(x − k1 + 2 k2); the sums in the order of ops/integration.py::rk3
template <class Dyn, class T>
__device__ __forceinline__ void rk3_step(const T* x, const T* u, float dt,
                                         T* out, const ChainTable* chain) {
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

// the quaternion quadrotor (quad_dynamics above)
struct Quadrotor {
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
  template <class T>
  static __device__ __forceinline__ void step(
      const T* x, const T* u, float dt, T* out,
      const ChainTable* chain = nullptr) {
    M::template step<T>(x, u, dt, out, chain);
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
struct Car {
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
struct Pendulum {
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

struct DoubleIntegrator {
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
// as a device pointer, like the fk rows' tables of canon.cuh: every thread
// of a warp reads the same entry at the same time, one cached load.
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

// A rigid-body chain of NDOF joints and NU controls, state [q; q̇]: the
// dynamics of make_chain_dynamics_lanes (Xup from the affine coefficients,
// the CRBA for H, the RNEA with q̈ = 0 for the bias, then the solve),
// written for one thread. Not inlined: the RK3 step calls it three times,
// and its ~700 values (7 Xup, 7 composite inertias, v, a, f, H) live in
// local memory whatever the inlining. For the same reason the sweeps over
// the joints are not unrolled (a joint's parent is read from the table):
// unrolled, the Dual form of K3 took nvcc about two minutes.
template <int NDOF, int NU_>
struct Chain {
  static constexpr int NX = 2 * NDOF, NU = NU_;
  static_assert(NDOF <= kChainMaxDof && NU <= kChainMaxDof, "table size");

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
};

// the 7-DOF arm (models/robots.py::kuka_model)
using Kuka = Chain<7, 7>;

}  // namespace trajopt
