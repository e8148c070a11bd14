// Closed-loop rollout, batched over problems (kernel K2).
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_rollout.py::_rollout_kernel
// (front end rollout_closed_loop_pallas) with the model's step inlined
// (models.cuh: the quadrotor, cartpole, car, pendulum, double integrator, the
// 7-DOF kuka arm's rigid-body chain step, and each of them with the slack
// controls of the infeasible-start transform)
// and, for the quadrotor's error-state solves,
// quadrotor_state_diff_lanes (quaternion error state). For every problem and
// knot k:
//   u_k = U_k + K_k·δx_k + α d_k,  δx_k = x̄_k − X_k  or  state_diff(x̄_k, X_k)
//   x̄_{k+1} = step(x̄_k, u_k, dt)
// A problem dies when |x̄| or |u| reaches its limit or x̄ turns non-finite,
// and then holds its last state; ok reports whether it stayed alive. The
// limits and dt are kernel arguments. The plain version is
// trajopt_tpu_torch/ops/rollout.py::rollout_closed_loop.
//
// What bounds it on this card: latency. Each problem is a chain of N-1
// dependent RK3 steps (for the quadrotor three dynamics evaluations, ~300
// flops); the quadrotor error-state path reads 128 x 100 x (13 + 4 + 48 + 4)
// floats (~3.5 MB) per launch, far below what bandwidth would notice. The
// kuka step is ~15k flops (three CRBA + RNEA + 7x7 solves) whose ~700
// intermediate values per dynamics call spill to local memory, so a kuka
// thread mostly waits on its own local-memory traffic.
//
// Design: one thread per problem; state, control and the gain row live in
// registers, and the model's widths are compile-time constants, one
// instantiation per model (and one more for the quadrotor's error state,
// ns = 12). Loads are strided across threads (batch-first layout, as the
// solver holds the arrays); a lane-major layout or one warp per problem is
// later work. For the two-state models most of a thread's time is waiting
// on its own loads. No fast-math and no rsqrtf: the quaternion norm uses
// 1.0f / sqrtf, because an approximate reciprocal square root compounds
// over the horizon (ops/pallas_rollout.py:53-55).
#include <cuda_runtime.h>

#include "models.cuh"

namespace {

using namespace trajopt;

// δx = state_diff(x, xr) with the cancellation-free quaternion error
// (quadrotor_state_diff_lanes)
__device__ __forceinline__ void state_diff(const float* x, const float* xr,
                                           float* dx) {
  const float rw = xr[3], rx = xr[4], ry = xr[5], rz = xr[6];
  // dq = conj(q_ref) ⊗ (q − q_ref), scalar part += |q_ref|²
  float dw, ex, ey, ez;
  quat_mul<float>(rw, -rx, -ry, -rz, x[3] - rw, x[4] - rx, x[5] - ry,
                  x[6] - rz, dw, ex, ey, ez);
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
  for (int i = 6; i < 12; ++i) dx[i] = x[i + 1] - xr[i + 1];
}

// ErrorState: the quadrotor's quaternion error state, gains of width 12
template <class M, bool ErrorState>
__global__ void rollout_kernel(
    const float* __restrict__ x0, const float* __restrict__ X,
    const float* __restrict__ U, const float* __restrict__ K,
    const float* __restrict__ d, const float* __restrict__ alpha,
    float* __restrict__ Xout, float* __restrict__ Uout,
    unsigned char* __restrict__ ok, const ChainTable* __restrict__ chain,
    int batch, int N, float dt, float max_state, float max_control) {
  constexpr int kN = M::NX;
  constexpr int kNs = ErrorState ? M::NX - 1 : M::NX;
  constexpr int kM = M::NU;
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
    if constexpr (ErrorState) {
      state_diff(x, xr, dx);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) dx[i] = x[i] - xr[i];
    }
    const float* Kk = K + bk * kM * kNs;
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      float acc = Kk[i * kNs] * dx[0];
#pragma unroll
      for (int c = 1; c < kNs; ++c) acc = acc + Kk[i * kNs + c] * dx[c];
      u[i] = U[bk * kM + i] + acc + a * d[bk * kM + i];
    }
    M::template step<float>(x, u, dt, xn, chain);
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

template <class M, bool ErrorState>
int launch(const float* x0, const float* X, const float* U, const float* K,
           const float* d, const float* alpha, float* Xout, float* Uout,
           unsigned char* ok, const ChainTable* chain, int batch, int N,
           float dt, float max_state, float max_control,
           cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  rollout_kernel<M, ErrorState><<<blocks, threads, 0, stream>>>(
      x0, X, U, K, d, alpha, Xout, Uout, ok, chain, batch, N, dt, max_state,
      max_control);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes from ops/cuda_rollout.py). Batch-first
// contiguous float32 for the model `model` (models.cuh ModelId) with n
// states, m controls and gains of width ns = n, or 12 with error_state (the
// quadrotor only): x0 (B,n), X (B,N,n), U (B,N-1,m), K (B,N-1,m,ns),
// d (B,N-1,m), alpha (B,) → Xout (B,N,n), Uout (B,N-1,m), ok (B,) bytes;
// chain: a chain model's table (models.cuh ChainTable) on the device, else
// null. Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a model that has no instantiation.
extern "C" int trajopt_rollout_f32(
    const float* x0, const float* X, const float* U, const float* K,
    const float* d, const float* alpha, float* Xout, float* Uout,
    unsigned char* ok, const float* chain, int batch, int N, int model,
    int error_state, float dt, float max_state, float max_control,
    void* stream) {
  if (batch <= 0 || N < 2) return (int)cudaErrorInvalidValue;
  if (error_state && model != kModelQuadrotor)
    return (int)cudaErrorInvalidValue;
  if (model % kModelSlack == kModelKuka && chain == nullptr)
    return (int)cudaErrorInvalidValue;
#define TRAJOPT_ROLLOUT(M, ES)                                              \
  return launch<M, ES>(x0, X, U, K, d, alpha, Xout, Uout, ok,              \
                       (const ChainTable*)chain, batch, N, dt, max_state,  \
                       max_control, (cudaStream_t)stream)
  switch (model) {
    case kModelQuadrotor:
      if (error_state) TRAJOPT_ROLLOUT(Quadrotor, true);
      TRAJOPT_ROLLOUT(Quadrotor, false);
    case kModelCartpole: TRAJOPT_ROLLOUT(Cartpole, false);
    case kModelCar: TRAJOPT_ROLLOUT(Car, false);
    case kModelPendulum: TRAJOPT_ROLLOUT(Pendulum, false);
    case kModelDoubleIntegrator: TRAJOPT_ROLLOUT(DoubleIntegrator, false);
    case kModelSlack + kModelQuadrotor:
      TRAJOPT_ROLLOUT(WithSlack<Quadrotor>, false);
    case kModelSlack + kModelCartpole:
      TRAJOPT_ROLLOUT(WithSlack<Cartpole>, false);
    case kModelSlack + kModelCar: TRAJOPT_ROLLOUT(WithSlack<Car>, false);
    case kModelSlack + kModelPendulum:
      TRAJOPT_ROLLOUT(WithSlack<Pendulum>, false);
    case kModelSlack + kModelDoubleIntegrator:
      TRAJOPT_ROLLOUT(WithSlack<DoubleIntegrator>, false);
    case kModelKuka: TRAJOPT_ROLLOUT(Kuka, false);
    case kModelSlack + kModelKuka: TRAJOPT_ROLLOUT(WithSlack<Kuka>, false);
  }
#undef TRAJOPT_ROLLOUT
  return (int)cudaErrorInvalidValue;
}
