// Closed-loop rollout, batched over problems (kernel K2).
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_rollout.py::_rollout_kernel
// (front end rollout_closed_loop_pallas) with the model's step inlined
// (models.cuh: the quadrotor, cartpole, car, pendulum, double integrator,
// ballonbeam, the Euler-angle quadrotor, the analytic double pendulum and
// acrobot, the rigid-body chain step of the 7-DOF kuka arm and of the three
// two-link URDF rigs, each of them with the slack controls of the
// infeasible-start transform, and each in the minimum-time form MinTime<M>
// of either, whose dt is u[-1]² and which ignores the dt argument)
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
// floats (~3.5 MB) per launch, far below what bandwidth would notice. A
// chain's step is ~13.6k operations (three CRBA + RNEA + NDOF x NDOF
// solves for kuka), most of them independent within a joint.
//
// Design: one warp per problem, a few problems per block (kWarpsPerBlock
// below), so that the main paths' 128 problems spread over the SMs. Every
// lane holds the state in registers. Lane i < m computes control i from its
// gain row (the rows of one knot are contiguous, so the warp's reads are
// coalesced) and the controls go to every lane by shuffle; for the error
// state every lane computes state_diff. A scalar model's step runs in
// registers on every lane; a chain's is computed by the warp together
// (models.cuh chain_dynamics_warp), from the table that the block stages in
// shared memory, its ~780 intermediate values in the warp's scratch there
// (only the RK3 stage vectors pass through local memory, as in the
// one-thread step, so that the step rounds bit for bit as that one does).
// Knot k+1's
// rows (X, U, K, d) are loaded into registers while knot k's step runs: they
// do not depend on the state, so the dependent RK3 chain never waits on a
// global load. Lane i < n writes state i. The model's widths are
// compile-time constants, one instantiation per model (and one more for the
// quadrotor's error state, ns = 12). No fast-math and no rsqrtf: the
// quaternion norm uses 1.0f / sqrtf, because an approximate reciprocal
// square root compounds over the horizon (ops/pallas_rollout.py:53-55).
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

// problems (warps) per block: at B = 128 one block per SM for 128 of the
// 132 SMs; more warps a block only stack problems on fewer SMs
constexpr int kWarpsPerBlock = 1;

// shared memory a block of M's instantiation needs: the chain's table and
// each warp's scratch (none for a scalar model)
template <class M>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((M::kChain ? kChainTableFloats : 0)
                          + kWarpsPerBlock * M::kWarpScratch);
}

// ErrorState: the quadrotor's quaternion error state, gains of width 12
template <class M, bool ErrorState>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) rollout_kernel(
    const float* __restrict__ x0, const float* __restrict__ X,
    const float* __restrict__ U, const float* __restrict__ K,
    const float* __restrict__ d, const float* __restrict__ alpha,
    float* __restrict__ Xout, float* __restrict__ Uout,
    unsigned char* __restrict__ ok, const ChainTable* __restrict__ chain,
    int batch, int N, float dt, float max_state, float max_control) {
  constexpr int kN = M::NX;
  constexpr int kNs = ErrorState ? M::NX - 1 : M::NX;
  constexpr int kM = M::NU;
  static_assert(kN <= 32 && kM <= 32, "one lane per state and per control");
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const ChainTable* tab = stage_chain_table<M>(chain, smem);
  float* scr = smem + (M::kChain ? kChainTableFloats : 0)
               + w * M::kWarpScratch;
  const int b = blockIdx.x * kWarpsPerBlock + w;
  if (b >= batch) return;
  const int Nm1 = N - 1;
  const float* Xb = X + (size_t)b * N * kN;
  const float* Ub = U + (size_t)b * Nm1 * kM;
  const float* Kb = K + (size_t)b * Nm1 * kM * kNs;
  const float* db = d + (size_t)b * Nm1 * kM;
  float* Xo = Xout + (size_t)b * N * kN;
  float* Uo = Uout + (size_t)b * Nm1 * kM;

  float x[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = x0[(size_t)b * kN + i];
  if (lane < kN) Xo[lane] = x0[(size_t)b * kN + lane];
  const float a = alpha[b];

  // knot k's rows: X_k on every lane, lane i < m its gain row, U and d
  float xr_n[kN], K_n[kNs] = {}, U_n = 0.0f, d_n = 0.0f;
  auto load = [&](int k) {
#pragma unroll
    for (int i = 0; i < kN; ++i) xr_n[i] = Xb[(size_t)k * kN + i];
    if (lane < kM) {
      const float* Kr = Kb + ((size_t)k * kM + lane) * kNs;
#pragma unroll
      for (int c = 0; c < kNs; ++c) K_n[c] = Kr[c];
      U_n = Ub[(size_t)k * kM + lane];
      d_n = db[(size_t)k * kM + lane];
    }
  };
  load(0);
  bool alive = true;
  for (int k = 0; k < Nm1; ++k) {
    float xr[kN], Kr[kNs];
#pragma unroll
    for (int i = 0; i < kN; ++i) xr[i] = xr_n[i];
#pragma unroll
    for (int c = 0; c < kNs; ++c) Kr[c] = K_n[c];
    const float Uk = U_n, dk = d_n;
    if (k + 1 < Nm1) load(k + 1);   // in flight while this knot steps

    float dx[kNs];
    if constexpr (ErrorState) {
      state_diff(x, xr, dx);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) dx[i] = x[i] - xr[i];
    }
    // u_i = U_i + K_i·δx + α d_i on lane i, then to every lane
    float u_mine = 0.0f;
    if (lane < kM) {
      float acc = Kr[0] * dx[0];
#pragma unroll
      for (int c = 1; c < kNs; ++c) acc = acc + Kr[c] * dx[c];
      u_mine = Uk + acc + a * dk;
    }
    float u[kM], xn[kN];
#pragma unroll
    for (int i = 0; i < kM; ++i) u[i] = __shfl_sync(kFullMask, u_mine, i);
    M::step_warp(x, u, dt, xn, tab, scr, lane);
    bool good = true;
#pragma unroll
    for (int i = 0; i < kN; ++i)
      good = good && fabsf(xn[i]) < max_state && isfinite(xn[i]);
#pragma unroll
    for (int i = 0; i < kM; ++i) good = good && fabsf(u[i]) < max_control;
    alive = alive && good;
#pragma unroll
    for (int i = 0; i < kN; ++i)
      if (alive) x[i] = xn[i];
    if (lane < kN) Xo[(size_t)(k + 1) * kN + lane] = lane_value(x, lane);
    if (lane < kM) Uo[(size_t)k * kM + lane] = u_mine;
  }
  if (lane == 0) ok[b] = alive ? 1 : 0;
}

template <class M, bool ErrorState>
int launch(const float* x0, const float* X, const float* U, const float* K,
           const float* d, const float* alpha, float* Xout, float* Uout,
           unsigned char* ok, const ChainTable* chain, int batch, int N,
           float dt, float max_state, float max_control,
           cudaStream_t stream) {
  static_assert(smem_bytes<M>() <= 48 * 1024, "static shared memory limit");
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rollout_kernel<M, ErrorState>
      <<<blocks, 32 * kWarpsPerBlock, smem_bytes<M>(), stream>>>(
          x0, X, U, K, d, alpha, Xout, Uout, ok, chain, batch, N, dt,
          max_state, max_control);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes from ops/cuda_rollout.py). Batch-first
// contiguous float32 for the model `model` (models.cuh ModelId, with
// kModelSlack and kModelMinTime added for those forms) with n
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
  if (is_chain_model(model) && chain == nullptr)
    return (int)cudaErrorInvalidValue;
#define TRAJOPT_ROLLOUT(M, ES)                                              \
  return launch<M, ES>(x0, X, U, K, d, alpha, Xout, Uout, ok,              \
                       (const ChainTable*)chain, batch, N, dt, max_state,  \
                       max_control, (cudaStream_t)stream)
  // a model's other three forms: with slacks, minimum time, minimum time
  // with slacks
#define TRAJOPT_FORMS(ID, M)                                                \
  case kModelSlack + ID: TRAJOPT_ROLLOUT(WithSlack<M>, false);             \
  case kModelMinTime + ID: TRAJOPT_ROLLOUT(MinTime<M>, false);             \
  case kModelMinTime + kModelSlack + ID:                                   \
    TRAJOPT_ROLLOUT(MinTime<WithSlack<M>>, false)
  switch (model) {
    case kModelQuadrotor:
      if (error_state) TRAJOPT_ROLLOUT(Quadrotor, true);
      TRAJOPT_ROLLOUT(Quadrotor, false);
    TRAJOPT_FORMS(kModelQuadrotor, Quadrotor);
    case kModelCartpole: TRAJOPT_ROLLOUT(Cartpole, false);
    TRAJOPT_FORMS(kModelCartpole, Cartpole);
    case kModelCar: TRAJOPT_ROLLOUT(Car, false);
    TRAJOPT_FORMS(kModelCar, Car);
    case kModelPendulum: TRAJOPT_ROLLOUT(Pendulum, false);
    TRAJOPT_FORMS(kModelPendulum, Pendulum);
    case kModelDoubleIntegrator: TRAJOPT_ROLLOUT(DoubleIntegrator, false);
    TRAJOPT_FORMS(kModelDoubleIntegrator, DoubleIntegrator);
    case kModelBallonbeam: TRAJOPT_ROLLOUT(Ballonbeam, false);
    TRAJOPT_FORMS(kModelBallonbeam, Ballonbeam);
    case kModelQuadrotorEuler: TRAJOPT_ROLLOUT(QuadrotorEuler, false);
    TRAJOPT_FORMS(kModelQuadrotorEuler, QuadrotorEuler);
    case kModelDoublependulum: TRAJOPT_ROLLOUT(Doublependulum, false);
    TRAJOPT_FORMS(kModelDoublependulum, Doublependulum);
    case kModelAcrobot: TRAJOPT_ROLLOUT(Acrobot, false);
    TRAJOPT_FORMS(kModelAcrobot, Acrobot);
    case kModelKuka: TRAJOPT_ROLLOUT(Kuka, false);
    TRAJOPT_FORMS(kModelKuka, Kuka);
    case kModelAcrobotUrdf: TRAJOPT_ROLLOUT(AcrobotUrdf, false);
    TRAJOPT_FORMS(kModelAcrobotUrdf, AcrobotUrdf);
    case kModelDoublependulumUrdf: TRAJOPT_ROLLOUT(DoublependulumUrdf, false);
    TRAJOPT_FORMS(kModelDoublependulumUrdf, DoublependulumUrdf);
    case kModelCartpoleUrdf: TRAJOPT_ROLLOUT(CartpoleUrdf, false);
    TRAJOPT_FORMS(kModelCartpoleUrdf, CartpoleUrdf);
  }
#undef TRAJOPT_FORMS
#undef TRAJOPT_ROLLOUT
  return (int)cudaErrorInvalidValue;
}
