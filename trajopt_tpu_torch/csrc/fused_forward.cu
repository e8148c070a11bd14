// Fused line search of an unconstrained iLQR iteration (kernel K7b).
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_fused.py::
// _fused_forward_kernel (front end fused_forward_pallas, full state:
// diff_lanes = None). Per problem, the whole backtracking line search of one
// iLQR iteration (reference forwardpass!, forward_pass.jl:5-85): for each
// candidate step α the closed-loop rollout u = U + K(x − X) + αd through the
// model's RK3 step with the divergence guard (|x|, |u| < 1e8 and finite),
// the stage cost dt(½xᵀQx + ½uᵀRu + qᵀx + rᵀu + uᵀHx + c) and the terminal
// cost, the ratio z = (J_prev − J)/(−α(ΔV1 + αΔV2)), acceptance on
// lb < z ≤ ub or J < J_prev, α halving (a diverged candidate keeps the old
// J and z), and after iterations_linesearch candidates the restore of X, U,
// J_prev with α = 0 and the ρ bump dρ = max(dρ·f, f),
// ρ = max(ρ·dρ, ρ_min) + bp_reg_fp. The step reported is the one used (the
// halved α times two). The plain version is
// trajopt_tpu_torch/ops/cuda_fused.py::fused_forward.
//
// The exit is per problem, as in the fused AL line search
// (fused_al_forward.cu): a lane's state changes only while it searches and
// every lane starts at trip 0, so each problem's result depends on its own
// trip count alone and its warp simply leaves its loop. A diverged candidate
// is abandoned at the knot where it dies; every live candidate is written
// straight to the outputs, because the search can only end on a live
// candidate or on the restore. A problem outside `active` is not searched
// and gets its inputs back.
//
// What bounds it on this card: latency. A candidate is a chain of N − 1
// dependent RK3 steps behind an m×n gain product; one candidate of the
// quadrotor at B=128, N=101 reads about 3.5 MB.
//
// Design: one warp per problem for every model, so that the accepted
// candidate does not depend on the model's size: the state lives in
// registers, identically on every lane (each lane runs the RK3 step, so the
// guard needs no vote); lane a < m owns control a and broadcasts it by
// shuffle; the cost's matrix rows split over lanes, each lane keeps its own
// partial cost over the knots and the warp sums once per candidate. For the
// one-control models most lanes only repeat the step; one thread per problem
// would use the card better there and is later work. A rigid-body chain's
// step (kuka and the three two-link rigs) reads its table from the device
// pointer the kernel is handed, on every lane, as in K4.
#include <cuda_runtime.h>
#include <math.h>

#include "models.cuh"
#include "warp_linalg.cuh"

namespace {

using namespace trajopt;

constexpr float kMaxValue = 1e8f;

struct Args {
  const float *x0, *X, *U, *K, *d, *dV1, *dV2, *Jprev, *rho, *drho, *alpha0;
  const float *dt, *Q, *R, *H, *q, *r, *c;
  const unsigned char* active;
  const ChainTable* chain;   // a chain model's table, else null
  float *Xout, *Uout, *scal;
  int batch, N, ls_iters;
  float ls_lb, ls_ub, reg_min, reg_factor, reg_fp;
};

template <class M>
__global__ void __launch_bounds__(32) fused_forward_kernel(Args a) {
  constexpr int NX = M::NX, NU = M::NU;
  // [x; u] of the current knot, for the cost rows a lane picks by its index
  __shared__ float z[NX + NU];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int N = a.N;
  const size_t xoff = (size_t)b * N * NX, uoff = (size_t)b * (N - 1) * NU;
  const float* Xb = a.X + xoff;
  const float* Ub = a.U + uoff;
  float* Xo = a.Xout + xoff;
  float* Uo = a.Uout + uoff;

  const float Jprev = a.Jprev[b], dV1 = a.dV1[b], dV2 = a.dV2[b];
  float alpha = a.alpha0[b], rho = a.rho[b], drho = a.drho[b];
  float J = INFINITY, zr = -1.0f;
  bool done = false;
  if (a.active && !a.active[b]) {   // not searched: hand the inputs back
    done = true;
    J = Jprev;
    alpha = 0.0f;
    for (int e = lane; e < N * NX; e += 32) Xo[e] = Xb[e];
    for (int e = lane; e < (N - 1) * NU; e += 32) Uo[e] = Ub[e];
  }

  for (int it = 0;
       ((zr <= a.ls_lb) || (zr > a.ls_ub)) && (J >= Jprev) && !done; ++it) {
    if (it > a.ls_iters) {
      // the search ran out (forward_pass.jl:22-37): restore and bump ρ
      drho = fmaxf(drho * a.reg_factor, a.reg_factor);
      rho = fmaxf(rho * drho, a.reg_min) + a.reg_fp;
      alpha = 0.0f;
      J = Jprev;
      zr = 0.0f;
      done = true;
      for (int e = lane; e < N * NX; e += 32) Xo[e] = Xb[e];
      for (int e = lane; e < (N - 1) * NU; e += 32) Uo[e] = Ub[e];
      break;
    }

    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = a.x0[(size_t)b * NX + i];
    if (lane < NX) Xo[lane] = a.x0[(size_t)b * NX + lane];
    float Jacc = 0.0f;
    bool ok = true;
    for (int k = 0; k < N - 1; ++k) {
      const float dtv = a.dt[k];
      // u = U + K (x − X) + α d: lane i < m computes control i
      float u_mine = 0.0f;
      if (lane < NU) {
        const float* Kr = a.K + (uoff + (size_t)k * NU + lane) * NX;
        float acc = Kr[0] * (x[0] - Xb[k * NX]);
#pragma unroll
        for (int c = 1; c < NX; ++c)
          acc = acc + Kr[c] * (x[c] - Xb[k * NX + c]);
        u_mine = Ub[k * NU + lane] + acc + alpha * a.d[uoff + k * NU + lane];
      }
      float u[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) u[i] = __shfl_sync(kFullMask, u_mine, i);
#pragma unroll
      for (int i = 0; i < NX; ++i)
        if (lane == i) z[i] = x[i];
      if (lane < NU) z[NX + lane] = u_mine;
      __syncwarp();

      // stage cost, split by rows of Q and of [R | H]
      float part = 0.0f;
      if (lane < NX) {
        const float* Qr = a.Q + ((size_t)k * NX + lane) * NX;
        float Qx = Qr[0] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) Qx = Qx + Qr[j] * x[j];
        part = 0.5f * z[lane] * Qx + z[lane] * a.q[(size_t)k * NX + lane];
      }
      if (lane < NU) {
        const float* Rr = a.R + ((size_t)k * NU + lane) * NU;
        const float* Hr = a.H + ((size_t)k * NU + lane) * NX;
        float Ru = Rr[0] * u[0];
#pragma unroll
        for (int j = 1; j < NU; ++j) Ru = Ru + Rr[j] * u[j];
        float Hx = Hr[0] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) Hx = Hx + Hr[j] * x[j];
        part = part + 0.5f * u_mine * Ru
             + u_mine * a.r[(size_t)k * NU + lane] + u_mine * Hx;
      }
      if (lane == 0) part = part + a.c[k];
      Jacc = Jacc + part * dtv;

      // the step and the divergence guard
      float xn[NX];
      M::template step<float>(x, u, dtv, xn, a.chain);
      bool good = true;
#pragma unroll
      for (int i = 0; i < NX; ++i)
        good = good && fabsf(xn[i]) < kMaxValue && isfinite(xn[i]);
#pragma unroll
      for (int i = 0; i < NU; ++i) good = good && fabsf(u[i]) < kMaxValue;
      if (lane < NU) Uo[k * NU + lane] = u_mine;
      __syncwarp();            // z is read; the next knot may overwrite it
      if (!good) {
        ok = false;
        break;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        x[i] = xn[i];
        if (lane == i) Xo[(k + 1) * NX + i] = xn[i];
      }
    }

    if (ok) {
      // terminal cost ½xᵀQx + qᵀx + c
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < NX; ++i)
        if (lane == i) z[i] = x[i];
      __syncwarp();
      if (lane < NX) {
        const float* Qr = a.Q + ((size_t)(N - 1) * NX + lane) * NX;
        float Qx = Qr[0] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) Qx = Qx + Qr[j] * x[j];
        part = 0.5f * z[lane] * Qx + z[lane] * a.q[(size_t)(N - 1) * NX + lane];
      }
      if (lane == 0) part = part + a.c[N - 1];
      Jacc = Jacc + part;
      __syncwarp();
      const float Jc = warp_sum(Jacc);
      const float expected = -alpha * (dV1 + alpha * dV2);
      J = Jc;
      zr = expected > 0.0f ? (Jprev - Jc) / expected : -1.0f;
    }
    alpha = alpha * 0.5f;
  }

  if (lane == 0) {
    a.scal[b] = J;
    a.scal[a.batch + b] = rho;
    a.scal[2 * a.batch + b] = drho;
    a.scal[3 * a.batch + b] = alpha * 2.0f;   // the step that was used
  }
}

}  // namespace

// C entry point (bound with ctypes from ops/cuda_fused.py). Contiguous
// float32, batch-first, for the model `model` (models.cuh ModelId) with n
// states and m controls: x0 (B,n), X (B,N,n), U (B,N-1,m), K (B,N-1,m,n),
// d (B,N-1,m), dV1, dV2, J_prev, rho, drho, alpha0 (B), dt (N-1), Q (N,n,n),
// R (N,m,m), H (N,m,n), q (N,n), r (N,m), c (N), active (B) bytes or null,
// chain (a chain model's table, models.cuh ChainTable, on the device; else
// null) →
// Xout (B,N,n), Uout (B,N-1,m), scal (4,B) = J, rho, drho and the step
// used. Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a model that has no instantiation.
extern "C" int trajopt_fused_forward_f32(
    const float* x0, const float* X, const float* U, const float* K,
    const float* d, const float* dV1, const float* dV2, const float* Jprev,
    const float* rho, const float* drho, const float* alpha0, const float* dt,
    const float* Q, const float* R, const float* H, const float* q,
    const float* r, const float* c, const unsigned char* active,
    const float* chain, float* Xout, float* Uout, float* scal, int batch,
    int N, int model, int ls_iters, float ls_lb, float ls_ub, float reg_min,
    float reg_factor, float reg_fp, void* stream) {
  if (batch <= 0 || N < 2 || (is_chain_model(model) && chain == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{x0, X, U, K, d, dV1, dV2, Jprev, rho, drho, alpha0, dt, Q, R, H, q,
         r, c, active, (const ChainTable*)chain, Xout, Uout, scal, batch, N,
         ls_iters, ls_lb, ls_ub, reg_min, reg_factor, reg_fp};
#define TRAJOPT_FUSED_FORWARD(M)                                         \
  fused_forward_kernel<M><<<batch, 32, 0, (cudaStream_t)stream>>>(a);    \
  return (int)cudaGetLastError()
  switch (model) {
    case kModelQuadrotor: TRAJOPT_FUSED_FORWARD(Quadrotor);
    case kModelCartpole: TRAJOPT_FUSED_FORWARD(Cartpole);
    case kModelCar: TRAJOPT_FUSED_FORWARD(Car);
    case kModelPendulum: TRAJOPT_FUSED_FORWARD(Pendulum);
    case kModelDoubleIntegrator: TRAJOPT_FUSED_FORWARD(DoubleIntegrator);
    case kModelKuka: TRAJOPT_FUSED_FORWARD(Kuka);
    case kModelAcrobotUrdf: TRAJOPT_FUSED_FORWARD(AcrobotUrdf);
    case kModelDoublependulumUrdf: TRAJOPT_FUSED_FORWARD(DoublependulumUrdf);
    case kModelCartpoleUrdf: TRAJOPT_FUSED_FORWARD(CartpoleUrdf);
  }
#undef TRAJOPT_FUSED_FORWARD
  return (int)cudaErrorInvalidValue;
}
