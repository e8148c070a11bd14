// Fused AL line search (kernel K4), for every model of models.cuh with or
// without the slack controls of the infeasible-start transform, and with
// the forward-kinematics rows of a rigid-body chain (K8) in the stack.
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_al_fused.py::
// _fused_al_forward_kernel (front end fused_al_forward_pallas). Per
// problem, the whole backtracking line search of one iLQR iteration
// (reference forwardpass!, forward_pass.jl:5-85): for each candidate step
// α the closed-loop full-state rollout u = U + K(x − X) + αd through the
// model's step (with slacks x⁺ = rk3(x, u_base) + u_slack), with the
// divergence guard
// (|x|, |u| < 1e8 and finite), the stage and terminal cost plus the AL cost
// Σ λc + ½ c Iμ c of the canonical stack (canon.cuh), the ratio
// z = (J_prev − J)/(−α(ΔV1 + αΔV2)), acceptance on lb < z ≤ ub or
// J < J_prev, α halving, and after iterations_linesearch candidates the
// restore of X, U, J_prev with the ρ bump. The plain version is
// trajopt_tpu_torch/ops/cuda_al_fused.py::fused_al_forward.
//
// The exit is per problem. On the TPU a 128-lane tile runs until its
// slowest lane is done; a lane's state changes only while it searches and
// every lane starts at trip 0, so each problem's result depends on its own
// trip count alone, and here each problem's warp simply leaves its loop.
// A diverged candidate is abandoned at the knot where it dies (its result
// is discarded anyway); every live candidate is written straight to the
// outputs, because the search can only end on a live candidate or on the
// restore.
//
// What bounds it on this card: latency. A candidate is a chain of N − 1
// dependent RK3 steps, each behind an m×n gain product and the P-row AL
// cost; one candidate of the slack-augmented quadrotor (17×13, P = 89) at
// B=128, N=101 reads about 21 MB (K, λ, μ), far from the card's bandwidth
// for the time it takes.
//
// Design: one warp per problem rather than one thread (the design of the
// rollout kernel K2), because a knot carries several times the work of K2's
// and the P rows (89 to 180), the gain rows and the cost's matrix rows split
// evenly over lanes with coalesced reads of λ and μ. The state lives in
// registers, identically on every lane (each lane runs the RK3 step, so the
// guard needs no vote); lane a < m owns control a and broadcasts it by
// shuffle; each lane keeps its own partial cost over the knots and the warp
// sums once per candidate. The model and the slack flag are template
// parameters, so n, m_base and m are compile-time constants.
#include <cuda_runtime.h>
#include <math.h>

#include "canon.cuh"
#include "models.cuh"

namespace {

using namespace trajopt;

constexpr float kMaxValue = 1e8f;

struct Args {
  const float *x0, *X, *U, *K, *d, *dV1, *dV2, *Jprev, *rho, *drho, *alpha0;
  const float *lam, *mu, *dt, *Q, *R, *H, *q, *r, *c;
  const unsigned char* active;
  const ChainTable* chain;   // a chain model's table, else null
  float *Xout, *Uout, *scal;
  int batch, N, ls_iters;
  float ls_lb, ls_ub, reg_min, reg_factor, reg_fp, atol;
};

// z ← [x; u] for the row evaluation
template <int NX, int NU>
__device__ __forceinline__ void put_z(float* z, const float* x, float u_mine,
                                      int lane) {
#pragma unroll
  for (int i = 0; i < NX; ++i)
    if (lane == i) z[i] = x[i];
  if (lane < NU) z[NX + lane] = u_mine;
  __syncwarp();
}

// M: the base model's trait; Slack: NX slack controls after its MB controls
template <class M, bool Slack>
__global__ void __launch_bounds__(32) fused_al_forward_kernel(Args a,
                                                              CanonTables tab) {
  constexpr int NX = M::NX, MB = M::NU, NU = Slack ? MB + NX : MB;
  static_assert(NU <= 32, "one lane per control");
  __shared__ float z[NX + NU];
  __shared__ FkWork fk;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int N = a.N, P = tab.P;
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
      put_z<NX, NU>(z, x, u_mine, lane);

      // stage cost dt(½xᵀQx + ½uᵀRu + qᵀx + rᵀu + uᵀHx + c), split by rows
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
      fk_knot_warp(tab, z, fk, lane);
      Jacc = Jacc + canon_al_cost_lane(tab, z, fk,
                                       a.lam + ((size_t)b * N + k) * P,
                                       a.mu + ((size_t)b * N + k) * P, a.atol,
                                       lane);

      // the step (the base controls lead u) and the divergence guard
      float xn[NX];
      M::template step<float>(x, u, dtv, xn, a.chain);
      bool good = true;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if constexpr (Slack) xn[i] = xn[i] + u[MB + i];
        good = good && fabsf(xn[i]) < kMaxValue && isfinite(xn[i]);
      }
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
      // terminal cost ½xᵀQx + qᵀx + c and the AL rows at u = 0
      put_z<NX, NU>(z, x, 0.0f, lane);
      float part = 0.0f;
      if (lane < NX) {
        const float* Qr = a.Q + ((size_t)(N - 1) * NX + lane) * NX;
        float Qx = Qr[0] * x[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) Qx = Qx + Qr[j] * x[j];
        part = 0.5f * z[lane] * Qx + z[lane] * a.q[(size_t)(N - 1) * NX + lane];
      }
      if (lane == 0) part = part + a.c[N - 1];
      Jacc = Jacc + part;
      fk_knot_warp(tab, z, fk, lane);
      Jacc = Jacc + canon_al_cost_lane(
          tab, z, fk, a.lam + ((size_t)b * N + N - 1) * P,
          a.mu + ((size_t)b * N + N - 1) * P, a.atol, lane);
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

// C entry point (bound with ctypes from ops/cuda_al_fused.py). Contiguous
// float32, batch-first, for the model `model` (models.cuh ModelId, plus
// kModelSlack for its slack-augmented form) with n states and m controls:
// x0 (B,n), X (B,N,n), U (B,N-1,m), K (B,N-1,m,n), d (B,N-1,m), dV1, dV2,
// J_prev, rho, drho, alpha0 (B), lam, mu (B,N,P), dt (N-1), Q (N,n,n),
// R (N,m,m), H (N,m,n), q (N,n), r (N,m), c (N), the stack's row tables
// row_i (P,4) int32 and row_f (P,4), its fk tables fk_joint (J,36) and
// fk_point (npts,4) (J = 0: no fk rows), active (B) bytes or null, chain (a
// chain model's table, models.cuh ChainTable, on the device; else null) →
// Xout (B,N,n), Uout (B,N-1,m), scal (4,B) = J, rho, drho and the step used.
// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a model that has no instantiation.
extern "C" int trajopt_fused_al_forward_f32(
    const float* x0, const float* X, const float* U, const float* K,
    const float* d, const float* dV1, const float* dV2, const float* Jprev,
    const float* rho, const float* drho, const float* alpha0,
    const float* lam, const float* mu, const float* dt, const float* Q,
    const float* R, const float* H, const float* q, const float* r,
    const float* c, const int* row_i, const float* row_f,
    const float* fk_joint, const float* fk_point,
    const unsigned char* active, const float* chain, float* Xout,
    float* Uout, float* scal, int batch, int N, int P, int J, int npts,
    int model, int ls_iters, float ls_lb, float ls_ub, float reg_min,
    float reg_factor, float reg_fp, float atol, void* stream) {
  if (batch <= 0 || N < 2 || P < 0 || J < 0 || J > kFkMaxJoints ||
      npts < 0 || npts > kFkMaxPoints ||
      (is_chain_model(model) && chain == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{x0, X, U, K, d, dV1, dV2, Jprev, rho, drho, alpha0, lam, mu, dt, Q,
         R, H, q, r, c, active, (const ChainTable*)chain, Xout, Uout, scal,
         batch, N, ls_iters, ls_lb, ls_ub, reg_min, reg_factor, reg_fp,
         atol};
  trajopt::CanonTables tab{(const int4*)row_i, (const float4*)row_f, nullptr,
                           nullptr, nullptr, P, 0, fk_joint,
                           (const float4*)fk_point, J, npts};
#define TRAJOPT_AL_FORWARD(M)                                              \
  case kModel##M:                                                          \
    fused_al_forward_kernel<M, false>                                      \
        <<<batch, 32, 0, (cudaStream_t)stream>>>(a, tab);                  \
    return (int)cudaGetLastError();                                        \
  case kModelSlack + kModel##M:                                            \
    fused_al_forward_kernel<M, true>                                       \
        <<<batch, 32, 0, (cudaStream_t)stream>>>(a, tab);                  \
    return (int)cudaGetLastError()
  switch (model) {
    TRAJOPT_AL_FORWARD(Quadrotor);
    TRAJOPT_AL_FORWARD(Cartpole);
    TRAJOPT_AL_FORWARD(Car);
    TRAJOPT_AL_FORWARD(Pendulum);
    TRAJOPT_AL_FORWARD(DoubleIntegrator);
    TRAJOPT_AL_FORWARD(Kuka);
    TRAJOPT_AL_FORWARD(AcrobotUrdf);
    TRAJOPT_AL_FORWARD(DoublependulumUrdf);
    TRAJOPT_AL_FORWARD(CartpoleUrdf);
  }
#undef TRAJOPT_AL_FORWARD
  return (int)cudaErrorInvalidValue;
}
