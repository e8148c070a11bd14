// Fused AL backward sweep (kernel K3), for every model of models.cuh with
// or without the slack controls of the infeasible-start transform, and with
// the forward-kinematics rows of a rigid-body chain (K8) in the stack.
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_al_fused.py::
// _fused_al_backward_kernel (front end fused_al_backward_pallas). Per
// problem, backward over the knots: the discrete-step Jacobians A and B (with
// slacks B = [B_base | I]: the slack controls enter linearly), the quadratic
// stage expansion, the Gauss-Newton AL expansion of the canonical constraint
// stack with its active set (canon.cuh), and the Riccati step with the
// equilibrated PD solve of Quu_reg against [Qux_reg | Qu] (riccati_step.cuh,
// posdef_solve.cuh). A, B and the expansion never reach device memory. A
// failed stage writes zero gains, sets the problem's fail flag, and the
// sweep goes on. The plain version is
// trajopt_tpu_torch/ops/cuda_al_fused.py::fused_al_backward.
//
// The TPU kernel linearizes its step with jax.linearize; here the Jacobians
// come from forward-mode dual numbers through the model's templated RK3 step
// (models.cuh), one tangent direction per lane: n state and m_base control
// directions fill n + m_base lanes of the warp (17 for the quadrotor, 3 for
// the pendulum), and the n slack columns are the identity and are never
// differentiated (_step_jac_cols of the TPU kernel takes the same shortcut).
//
// What bounds it on this card: latency, not bytes or operations. One launch
// for the slack-augmented quadrotor at B=128, N=101, P=89 moves about 23 MB
// (λ, μ and the gains K dominate) and does about 0.8 GFLOP, microseconds of
// either at the card's rates; but each problem is a chain of N − 1 dependent
// knots, each a chain of small dependent products and an m-pivot elimination.
//
// Design: one warp per problem (one block of 32 threads) whatever the
// model, the knot loop inside the kernel, every matrix of the step in shared
// memory (about 15 KB for the slack-augmented quadrotor), the lanes
// splitting the entries of each product. 128 problems put one warp on each
// of 128 SMs, so nothing hides the chain's latency yet; packing several
// problems into one block, or several warps on one problem's products, is
// later work. The model and the slack flag are template parameters, so n,
// m_base and m are compile-time constants, one instantiation per (model,
// slack) pair; P, the stack's tables, N and the batch are arguments.
#include <cuda_runtime.h>

#include "canon.cuh"
#include "models.cuh"
#include "riccati_step.cuh"

namespace {

using namespace trajopt;

template <int NX, int NU>
struct Shared {
  RiccatiWork<NX, NU> w;
  FkWork fk;
  float z[NX + NU];
  float alx[NX], alu[NU], alxx[NX * NX], aluu_d[NU];
};

// M: the base model's trait; Slack: NX slack controls after its MB controls
template <class M, bool Slack>
__global__ void __launch_bounds__(32) fused_al_backward_kernel(
    const float* __restrict__ X, const float* __restrict__ U,
    const float* __restrict__ lam, const float* __restrict__ mu,
    const float* __restrict__ dt, const float* __restrict__ Q,
    const float* __restrict__ R, const float* __restrict__ H,
    const float* __restrict__ q, const float* __restrict__ r,
    const float* __restrict__ rho_in, CanonTables tab,
    const ChainTable* __restrict__ chain, float* __restrict__ K,
    float* __restrict__ d, float* __restrict__ dV,
    unsigned char* __restrict__ fail_out, float* __restrict__ Aout,
    float* __restrict__ Bout, int batch, int N, int reg_state, float atol) {
  constexpr int NX = M::NX, MB = M::NU, NU = Slack ? MB + NX : MB;
  __shared__ Shared<NX, NU> s;
  extern __shared__ float dyn[];       // g and Iμ of the P rows
  float* g_s = dyn;
  float* imu_s = dyn + tab.P;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int P = tab.P;
  const float rho = rho_in[b];
  RiccatiWork<NX, NU>& w = s.w;

  // terminal knot: Sx = Q_N x_N + q_N + alx, Sxx = Q_N + alxx (u = 0)
  const float* xN = X + ((size_t)b * N + (N - 1)) * NX;
  for (int e = lane; e < NX + NU; e += 32) s.z[e] = e < NX ? xN[e] : 0.0f;
  __syncwarp();
  fk_knot_warp(tab, s.z, s.fk, lane);
  canon_al_expansion_warp<NX, NU>(
      tab, s.z, s.fk, lam + ((size_t)b * N + (N - 1)) * P,
      mu + ((size_t)b * N + (N - 1)) * P, atol, g_s, imu_s, s.alx, s.alu,
      s.alxx, s.aluu_d, lane);
  const float* QN = Q + (size_t)(N - 1) * NX * NX;
  if (lane < NX) {
    float acc = QN[lane * NX] * s.z[0];
    for (int j = 1; j < NX; ++j) acc = acc + QN[lane * NX + j] * s.z[j];
    w.Sx[lane] = acc + q[(size_t)(N - 1) * NX + lane] + s.alx[lane];
  }
  for (int e = lane; e < NX * NX; e += 32) w.Sxx[e] = QN[e] + s.alxx[e];
  if constexpr (Slack) {
    // the slack columns of B are the identity, once and for all
    for (int e = lane; e < NX * NX; e += 32)
      w.B[(e / NX) * NU + MB + e % NX] = (e / NX == e % NX) ? 1.0f : 0.0f;
  }
  __syncwarp();

  float dV1 = 0.0f, dV2 = 0.0f;
  bool fail = false;
  for (int k = N - 2; k >= 0; --k) {
    const size_t bk = (size_t)b * (N - 1) + k;
    const float* xk = X + ((size_t)b * N + k) * NX;
    const float* uk = U + bk * NU;
    const float dtv = dt[k];
    for (int e = lane; e < NX + NU; e += 32)
      s.z[e] = e < NX ? xk[e] : uk[e - NX];
    __syncwarp();

    // Jacobians: lane j < n + m_base pushes tangent e_j of [x; u_base]
    // through the RK3 step; row i of its result is A[i][j] or
    // B_base[i][j − n]
    if (lane < NX + MB) {
      Dual xd[NX], ud[MB], out[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xd[i] = Dual(s.z[i], lane == i ? 1.f : 0.f);
#pragma unroll
      for (int i = 0; i < MB; ++i)
        ud[i] = Dual(s.z[NX + i], lane == NX + i ? 1.f : 0.f);
      M::template step<Dual>(xd, ud, dtv, out, chain);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (lane < NX) {
          w.A[i * NX + lane] = out[i].d;
          if (Aout) Aout[(bk * NX + i) * NX + lane] = out[i].d;
        } else {
          w.B[i * NU + lane - NX] = out[i].d;
          if (Bout) Bout[(bk * NX + i) * MB + lane - NX] = out[i].d;
        }
      }
    }

    // quadratic stage expansion: lx = dt(Qx + q + Hᵀu), lu = dt(Ru + r + Hx),
    // lxx = dtQ, luu = dtR, lux = dtH
    const float* Qk = Q + (size_t)k * NX * NX;
    const float* Rk = R + (size_t)k * NU * NU;
    const float* Hk = H + (size_t)k * NU * NX;
    const float* x = s.z;
    const float* u = s.z + NX;
    if (lane < NX) {
      float a = Qk[lane * NX] * x[0];
      for (int j = 1; j < NX; ++j) a = a + Qk[lane * NX + j] * x[j];
      float h = Hk[lane] * u[0];
      for (int j = 1; j < NU; ++j) h = h + Hk[j * NX + lane] * u[j];
      w.lx[lane] = (a + q[(size_t)k * NX + lane] + h) * dtv;
    }
    if (lane < NU) {
      float a = Rk[lane * NU] * u[0];
      for (int j = 1; j < NU; ++j) a = a + Rk[lane * NU + j] * u[j];
      float h = Hk[lane * NX] * x[0];
      for (int j = 1; j < NX; ++j) h = h + Hk[lane * NX + j] * x[j];
      w.lu[lane] = (a + r[(size_t)k * NU + lane] + h) * dtv;
    }
    for (int e = lane; e < NX * NX; e += 32) w.lxx[e] = Qk[e] * dtv;
    for (int e = lane; e < NU * NU; e += 32) w.luu[e] = Rk[e] * dtv;
    for (int e = lane; e < NU * NX; e += 32) w.lux[e] = Hk[e] * dtv;
    __syncwarp();

    // AL expansion of the stack; lux gets no AL term
    fk_knot_warp(tab, s.z, s.fk, lane);
    canon_al_expansion_warp<NX, NU>(tab, s.z, s.fk,
                                    lam + ((size_t)b * N + k) * P,
                                    mu + ((size_t)b * N + k) * P, atol, g_s,
                                    imu_s, s.alx, s.alu, s.alxx, s.aluu_d,
                                    lane);
    if (lane < NX) w.lx[lane] = w.lx[lane] + s.alx[lane];
    if (lane < NU) {
      w.lu[lane] = w.lu[lane] + s.alu[lane];
      w.luu[lane * NU + lane] = w.luu[lane * NU + lane] + s.aluu_d[lane];
    }
    for (int e = lane; e < NX * NX; e += 32) w.lxx[e] = w.lxx[e] + s.alxx[e];
    __syncwarp();

    const bool fail_k = riccati_step_warp<NX, NU>(
        w, rho, reg_state != 0, K + bk * NU * NX, d + bk * NU, dV1, dV2, lane);
    fail = fail || fail_k;
  }
  if (lane == 0) {
    dV[b] = dV1;
    dV[batch + b] = dV2;
    fail_out[b] = fail ? 1 : 0;
  }
}

template <class M, bool Slack>
int launch(const float* X, const float* U, const float* lam, const float* mu,
           const float* dt, const float* Q, const float* R, const float* H,
           const float* q, const float* r, const float* rho,
           const CanonTables& tab, const ChainTable* chain, float* K,
           float* d, float* dV, unsigned char* fail, float* Aout,
           float* Bout, int batch, int N, int reg_state, float atol,
           cudaStream_t stream) {
  const size_t dyn = 2 * (size_t)tab.P * sizeof(float);
  fused_al_backward_kernel<M, Slack><<<batch, 32, dyn, stream>>>(
      X, U, lam, mu, dt, Q, R, H, q, r, rho, tab, chain, K, d, dV, fail,
      Aout, Bout, batch, N, reg_state, atol);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes from ops/cuda_al_fused.py). Contiguous
// float32, batch-first, for the model `model` (models.cuh ModelId, plus
// kModelSlack for its slack-augmented form) with n states, m_base base
// controls and m = m_base or m_base + n controls: X (B,N,n), U (B,N-1,m),
// lam, mu (B,N,P), dt (N-1), Q (N,n,n), R (N,m,m), H (N,m,n), q (N,n),
// r (N,m), rho (B); the stack's tables row_i (P,4) int32, row_f (P,4),
// groups (G,6) int32, col_ptr (n+m+1) int32, col_rows int32, fk_joint
// (J,36) and fk_point (npts,4) (J = 0: no fk rows), chain (a chain model's
// table, models.cuh ChainTable, on the device; else null) →
// K (B,N-1,m,n), d (B,N-1,m), dV (2,B), fail (B) bytes, and where Aout/Bout
// are not null the in-kernel Jacobians A (B,N-1,n,n), B_base (B,N-1,n,m_base).
// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a model that has no instantiation.
extern "C" int trajopt_fused_al_backward_f32(
    const float* X, const float* U, const float* lam, const float* mu,
    const float* dt, const float* Q, const float* R, const float* H,
    const float* q, const float* r, const float* rho, const int* row_i,
    const float* row_f, const int* groups, const int* col_ptr,
    const int* col_rows, const float* fk_joint, const float* fk_point,
    const float* chain, float* K, float* d, float* dV, unsigned char* fail,
    float* Aout, float* Bout, int batch, int N, int P, int G, int J,
    int npts, int model, int reg_state, float atol, void* stream) {
  if (batch <= 0 || N < 2 || P < 0 || J < 0 || J > kFkMaxJoints ||
      npts < 0 || npts > kFkMaxPoints ||
      (is_chain_model(model) && chain == nullptr))
    return (int)cudaErrorInvalidValue;
  const ChainTable* ct = (const ChainTable*)chain;
  trajopt::CanonTables tab{(const int4*)row_i, (const float4*)row_f, groups,
                           col_ptr, col_rows, P, G, fk_joint,
                           (const float4*)fk_point, J, npts};
#define TRAJOPT_AL_BACKWARD(M)                                               \
  case kModel##M:                                                            \
    return launch<M, false>(X, U, lam, mu, dt, Q, R, H, q, r, rho, tab, ct,  \
                            K, d, dV, fail, Aout, Bout, batch, N, reg_state, \
                            atol, (cudaStream_t)stream);                     \
  case kModelSlack + kModel##M:                                              \
    return launch<M, true>(X, U, lam, mu, dt, Q, R, H, q, r, rho, tab, ct,   \
                           K, d, dV, fail, Aout, Bout, batch, N, reg_state,  \
                           atol, (cudaStream_t)stream)
  switch (model) {
    TRAJOPT_AL_BACKWARD(Quadrotor);
    TRAJOPT_AL_BACKWARD(Cartpole);
    TRAJOPT_AL_BACKWARD(Car);
    TRAJOPT_AL_BACKWARD(Pendulum);
    TRAJOPT_AL_BACKWARD(DoubleIntegrator);
    TRAJOPT_AL_BACKWARD(Kuka);
    TRAJOPT_AL_BACKWARD(AcrobotUrdf);
    TRAJOPT_AL_BACKWARD(DoublependulumUrdf);
    TRAJOPT_AL_BACKWARD(CartpoleUrdf);
  }
#undef TRAJOPT_AL_BACKWARD
  return (int)cudaErrorInvalidValue;
}
