// Fused backward sweep of an unconstrained iLQR iteration (kernel K7a).
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_fused.py::
// _fused_backward_kernel (front end fused_backward_pallas). Per problem,
// backward over the knots, from X, U and the objective's stacks alone: the
// discrete-step Jacobians A and B, the quadratic stage expansion
//   lx = dt(Qx + q + Hᵀu), lu = dt(Ru + r + Hx), lxx = dtQ, luu = dtR,
//   lux = dtH,
// and the Riccati step with the equilibrated PD solve (riccati_step.cuh).
// A, B and the expansion never reach device memory. The terminal carry is
// Sx = Q_N x_N + q_N, Sxx = Q_N. A failed stage writes zero gains, sets the
// problem's fail flag, and the sweep goes on. The plain version is
// trajopt_tpu_torch/ops/cuda_fused.py::fused_backward.
//
// The TPU kernel linearizes its step with jax.linearize; here the Jacobians
// come from forward-mode dual numbers through the model's templated RK3 step
// (models.cuh), one tangent direction per lane: n state and m control
// directions on n + m lanes of the warp (17 for the quadrotor, 21 for the
// kuka arm). For a rigid-body chain (Chain<NDOF, NU>: kuka and the three
// two-link rigs) each of those lanes walks the chain in Dual on its own,
// the chain's table read from the device pointer the kernel is handed, its
// arrays in local memory, as in K3.
//
// What bounds it on this card: latency, not bytes or operations. For the
// quadrotor at B=128, N=101 a launch moves about 3.5 MB (the gains K
// dominate), a tenth of what the plain Riccati kernel (riccati_sweep.cu)
// reads for the same sweep; each problem is a chain of 100 dependent knots.
//
// Design: the fused AL backward kernel (fused_al_backward.cu) without the
// constraint stack and the slack columns, templated on the model: one warp
// per problem, the knot loop inside the kernel, every matrix of the step in
// shared memory, the lanes splitting the entries of each product.
#include <cuda_runtime.h>

#include "models.cuh"
#include "riccati_step.cuh"

namespace {

using namespace trajopt;

template <class M>
struct Shared {
  RiccatiWork<M::NX, M::NU> w;
  float z[M::NX + M::NU];
};

template <class M>
__global__ void __launch_bounds__(32) fused_backward_kernel(
    const float* __restrict__ X, const float* __restrict__ U,
    const float* __restrict__ dt, const float* __restrict__ Q,
    const float* __restrict__ R, const float* __restrict__ H,
    const float* __restrict__ q, const float* __restrict__ r,
    const float* __restrict__ rho_in, const ChainTable* __restrict__ chain,
    float* __restrict__ K,
    float* __restrict__ d, float* __restrict__ dV,
    unsigned char* __restrict__ fail_out, float* __restrict__ Aout,
    float* __restrict__ Bout, int batch, int N, int reg_state) {
  constexpr int NX = M::NX, NU = M::NU;
  static_assert(NX + NU <= 32, "one tangent direction per lane");
  __shared__ Shared<M> s;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float rho = rho_in[b];
  RiccatiWork<NX, NU>& w = s.w;

  // terminal knot: Sx = Q_N x_N + q_N, Sxx = Q_N
  const float* xN = X + ((size_t)b * N + (N - 1)) * NX;
  const float* QN = Q + (size_t)(N - 1) * NX * NX;
  if (lane < NX) {
    float acc = QN[lane * NX] * xN[0];
    for (int j = 1; j < NX; ++j) acc = acc + QN[lane * NX + j] * xN[j];
    w.Sx[lane] = acc + q[(size_t)(N - 1) * NX + lane];
  }
  for (int e = lane; e < NX * NX; e += 32) w.Sxx[e] = QN[e];
  __syncwarp();

  float dV1 = 0.0f, dV2 = 0.0f;
  bool fail = false;
  for (int k = N - 2; k >= 0; --k) {
    const size_t bk = (size_t)b * (N - 1) + k;
    const float* xk = X + ((size_t)b * N + k) * NX;
    const float* uk = U + bk * NU;
    const float dtv = dt[k];
    if (lane < NX + NU) s.z[lane] = lane < NX ? xk[lane] : uk[lane - NX];
    __syncwarp();

    // Jacobians: lane j pushes tangent e_j of [x; u] through the RK3 step;
    // row i of its result is A[i][j] or B[i][j − n]
    if (lane < NX + NU) {
      Dual xd[NX], ud[NU], out[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xd[i] = Dual(s.z[i], lane == i ? 1.f : 0.f);
#pragma unroll
      for (int i = 0; i < NU; ++i)
        ud[i] = Dual(s.z[NX + i], lane == NX + i ? 1.f : 0.f);
      M::template step<Dual>(xd, ud, dtv, out, chain);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (lane < NX) {
          w.A[i * NX + lane] = out[i].d;
          if (Aout) Aout[(bk * NX + i) * NX + lane] = out[i].d;
        } else {
          w.B[i * NU + lane - NX] = out[i].d;
          if (Bout) Bout[(bk * NX + i) * NU + lane - NX] = out[i].d;
        }
      }
    }

    // quadratic stage expansion
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

template <class M>
int launch(const float* X, const float* U, const float* dt, const float* Q,
           const float* R, const float* H, const float* q, const float* r,
           const float* rho, const ChainTable* chain, float* K, float* d,
           float* dV, unsigned char* fail, float* Aout, float* Bout,
           int batch, int N, int reg_state, cudaStream_t stream) {
  fused_backward_kernel<M><<<batch, 32, 0, stream>>>(
      X, U, dt, Q, R, H, q, r, rho, chain, K, d, dV, fail, Aout, Bout, batch,
      N, reg_state);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes from ops/cuda_fused.py). Contiguous
// float32, batch-first, for the model `model` (models.cuh ModelId) with n
// states and m controls: X (B,N,n), U (B,N-1,m), dt (N-1), Q (N,n,n),
// R (N,m,m), H (N,m,n), q (N,n), r (N,m), rho (B), chain (a chain model's
// table, models.cuh ChainTable, on the device; else null) → K (B,N-1,m,n),
// d (B,N-1,m), dV (2,B), fail (B) bytes, and where Aout/Bout are not null
// the in-kernel Jacobians A (B,N-1,n,n), B (B,N-1,n,m). Returns the CUDA
// error of the launch (0 on success), or cudaErrorInvalidValue for a model
// that has no instantiation.
extern "C" int trajopt_fused_backward_f32(
    const float* X, const float* U, const float* dt, const float* Q,
    const float* R, const float* H, const float* q, const float* r,
    const float* rho, const float* chain, float* K, float* d, float* dV,
    unsigned char* fail, float* Aout, float* Bout, int batch, int N,
    int model, int reg_state, void* stream) {
  if (batch <= 0 || N < 2 || (is_chain_model(model) && chain == nullptr))
    return (int)cudaErrorInvalidValue;
#define TRAJOPT_FUSED_BACKWARD(M)                                            \
  return launch<M>(X, U, dt, Q, R, H, q, r, rho, (const ChainTable*)chain,  \
                   K, d, dV, fail, Aout, Bout, batch, N, reg_state,          \
                   (cudaStream_t)stream)
  switch (model) {
    case kModelQuadrotor: TRAJOPT_FUSED_BACKWARD(Quadrotor);
    case kModelCartpole: TRAJOPT_FUSED_BACKWARD(Cartpole);
    case kModelCar: TRAJOPT_FUSED_BACKWARD(Car);
    case kModelPendulum: TRAJOPT_FUSED_BACKWARD(Pendulum);
    case kModelDoubleIntegrator: TRAJOPT_FUSED_BACKWARD(DoubleIntegrator);
    case kModelKuka: TRAJOPT_FUSED_BACKWARD(Kuka);
    case kModelAcrobotUrdf: TRAJOPT_FUSED_BACKWARD(AcrobotUrdf);
    case kModelDoublependulumUrdf: TRAJOPT_FUSED_BACKWARD(DoublependulumUrdf);
    case kModelCartpoleUrdf: TRAJOPT_FUSED_BACKWARD(CartpoleUrdf);
  }
#undef TRAJOPT_FUSED_BACKWARD
  return (int)cudaErrorInvalidValue;
}
