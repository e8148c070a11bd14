// Standard Riccati backward sweep, batched over problems (kernel K5).
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_riccati.py::_riccati_kernel
// (front end riccati_sweep_pallas, the default bp_type='scan' backward pass).
// Per problem, backward over the knots, from A, B and the cost expansion in
// device memory: the Q-function blocks, gains from the regularized Quu
// (control regularization ρI, or state regularization ρBᵀB / ρBᵀA) by the
// Jacobi-equilibrated PD solve with its float32 pivot policy
// (posdef_solve.cuh), the cost-to-go from the unregularized blocks, and the
// expected-decrease sums ΔV1, ΔV2 (riccati_step.cuh). A failed stage writes
// zero gains, sets the problem's fail flag, and the sweep goes on. The
// terminal carry is Sx = lx_N, Sxx = lxx_N. The plain version is
// trajopt_tpu_torch/ops/riccati.py::scan_sweep.
//
// What bounds it on this card: by the roofline, bytes. It reads A, B and
// five expansion stacks, about 0.3 MB per problem at n = 13, m = 4, N = 101
// (39 MB for 128 problems), several times what the fused backward kernel
// (fused_backward.cu) moves for the same sweep; in practice each problem is
// a chain of N − 1 dependent knots and the launch is bound by latency.
//
// Design: one warp per problem (one block of 32 threads), the knot loop
// inside the kernel, the step's matrices in shared memory, the lanes
// splitting the loads and the entries of each product. The warp is the unit
// for every shape: on a 2×1 problem 30 lanes idle through the step, which is
// accepted for now (packing several small problems into one warp is later
// work). (n, m) are compile-time constants, one instantiation per pair that
// a ported model produces; the wrapper refuses any other pair.
#include <cuda_runtime.h>

#include "riccati_step.cuh"

namespace {

using namespace trajopt;

template <int NX, int NU>
__global__ void __launch_bounds__(32) riccati_sweep_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ lx, const float* __restrict__ lu,
    const float* __restrict__ lxx, const float* __restrict__ luu,
    const float* __restrict__ lux, const float* __restrict__ rho_in,
    float* __restrict__ K, float* __restrict__ d, float* __restrict__ dV,
    unsigned char* __restrict__ fail_out, int batch, int N, int reg_state) {
  __shared__ RiccatiWork<NX, NU> w;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float rho = rho_in[b];

  const size_t bN = (size_t)b * N + (N - 1);
  for (int e = lane; e < NX; e += 32) w.Sx[e] = lx[bN * NX + e];
  for (int e = lane; e < NX * NX; e += 32) w.Sxx[e] = lxx[bN * NX * NX + e];
  __syncwarp();

  float dV1 = 0.0f, dV2 = 0.0f;
  bool fail = false;
  for (int k = N - 2; k >= 0; --k) {
    const size_t bk = (size_t)b * (N - 1) + k;
    const size_t bkx = (size_t)b * N + k;
    for (int e = lane; e < NX * NX; e += 32) {
      w.A[e] = A[bk * NX * NX + e];
      w.lxx[e] = lxx[bkx * NX * NX + e];
    }
    for (int e = lane; e < NX * NU; e += 32) {
      w.B[e] = B[bk * NX * NU + e];
      w.lux[e] = lux[bk * NU * NX + e];
    }
    for (int e = lane; e < NU * NU; e += 32) w.luu[e] = luu[bk * NU * NU + e];
    for (int e = lane; e < NX; e += 32) w.lx[e] = lx[bkx * NX + e];
    for (int e = lane; e < NU; e += 32) w.lu[e] = lu[bk * NU + e];
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

template <int NX, int NU>
int launch(const float* A, const float* B, const float* lx, const float* lu,
           const float* lxx, const float* luu, const float* lux,
           const float* rho, float* K, float* d, float* dV,
           unsigned char* fail, int batch, int N, int reg_state,
           cudaStream_t stream) {
  riccati_sweep_kernel<NX, NU><<<batch, 32, 0, stream>>>(
      A, B, lx, lu, lxx, luu, lux, rho, K, d, dV, fail, batch, N, reg_state);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes from ops/cuda_riccati.py). Contiguous
// float32, batch-first: A (B,N-1,n,n), B (B,N-1,n,m), lx (B,N,n),
// lu (B,N-1,m), lxx (B,N,n,n), luu (B,N-1,m,m), lux (B,N-1,m,n), rho (B) →
// K (B,N-1,m,n), d (B,N-1,m), dV (2,B), fail (B) bytes. Returns the CUDA
// error of the launch (0 on success), or cudaErrorInvalidValue for an (n, m)
// that has no instantiation.
extern "C" int trajopt_riccati_sweep_f32(
    const float* A, const float* B, const float* lx, const float* lu,
    const float* lxx, const float* luu, const float* lux, const float* rho,
    float* K, float* d, float* dV, unsigned char* fail, int batch, int N,
    int n, int m, int reg_state, void* stream) {
  if (batch <= 0 || N < 2) return (int)cudaErrorInvalidValue;
#define TRAJOPT_RICCATI(NX, NU)                                             \
  if (n == NX && m == NU)                                                   \
    return launch<NX, NU>(A, B, lx, lu, lxx, luu, lux, rho, K, d, dV, fail, \
                          batch, N, reg_state, (cudaStream_t)stream)
  TRAJOPT_RICCATI(13, 4);    // quadrotor
  TRAJOPT_RICCATI(12, 4);    // quadrotor, quaternion error state
  TRAJOPT_RICCATI(13, 17);   // quadrotor with the infeasible-start slacks
  TRAJOPT_RICCATI(4, 1);     // cartpole
  TRAJOPT_RICCATI(3, 2);     // car
  TRAJOPT_RICCATI(2, 1);     // pendulum, double integrator
  TRAJOPT_RICCATI(4, 5);     // cartpole with the slacks
  TRAJOPT_RICCATI(3, 5);     // car with the slacks
  TRAJOPT_RICCATI(2, 3);     // pendulum, double integrator with the slacks
  TRAJOPT_RICCATI(14, 7);    // kuka
  TRAJOPT_RICCATI(14, 21);   // kuka with the slacks (~19 KB of shared memory)
#undef TRAJOPT_RICCATI
  return (int)cudaErrorInvalidValue;
}
