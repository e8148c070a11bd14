// Fused line search of an unconstrained iLQR iteration (kernel K7b).
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_fused.py::
// _fused_forward_kernel (front end fused_forward_pallas, full state:
// diff_lanes = None). Per problem, the whole backtracking line search of one
// iLQR iteration (reference forwardpass!, forward_pass.jl:5-85) under the
// objective's cost: the closed-loop rollout of each candidate step α with
// the divergence guard, the cost, the acceptance test, α halving, and the
// restore of X, U, J_prev with the ρ bump when the search runs out. The
// plain version is trajopt_tpu_torch/ops/cuda_fused.py::fused_forward.
//
// The kernel is line_search_rounds.cuh's without the AL cost, the one that
// K4 (fused_al_forward.cu) instantiates with it: the candidates of one
// search in parallel rounds of W ≤ 8 warps a problem, W from the batch and
// the occupancy (8 at B = 128: a search that runs out takes 3 rounds
// instead of 21 candidates), the lowest accepted candidate wins and only
// its buffer is copied out; a rigid-body chain's step (kuka and the three
// two-link rigs) is computed by each warp together from the table that the
// block stages in shared memory, and rounds bit for bit as the one-thread
// chain step. See that header for why the rounds give the serial search's
// result bit for bit, and for what bounds it (latency: a candidate is a
// chain of N − 1 dependent steps; one quadrotor candidate at B=128, N=101
// reads about 3.5 MB).
#include <cuda_runtime.h>

#include "line_search_rounds.cuh"

namespace {

using namespace trajopt;

// f(M{}) for the model of id `model`, or `none` for a model without a step
template <class F>
int dispatch(int model, F f, int none) {
  switch (model) {
    case kModelQuadrotor: return f(Quadrotor{});
    case kModelCartpole: return f(Cartpole{});
    case kModelCar: return f(Car{});
    case kModelPendulum: return f(Pendulum{});
    case kModelDoubleIntegrator: return f(DoubleIntegrator{});
    case kModelKuka: return f(Kuka{});
    case kModelAcrobotUrdf: return f(AcrobotUrdf{});
    case kModelDoublependulumUrdf: return f(DoublependulumUrdf{});
    case kModelCartpoleUrdf: return f(CartpoleUrdf{});
  }
  return none;
}

}  // namespace

// The warps W a block of the model `model`'s instantiation takes for a
// batch of `batch` problems (line_search_rounds.cuh), so that the wrapper
// can size the candidates' workspace; −1 for a model without an
// instantiation or when the device cannot be queried.
extern "C" int trajopt_fused_forward_warps(int model, int batch) {
  if (batch <= 0) return -1;
  return dispatch(model, [&](auto m) {
    return search_warps<decltype(m), false, false>(batch);
  }, -1);
}

// C entry point (bound with ctypes from ops/cuda_fused.py). Contiguous
// float32, batch-first, for the model `model` (models.cuh ModelId) with n
// states and m controls: x0 (B,n), X (B,N,n), U (B,N-1,m), K (B,N-1,m,n),
// d (B,N-1,m), dV1, dV2, J_prev, rho, drho, alpha0 (B), dt (N-1), Q (N,n,n),
// R (N,m,m), H (N,m,n), q (N,n), r (N,m), c (N), active (B) bytes or null,
// chain (a chain model's table, models.cuh ChainTable, on the device; else
// null), ws: ws_floats floats of workspace, at least B·W·(N·n + (N−1)·m)
// for the W of trajopt_fused_forward_warps when W > 1 (else null, 0) →
// Xout (B,N,n), Uout (B,N-1,m), scal (4,B) = J, rho, drho and the step
// used. Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a model that has no instantiation or a
// workspace too small.
extern "C" int trajopt_fused_forward_f32(
    const float* x0, const float* X, const float* U, const float* K,
    const float* d, const float* dV1, const float* dV2, const float* Jprev,
    const float* rho, const float* drho, const float* alpha0, const float* dt,
    const float* Q, const float* R, const float* H, const float* q,
    const float* r, const float* c, const unsigned char* active,
    const float* chain, float* ws, long long ws_floats, float* Xout,
    float* Uout, float* scal, int batch, int N, int model, int ls_iters,
    float ls_lb, float ls_ub, float reg_min, float reg_factor, float reg_fp,
    void* stream) {
  if (batch <= 0 || N < 2 || (is_chain_model(model) && chain == nullptr))
    return (int)cudaErrorInvalidValue;
  const SearchArgs a{x0, X, U, K, d, dV1, dV2, Jprev, rho, drho, alpha0,
                     nullptr, nullptr, dt, Q, R, H, q, r, c, active,
                     (const ChainTable*)chain, Xout, Uout, scal, ws, batch, N,
                     ls_iters, ls_lb, ls_ub, reg_min, reg_factor, reg_fp,
                     0.0f};
  const CanonTables none{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0,
                         nullptr, nullptr, 0, 0};
  return dispatch(model, [&](auto m) {
    return launch_search<decltype(m), false, false>(a, none, ws_floats,
                                                    (cudaStream_t)stream);
  }, (int)cudaErrorInvalidValue);
}
