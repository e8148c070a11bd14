// Fused AL line search (kernel K4), for every model of models.cuh with or
// without the slack controls of the infeasible-start transform, and with
// the forward-kinematics rows of a rigid-body chain (K8) in the stack.
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_al_fused.py::
// _fused_al_forward_kernel (front end fused_al_forward_pallas). Per
// problem, the whole backtracking line search of one iLQR iteration under
// the objective's cost plus the AL cost Σ λc + ½ c Iμ c of the canonical
// stack (canon.cuh). The plain version is
// trajopt_tpu_torch/ops/cuda_al_fused.py::fused_al_forward.
//
// The kernel is line_search_rounds.cuh's with the AL cost: the candidates
// of one search in parallel rounds of W ≤ 8 warps a problem, W from the
// batch and the occupancy, a chain's step over each warp from the table
// that the block stages in shared memory (see that header for why the
// rounds give the serial search's result bit for bit, and for what bounds
// it). K7b (fused_forward.cu) instantiates the same kernel without the AL
// cost. The model and the slack flag are template parameters, so n, m_base
// and m are compile-time constants.
#include <cuda_runtime.h>

#include "line_search_rounds.cuh"

namespace {

using namespace trajopt;

// f(Inst<M, Slack>{}) for the instantiation of model id `model`, or
// `none` for a model that has none
template <class M_, bool Slack_>
struct Inst {
  using M = M_;
  static constexpr bool kSlack = Slack_;
};

template <class F>
int dispatch(int model, F f, int none) {
#define TRAJOPT_AL_FORWARD(M)                  \
  case kModel##M:                              \
    return f(Inst<M, false>{});                \
  case kModelSlack + kModel##M:                \
    return f(Inst<M, true>{})
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
  return none;
}

}  // namespace

// The warps W a block of the model `model`'s instantiation takes for a
// batch of `batch` problems (line_search_rounds.cuh), so that the wrapper
// can size the candidates' workspace; −1 for a model without an
// instantiation or when the device cannot be queried.
extern "C" int trajopt_fused_al_forward_warps(int model, int batch) {
  if (batch <= 0) return -1;
  return dispatch(model, [&](auto inst) {
    using I = decltype(inst);
    return search_warps<typename I::M, I::kSlack, true>(batch);
  }, -1);
}

// C entry point (bound with ctypes from ops/cuda_al_fused.py). Contiguous
// float32, batch-first, for the model `model` (models.cuh ModelId, plus
// kModelSlack for its slack-augmented form) with n states and m controls:
// x0 (B,n), X (B,N,n), U (B,N-1,m), K (B,N-1,m,n), d (B,N-1,m), dV1, dV2,
// J_prev, rho, drho, alpha0 (B), lam, mu (B,N,P), dt (N-1), Q (N,n,n),
// R (N,m,m), H (N,m,n), q (N,n), r (N,m), c (N), the stack's row tables
// row_i (P,4) int32 and row_f (P,4), its fk tables fk_joint (J,36) and
// fk_point (npts,4) (J = 0: no fk rows), active (B) bytes or null, chain (a
// chain model's table, models.cuh ChainTable, on the device; else null),
// ws: ws_floats floats of workspace, at least B·W·(N·n + (N−1)·m) for the
// W of trajopt_fused_al_forward_warps when W > 1 (else null, 0) →
// Xout (B,N,n), Uout (B,N-1,m), scal (4,B) = J, rho, drho and the step used.
// Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a model that has no instantiation or a
// workspace too small.
extern "C" int trajopt_fused_al_forward_f32(
    const float* x0, const float* X, const float* U, const float* K,
    const float* d, const float* dV1, const float* dV2, const float* Jprev,
    const float* rho, const float* drho, const float* alpha0,
    const float* lam, const float* mu, const float* dt, const float* Q,
    const float* R, const float* H, const float* q, const float* r,
    const float* c, const int* row_i, const float* row_f,
    const float* fk_joint, const float* fk_point,
    const unsigned char* active, const float* chain, float* ws,
    long long ws_floats, float* Xout, float* Uout, float* scal, int batch,
    int N, int P, int J, int npts, int model, int ls_iters, float ls_lb,
    float ls_ub, float reg_min, float reg_factor, float reg_fp, float atol,
    void* stream) {
  if (batch <= 0 || N < 2 || P < 0 || J < 0 || J > kFkMaxJoints ||
      npts < 0 || npts > kFkMaxPoints ||
      (is_chain_model(model) && chain == nullptr))
    return (int)cudaErrorInvalidValue;
  const SearchArgs a{x0, X, U, K, d, dV1, dV2, Jprev, rho, drho, alpha0,
                     lam, mu, dt, Q, R, H, q, r, c, active,
                     (const ChainTable*)chain, Xout, Uout, scal, ws, batch, N,
                     ls_iters, ls_lb, ls_ub, reg_min, reg_factor, reg_fp,
                     atol};
  const trajopt::CanonTables tab{(const int4*)row_i, (const float4*)row_f,
                                 nullptr, nullptr, nullptr, P, 0, fk_joint,
                                 (const float4*)fk_point, J, npts};
  return dispatch(model, [&](auto inst) {
    using I = decltype(inst);
    return launch_search<typename I::M, I::kSlack, true>(
        a, tab, ws_floats, (cudaStream_t)stream);
  }, (int)cudaErrorInvalidValue);
}
