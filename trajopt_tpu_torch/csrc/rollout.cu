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
#include "rollout_kernel.cuh"

// C entry point (bound with ctypes from ops/cuda_rollout.py). Batch-first
// contiguous float32 for the model `model` (models.cuh ModelId, with
// kModelSlack and kModelMinTime added for those forms) with n
// states, m controls and gains of width ns = n, or 12 with error_state (the
// quadrotor only): x0 (B,n), X (B,N,n), U (B,N-1,m), K (B,N-1,m,ns),
// d (B,N-1,m), alpha (B,) → Xout (B,N,n), Uout (B,N-1,m), ok (B,) bytes;
// chain: a chain model's table (models.cuh ChainTable) on the device, else
// null. Returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a model that has no instantiation. This library
// steps the models with RK3; each other rule's library
// (rollout_<rule>.cu) has the same entry as trajopt_rollout_<rule>_f32.
TRAJOPT_ROLLOUT_ENTRY(trajopt_rollout_f32, kRk3)
