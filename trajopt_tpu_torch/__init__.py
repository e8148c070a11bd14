"""trajopt_tpu_torch — the PyTorch/CUDA port of trajopt_tpu.

The JAX package ``trajopt_tpu`` is the reference; this package mirrors its
module paths and public names (``trajopt_tpu_torch/solvers/ilqr.py`` ↔
``trajopt_tpu/solvers/ilqr.py``, …). Batching is a leading problem
dimension in place of ``vmap``; options are frozen dataclasses; every
constructor takes an explicit ``device``. The Pallas TPU kernels of the
ported path are hand-written CUDA kernels for Hopper (``csrc/``), built by
``kernels/_build.py`` at first use; each has a plain PyTorch twin that runs
on the CPU.

Ported so far: everything the JAX package does for iLQR, AL and ALTRO on
its iLQR-able models. That is the whole ALTRO solve (``altro_solve`` with
the infeasible-start and the minimum-time transforms, the fused AL stages,
``tvlqr_projection``, the feasible re-solve and the projected-Newton polish
``pn_solve`` / ``parallel.batch.pn_polish_batch``), the library's default
path (``al_solve`` and ``parallel.batch.solve_batch``, fused and
phase-split), the quadrotor iLQR queued-pool path
(``parallel.batch.solve_batch_queued`` with
``ALOptions(opts_uncon=iLQROptions(error_state=True, bp_type="sqrt"))``),
the quadrotor_maze ALTRO AL stage (``solve_batch_queued_altro_retry``), the
kuka arm and the URDF rigs, custom constraints, generic costs and every
model and problem of the zoo (``models.zoo.MODELS``, ``convert.PROBLEMS``),
the uncertain models with ``models.base.discretize_uncertain`` among them.
Each Pallas kernel is a CUDA kernel of ``csrc/``; ballonbeam, the
Euler-angle quadrotor, the analytic double pendulum and acrobot and every
minimum-time form (the rigid-body chains' too) run phase-split on K5 and
K2, as the JAX package runs them unfused. Only RK3 has CUDA steps.

Constructors and entry points build on the current CUDA device unless told
otherwise (``device="cpu"`` runs the kernels' plain versions).
"""
from trajopt_tpu_torch.models.base import DiscreteModel, Model, discretize
from trajopt_tpu_torch.ops.constraints import (
    Constraint, ConstraintSet, ConstraintSetBuilder, bound_constraint,
    circle_constraint_fn, custom_constraint, goal_constraint,
    infeasible_constraint, obstacle_field_constraint,
    planar_obstacle_constraint, sphere_constraint_fn,
)
from trajopt_tpu_torch.ops.cost import (
    GenericObjective, LQRCost, LQRCostTerminal, LQRObjective, Objective,
    QuadraticCost, cost_expansion, stage_cost, total_cost,
)
from trajopt_tpu_torch.ops.integration import INTEGRATORS, euler, midpoint, \
    rk3, rk4
from trajopt_tpu_torch.ops.rollout import rollout, rollout_closed_loop
from trajopt_tpu_torch.parallel.batch import (
    QueuedBatchResult, pn_polish_batch, solve_batch, solve_batch_queued,
    solve_batch_queued_altro, solve_batch_queued_altro_retry,
)
from trajopt_tpu_torch.problem import (
    Problem, initial_controls, initial_states, problem, update_problem,
)
from trajopt_tpu_torch.solvers.al import (
    ALOptions, ALResult, al_solve, max_violation,
)
from trajopt_tpu_torch.solvers.altro import (
    ALTROOptions, ALTROResult, altro_solve, infeasible_problem,
    minimum_time_problem, total_time,
)
from trajopt_tpu_torch.solvers.ilqr import (
    iLQROptions, ilqr_solve, tvlqr_projection,
)
from trajopt_tpu_torch.solvers.projected_newton import (
    PNOptions, PNResult, pn_solve,
)
from trajopt_tpu_torch.utils.tree import precise, precise_context

__all__ = [
    "ALOptions", "ALResult", "ALTROOptions", "ALTROResult", "Constraint",
    "ConstraintSet", "ConstraintSetBuilder", "DiscreteModel",
    "GenericObjective", "INTEGRATORS", "LQRCost", "LQRCostTerminal",
    "LQRObjective", "Model", "Objective", "PNOptions", "PNResult", "Problem",
    "QuadraticCost", "QueuedBatchResult", "al_solve", "altro_solve",
    "bound_constraint", "circle_constraint_fn", "cost_expansion",
    "custom_constraint", "discretize", "euler", "goal_constraint",
    "iLQROptions", "ilqr_solve", "infeasible_constraint",
    "infeasible_problem", "initial_controls", "initial_states",
    "max_violation", "midpoint", "minimum_time_problem",
    "obstacle_field_constraint", "planar_obstacle_constraint",
    "pn_polish_batch", "pn_solve", "precise", "precise_context", "problem",
    "rk3", "rk4", "rollout", "rollout_closed_loop", "solve_batch",
    "solve_batch_queued", "solve_batch_queued_altro",
    "solve_batch_queued_altro_retry", "sphere_constraint_fn", "stage_cost",
    "total_cost", "total_time", "tvlqr_projection", "update_problem",
]
