"""trajopt_tpu_torch — the PyTorch/CUDA port of trajopt_tpu.

The JAX package ``trajopt_tpu`` is the reference; this package mirrors its
module paths and public names (``trajopt_tpu_torch/solvers/ilqr.py`` ↔
``trajopt_tpu/solvers/ilqr.py``, …). Batching is a leading problem
dimension in place of ``vmap``; options are frozen dataclasses; every
constructor takes an explicit ``device``. The Pallas TPU kernels of the
ported path are hand-written CUDA kernels for Hopper (``csrc/``), built by
``kernels/_build.py`` at first use; each has a plain PyTorch twin that runs
on the CPU.

Ported so far: the whole ALTRO solve (slice 4: ``altro_solve`` with the
infeasible-start transform, the fused AL stages, ``tvlqr_projection``, the
feasible re-solve and the projected-Newton polish ``pn_solve`` /
``parallel.batch.pn_polish_batch``, on ``problems.zoo.car_escape``; the
fused AL kernels now serve every model with a CUDA step, with or without
slack controls, so the default constrained solve runs fused), the library's
default path (slice 3: ``al_solve`` and
``parallel.batch.solve_batch`` with ``iLQROptions()``, the scan backward
pass on the full state, and its ``fused=True`` variant, for the quadrotor,
cartpole, car, pendulum and double integrator), the quadrotor iLQR
queued-pool path (slice 1:
``problems.zoo.quadrotor_line`` solved by ``parallel.batch.
solve_batch_queued`` with ``ALOptions(opts_uncon=iLQROptions(
error_state=True, bp_type="sqrt"))``) and the quadrotor_maze ALTRO AL stage
(slice 2: ``problems.zoo.quadrotor_maze`` solved by ``parallel.batch.
solve_batch_queued_altro_retry`` with ``iLQROptions(fused=True)``, every
iteration the two fused AL kernels of ``ops/cuda_al_fused.py``).

Constructors and entry points build on the current CUDA device unless told
otherwise (``device="cpu"`` runs the kernels' plain versions).
"""
from trajopt_tpu_torch.models.base import DiscreteModel, Model, discretize
from trajopt_tpu_torch.ops.constraints import (
    Constraint, ConstraintSet, ConstraintSetBuilder, bound_constraint,
    goal_constraint, infeasible_constraint, obstacle_field_constraint,
)
from trajopt_tpu_torch.ops.cost import LQRObjective, Objective, QuadraticCost
from trajopt_tpu_torch.parallel.batch import (
    QueuedBatchResult, pn_polish_batch, solve_batch, solve_batch_queued,
    solve_batch_queued_altro, solve_batch_queued_altro_retry,
)
from trajopt_tpu_torch.problem import (
    Problem, initial_states, problem, update_problem,
)
from trajopt_tpu_torch.solvers.al import ALOptions, ALResult, al_solve
from trajopt_tpu_torch.solvers.altro import (
    ALTROOptions, ALTROResult, altro_solve, infeasible_problem,
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
    "ConstraintSet", "PNOptions", "PNResult", "altro_solve", "pn_polish_batch",
    "pn_solve", "tvlqr_projection",
    "ConstraintSetBuilder", "DiscreteModel", "LQRObjective", "Model",
    "Objective", "Problem", "QuadraticCost", "QueuedBatchResult", "al_solve",
    "bound_constraint", "discretize", "goal_constraint", "iLQROptions",
    "ilqr_solve", "infeasible_constraint", "infeasible_problem",
    "initial_states", "obstacle_field_constraint", "precise",
    "precise_context", "problem", "solve_batch", "solve_batch_queued",
    "solve_batch_queued_altro", "solve_batch_queued_altro_retry",
    "update_problem",
]
