"""trajopt_tpu_torch — the PyTorch/CUDA port of trajopt_tpu.

The JAX package ``trajopt_tpu`` is the reference; this package mirrors its
module paths and public names (``trajopt_tpu_torch/solvers/ilqr.py`` ↔
``trajopt_tpu/solvers/ilqr.py``, …). Batching is a leading problem
dimension in place of ``vmap``; options are frozen dataclasses; every
constructor takes an explicit ``device``. The Pallas TPU kernels of the
ported path are hand-written CUDA kernels for Hopper (``csrc/``), built by
``kernels/_build.py`` at first use; each has a plain PyTorch twin that runs
on the CPU.

Ported so far (slice 1): the quadrotor iLQR queued-pool path —
``problems.zoo.quadrotor_line`` solved by ``parallel.batch.
solve_batch_queued`` with ``ALOptions(opts_uncon=iLQROptions(
error_state=True, bp_type="sqrt"))``.
"""
from trajopt_tpu_torch.models.base import DiscreteModel, Model, discretize
from trajopt_tpu_torch.ops.cost import LQRObjective, Objective, QuadraticCost
from trajopt_tpu_torch.parallel.batch import (
    QueuedBatchResult, solve_batch_queued,
)
from trajopt_tpu_torch.problem import Problem, problem, update_problem
from trajopt_tpu_torch.solvers.al import ALOptions
from trajopt_tpu_torch.solvers.ilqr import iLQROptions, ilqr_solve
from trajopt_tpu_torch.utils.tree import precise, precise_context

__all__ = [
    "ALOptions", "DiscreteModel", "LQRObjective", "Model", "Objective",
    "Problem", "QuadraticCost", "QueuedBatchResult", "discretize",
    "iLQROptions", "ilqr_solve", "precise", "precise_context", "problem",
    "solve_batch_queued", "update_problem",
]
