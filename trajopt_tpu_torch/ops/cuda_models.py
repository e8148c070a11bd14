"""Which discrete models the CUDA kernels carry.

The kernels inline a model's RK3 step as a compile-time trait
(``csrc/models.cuh``), so a model reaches them by an id, not by its Python
step function. ``DiscreteModel.cuda_step`` names the step
(``models/base.py::discretize`` sets it for every (model, "rk3") pair that has
a trait); the infeasible-start model of ``solvers/altro.py`` keeps its base
model's name and carries ``slack_m``.
"""
from __future__ import annotations

from typing import NamedTuple


class CudaModel(NamedTuple):
    id: int        # ModelId of csrc/models.cuh
    label: str     # names the instantiation in launch counts and reports
    n: int
    m: int


CUDA_STEPS = {
    "quadrotor_rk3": CudaModel(0, "quadrotor", 13, 4),
    "cartpole_rk3": CudaModel(1, "cartpole", 4, 1),
    "car_rk3": CudaModel(2, "car", 3, 2),
    "pendulum_rk3": CudaModel(3, "pendulum", 2, 1),
    "doubleintegrator_rk3": CudaModel(4, "doubleintegrator", 2, 1),
}
QUADROTOR_SLACK = CudaModel(5, "quadrotor_slack", 13, 17)


def cuda_model(model, fn: str, slack_ok: bool = False) -> CudaModel:
    """The kernels' entry for ``model``, or NotImplementedError: a model
    without a CUDA step (``cuda_step`` is None), or the slack-augmented
    model where the kernel behind ``fn`` has no slack instantiation."""
    found = CUDA_STEPS.get(getattr(model, "cuda_step", None))
    slack = getattr(model, "slack_m", None)
    if found is not None and slack is not None:
        found = QUADROTOR_SLACK if (
            slack_ok and found.label == "quadrotor") else None
    if found is None or (model.n, model.m) != (found.n, found.m):
        raise NotImplementedError(
            f"{fn}: no CUDA step for model {getattr(model, 'name', model)!r} "
            f"(n={model.n}, m={model.m}); the kernels carry the RK3 steps of "
            f"{sorted(c.label for c in CUDA_STEPS.values())} (the rest of "
            "the zoo and the rigid-body chain step: ROADMAP Queue 2, K6)")
    return found
