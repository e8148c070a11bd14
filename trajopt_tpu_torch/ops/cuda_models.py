"""Which discrete models the CUDA kernels carry.

The kernels inline a model's RK3 step as a compile-time trait
(``csrc/models.cuh``), so a model reaches them by an id, not by its Python
step function. ``DiscreteModel.cuda_step`` names the step
(``models/base.py::discretize`` sets it for every (model, "rk3") pair that has
a trait); the infeasible-start model of ``solvers/altro.py`` keeps its base
model's name and carries ``slack_m``, the base model's control width. Every
base model has a slack-augmented instantiation: n slack controls after the
base controls, x⁺ = base_step(x, u[:m]) + u[m:].
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CudaModel(NamedTuple):
    id: int        # ModelId of csrc/models.cuh
    label: str     # names the instantiation in launch counts and reports
    n: int
    m: int         # all controls, the slacks included
    m_base: int    # the base model's controls (m_base == m without slacks)


CUDA_STEPS = {
    "quadrotor_rk3": CudaModel(0, "quadrotor", 13, 4, 4),
    "cartpole_rk3": CudaModel(1, "cartpole", 4, 1, 1),
    "car_rk3": CudaModel(2, "car", 3, 2, 2),
    "pendulum_rk3": CudaModel(3, "pendulum", 2, 1, 1),
    "doubleintegrator_rk3": CudaModel(4, "doubleintegrator", 2, 1, 1),
    # the rigid-body chains: the Chain trait, which reads the model's chain
    # table (the 7-DOF arm; the two-link URDF rigs of models/robots.py)
    "kuka_rk3": CudaModel(5, "kuka", 14, 7, 7),
    "acrobot_urdf_rk3": CudaModel(6, "acrobot_urdf", 4, 1, 1),
    "doublependulum_urdf_rk3": CudaModel(7, "doublependulum_urdf", 4, 2, 2),
    "cartpole_urdf_rk3": CudaModel(8, "cartpole_urdf", 4, 1, 1),
}
# kModelSlack of csrc/models.cuh: a slack-augmented model's id is its base
# model's plus this (tests/test_torch_rigidbody.py holds the two tables
# equal)
SLACK_ID = 9


def with_slack(base: CudaModel) -> CudaModel:
    """The slack-augmented instantiation of ``base``."""
    return CudaModel(base.id + SLACK_ID, base.label + "_slack", base.n,
                     base.m + base.n, base.m)


# (cuda_step, with slacks) -> the kernels' entry: the one table of what the
# model-templated kernels (K2, K3, K4; K7a and K7b without slacks) carry
CUDA_MODELS = {(step, slack): with_slack(cm) if slack else cm
               for step, cm in CUDA_STEPS.items() for slack in (False, True)}


def find_cuda_model(model, slack_ok: bool = False):
    """The kernels' entry for ``model``, or None: a model without a CUDA
    step (``cuda_step`` is None), widths that are not the step's, or a
    slack-augmented model where ``slack_ok`` is False."""
    slack = getattr(model, "slack_m", None)
    found = CUDA_MODELS.get((getattr(model, "cuda_step", None),
                             slack is not None))
    if found is None or (model.n, model.m) != (found.n, found.m):
        return None
    if slack is not None and not (slack_ok and slack == found.m_base):
        return None
    return found


def cuda_model(model, fn: str, slack_ok: bool = False) -> CudaModel:
    """:func:`find_cuda_model`, or NotImplementedError in the name of the
    wrapper ``fn`` (``slack_ok``: whether the kernel behind it has slack
    instantiations)."""
    found = find_cuda_model(model, slack_ok)
    if found is None:
        raise NotImplementedError(
            f"{fn}: no CUDA step for model {getattr(model, 'name', model)!r} "
            f"(n={model.n}, m={model.m}); the kernels carry the RK3 steps of "
            f"{sorted(c.label for c in CUDA_STEPS.values())}"
            + (", each with or without slack controls" if slack_ok else "")
            + " (no other model has a lane step, K6, in the JAX package "
            "either: ROADMAP Queue 1)")
    return found


def chain_table_ptr(model, cm: CudaModel, device):
    """The device address of the chain table that the kernels take for a
    chain model (``CHAIN_LABELS``), else None (a null pointer): the model's float32
    table (``models/rigidbody_lanes.py::chain_table``), copied to ``device``
    once and kept on the model."""
    if cm.label.removesuffix("_slack") not in CHAIN_LABELS:
        return None
    table = getattr(model, "chain_table", None)
    if table is None:
        raise ValueError(f"model {getattr(model, 'name', model)!r} has the "
                         f"CUDA step {cm.label!r} but no chain table")
    on = model.chain_table_on
    if device not in on:
        on[device] = torch.as_tensor(table, device=device)
    return on[device].data_ptr()


# the CUDA steps that are rigid-body chains (the Chain trait)
CHAIN_LABELS = ("kuka", "acrobot_urdf", "doublependulum_urdf",
                "cartpole_urdf")
