"""Which discrete models the CUDA kernels carry.

The kernels inline a model's RK3 step as a compile-time trait
(``csrc/models.cuh``), so a model reaches them by an id, not by its Python
step function. ``DiscreteModel.cuda_step`` names the step
(``models/base.py::discretize`` sets it for every (model, "rk3") pair that has
a trait); the infeasible-start model of ``solvers/altro.py`` keeps its base
model's name and carries ``slack_m``, the base model's control width, and
the minimum-time model keeps it too and carries ``mintime``. Every base
model has a slack-augmented instantiation: n slack controls after the base
controls, x⁺ = base_step(x, u[:m]) + u[m:]. Every model, the rigid-body
chains included, has a minimum-time instantiation of itself and of its
slack form: one more control h after the others and one more state that
carries it, x⁺ = [base_step(x[:-1], u[:-1], h²); h].

An entry marked ``k2_only`` is carried by the rollout kernel K2 alone (and
takes K5's sweep, which is model-free): ballonbeam, the Euler-angle
quadrotor, the analytic double pendulum and acrobot, and every minimum-time
form. The JAX package gives them no lane step, so it never runs them fused,
and neither does the port: the fused kernels (K3, K4, K7a, K7b) refuse
them, and the fused paths' eligibility says no for them on either device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CudaModel(NamedTuple):
    id: int        # ModelId of csrc/models.cuh
    label: str     # names the instantiation in launch counts and reports
    n: int         # all states, the minimum-time state included
    m: int         # all controls, the slacks and h included
    m_base: int    # the base model's controls (m_base == m without slacks)
    k2_only: bool = False   # no fused kernel carries it (module docstring)


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
    # scalar models without a lane step in the JAX package: K2 only
    "ballonbeam_rk3": CudaModel(9, "ballonbeam", 4, 1, 1, True),
    "quadrotor_euler_rk3": CudaModel(10, "quadrotor_euler", 12, 4, 4, True),
    "doublependulum_rk3": CudaModel(11, "doublependulum", 4, 2, 2, True),
    "acrobot_rk3": CudaModel(12, "acrobot", 4, 1, 1, True),
}
# kModelSlack and kModelMinTime of csrc/models.cuh: a slack-augmented
# model's id is its base model's plus SLACK_ID, a minimum-time model's its
# base model's (with or without slacks) plus MINTIME_ID
# (tests/test_torch_rigidbody.py holds the two tables equal)
SLACK_ID = 13
MINTIME_ID = 26
# the CUDA steps that are rigid-body chains (the Chain trait), whose kernels
# read the model's chain table
CHAIN_LABELS = ("kuka", "acrobot_urdf", "doublependulum_urdf",
                "cartpole_urdf")


def with_slack(base: CudaModel) -> CudaModel:
    """The slack-augmented instantiation of ``base``."""
    return CudaModel(base.id + SLACK_ID, base.label + "_slack", base.n,
                     base.m + base.n, base.m, base.k2_only)


def with_mintime(cm: CudaModel) -> CudaModel:
    """The minimum-time instantiation of ``cm`` (with or without slacks):
    one more state and control, K2 only."""
    return CudaModel(cm.id + MINTIME_ID, cm.label + "_mintime", cm.n + 1,
                     cm.m + 1, cm.m_base, True)


def _entries():
    out = {}
    for step, cm in CUDA_STEPS.items():
        for slack in (False, True):
            e = with_slack(cm) if slack else cm
            out[(step, slack, False)] = e
            out[(step, slack, True)] = with_mintime(e)
    return out


# (cuda_step, with slacks, minimum time) -> the kernels' entry: the one
# table of what the model-templated kernels carry (K2 all of it; K3 and K4
# the entries that are not k2_only; K7a and K7b those without slacks)
CUDA_MODELS = _entries()


def find_cuda_model(model, slack_ok: bool = False,
                    k2_only_ok: bool = False):
    """The kernels' entry for ``model``, or None: a model without a CUDA
    step (``cuda_step`` is None), widths that are not the step's, a
    slack-augmented model where ``slack_ok`` is False, or an entry marked
    ``k2_only`` where ``k2_only_ok`` is False."""
    slack = getattr(model, "slack_m", None)
    found = CUDA_MODELS.get((getattr(model, "cuda_step", None),
                             slack is not None,
                             bool(getattr(model, "mintime", False))))
    if found is None or (model.n, model.m) != (found.n, found.m):
        return None
    if slack is not None and not (slack_ok and slack == found.m_base):
        return None
    if found.k2_only and not k2_only_ok:
        return None
    return found


def cuda_model(model, fn: str, slack_ok: bool = False,
               k2_only_ok: bool = False) -> CudaModel:
    """:func:`find_cuda_model`, or NotImplementedError in the name of the
    wrapper ``fn`` (``slack_ok``: whether the kernel behind it has slack
    instantiations; ``k2_only_ok``: whether it is the rollout kernel K2,
    which carries the ``k2_only`` entries)."""
    found = find_cuda_model(model, slack_ok, k2_only_ok)
    if found is not None:
        return found
    name = getattr(model, "name", model)
    if not k2_only_ok and find_cuda_model(model, slack_ok, True) is not None:
        raise NotImplementedError(
            f"{fn}: model {name!r} has no lane step in the JAX package, so "
            "no fused kernel carries it: its solves run phase-split on K5 "
            "and K2, as the JAX package runs them on XLA")
    raise NotImplementedError(
        f"{fn}: no CUDA step for model {name!r} "
        f"(n={model.n}, m={model.m}); the kernels carry the RK3 steps of "
        f"{sorted(c.label for c in CUDA_STEPS.values())}"
        + (", each with or without slack controls" if slack_ok else "")
        + (", each also in its minimum-time form" if k2_only_ok else "")
        + " (no other model or integrator has a lane step, K6, here or in "
        "the JAX package; the integrators other than rk3 on the card are "
        "ROADMAP Queue 1 #4)")


def chain_table_ptr(model, cm: CudaModel, device):
    """The device address of the chain table that the kernels take for a
    chain model (``CHAIN_LABELS``), else None (a null pointer): the model's float32
    table (``models/rigidbody_lanes.py::chain_table``), copied to ``device``
    once and kept on the model."""
    if cm.label.removesuffix("_mintime").removesuffix("_slack") \
            not in CHAIN_LABELS:
        return None
    table = getattr(model, "chain_table", None)
    if table is None:
        raise ValueError(f"model {getattr(model, 'name', model)!r} has the "
                         f"CUDA step {cm.label!r} but no chain table")
    on = model.chain_table_on
    if device not in on:
        on[device] = torch.as_tensor(table, device=device)
    return on[device].data_ptr()

