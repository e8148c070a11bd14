"""Minimum time for the rigid-body chains, on the CPU in float64.

The minimum-time model of the three URDF rigs (kuka's:
``tests/test_torch_mintime_kuka.py``, a file of its own for the JAX
reference's compile), with and without
the infeasible-start slacks (``solvers/altro.py::minimum_time_problem``):
its step against the JAX package's ``minimum_time_problem(...).model`` step
at 1e-10 of scale; its structured Jacobian (the chain's RK3 Jacobian of
``models/base.py::rk3_jacobian`` with h's column 2h·∂step/∂dt) against
``jacfwd`` of the JAX package's step and of its own step at 1e-10 of
scale; its table for the kernels and its K2-only entry (K2's
``MinTime<Chain>``), which no fused kernel takes; and the double-pendulum
rig's minimum-time ``altro_solve`` at N = 21 (dt kept at 0.01), cut to a
few outer iterations in both packages, count for count with X within 1e-6
(as ``tests/test_torch_mintime.py`` holds the pendulum's: past its first
iterations the solve may part by chaos, ROADMAP Q3-27). The kernels are
held to the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_mintime_chains import check_step_and_jacobian, problem
import trajopt_tpu as jtt
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.solvers import altro as jalt

import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.ops.cuda_models import (
    CHAIN_LABELS, CUDA_MODELS, cuda_model, find_cuda_model,
)
from trajopt_tpu_torch.solvers.ilqr import (
    _fused_al_eligible, _fused_eligible, iLQROptions,
)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

TWO_LINK_RIGS = tuple(r for r in CHAIN_LABELS if r != "kuka")


@pytest.mark.parametrize("slack", [False, True])
@pytest.mark.parametrize("rig", TWO_LINK_RIGS)
def test_chain_mintime_step_and_jacobian_match_jax(rig, slack):
    """The step and the structured Jacobian at 1e-10 of scale against the
    JAX package's step and its ``jacfwd``, and against ``jacfwd`` of the
    port's own step; the model keeps the chain's table (kuka's:
    ``tests/test_torch_mintime_kuka.py``)."""
    check_step_and_jacobian(rig, slack)


def test_chain_mintime_entries_are_k2_only():
    """``cuda_model`` finds the eight entries (four chains, with and without
    slacks), each K2-only with the model's widths and the chain's table;
    the fused rules say no for each."""
    found = []
    for rig in CHAIN_LABELS:
        for slack in (False, True):
            pt = problem(tt, rig, slack)
            cm = cuda_model(pt.model, "test", slack_ok=True, k2_only_ok=True)
            want = rig + ("_slack" if slack else "") + "_mintime"
            assert cm.label == want and cm.k2_only
            assert (cm.n, cm.m) == (pt.model.n, pt.model.m)
            assert pt.model.chain_table is not None
            assert find_cuda_model(pt.model, slack_ok=True) is None
            with pytest.raises(NotImplementedError, match="no lane step"):
                cuda_model(pt.model, "test", slack_ok=True)
            fused = iLQROptions(fused=True)
            assert not _fused_eligible(pt.model, fused, pt.obj)
            assert not _fused_al_eligible(pt.model, fused, None)
            found.append(cm)
    assert len({cm.id for cm in found}) == 8
    assert set(found) == {cm for (step, _, mt), cm in CUDA_MODELS.items()
                          if mt and CUDA_MODELS[(step, False, False)].label
                          in CHAIN_LABELS}


def _rig_mintime(lib, N):
    """The double-pendulum rig on its zoo problem (the model replaced, dt
    = 0.01) at N knots, with |u| ≤ 20 and the goal constraint, as
    ``chip_smoke.py``'s minimum-time rig (tools/slice8_gates_jax.py)."""
    rmod = jrobots if lib is jtt else None
    kw = {} if lib is jtt else {"device": "cpu"}
    model = lib.discretize(rmod.doublependulum_urdf_model() if rmod else
                           zoo.MODELS["doublependulum_urdf"], "rk3")
    n, m = 4, 2
    xf = np.array([np.pi, 0.0, 0.0, 0.0])
    obj = lib.LQRObjective(np.eye(n) * 1e-2, np.eye(m) * 1e-2,
                           np.eye(n) * 100.0, xf, N, **kw)
    cons = lib.ConstraintSetBuilder(N)
    cons.add(lib.bound_constraint(n, m, u_min=-20.0, u_max=20.0))
    cons.add(lib.goal_constraint(xf))
    return lib.problem(model, obj, constraints=cons, x0=np.zeros(n), xf=xf,
                       N=N, dt=0.01, U0=np.ones((N - 1, m)), **kw)


def test_rig_mintime_altro_first_iterations_match_jax():
    """``altro_solve(minimum_time=True)`` on the double-pendulum rig at
    N = 21, cut to three outer iterations, with the options of
    tools/slice8_gates_jax.py: the same outer and inner iteration counts,
    X within 1e-6, the steps within 1e-6."""
    jopts = jalt.ALTROOptions(
        opts_al=jtt.ALOptions(iterations=3, penalty_scaling=10.0),
        R_minimum_time=10.0, dt_max=0.02, dt_min=1e-3)
    opts = convert.altro_options_from_dict(convert.options_dict(jopts))
    rj = jalt.altro_solve(_rig_mintime(jtt, 21), jopts, minimum_time=True)
    rt = tt.altro_solve(_rig_mintime(tt, 21), opts, minimum_time=True)
    assert int(rt.iterations) == int(rj.iterations)
    assert int(rt.iterations_total) == int(rj.iterations_total)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=1e-6)
    np.testing.assert_allclose(rt.dt_traj.numpy(), np.asarray(rj.dt_traj),
                               atol=1e-6)
    assert float(rt.tt) == pytest.approx(float(rj.tt), abs=1e-6)
