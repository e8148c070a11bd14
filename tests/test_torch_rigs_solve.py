"""Solves of the three URDF rigs by the port against the JAX package, on the
CPU, in float64.

Each rig on the recipe of its zoo problem (``doublependulum_problem``,
unconstrained; ``acrobot_problem``, the goal constraint; ``cartpole``, the
control box and the goal), the horizon cut to N = 21 with the zoo's dt kept
(0.01 s, 0.05 s for the cartpole), built by the JAX package with the rig's
model and carried over by ``convert``. At that horizon no swing-up can
reach its goal, so AL would raise its penalties for as long as it is let
(the JAX package ran for minutes): the solve is cut to 3 outer iterations
of at most 15 inner ones, in both packages, and compared value by value,
X at 1e-6 of scale, J at rtol 1e-8, c_max at rtol 1e-6 and the iteration
counts equal. The port's solve goes through the plain versions of the
kernels that take it on the card: K7a/K7b (``fused=True``) or K5/K2 for the
unconstrained double pendulum, K3/K4 (the default) or K5/K2
(``fused_al=False``) for the other two; all arms agree with the JAX
package's solve.
"""
import jax
import numpy as np
import pytest
import torch

import trajopt_tpu as tt_jax
from trajopt_tpu.models import robots as jrobots

import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

N = 21


def _jax_problem(rig):
    model = tt_jax.discretize(getattr(jrobots, f"{rig}_model")(), "rk3")
    n, m = model.n, model.m
    if rig == "cartpole_urdf":
        xf, R, dt, u0 = np.array([0.0, np.pi, 0.0, 0.0]), 1e-1, 0.05, 0.01
    else:
        xf, R, dt, u0 = np.array([np.pi, 0.0, 0.0, 0.0]), 1e-2, 0.01, 1.0
    obj = tt_jax.LQRObjective(np.eye(n) * 1e-2, np.eye(m) * R,
                              np.eye(n) * 100.0, xf, N)
    cons = None
    if rig != "doublependulum_urdf":
        cons = tt_jax.ConstraintSetBuilder(N)
        if rig == "cartpole_urdf":
            cons.add(tt_jax.bound_constraint(n, m, u_min=-3.0, u_max=3.0))
        cons.add(tt_jax.goal_constraint(xf))
    return tt_jax.problem(model, obj, constraints=cons, x0=np.zeros(n),
                          xf=xf, N=N, dt=dt, U0=np.full((N - 1, m), u0))


def _options(pkg, **kw):
    return pkg.ALOptions(iterations=3,
                         opts_uncon=pkg.iLQROptions(iterations=15, **kw))


@pytest.mark.parametrize("rig,arms", [
    ("doublependulum_urdf", (dict(fused=True), dict(fused=False))),
    ("acrobot_urdf", (dict(), dict(fused_al=False))),
    ("cartpole_urdf", (dict(), dict(fused_al=False)))])
def test_rig_solve_matches_jax_f64(rig, arms):
    pj = _jax_problem(rig)
    ref = tt_jax.al_solve(pj, _options(tt_jax))
    prob = convert.problem_from_arrays(**convert.problem_arrays(pj),
                                       device="cpu")
    assert prob.model.cuda_step == rig
    Xj = np.asarray(ref.X)
    for kw in arms:
        res = tt.al_solve(prob, _options(tt, **kw))
        assert np.abs(res.X.numpy() - Xj).max() < 1e-6 * np.abs(Xj).max()
        np.testing.assert_allclose(float(res.J), float(ref.J), rtol=1e-8)
        np.testing.assert_allclose(float(res.c_max), float(ref.c_max),
                                   rtol=1e-6)
        assert int(res.iterations_total) == int(ref.iterations_total)
        assert int(res.iterations) == int(ref.iterations)
