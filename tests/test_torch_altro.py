"""``altro_solve`` of the port against the JAX package, on the CPU in float64.

The whole ALTRO solve (infeasible-start transform → AL stage → strip the
slacks → ``tvlqr_projection`` → feasible re-solve, and the projected-Newton
polish) runs through the kernels' plain versions here. Held to the JAX
package: the ``car_escape`` problem and its seed at 1e-12; ``tvlqr_projection``
at 1e-8; ``altro_solve`` on the pendulum of tests/test_altro.py:15-62 count
for count with X within 1e-6; ``car_escape`` at its own N = 101 and dt after a
fixed small number of outer iterations (the full float64 solve takes minutes
on the CPU and is left to ``chip_smoke.py``), with and without the polish;
the minimum-time pendulum of tests/test_altro.py:64-82 to that test's bars
and to the JAX package's float64 total time within 20% (a chaotic solve:
ROADMAP Q3-27).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.problems import zoo as jprobs
from trajopt_tpu.solvers import altro as jalt
from trajopt_tpu.solvers.ilqr import tvlqr_projection as jax_tvlqr
from trajopt_tpu.utils.interp import line_trajectory

import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.models import zoo as tzoo
from trajopt_tpu_torch.problems import zoo as probs
from trajopt_tpu_torch.solvers.projected_newton import _dynamics_defects

torch.set_num_threads(1)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _port_opts(jopts):
    """The port's ALTROOptions with the values of the JAX package's."""
    return convert.altro_options_from_dict(convert.options_dict(jopts))


# ------------------------------------------------------------- car_escape

def test_car_escape_equals_jax_problem():
    """Spec and seed of ``car_escape`` at 1e-12: start, goal, objective,
    the 177 constraint rows with their masks, the control seed and the
    interpolated infeasible-start state seed."""
    pj = jprobs.car_escape()
    pt = probs.car_escape(device="cpu")
    assert convert.PROBLEMS["car_escape"] is probs.car_escape
    assert (pt.N, pt.n, pt.m, pt.constraints.P) == (101, 3, 2, 177)
    assert pt.dt == pytest.approx(float(pj.dt), abs=1e-15)
    assert pt.model.cuda_step == "car"
    for k in ("x0", "xf", "X", "U"):
        np.testing.assert_allclose(getattr(pt, k).numpy(),
                                   np.asarray(getattr(pj, k)), atol=1e-12)
    for k in convert.OBJECTIVE_FIELDS:
        np.testing.assert_allclose(getattr(pt.obj, k).numpy(),
                                   np.asarray(getattr(pj.obj, k)), atol=1e-12)
    assert pt.constraints.labels() == pj.constraints.labels()
    np.testing.assert_array_equal(pt.constraints.mask.numpy(),
                                  np.asarray(pj.constraints.mask))
    np.testing.assert_array_equal(pt.constraints.is_eq.numpy(),
                                  np.asarray(pj.constraints.is_eq))
    C = pt.constraints.evaluate(pt.X, pt.U)
    np.testing.assert_allclose(
        C.numpy(), np.asarray(pj.constraints.evaluate(pj.X, pj.U)),
        atol=1e-12)
    # the transform: 3 slack controls and their 3 equality rows
    pi = tt.infeasible_problem(pt, 1e-1)
    pji = jalt.infeasible_problem(pj, 1e-1)
    assert (pi.m, pi.constraints.P, pi.model.slack_m) == (5, 180, 2)
    np.testing.assert_allclose(pi.U.numpy(), np.asarray(pji.U), atol=1e-12)
    np.testing.assert_allclose(pi.obj.R.numpy(), np.asarray(pji.obj.R),
                               atol=1e-12)


# ------------------------------------------------------- tvlqr_projection

def test_tvlqr_projection_matches_jax():
    """The stripped infeasible-start seed of ``car_escape`` (the waypoint
    trajectory with the unit controls, dynamically infeasible by metres)
    and a perturbed copy projected by both packages: X̄ and Ū at 1e-8, and
    the result follows the dynamics to 1e-12."""
    pj = jprobs.car_escape()
    pt = probs.car_escape(device="cpu")
    rng = np.random.default_rng(0)
    Xs = np.stack([np.asarray(pj.X), np.asarray(pj.X)
                   + rng.normal(size=(101, 3)) * 0.05])
    Xs[:, 0] = np.asarray(pj.x0)
    Us = np.stack([np.asarray(pj.U), np.asarray(pj.U)
                   + rng.normal(size=(100, 2)) * 0.1])
    dtj = pj.dt_traj()

    def one(X, U):
        return jax_tvlqr(pj.model, lambda a, b: pj.obj.expansion(a, b, dtj),
                         pj.x0, X, U, dtj, jtt.iLQROptions())

    Xj, Uj = jax.vmap(one)(jnp.asarray(Xs), jnp.asarray(Us))
    dtt = pt.dt_traj()
    Xn, Un = tt.tvlqr_projection(
        pt.model, lambda a, b: pt.obj.expansion(a, b, dtt),
        pt.x0.expand(2, -1), _t(Xs), _t(Us), pt.dt, tt.iLQROptions())
    np.testing.assert_allclose(Xn.numpy(), np.asarray(Xj), atol=1e-8)
    np.testing.assert_allclose(Un.numpy(), np.asarray(Uj), atol=1e-8)
    d = _dynamics_defects(pt, pt.x0.expand(2, -1), Xn, Un)
    assert float(d.abs().max()) < 1e-12


# ------------------------------------------------- altro_solve, pendulum

def _pendulum_jax(N=31, dt=0.15, u_bnd=3.0):
    model_d = jtt.discretize(jzoo.pendulum, "rk3")
    n, m = 2, 1
    xf = np.array([np.pi, 0.0])
    obj = jtt.LQRObjective(np.eye(n) * 1e-3, np.eye(m) * 1e-3,
                           np.eye(n) * 1e-3, xf, N)
    cons = jtt.ConstraintSetBuilder(N)
    cons.add(jtt.bound_constraint(n, m, u_min=-u_bnd, u_max=u_bnd))
    cons.add(jtt.goal_constraint(xf))
    prob = jtt.problem(model_d, obj, constraints=cons, x0=np.zeros(n), xf=xf,
                       N=N, dt=dt, U0=np.ones((N - 1, m)))
    return jtt.initial_states(prob, line_trajectory(np.zeros(2),
                                                    [np.pi, 0.0], N))


def _assert_same_result(rt, rj, x_tol=1e-6):
    assert int(rt.iterations) == int(rj.iterations)
    assert int(rt.iterations_total) == int(rj.iterations_total)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=x_tol)
    np.testing.assert_allclose(rt.U.numpy(), np.asarray(rj.U), atol=x_tol)
    np.testing.assert_allclose(float(rt.c_max), float(rj.c_max), atol=x_tol)
    np.testing.assert_allclose(float(rt.J), float(rj.J), rtol=1e-6)
    np.testing.assert_allclose(rt.dt_traj.numpy(), np.asarray(rj.dt_traj),
                               atol=1e-15)
    assert float(rt.tt) == pytest.approx(float(rj.tt), abs=1e-12)


@pytest.mark.parametrize("resolve", [True, False])
def test_altro_solve_pendulum_matches_jax(resolve):
    """The infeasible-start pendulum of tests/test_altro.py:28-61 (a line
    seed, slack controls, projection, with and without the re-solve): outer
    and inner iteration counts equal, X and U within 1e-6, and that test's
    own bars (goal within 1e-3, c_max < 1e-3; with the re-solve the dynamics
    defect below 1e-6)."""
    pj = _pendulum_jax()
    pt = convert.problem_from_arrays(**convert.problem_arrays(pj),
                                     device="cpu")
    opts_al = jtt.ALOptions(constraint_tolerance=1e-5, cost_tolerance=1e-5,
                            cost_tolerance_intermediate=1e-5, iterations=30,
                            penalty_scaling=10.0)
    jopts = jalt.ALTROOptions(opts_al=opts_al, R_inf=1.0,
                              resolve_feasible_problem=resolve)
    rj = jalt.altro_solve(pj, jopts)
    rt = tt.altro_solve(pt, _port_opts(jopts))
    assert isinstance(rt, tt.ALTROResult)
    _assert_same_result(rt, rj)
    # a line seed: no open-loop rollout to guard; a loop test per iteration
    assert rt.seed_held == 0 and rt.host_syncs >= int(rt.iterations_total)
    assert float((rt.X[-1] - pt.xf).norm()) < 1e-3
    assert float(rt.c_max) < 1e-3
    if resolve:
        d = _dynamics_defects(pt, pt.x0, rt.X, rt.U)
        assert float(d.abs().max()) < 1e-6


# ----------------------------------------------- altro_solve, car_escape

def _escape_opts(**kw):
    """The options of tests/test_altro.py:88-94 with the AL stage cut to two
    outer iterations of at most six inner ones."""
    opts_al = jtt.ALOptions(
        cost_tolerance=1e-6, cost_tolerance_intermediate=1e-2,
        constraint_tolerance=1e-8, penalty_scaling=50.0,
        penalty_initial=10.0, iterations=2,
        opts_uncon=jtt.iLQROptions(iterations=6))
    return jalt.ALTROOptions(opts_al=opts_al, R_inf=1e-1, **kw)


def test_altro_solve_car_escape_resolve_matches_jax():
    """``car_escape`` (N = 101, the zoo's dt, P = 180 with the slack rows)
    through the transform, two outer iterations of the slack problem, the
    strip, the projection and two outer iterations of the re-solve: counts
    equal, X and U within 1e-6."""
    jopts = _escape_opts(resolve_feasible_problem=True)
    rj = jalt.altro_solve(jprobs.car_escape(), jopts)
    rt = tt.altro_solve(probs.car_escape(device="cpu"), _port_opts(jopts))
    assert int(rt.iterations_total) == 24
    _assert_same_result(rt, rj)
    d = _dynamics_defects(probs.car_escape(device="cpu"),
                          rt.X[0], rt.X, rt.U)
    assert float(d.abs().max()) < 1e-9      # the re-solve's rollouts


def test_altro_solve_car_escape_polish_matches_jax():
    """The same AL stage handed to the projected-Newton polish
    (``projected_newton=True``, no re-solve): the polish runs on the
    slack-augmented problem (q = 183 rows a knot), and both packages come
    out at the same trajectory within 1e-6, with the same violation."""
    jopts = _escape_opts(resolve_feasible_problem=False,
                         projected_newton=True,
                         projected_newton_tolerance=1e-3,
                         opts_pn=jtt.PNOptions(max_projection_iters=2))
    rj = jalt.altro_solve(jprobs.car_escape(), jopts)
    rt = tt.altro_solve(probs.car_escape(device="cpu"), _port_opts(jopts))
    _assert_same_result(rt, rj)


# ------------------------------------------------------------ what raises

@pytest.mark.slow
def test_minimum_time_pendulum():
    """tests/test_altro.py:64-82 (reference minimum_time_tests.jl:59-63) on
    the port: the fixed-time pendulum's total time is 0.15·30; the
    minimum-time solve from dt = 0.075 reaches tt_mt < 0.5·tt_fixed and
    tt_mt < 1, the goal within 1e-3 in the ∞-norm and c_max < 1e-3 on the
    original constraints, as the JAX package's float64 solve does; tt_mt
    within 20% of the JAX package's (the solve is chaotic in float64: the
    JAX package's own tt spreads over 0.816-0.945 when x0 moves by 1e-13,
    tools/slice7_gates_jax.py --spread; ROADMAP Q3-27)."""
    jopts = jalt.ALTROOptions(opts_al=jtt.ALOptions(iterations=50,
                                                    penalty_scaling=10.0),
                              R_minimum_time=15.0, dt_max=0.15, dt_min=1e-3)
    opts = _port_opts(jopts)

    def pendulum(lib, zoo_, **kw):
        N, n, m = 31, 2, 1
        xf = np.array([np.pi, 0.0])
        dev = {"device": "cpu"} if lib is tt else {}
        obj = lib.LQRObjective(np.eye(n) * 1e-3, np.eye(m) * 1e-3,
                               np.eye(n) * 1e-3, xf, N, **dev)
        cons = lib.ConstraintSetBuilder(N)
        cons.add(lib.bound_constraint(n, m, u_min=-5.0, u_max=5.0))
        cons.add(lib.goal_constraint(xf))
        return lib.problem(lib.discretize(zoo_.pendulum, "rk3"), obj,
                           constraints=cons, x0=np.zeros(n), xf=xf, N=N,
                           U0=np.ones((N - 1, m)), **kw, **dev)

    res_fixed = tt.altro_solve(pendulum(tt, tzoo, dt=0.15), opts)
    tt_fixed = float(res_fixed.tt)
    assert tt_fixed == pytest.approx(0.15 * 30)

    rt = tt.altro_solve(pendulum(tt, tzoo, dt=0.075), opts,
                        minimum_time=True)
    rj = jalt.altro_solve(pendulum(jtt, jzoo, dt=0.075), jopts,
                          minimum_time=True)
    for r, X in ((rt, rt.X.numpy()), (rj, np.asarray(rj.X))):
        tt_mt = float(r.tt)
        assert tt_mt < 0.5 * tt_fixed
        assert tt_mt < 1.0
        assert np.linalg.norm(X[-1] - [np.pi, 0.0], np.inf) < 1e-3
        assert float(r.c_max) < 1e-3
    assert abs(float(rt.tt) - float(rj.tt)) < 0.2 * float(rj.tt)
    assert rt.dt_traj.shape == (30,) and bool((rt.dt_traj > 0).all())
    assert float(rt.dt_traj.sum()) == pytest.approx(float(rt.tt), rel=1e-14)


def test_altro_options_carry_over_as_data():
    """``ALTROOptions`` with its nested ``ALOptions``, ``iLQROptions`` and
    ``PNOptions`` of the JAX package become the port's, field for field; an
    option the port lacks raises."""
    jopts = jalt.ALTROOptions(
        opts_al=jtt.ALOptions(penalty_scaling=50.0, opts_uncon=jtt.iLQROptions(
            iterations=7, bp_reg_type="state")),
        R_inf=1e-1, projected_newton=True,
        opts_pn=jtt.PNOptions(ridge=1e-3, solve_type="optimal"))
    d = convert.options_dict(jopts)
    opts = convert.altro_options_from_dict(d)
    assert isinstance(opts, tt.ALTROOptions)
    assert isinstance(opts.opts_pn, tt.PNOptions)
    assert isinstance(opts.opts_al.opts_uncon, tt.iLQROptions)
    assert convert.options_dict(opts) == d
    assert convert.options_dict(tt.ALTROOptions()) == convert.options_dict(
        jalt.ALTROOptions())
    assert convert.options_dict(tt.PNOptions()) == convert.options_dict(
        jtt.PNOptions())
    with pytest.raises(TypeError):
        convert.altro_options_from_dict(dict(d, no_such_option=1))
