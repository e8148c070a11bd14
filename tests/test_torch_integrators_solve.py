"""The pendulum swing-up of tests/test_ilqr.py:36-50 (N = 31, dt = 0.15,
|u| ≤ 3, the goal constraint) under every integrator but RK3, in float64
against the JAX package: K2's plain version (``rollout_closed_loop``) in
the problem's four forms (plain, with slacks, minimum time, both) against
the JAX package's rollout within 1e-12, and a whole ``al_solve``.

The explicit rules' solves take the JAX package's outer and inner
iteration counts and X within 1e-6, except RK4's: its last outer
iterations sit at c_max ≈ 2e-3 with the penalty grown to ~1e8, where the
two packages' 1e-16 differences in a step grow to 2.2e-6 in X (1.1e-9
after six outer iterations, 1.5e-6 after ten; J within 1e-6 relative), so
RK4 is held count for count with X within 1e-6 over its first six outer
iterations and within RK4_X_TOL = 5e-6 over the whole solve. The implicit
rules' Jacobians differ from the JAX package's by the Newton loop's last
residual but one (``tests/_torch_integrators.py``), so their solves are
judged by outcome: c_max < 1e-3 as in the JAX package, J within
IMPLICIT_J_RTOL = 1e-6 of the JAX package's J (measured: the same seven
leading digits of J and the same iteration counts under both rules, X
within 1.4e-11 under midpoint_implicit and 1.3e-8 under rk3_implicit).
The rk3_implicit solve (about 20 s: every line-search rollout runs the
Newton loop) is in ``tests/test_torch_integrators.py``, the file with the
most tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.ops.rollout import rollout_closed_loop as jax_rollout_cl
from trajopt_tpu.solvers import altro as jalt
from trajopt_tpu.utils.interp import line_trajectory

import trajopt_tpu_torch as tt
from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

from _torch_integrators import scale_close

torch.set_num_threads(1)

RULES = ("euler", "midpoint", "rk4", "midpoint_implicit", "rk3_implicit")
RK4_X_TOL = 5e-6
IMPLICIT_J_RTOL = 1e-6


def _pendulum(lib, zoo_, rule, **kw):
    n, m, N = 2, 1, 31
    xf = np.array([np.pi, 0.0])
    obj = lib.LQRObjective(np.eye(n) * 1e-3, np.eye(m) * 1e-3,
                           np.eye(n) * 1e-3, xf, N, **kw)
    cons = lib.ConstraintSetBuilder(N)
    cons.add(lib.bound_constraint(n, m, u_min=-3.0, u_max=3.0))
    cons.add(lib.goal_constraint(xf))
    return lib.problem(lib.discretize(zoo_.pendulum, rule), obj,
                       constraints=cons, x0=np.zeros(n), xf=xf, N=N, dt=0.15,
                       U0=np.ones((N - 1, m)), **kw)


def _forms(rule):
    """The problem's four forms in both packages: [(label, JAX, port)]."""
    pj = _pendulum(jtt, jzoo, rule)
    pt = _pendulum(tt, zoo, rule, device="cpu")
    X0 = line_trajectory(np.zeros(2), [np.pi, 0.0], pt.N)
    sj = jalt.infeasible_problem(jtt.initial_states(pj, X0), 1.0)
    st = tt.infeasible_problem(tt.initial_states(pt, X0))
    out = [("plain", pj, pt), ("slack", sj, st)]
    for label, a, b in list(out):
        out.append((label + "_mintime",
                    jalt.minimum_time_problem(a, 15.0, 0.15, 1e-3),
                    tt.minimum_time_problem(b, 15.0, 0.15, 1e-3)))
    return out


@pytest.mark.parametrize("rule", RULES)
def test_rollout_plain_version_matches_jax(rule):
    """``rollout_closed_loop`` in each form, three starts with random gains
    (none on h; one start's torque past the control limit: stopped in
    both), against the JAX
    package's rollout of the same model one problem at a time, within
    1e-12."""
    rng = np.random.default_rng(21)
    for label, pj, pt in _forms(rule):
        n, m, N = pt.n, pt.m, pt.N
        Bz = 3
        mintime = label.endswith("mintime")
        x0 = np.concatenate([rng.normal(size=(Bz, n - mintime)) * 0.1,
                             np.zeros((Bz, int(mintime)))], axis=1)
        X = np.nan_to_num(np.asarray(pj.X))[None].repeat(Bz, 0) \
            + rng.normal(size=(Bz, N, n)) * 0.01
        U = np.asarray(pj.U)[None].repeat(Bz, 0) \
            + rng.normal(size=(Bz, N - 1, m)) * 0.01
        K = rng.normal(size=(Bz, N - 1, m, n)) * 0.05
        d = rng.normal(size=(Bz, N - 1, m)) * 0.05
        if mintime:
            # h = u[-1] follows its seed: fed back, it grows the step
            # dt = h² until the pendulum leaves every bound
            K[..., -1, :] = 0.0
            d[..., -1] = 0.0
        d[2, 5, 0] = 50.0
        alpha = np.array([1.0, 0.5, 1.0])
        Xt, Ut, okt = rollout_closed_loop(
            pt.model, *(torch.tensor(a) for a in (x0, X, U, K, d, alpha)),
            pt.dt, max_control_value=10.0)
        assert okt.tolist() == [True, True, False]
        for b in range(Bz):
            Xj, Uj, okj = jax_rollout_cl(
                pj.model, *(jnp.asarray(a[b]) for a in (x0, X, U, K, d)),
                float(alpha[b]), pj.dt, max_control_value=10.0)
            assert bool(okj) == bool(okt[b])
            scale_close(Xt[b].numpy(), Xj, 1e-12)
            scale_close(Ut[b].numpy(), Uj, 1e-12)


@pytest.mark.parametrize("rule", ("euler", "midpoint", "rk4"))
def test_al_solve_explicit_rules_match_jax(rule):
    """The whole AL solve under an explicit rule: the JAX package's outer
    and inner iteration counts, X within 1e-6 (RK4: module docstring),
    c_max < 1e-3."""
    rj = jtt.al_solve(_pendulum(jtt, jzoo, rule), jtt.ALOptions())
    rt = tt.al_solve(_pendulum(tt, zoo, rule, device="cpu"), tt.ALOptions())
    assert int(rt.iterations) == int(rj.iterations)
    assert int(rt.iterations_total) == int(rj.iterations_total)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X),
                               atol=RK4_X_TOL if rule == "rk4" else 1e-6)
    assert float(rt.c_max) < 1e-3 and float(rj.c_max) < 1e-3
    if rule == "rk4":
        cut = tt.ALOptions(iterations=6)
        rj = jtt.al_solve(_pendulum(jtt, jzoo, rule), jtt.ALOptions(
            iterations=6))
        rt = tt.al_solve(_pendulum(tt, zoo, rule, device="cpu"), cut)
        assert int(rt.iterations_total) == int(rj.iterations_total)
        np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=1e-6)


def al_solve_implicit_rule_meets_the_jax_outcome(rule):
    """The whole AL solve under an implicit rule, judged by outcome (module
    docstring): c_max < 1e-3 in both packages, the goal reached, J within
    IMPLICIT_J_RTOL of the JAX package's."""
    rj = jtt.al_solve(_pendulum(jtt, jzoo, rule), jtt.ALOptions())
    rt = tt.al_solve(_pendulum(tt, zoo, rule, device="cpu"), tt.ALOptions())
    assert float(rt.c_max) < 1e-3 and float(rj.c_max) < 1e-3
    assert float((rt.X[-1] - torch.tensor([np.pi, 0.0],
                                          dtype=torch.float64)).norm()) < 2e-3
    assert float(rt.J) == pytest.approx(float(rj.J), rel=IMPLICIT_J_RTOL)


def test_al_solve_midpoint_implicit_meets_the_jax_outcome():
    al_solve_implicit_rule_meets_the_jax_outcome("midpoint_implicit")
