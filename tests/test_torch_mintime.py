"""The port's minimum-time transform against the JAX package, on the CPU in
float64.

``MinTimeObjective`` (total and expansion at 1e-12 of scale; the closed-form
expansion also against ``torch.func`` AD of the total), ``mintime_equality``
(value, Jacobian, AL terms exactly), ``minimum_time_problem`` (fields, the
constraint stack's rows, masks, values and Jacobians at 1e-12, the τ model's
step and Jacobians at 1e-12, over the plain and the slack-augmented
pendulum), ``total_time``, and the plain version of the rollout kernel K2 on
the ``MinTime`` model and on ``MinTime`` with slacks against the JAX
package's rollout at 1e-12. ``altro_solve`` on the reference's min-time
pendulum (tests/test_altro.py:64-82) seeded with the line trajectory, the
infeasible arm (trajopt_tpu altro.py:445-457): the first eight outer
iterations count for count with the JAX package, X within 1e-6, and the
whole solve to the reference test's bars, its total time within 20% of the
JAX package's float64 one (the solve is chaotic in float64: the packages
agree to 1e-10 for about ten outer iterations and part after, and the JAX
package's own total time spreads over 0.772-0.925 when x0 moves by 1e-13,
tools/slice7_gates_jax.py --spread; ROADMAP Q3-27). The feasible solve is ``tests/test_torch_altro.py``'s. And a chain's
minimum-time model has its K2-only CUDA form, and its plain step runs.
"""
import jax
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
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.ops.cuda_models import cuda_model, find_cuda_model
from trajopt_tpu_torch.ops.rollout import rollout_closed_loop
from trajopt_tpu_torch.solvers import altro as alt
from trajopt_tpu_torch.solvers.ilqr import _fused_eligible, iLQROptions

torch.set_num_threads(1)


def _pendulum(lib, zoo_, device=None, N=31, dt=0.15, u_bnd=3.0):
    """tests/test_altro.py:15-26 for either package."""
    model_d = lib.discretize(zoo_.pendulum, "rk3")
    n, m = 2, 1
    xf = np.array([np.pi, 0.0])
    kw = {} if device is None else {"device": device}
    obj = lib.LQRObjective(np.eye(n) * 1e-3, np.eye(m) * 1e-3,
                           np.eye(n) * 1e-3, xf, N, **kw)
    cons = lib.ConstraintSetBuilder(N)
    cons.add(lib.bound_constraint(n, m, u_min=-u_bnd, u_max=u_bnd))
    cons.add(lib.goal_constraint(xf))
    return lib.problem(model_d, obj, constraints=cons, x0=np.zeros(n), xf=xf,
                       N=N, dt=dt, U0=np.ones((N - 1, m)), **kw)


def _pair(line=False):
    """The reference's min-time pendulum (dt = 0.075, |u| ≤ 5) in both
    packages, seeded with the line trajectory if ``line``."""
    pj = _pendulum(jtt, jzoo, dt=0.075, u_bnd=5.0)
    pt = _pendulum(tt, zoo, "cpu", dt=0.075, u_bnd=5.0)
    if line:
        X0 = line_trajectory(np.zeros(2), [np.pi, 0.0], pt.N)
        pj, pt = jtt.initial_states(pj, X0), tt.initial_states(pt, X0)
    return pj, pt


def _jopts(iterations=50):
    """The reference test's options (tests/test_altro.py:66-68)."""
    return jalt.ALTROOptions(
        opts_al=jtt.ALOptions(iterations=iterations, penalty_scaling=10.0),
        R_minimum_time=15.0, dt_max=0.15, dt_min=1e-3)


def _port_opts(jopts):
    return convert.altro_options_from_dict(convert.options_dict(jopts))


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(1.0, float(np.abs(b).max()))
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * scale


@pytest.fixture(scope="module")
def transformed():
    """The min-time transform of the plain and of the slack-augmented
    pendulum in both packages: [(label, JAX problem, port problem)]."""
    pj, pt = _pair(line=True)
    out = [("plain", jalt.minimum_time_problem(pj, 15.0, 0.15, 1e-3),
            alt.minimum_time_problem(pt, 15.0, 0.15, 1e-3))]
    pji, pti = jalt.infeasible_problem(pj, 1.0), tt.infeasible_problem(pt)
    out.append(("slack", jalt.minimum_time_problem(pji, 15.0, 0.15, 1e-3),
                alt.minimum_time_problem(pti, 15.0, 0.15, 1e-3)))
    return out


# ------------------------------------------------------- objective, row

def test_mintime_objective_matches_jax(transformed):
    """Total and expansion of ``MinTimeObjective`` at random (X, U) at
    1e-12 of scale, a batch of two against the JAX package one by one; the
    closed-form expansion against ``torch.func`` AD of the total."""
    for label, pj, pt in transformed:
        n, m, N = pt.n, pt.m, pt.N
        X, U = _rand((2, N, n), 1), _rand((2, N - 1, m), 2)
        Xt, Ut = torch.tensor(X), torch.tensor(U)
        J = pt.obj.total(Xt, Ut, None)
        e = pt.obj.expansion(Xt, Ut, None)
        for b in range(2):
            _close(J[b], pj.obj.total(jnp.asarray(X[b]), jnp.asarray(U[b]),
                                      None))
            ej = pj.obj.expansion(jnp.asarray(X[b]), jnp.asarray(U[b]), None)
            for k in ("x", "u", "xx", "uu", "ux"):
                _close(getattr(e, k)[b], getattr(ej, k))
        # torch.func: the gradient and Hessian of the total (the stages are
        # independent, the terminal cost acts on X[-1] alone)
        Z = torch.cat([Xt[0].reshape(-1), Ut[0].reshape(-1)])

        def total(z):
            return pt.obj.total(z[:N * n].reshape(N, n),
                                z[N * n:].reshape(N - 1, m), None)

        g = torch.func.grad(total)(Z)
        Hs = torch.func.hessian(total)(Z)
        gx, gu = g[:N * n].reshape(N, n), g[N * n:].reshape(N - 1, m)
        _close(e.x[0], gx)
        _close(e.u[0], gu)
        for k in range(N - 1):
            ix = slice(k * n, (k + 1) * n)
            iu = slice(N * n + k * m, N * n + (k + 1) * m)
            _close(e.xx[0, k], Hs[ix, ix])
            _close(e.uu[0, k], Hs[iu, iu])
            _close(e.ux[0, k], Hs[iu, ix])
        _close(e.xx[0, -1], Hs[(N - 1) * n:N * n, (N - 1) * n:N * n])


def test_mintime_equality_matches_jax():
    """The τ row u[-1] − x[-1] = 0: value, analytic Jacobian and AL terms
    equal to the JAX package's, and no canonical descriptor."""
    cj, ct = jalt.mintime_equality(2, 1), alt.mintime_equality(2, 1)
    assert ct.canon is None and ct.label == cj.label == "min_time_eq"
    assert ct.applies == "stage" and bool(ct.equality.all())
    X, U = _rand((5, 3), 3), _rand((5, 2), 4)
    g, imu = _rand((5, 1), 5), np.abs(_rand((5, 1), 6))
    Xt, Ut = torch.tensor(X), torch.tensor(U)
    _close(ct.fn(Xt, Ut), jax.vmap(cj.fn)(jnp.asarray(X), jnp.asarray(U)), 0)
    cx, cu = ct.jac_fn(Xt, Ut)
    cxj, cuj = jax.vmap(cj.jac_fn)(jnp.asarray(X), jnp.asarray(U))
    _close(cx, cxj, 0)
    _close(cu, cuj, 0)
    tt_ = ct.al_terms(Xt, Ut, torch.tensor(g), torch.tensor(imu))
    tj = cj.al_terms(jnp.asarray(X), jnp.asarray(U), jnp.asarray(g),
                     jnp.asarray(imu))
    assert set(tt_) == set(tj)
    for k in tj:
        _close(tt_[k], tj[k], 0)


# ------------------------------------------------------------- the problem

def test_minimum_time_problem_matches_jax(transformed):
    """Fields of the transformed problem (start, goal, seeds with the NaN
    pattern, dt, tf), its constraint stack (labels, masks, equality rows,
    values and Jacobians at random (X, U)), ALTRO's penalty rows, and the τ
    model's step and Jacobians, for the plain and the slack-augmented
    pendulum; the model keeps its base's CUDA step and slack width and is
    marked ``mintime``."""
    opts = _port_opts(_jopts())
    for label, pj, pt in transformed:
        assert (pt.n, pt.m, pt.N) == (pj.model.n, pj.model.m, pj.N)
        assert pt.model.mintime and pt.model.cuda_step == "pendulum"
        assert pt.model.slack_m == (1 if label == "slack" else None)
        for k in ("x0", "xf", "X", "U"):
            np.testing.assert_allclose(getattr(pt, k).numpy(),
                                       np.asarray(getattr(pj, k)),
                                       atol=1e-15)
        assert pt.dt == pytest.approx(float(pj.dt), abs=1e-15)
        cs, csj = pt.constraints, pj.constraints
        assert cs.labels() == csj.labels()
        np.testing.assert_array_equal(cs.mask.numpy(), np.asarray(csj.mask))
        np.testing.assert_array_equal(cs.is_eq.numpy(),
                                      np.asarray(csj.is_eq))
        X, U = _rand((pt.N, pt.n), 7), _rand((pt.N - 1, pt.m), 8)
        _close(cs.evaluate(torch.tensor(X), torch.tensor(U)),
               csj.evaluate(jnp.asarray(X), jnp.asarray(U)))
        for a, b in zip(cs.jacobian(torch.tensor(X), torch.tensor(U)),
                        csj.jacobian(jnp.asarray(X), jnp.asarray(U))):
            _close(a, b)
        jo = _jopts()
        for a, b in zip(alt._penalty_rows(cs, opts, torch.float64),
                        jalt._penalty_rows(csj, jo, jnp.float64)):
            _close(a, b, 0)
        dt = pt.dt_traj()
        _close(pt.model.step(torch.tensor(X[:-1]), torch.tensor(U), dt[:, None]),
               jax.vmap(pj.model.step)(jnp.asarray(X[:-1]), jnp.asarray(U),
                                       pj.dt_traj()))
        A, Bm = pt.model.jacobian_traj(torch.tensor(X[:-1]), torch.tensor(U),
                                       pt.dt)
        Aj, Bj = jax.vmap(pj.model._jac)(jnp.asarray(X[:-1]), jnp.asarray(U),
                                         pj.dt_traj())
        _close(A, Aj)
        _close(Bm, Bj)


def test_total_time_matches_jax():
    """Σ τ² on a minimum-time problem (tf = 0), dt·(N − 1) otherwise."""
    pj, pt = _pair()
    U = _rand((pt.N - 1, 2), 9)
    for pjx, ptx in ((pj, pt), (jtt.update_problem(pj, tf=0.0),
                                tt.update_problem(pt, tf=0.0))):
        ptm = alt.minimum_time_problem(ptx)
        pjm = jalt.minimum_time_problem(pjx)
        _close(alt.total_time(ptm, torch.tensor(U)),
               jalt.total_time(pjm, jnp.asarray(U)), 1e-14)
        _close(alt.total_time(ptm), jalt.total_time(pjm), 1e-14)


def test_rollout_plain_version_on_mintime_models_matches_jax(transformed):
    """The plain version of K2 (``rollout_closed_loop``) on the ``MinTime``
    model and on ``MinTime`` with slacks, for a batch of four starts with
    random gains, against the JAX package's rollout of the same model one by
    one at 1e-12; a step with |u| past the limit stops a problem in both."""
    for label, pj, pt in transformed:
        n, m, N = pt.n, pt.m, pt.N
        Bz = 4
        x0 = np.concatenate([_rand((Bz, n - 1), 10) * 0.1,
                             np.zeros((Bz, 1))], axis=1)
        X = np.concatenate([np.asarray(pj.X)[None].repeat(Bz, 0)], 0)
        X = np.nan_to_num(X) + _rand((Bz, N, n), 11) * 0.01
        U = np.asarray(pj.U)[None].repeat(Bz, 0) + _rand((Bz, N - 1, m),
                                                          12) * 0.01
        K = _rand((Bz, N - 1, m, n), 13) * 0.05
        d = _rand((Bz, N - 1, m), 14) * 0.05
        alpha = np.array([1.0, 0.5, 0.25, 1.0])
        lim = 1e8 if label == "plain" else 1.0
        Xt, Ut, okt = rollout_closed_loop(
            pt.model, *(torch.tensor(a) for a in (x0, X, U, K, d, alpha)),
            pt.dt, max_control_value=lim)
        for b in range(Bz):
            Xj, Uj, okj = jax_rollout_cl(
                pj.model, *(jnp.asarray(a[b]) for a in (x0, X, U, K, d)),
                float(alpha[b]), pj.dt, max_control_value=lim)
            _close(Xt[b], Xj)
            _close(Ut[b], Uj)
            assert bool(okt[b]) == bool(okj)
        if label == "slack":
            assert not bool(okt.all())


# ------------------------------------------------------------ dispatch

def test_mintime_runs_phase_split_and_chains_have_no_cuda_form():
    """A minimum-time problem is never fused (``fused=True`` runs the
    phase-split path, as in the JAX package): its K2 entry is K2-only. A
    chain's minimum-time model has its K2-only entry too (K2's
    ``MinTime<Chain>``), which the fused kernels refuse; its plain step
    runs."""
    _, pt = _pair()
    pm = alt.minimum_time_problem(pt)
    fused = iLQROptions(fused=True)
    assert not _fused_eligible(pm.model, fused, pm.obj)
    assert not _fused_eligible(pm.model, fused, pt.obj)
    cm = find_cuda_model(pm.model, k2_only_ok=True)
    assert cm.label == "pendulum_mintime" and cm.k2_only
    assert find_cuda_model(pm.model, slack_ok=True) is None
    with pytest.raises(NotImplementedError, match="no lane step"):
        cuda_model(pm.model, "test", slack_ok=True)
    chain = tt.discretize(zoo.MODELS["acrobot_urdf"], "rk3")
    pc = tt.problem(chain, tt.LQRObjective(np.eye(4), np.eye(1), np.eye(4),
                                           np.zeros(4), 5, device="cpu"),
                    N=5, dt=0.01, device="cpu")
    pcm = alt.minimum_time_problem(pc)
    assert pcm.model.mintime and pcm.model.cuda_step == "acrobot_urdf"
    cmc = cuda_model(pcm.model, "test", slack_ok=True, k2_only_ok=True)
    assert cmc.label == "acrobot_urdf_mintime" and cmc.k2_only
    assert (cmc.n, cmc.m) == (pcm.model.n, pcm.model.m) == (5, 2)
    assert pcm.model.chain_table is chain.chain_table
    assert find_cuda_model(pcm.model, slack_ok=True) is None
    with pytest.raises(NotImplementedError, match="no lane step"):
        cuda_model(pcm.model, "test", slack_ok=True)
    x = torch.zeros(3, 5, dtype=torch.float64)
    u = torch.full((3, 2), 0.1, dtype=torch.float64)
    assert pcm.model.step(x, u, 0.01).shape == (3, 5)
    # the constrained solve's fused-AL rule says no too
    res = tt.al_solve(pm, tt.ALOptions(iterations=1, opts_uncon=iLQROptions(
        iterations=2, fused=True)))
    res_split = tt.al_solve(pm, tt.ALOptions(iterations=1, opts_uncon=(
        iLQROptions(iterations=2, fused_al=False))))
    np.testing.assert_array_equal(res.X.numpy(), res_split.X.numpy())


# --------------------------------------------------------------- the solve

def test_altro_solve_mintime_feasible_first_iterations_match_jax():
    """The feasible arm of the minimum-time solve (tests/test_altro.py:64-82
    from its own seed), cut to eight outer iterations in both packages: the
    same outer and inner iteration counts, X within 1e-6, U within 1e-5,
    τ² within 1e-6 (the whole solve is chaotic in float64, ROADMAP Q3-27:
    it runs in the slow lane, ``tests/test_torch_altro.py::
    test_minimum_time_pendulum``, and on the card in ``chip_smoke.py``'s
    phase ``slice7_mintime``). The fixed-time solve's total time is
    0.15·30, as there."""
    pj, pt = _pair()
    jopts = _jopts(iterations=8)
    rj = jalt.altro_solve(pj, jopts, minimum_time=True)
    rt = tt.altro_solve(pt, _port_opts(jopts), minimum_time=True)
    assert int(rt.iterations) == int(rj.iterations)
    assert int(rt.iterations_total) == int(rj.iterations_total)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=1e-6)
    np.testing.assert_allclose(rt.U.numpy(), np.asarray(rj.U), atol=1e-5)
    np.testing.assert_allclose(rt.dt_traj.numpy(), np.asarray(rj.dt_traj),
                               atol=1e-6)
    fixed = tt.altro_solve(_pendulum(tt, zoo, "cpu", dt=0.15, u_bnd=5.0),
                           _port_opts(_jopts()))
    assert float(fixed.tt) == pytest.approx(0.15 * 30)


def test_altro_solve_mintime_line_seeded_first_iterations_match_jax():
    """The infeasible arm of the minimum-time solve from the line seed, cut
    to eight outer iterations in both packages (the re-solve too): the
    same outer and inner iteration counts, X within 1e-6, U within 1e-5
    (the controls sit on their bound of 5, where the packages differ by up
    to 5.2e-6, 1e-6 relative), τ² within 1e-6 (they differ by up to 4e-8,
    5e-7 relative)."""
    pj, pt = _pair(line=True)
    jopts = _jopts(iterations=8)
    rj = jalt.altro_solve(pj, jopts, minimum_time=True)
    rt = tt.altro_solve(pt, _port_opts(jopts), minimum_time=True)
    assert int(rt.iterations) == int(rj.iterations)
    assert int(rt.iterations_total) == int(rj.iterations_total)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=1e-6)
    np.testing.assert_allclose(rt.U.numpy(), np.asarray(rj.U), atol=1e-5)
    np.testing.assert_allclose(rt.dt_traj.numpy(), np.asarray(rj.dt_traj),
                               atol=1e-6)


@pytest.mark.slow
def test_altro_solve_mintime_line_seeded_meets_the_reference_bars():
    """The whole line-seeded minimum-time solve with the reference test's
    options: tt < 0.5·(0.15·30), tt < 1, the goal within 1e-3 in the
    ∞-norm, c_max < 1e-3 on the original constraints; tt within 20% of the
    JAX package's float64 solve, which meets the same bars (ROADMAP
    Q3-27)."""
    pj, pt = _pair(line=True)
    jopts = _jopts()
    rj = jalt.altro_solve(pj, jopts, minimum_time=True)
    rt = tt.altro_solve(pt, _port_opts(jopts), minimum_time=True)
    for r, X in ((rt, rt.X.numpy()), (rj, np.asarray(rj.X))):
        tt_mt = float(r.tt)
        assert tt_mt < 0.5 * (0.15 * 30) and tt_mt < 1.0
        assert np.abs(X[-1] - [np.pi, 0.0]).max() < 1e-3
        assert float(r.c_max) < 1e-3
    assert abs(float(rt.tt) - float(rj.tt)) < 0.2 * float(rj.tt)
    assert rt.dt_traj.shape == (pt.N - 1,)
    np.testing.assert_allclose(float(rt.tt), float(rt.dt_traj.sum()),
                               rtol=1e-14)
