"""The port's constraint layer and infeasible-start transform against the
JAX package, float64 on the CPU.

The stack under test is the full infeasible-start ``quadrotor_maze`` one
(n = 13, m = 17, N = 101, P = 89 rows in five groups): the same numpy inputs
go through ``trajopt_tpu`` and ``trajopt_tpu_torch``, per problem on the JAX
side and with a leading problem dimension on the port's. Tolerance 1e-10
unless a test says otherwise: both sides do the same few float64 operations
per entry, in possibly another order.

``small_maze_jax`` builds the miniature of the maze (N = 21, three
cylinders) that tests/test_torch_al_fused.py and tests/test_torch_maze.py
solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as tt_jax
from trajopt_tpu.models import zoo as jax_models
from trajopt_tpu.ops import constraints as jax_cons
from trajopt_tpu.ops.canonical import canon_evaluate as jax_canon_evaluate
from trajopt_tpu.ops.canonical import canonical_stack as jax_canonical_stack
from trajopt_tpu.problems.zoo import quadrotor_maze as jax_quadrotor_maze
from trajopt_tpu.solvers import al as jax_al
from trajopt_tpu.solvers.altro import ALTROOptions as JaxALTROOptions
from trajopt_tpu.solvers.altro import _penalty_rows as jax_penalty_rows
from trajopt_tpu.solvers.altro import infeasible_problem as jax_infeasible
from trajopt_tpu.utils.interp import interp_rows as jax_interp_rows

import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.models import zoo as torch_models
from trajopt_tpu_torch.ops.canonical import (
    canon_al_cost, canon_al_expansion, canon_evaluate, canonical_stack,
)
from trajopt_tpu_torch.ops.constraints import ConstraintSet, empty_constraints
from trajopt_tpu_torch.problems.zoo import quadrotor_line, quadrotor_maze
from trajopt_tpu_torch.solvers import al
from trajopt_tpu_torch.solvers.altro import (
    ALTROOptions, _penalty_rows, infeasible_problem,
)
from trajopt_tpu_torch.utils.interp import interp_rows

torch.set_num_threads(1)

ATOL = 1e-10
B = 2


def small_maze_jax(N=21, dtype=jnp.float64):
    """A miniature of quadrotor_maze in the JAX package: the quadrotor flies
    4 m in 2 s past three cylinders, with the maze's constraint layout
    (knot-0 control bounds, interior state and control box, obstacle field,
    terminal position/velocity box) and a one-waypoint infeasible seed."""
    model_d = tt_jax.discretize(jax_models.quadrotor, "rk3")
    n, m, tf = 13, 4, 2.0
    x0 = np.zeros(n)
    x0[0:3] = [0.0, 0.0, 10.0]
    x0[3] = 1.0
    xf = np.zeros(n)
    xf[0:3] = [0.0, 4.0, 10.0]
    xf[3] = 1.0
    Q = np.eye(n) * 1e-3
    Q[3:7, 3:7] = np.eye(4) * 1e-2
    obj = tt_jax.LQRObjective(Q, np.eye(m) * 1e-4, np.eye(n) * 1000.0, xf, N)
    x_max = np.full(n, np.inf)
    x_min = np.full(n, -np.inf)
    x_max[0:3] = [3.0, np.inf, 20.0]
    x_min[0:3] = [-3.0, -np.inf, 0.0]
    bnd1 = jax_cons.bound_constraint(n, m, u_min=0.0, u_max=50.0,
                                     label="bnd1")
    bnd2 = jax_cons.bound_constraint(n, m, u_min=0.0, u_max=50.0,
                                     x_min=x_min, x_max=x_max, label="bnd2")
    xf_U, xf_L = xf.copy(), xf.copy()
    xf_U[3:7], xf_L[3:7] = np.inf, -np.inf
    xf_U[7:10], xf_L[7:10] = 0.0, 0.0
    xf_U[10:], xf_L[10:] = np.inf, -np.inf
    bnd_xf = jax_cons.bound_constraint(n, m, x_min=xf_L, x_max=xf_U,
                                       label="bnd_xf")
    maze = jax_cons.obstacle_field_constraint(
        [(0.1, 2.0, 0.5), (-1.5, 1.0, 0.3), (1.6, 3.0, 0.3)], label="maze")
    cons = jax_cons.ConstraintSetBuilder(N)
    cons.add(bnd1, knots=[0])
    cons.add(bnd2, knots=range(1, N - 1))
    cons.add(maze, knots=range(1, N - 1))
    cons.add(bnd_xf, knots=[N - 1])
    prob = tt_jax.problem(model_d, obj, constraints=cons, x0=x0, xf=xf, N=N,
                          tf=tf, U0=np.full((N - 1, m), 0.5 * 9.81 / 4.0),
                          dtype=dtype)
    X_guess = np.zeros((n, 3))
    X_guess[:, 0], X_guess[:, 2] = x0, xf
    X_guess[0:3, 1] = [0.9, 2.0, 10.0]
    X_guess[3, :] = 1.0
    return tt_jax.initial_states(prob, jax_interp_rows(N, tf, X_guess))


@pytest.fixture(scope="module")
def maze():
    """(JAX infeasible maze problem, the port's, random X, U, λ, μ)."""
    pj = jax_infeasible(jax_quadrotor_maze(dtype=jnp.float64), 1e-8)
    pt = infeasible_problem(quadrotor_maze(device="cpu"), 1e-8)
    rng = np.random.default_rng(0)
    N, P = pj.N, pj.constraints.P
    mask = np.asarray(pj.constraints.mask)
    return dict(
        pj=pj, pt=pt, X=rng.normal(size=(B, N, 13)) * 4,
        U=rng.normal(size=(B, N - 1, 17)) * 2,
        lam=rng.uniform(-0.2, 0.5, size=(B, N, P)) * mask,
        mu=rng.uniform(0.5, 20.0, size=(B, N, P)) * mask)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(mine, ref, atol=ATOL, rtol=0.0):
    ref = np.asarray(ref)
    assert tuple(mine.shape) == ref.shape
    np.testing.assert_allclose(mine.numpy(), ref, rtol=rtol, atol=atol)


def test_interp_rows_is_the_jax_packages():
    way = np.random.default_rng(1).normal(size=(5, 4))
    assert np.array_equal(interp_rows(17, 3.0, way),
                          jax_interp_rows(17, 3.0, way))


def test_quadrotor_maze_matches_jax():
    """Seeds, boundary states, objective, and the stack's layout."""
    pj = jax_quadrotor_maze(dtype=jnp.float64)
    pt = quadrotor_maze(device="cpu")
    for name in ("x0", "xf", "X", "U"):
        assert np.array_equal(getattr(pt, name).numpy(),
                              np.asarray(getattr(pj, name))), name
    for name in convert.OBJECTIVE_FIELDS:
        _close(getattr(pt.obj, name), getattr(pj.obj, name), atol=1e-15)
    assert (pt.N, pt.dt, pt.tf) == (pj.N, float(pj.dt), float(pj.tf))
    cj, ct = pj.constraints, pt.constraints
    assert ct.P == cj.P == 76 and ct.slices == cj.slices
    assert ct.labels() == cj.labels()
    assert np.array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    assert np.array_equal(ct.is_eq.numpy(), np.asarray(cj.is_eq))


def test_infeasible_problem_matches_jax(maze):
    """Objective blocks, slack seed, P, mask, slices of the transform, and
    ALTRO's per-row penalty schedules."""
    pj, pt = maze["pj"], maze["pt"]
    assert (pt.model.n, pt.model.m, pt.model.slack_m) == (13, 17, 4)
    for name in convert.OBJECTIVE_FIELDS:
        _close(getattr(pt.obj, name), getattr(pj.obj, name), atol=1e-15)
    assert np.array_equal(pt.X.numpy(), np.asarray(pj.X))
    _close(pt.U, pj.U, atol=1e-13)          # slack seed: the step's defects
    cj, ct = pj.constraints, pt.constraints
    assert ct.P == cj.P == 89 and ct.slices == cj.slices
    assert ct.row_slice("infeasible") == cj.row_slice("infeasible") == (76, 89)
    assert np.array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    assert np.array_equal(ct.is_eq.numpy(), np.asarray(cj.is_eq))
    assert ct.mask.sum(1)[[0, 1, 100]].tolist() == [21, 69, 12]
    kw = dict(R_inf=1e-8, penalty_initial_infeasible=3.0,
              penalty_scaling_infeasible=7.0)
    ref = jax_penalty_rows(cj, JaxALTROOptions(**kw), jnp.float64)
    got = _penalty_rows(ct, ALTROOptions(**kw), torch.float64)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


def test_infeasible_model_step_and_jacobians_match_jax(maze):
    pj, pt = maze["pj"], maze["pt"]
    X, U = maze["X"][0, :-1] * 0.1, maze["U"][0]
    X[:, 3] += 1.0
    dt = np.full(X.shape[0], float(pj.dt))
    Aj, Bj = pj.model.jacobian_traj(jnp.asarray(X), jnp.asarray(U),
                                    jnp.asarray(dt))
    A, Bm = pt.model.jacobian_traj(_t(X), _t(U), pt.dt_traj())
    _close(A, Aj)
    _close(Bm, Bj)
    xn = jax.vmap(pj.model.step)(jnp.asarray(X), jnp.asarray(U),
                                 jnp.asarray(dt))
    _close(pt.model.step(_t(X), _t(U), pt.dt_traj()[:, None]), xn)


@pytest.mark.parametrize("carried", [False, True],
                         ids=["zoo", "carried-by-convert"])
def test_constraint_set_matches_jax(maze, carried):
    """evaluate, jacobian, active_set, violation, max_violation and
    al_expansion_terms on the P = 89 stack, for the stack built by the
    port's zoo and for the JAX one carried across as data."""
    pj = maze["pj"]
    cj = pj.constraints
    ct = maze["pt"].constraints
    if carried:
        ct = convert.constraints_from_arrays(convert.constraint_arrays(cj),
                                             pj.N, device="cpu")
        assert np.array_equal(ct.mask.numpy(), np.asarray(cj.mask))
        assert ct.slices == cj.slices and ct.labels() == cj.labels()
    X, U, lam, mu = (maze[k] for k in ("X", "U", "lam", "mu"))
    C = ct.evaluate(_t(X), _t(U))
    cx, cu = ct.jacobian(_t(X), _t(U))
    act = ct.active_set(C, _t(lam), 1e-3)
    Imu = torch.where(act, _t(mu), torch.zeros(()).double())
    g = Imu * C + _t(lam)
    terms = ct.al_expansion_terms(_t(X), _t(U), g, Imu)
    for b in range(B):
        Xb, Ub = jnp.asarray(X[b]), jnp.asarray(U[b])
        Cj = cj.evaluate(Xb, Ub)
        _close(C[b], Cj)
        cxj, cuj = cj.jacobian(Xb, Ub)
        _close(cx[b], cxj)
        _close(cu[b], cuj)
        actj = cj.active_set(Cj, jnp.asarray(lam[b]), 1e-3)
        assert np.array_equal(act[b].numpy(), np.asarray(actj))
        _close(ct.violation(C)[b], cj.violation(Cj))
        _close(ct.max_violation(C)[b], cj.max_violation(Cj))
        Imuj = jnp.where(actj, jnp.asarray(mu[b]), 0.0)
        gj = Imuj * Cj + jnp.asarray(lam[b])
        for mine, ref in zip(terms, cj.al_expansion_terms(Xb, Ub, gj, Imuj)):
            _close(mine[b], ref, rtol=1e-12)    # entries up to ~1e7


def test_structured_al_terms_match_dense_products(maze):
    """The ``al_terms`` hooks against the dense Gauss-Newton products of the
    stacked Jacobians (tests/test_al_structured.py in the JAX package)."""
    ct = maze["pt"].constraints
    X, U, lam, mu = (_t(maze[k]) for k in ("X", "U", "lam", "mu"))
    C = ct.evaluate(X, U)
    Imu = torch.where(ct.active_set(C, lam), mu, torch.zeros(()).double())
    g = Imu * C + lam
    hooks = ct.al_expansion_terms(X, U, g, Imu)
    cx, cu = ct.jacobian(X, U)
    dense = (torch.einsum("...pi,...p->...i", cx, g),
             torch.einsum("...pi,...p->...i", cu, g),
             torch.einsum("...pi,...p,...pj->...ij", cx, Imu, cx),
             torch.einsum("...pi,...p,...pj->...ij", cu, Imu, cu),
             torch.einsum("...pi,...p,...pj->...ij", cu, Imu, cx))
    for h, d in zip(hooks, dense):
        torch.testing.assert_close(h, d, rtol=1e-12, atol=1e-9)


def test_dual_and_penalty_update_match_jax(maze):
    cj, ct = maze["pj"].constraints, maze["pt"].constraints
    X, U, lam, mu = (maze[k] for k in ("X", "U", "lam", "mu"))
    kw = dict(dual_max=30.0, dual_min=-25.0, penalty_max=150.0)
    oj, ot = jax_al.ALOptions(**kw), tt.ALOptions(**kw)
    P = cj.P
    scaling = np.linspace(2.0, 25.0, P)
    C = ct.evaluate(_t(X), _t(U))
    lam_new = al.dual_update(ct, C, _t(lam), _t(mu), ot)
    mu_new = al.penalty_update(ct, _t(mu), _t(scaling), ot)
    for b in range(B):
        Cj = cj.evaluate(jnp.asarray(X[b]), jnp.asarray(U[b]))
        _close(lam_new[b], jax_al.dual_update(cj, Cj, jnp.asarray(lam[b]),
                                              jnp.asarray(mu[b]), oj))
        _close(mu_new[b], jax_al.penalty_update(
            cj, jnp.asarray(mu[b]), jnp.asarray(scaling)[None, :], oj))


def test_canonical_stack_matches_evaluate_and_jax(maze):
    """canon_evaluate against ConstraintSet.evaluate (as
    tests/test_fused_al.py:86-105) and against the JAX canonical stack; the
    canonical AL cost and expansion against the closures of al_cost_fns."""
    pj, pt = maze["pj"], maze["pt"]
    ct = pt.constraints
    X, U, lam, mu = (_t(maze[k]) for k in ("X", "U", "lam", "mu"))
    lam = lam.clamp(min=0.0) * ~ct.is_eq + lam * ct.is_eq
    stack = canonical_stack(ct, 13, 17, dtype=torch.float64)
    assert stack is not None and stack.P == ct.P == 89
    assert [e[:3] for e in stack.spec] == [
        e[:3] for e in jax_canonical_stack(pj.constraints, 13, 17,
                                           dtype=jnp.float64).spec]
    U_pad = torch.cat([U, torch.zeros_like(U[:, :1])], dim=1)
    C_can = canon_evaluate(stack, X, U_pad)
    _close(torch.where(ct.mask, C_can, torch.zeros(()).double()),
           ct.evaluate(X, U))
    sj = jax_canonical_stack(pj.constraints, 13, 17, dtype=jnp.float64)
    _close(C_can[0], jax_canon_evaluate(sj, 13, 17, jnp.asarray(X[0].numpy()),
                                        jnp.asarray(U_pad[0].numpy())))

    cost_fn, expansion_fn = al.al_cost_fns(pt.obj, ct, pt.dt_traj(), lam, mu,
                                           1e-3)
    J_al = cost_fn(X, U) - pt.obj.total(X, U, pt.dt_traj())
    torch.testing.assert_close(canon_al_cost(stack, X, U_pad, lam, mu, 1e-3),
                               J_al, rtol=1e-9, atol=1e-6)
    e, e0 = expansion_fn(X, U), pt.obj.expansion(X, U, pt.dt_traj())
    tx, tu, txx, tuu = canon_al_expansion(stack, X, U_pad, lam, mu, 1e-3)
    for mine, ref in ((tx, e.x - e0.x), (tu[:, :-1], e.u - e0.u),
                      (txx, e.xx - e0.xx), (tuu[:, :-1], e.uu - e0.uu)):
        torch.testing.assert_close(mine, ref, rtol=1e-9, atol=1e-7)
    assert float((e.ux - e0.ux).abs().max()) == 0.0


def test_canonical_tables_describe_the_stack(maze):
    """The kernels' flat tables: row kinds, z-columns, the sphere group and
    the linear rows by column."""
    ct = maze["pt"].constraints
    st = canonical_stack(ct, 13, 17, dtype=torch.float32)
    kinds = st.row_i[:, 0].tolist()
    r0, r1 = ct.row_slice("maze")
    assert kinds == [0] * r0 + [1] * (r1 - r0) + [0] * (89 - r1)
    assert st.groups.tolist() == [[r0, r1, 2, 0, 1, -1]]
    s0, s1 = ct.row_slice("infeasible")
    assert st.row_i[s0:s1, 1].tolist() == list(range(17, 30))
    assert st.row_f[s0:s1, 2].tolist() == [1.0] * 13          # equality rows
    ptr, rows = st.col_ptr.tolist(), st.col_rows.tolist()
    assert len(ptr) == 31 and ptr[-1] == len(rows) == 89 - (r1 - r0)
    for col in range(30):
        for r in rows[ptr[col]:ptr[col + 1]]:
            assert st.row_i[r, 1] == col and st.row_i[r, 0] == 0


def test_problem_arrays_carry_constraints_and_state(maze):
    pj = jax_quadrotor_maze(dtype=jnp.float64)
    carried = convert.problem_from_arrays(**convert.problem_arrays(pj),
                                          device="cpu")
    mine = quadrotor_maze(device="cpu")
    assert np.array_equal(carried.constraints.mask.numpy(),
                          mine.constraints.mask.numpy())
    X, U = _t(maze["X"]), _t(maze["U"][..., :4])
    torch.testing.assert_close(carried.constraints.evaluate(X, U),
                               mine.constraints.evaluate(X, U), rtol=0,
                               atol=ATOL)
    state = convert.state_arrays(X=X, U=U, lam=_t(maze["lam"]), other=1)
    assert sorted(state) == ["U", "X", "lam"]
    back = convert.state_from_arrays(device="cpu", **state)
    assert torch.equal(back["X"], X) and back["lam"].dtype == torch.float64


@pytest.mark.parametrize("build", [
    lambda **kw: quadrotor_maze(**kw),
    lambda **kw: quadrotor_line(N=11, **kw),
    lambda **kw: tt.LQRObjective(np.eye(2), np.eye(1), np.eye(2),
                                 np.zeros(2), 5, **kw),
    lambda **kw: tt.problem(
        tt.discretize(torch_models.quadrotor, "rk3"),
        tt.LQRObjective(np.eye(13), np.eye(4), np.eye(13), np.zeros(13), 5,
                        device="cpu"), N=5, dt=0.1, **kw),
    lambda **kw: empty_constraints(5, **kw),
    lambda **kw: ConstraintSet.build([], 5, **kw),
    lambda **kw: convert.problem_from_arrays(
        **convert.problem_arrays(jax_quadrotor_maze(dtype=jnp.float64)),
        **kw),
], ids=["quadrotor_maze", "quadrotor_line", "LQRObjective", "problem",
        "empty_constraints", "ConstraintSet.build", "problem_from_arrays"])
def test_constructors_build_on_the_card_by_default(build):
    """With no device given everything lands on the current CUDA device;
    without one that raises, and nothing moves to the CPU quietly."""
    if torch.cuda.is_available():
        out = build()
        dev = out.mask.device if isinstance(out, ConstraintSet) else \
            (out.Q.device if hasattr(out, "Q") else out.device)
        assert dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    build(device="cpu")
