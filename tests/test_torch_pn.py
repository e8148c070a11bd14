"""The projected-Newton polish of the port against the JAX package, on the
CPU in float64.

``solvers/projected_newton.py`` is plain tensor code with a leading problem
dimension (the JAX package has no Pallas kernel on this path either): the
block-tridiagonal Cholesky, solve and product against the JAX functions and
a dense solve at 1e-10; ``pn_solve`` on perturbed pendulum solutions
(feasibility ≤ 1e-8 on both sides, the same iteration count, X and U within
1e-6: the two follow the same Newton iterates, and 1e-6 leaves room for the
25 refinement sweeps' rounding); the batched ``pn_polish_batch`` against
``vmap``; the ``'optimal'`` KKT steps; and what the port does differently by
design: NaN factors from a block that is not positive definite, and the
equilibration scale floored relative to the largest diagonal entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.parallel.batch import pn_polish_batch as jax_pn_polish_batch
from trajopt_tpu.parallel.batch import solve_batch as jax_solve_batch
from trajopt_tpu.solvers import projected_newton as jpn

import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.solvers import projected_newton as pn

torch.set_num_threads(1)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _random_block_tridiag(Nb, q, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=batch + (Nb, q, q))
    D = A @ np.swapaxes(A, -1, -2) + q * np.eye(q)
    L = rng.normal(size=batch + (Nb - 1, q, q)) * 0.1
    return D, L


def _dense(D, L):
    Nb, q, _ = D.shape
    S = np.zeros((Nb * q, Nb * q))
    for k in range(Nb):
        S[k * q:(k + 1) * q, k * q:(k + 1) * q] = D[k]
        if k < Nb - 1:
            S[(k + 1) * q:(k + 2) * q, k * q:(k + 1) * q] = L[k]
            S[k * q:(k + 1) * q, (k + 1) * q:(k + 2) * q] = L[k].T
    return S


# --------------------------------------------- block-tridiagonal functions

def test_block_tridiag_matches_jax_and_dense():
    """Factors, solution and product of one 7-block system (q = 5) against
    the JAX functions and a dense solve, all at 1e-10."""
    D, L = _random_block_tridiag(7, 5)
    b = np.random.default_rng(1).normal(size=(7, 5))
    Gj, Mj = jpn.block_tridiag_cholesky(jnp.asarray(D), jnp.asarray(L))
    xj = jpn.block_tridiag_solve(Gj, Mj, jnp.asarray(b))
    G, M = pn.block_tridiag_cholesky(_t(D), _t(L))
    x = pn.block_tridiag_solve(G, M, _t(b))
    np.testing.assert_allclose(G.numpy(), np.asarray(Gj), atol=1e-10)
    np.testing.assert_allclose(M.numpy(), np.asarray(Mj), atol=1e-10)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-10)
    x_dense = np.linalg.solve(_dense(D, L), b.ravel())
    np.testing.assert_allclose(x.numpy().ravel(), x_dense, atol=1e-10)
    y = pn.block_tridiag_matvec(_t(D), _t(L), x)
    yj = jpn.block_tridiag_matvec(jnp.asarray(D), jnp.asarray(L), xj)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-10)
    np.testing.assert_allclose(y.numpy(), b, atol=1e-9)


def test_block_tridiag_batched_matches_vmap():
    """With a leading problem dimension (B = 3) the functions equal ``vmap``
    of the JAX ones at 1e-10."""
    D, L = _random_block_tridiag(6, 4, seed=2, batch=(3,))
    b = np.random.default_rng(3).normal(size=(3, 6, 4))
    Gj, Mj = jax.vmap(jpn.block_tridiag_cholesky)(jnp.asarray(D),
                                                  jnp.asarray(L))
    xj = jax.vmap(jpn.block_tridiag_solve)(Gj, Mj, jnp.asarray(b))
    G, M = pn.block_tridiag_cholesky(_t(D), _t(L))
    assert G.shape == (3, 6, 4, 4) and M.shape == (3, 5, 4, 4)
    x = pn.block_tridiag_solve(G, M, _t(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=1e-10)
    yj = jax.vmap(jpn.block_tridiag_matvec)(jnp.asarray(D), jnp.asarray(L), xj)
    np.testing.assert_allclose(
        pn.block_tridiag_matvec(_t(D), _t(L), x).numpy(), np.asarray(yj),
        atol=1e-10)


def test_block_that_is_not_positive_definite_gives_nan_factors():
    """``torch.linalg.cholesky`` raises where ``jnp.linalg.cholesky`` returns
    NaN; the port keeps the JAX semantics: NaN from the failing block on, in
    that problem only."""
    D, L = _random_block_tridiag(4, 3, seed=4, batch=(2,))
    D[1, 2] = -np.eye(3)
    Gj, _ = jax.vmap(jpn.block_tridiag_cholesky)(jnp.asarray(D),
                                                 jnp.asarray(L))
    G, _ = pn.block_tridiag_cholesky(_t(D), _t(L))
    low = np.tril(np.ones((3, 3), bool))
    assert np.isnan(np.asarray(Gj)[1, 2][low]).all()
    assert bool(torch.isnan(G[1, 2:][:, low]).all())
    assert bool(torch.isfinite(G[0]).all()) and bool(
        torch.isfinite(G[1, :2]).all())


def test_pack_unpack_primals_match_jax():
    rng = np.random.default_rng(5)
    X, U = rng.normal(size=(6, 3)), rng.normal(size=(5, 2))
    Z = pn.pack_primals(_t(X), _t(U))
    np.testing.assert_array_equal(
        Z.numpy(), np.asarray(jpn.pack_primals(jnp.asarray(X),
                                               jnp.asarray(U))))
    X2, U2 = pn.unpack_primals(Z, 3, 2, 6)
    np.testing.assert_array_equal(X2.numpy(), X)
    np.testing.assert_array_equal(U2.numpy(), U)


# ---------------------------------------------------- equilibration (R3)

def test_equilibration_scale_is_floored_relative_to_the_diagonal():
    """The JAX package floors diag(S) at an absolute 1e-30 before the
    reciprocal square root: 1e15 in float32, whose products with a block of
    ordinary size overflow. The port floors at ε·max(diag): on an ordinary
    diagonal the scale is exactly 1/sqrt(diag) (so float64 results equal the
    JAX package's), and a zero entry gives a finite scale whose products
    s·D·s stay finite in float32."""
    D, _ = _random_block_tridiag(3, 4, seed=6, batch=(2,))
    s = pn._equilibration_scale(_t(D))
    dg = np.diagonal(D, axis1=-2, axis2=-1)
    np.testing.assert_allclose(s.numpy(), 1.0 / np.sqrt(dg), rtol=1e-14)

    D32 = _t(D, torch.float32) * 1e6
    D32[0, 1, 2, :] = 0.0
    D32[0, 1, :, 2] = 0.0
    s32 = pn._equilibration_scale(D32)
    eps = torch.finfo(torch.float32).eps
    top = float(torch.diagonal(D32[0], dim1=-2, dim2=-1).max())
    assert bool(torch.isfinite(s32).all())
    assert float(s32[0, 1, 2]) == pytest.approx((eps * top) ** -0.5, rel=1e-5)
    scaled = D32 * s32[..., :, None] * s32[..., None, :]
    assert bool(torch.isfinite(scaled).all())
    # the other problem keeps its own, unfloored scale
    np.testing.assert_allclose(
        s32[1].numpy(), 1.0 / np.sqrt(dg[1] * 1e6), rtol=1e-5)
    # what the absolute floor does to the same entry
    assert not np.isfinite(np.float32(1e15) * np.float32(1e15)
                           * np.float32(1e9))


# ------------------------------------------------------------- pn_solve

def _pendulum_jax(N=31, ulim=3.0):
    model_d = jtt.discretize(jzoo.pendulum, "rk3")
    n, m = 2, 1
    xf = np.array([np.pi, 0.0])
    obj = jtt.LQRObjective(np.eye(n) * 1e-3, np.eye(m) * 1e-3,
                           np.eye(n) * 1e-3, xf, N)
    cons = jtt.ConstraintSetBuilder(N)
    cons.add(jtt.bound_constraint(n, m, u_min=-ulim, u_max=ulim))
    cons.add(jtt.goal_constraint(xf))
    return jtt.problem(model_d, obj, constraints=cons, x0=np.zeros(n), xf=xf,
                       N=N, dt=0.15, U0=np.ones((N - 1, m)))


@pytest.fixture(scope="module")
def solved():
    """The pendulum swing-up solved by the JAX package's AL solver: the
    trajectory both polishes start from."""
    pj = _pendulum_jax()
    res = jtt.al_solve(pj, jtt.ALOptions())
    assert float(res.c_max) < 1e-3
    pt = convert.problem_from_arrays(**convert.problem_arrays(pj),
                                     device="cpu")
    return pj, pt, np.asarray(res.X), np.asarray(res.U)


def _both(pj, pt, X, U, jopts, opts):
    rj = jpn.pn_solve(jtt.update_problem(pj, X=jnp.asarray(X),
                                         U=jnp.asarray(U)), jopts)
    rt = pn.pn_solve(tt.update_problem(pt, X=_t(X), U=_t(U)), opts)
    return rj, rt


def _assert_same_polish(rj, rt, viol_tol=1e-8, x_tol=1e-6):
    assert float(rj.viol) <= viol_tol and float(rt.viol) <= viol_tol
    assert float(rt.c_max) <= viol_tol
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=x_tol)
    np.testing.assert_allclose(rt.U.numpy(), np.asarray(rj.U), atol=x_tol)
    np.testing.assert_allclose(float(rt.J), float(rj.J), rtol=1e-8)


def test_pn_solve_matches_jax_on_a_perturbed_solution(solved):
    """States perturbed by 1e-3 (dynamics violated at that scale): both
    polishes reach ≤ 1e-8 in the same number of projection iterations and
    agree on X and U within 1e-6."""
    pj, pt, X, U = solved
    Xp = X + np.random.default_rng(3).normal(size=X.shape) * 1e-3
    Xp[0] = X[0]
    rj, rt = _both(pj, pt, Xp, U,
                   jpn.PNOptions(feasibility_tolerance=1e-8),
                   tt.PNOptions(feasibility_tolerance=1e-8))
    _assert_same_polish(rj, rt)
    d = pn._dynamics_defects(pt, pt.x0, rt.X, rt.U)
    assert float(d.abs().max()) < 1e-8


def test_pn_solve_matches_jax_across_an_active_set_flip(solved):
    """Three interior controls pushed past the bound (rows violated at the
    seed, tests/test_pn.py::test_pn_active_set_flip): same polish, and the
    rows come back inside."""
    pj, pt, X, U = solved
    inside = np.where(np.abs(U[:, 0]) < 2.0)[0]
    Up = U.copy()
    Up[inside[:3]] = 3.4
    rj, rt = _both(pj, pt, X, Up,
                   jpn.PNOptions(feasibility_tolerance=1e-8),
                   tt.PNOptions(feasibility_tolerance=1e-8))
    _assert_same_polish(rj, rt)
    assert bool((rt.U[inside[:3], 0] <= 3.0 + 1e-8).all())


def test_pn_solve_without_equilibration_matches_jax(solved):
    pj, pt, X, U = solved
    Xp = X + np.random.default_rng(7).normal(size=X.shape) * 1e-3
    Xp[0] = X[0]
    rj, rt = _both(
        pj, pt, Xp, U,
        jpn.PNOptions(feasibility_tolerance=1e-8, equilibrate=False),
        tt.PNOptions(feasibility_tolerance=1e-8, equilibrate=False))
    _assert_same_polish(rj, rt)


def test_pn_solve_optimal_matches_jax(solved):
    """``solve_type='optimal'``: one KKT Newton step with its re-projecting
    line search on top of the projection; same iterate within 1e-6."""
    pj, pt, X, U = solved
    Xp = X + np.random.default_rng(8).normal(size=X.shape) * 1e-3
    Xp[0] = X[0]
    kw = dict(feasibility_tolerance=1e-8, solve_type="optimal", n_steps=1)
    rj, rt = _both(pj, pt, Xp, U, jpn.PNOptions(**kw), tt.PNOptions(**kw))
    assert int(rt.iterations) == int(rj.iterations)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=1e-6)
    np.testing.assert_allclose(rt.U.numpy(), np.asarray(rj.U), atol=1e-6)
    np.testing.assert_allclose(float(rt.viol), float(rj.viol), atol=1e-9)


def test_pn_solve_float32_reduces_the_violation(solved):
    """float32 runs too (the card's polish of a float32 AL result starts
    there): the violation falls by two orders and nothing turns NaN; the
    float64 bar is not asked of it."""
    pj, pt, X, U = solved
    Xp = X + np.random.default_rng(3).normal(size=X.shape) * 1e-3
    Xp[0] = X[0]
    p32 = convert.problem_from_arrays(**convert.problem_arrays(pj),
                                      dtype=torch.float32, device="cpu")
    p32 = tt.update_problem(p32, X=_t(Xp, torch.float32),
                            U=_t(U, torch.float32))
    r = pn.pn_solve(p32, tt.PNOptions())
    assert r.X.dtype == torch.float32 and bool(torch.isfinite(r.X).all())
    assert float(r.viol) < 1e-5


def test_a_projection_that_meets_nan_returns_its_entry_state(solved):
    """A ridge of −1e6 makes every Schur block indefinite: the factors are
    NaN, the line search leaves at once, and the entry state comes back
    unchanged (the JAX package does the same)."""
    pj, pt, X, U = solved
    Xp = X + np.random.default_rng(3).normal(size=X.shape) * 1e-3
    Xp[0] = X[0]
    kw = dict(ridge=-1e6, equilibrate=False, max_projection_iters=2)
    rj, rt = _both(pj, pt, Xp, U, jpn.PNOptions(**kw), tt.PNOptions(**kw))
    np.testing.assert_array_equal(rt.X.numpy(), Xp)
    np.testing.assert_array_equal(np.asarray(rj.X), Xp)
    assert int(rt.iterations) == int(rj.iterations) == 2


# ------------------------------------------------------ pn_polish_batch

def test_pn_polish_batch_matches_jax_vmap():
    """A pool of six dispersed pendulum solves (the JAX package's
    ``solve_batch``) polished by both ``pn_polish_batch``: every problem
    ≤ 1e-8 on both sides, the same iteration counts (the problems need
    different numbers of iterations, so the per-problem masks are
    exercised), X and U within 1e-6."""
    pj = _pendulum_jax()
    Bz = 6
    x0s = np.random.default_rng(0).normal(size=(Bz, 2)) * 0.05
    res = jax_solve_batch(pj, jtt.ALOptions(), jnp.asarray(x0s))
    Xs, Us = np.array(res.X), np.array(res.U)
    # one problem starts far from feasible, one already feasible to 1e-8
    Xs[1, 1:] += np.random.default_rng(1).normal(size=Xs[1, 1:].shape) * 1e-2
    jopts = jpn.PNOptions(feasibility_tolerance=1e-8)
    rj = jax_pn_polish_batch(pj, jnp.asarray(Xs), jnp.asarray(Us), jopts)
    pt = convert.problem_from_arrays(**convert.problem_arrays(pj),
                                     device="cpu")
    rt = tt.pn_polish_batch(pt, _t(Xs), _t(Us),
                            tt.PNOptions(feasibility_tolerance=1e-8))
    assert rt.X.shape == Xs.shape and rt.viol.shape == (Bz,)
    assert float(rt.viol.max()) <= 1e-8 and float(np.asarray(rj.viol).max()) \
        <= 1e-8
    assert rt.iterations.tolist() == np.asarray(rj.iterations).tolist()
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=1e-6)
    np.testing.assert_allclose(rt.U.numpy(), np.asarray(rj.U), atol=1e-6)
    np.testing.assert_allclose(rt.c_max.numpy(), np.asarray(rj.c_max),
                               atol=1e-9)
    # each problem's start is its own trajectory's first knot
    np.testing.assert_allclose(rt.X[:, 0].numpy(), Xs[:, 0], atol=1e-9)
