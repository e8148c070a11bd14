"""The port's default path against the JAX package, end to end, on the CPU.

``al_solve`` and ``solve_batch`` with the default options
(``iLQROptions()``: scan backward pass, full state) run in both packages in float64 on the same problems, carried
over as numpy arrays by ``trajopt_tpu_torch.convert``. The port reaches its
kernels' plain versions here; the CUDA kernels are checked on the card by
``chip_smoke.py``.

Pool seeds: a solve whose last step changes J by ~1e-12 can converge or run
two more iterations on rounding alone (ROADMAP Queue 3, Q3-1; the JAX package
disagrees with itself there). The seeds below were checked to sit away from
that edge: with seeds 0, 1 and 2 every count agrees and X is within 3e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as tt_jax
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.parallel.batch import solve_batch as jax_solve_batch
from trajopt_tpu.problems import zoo as jproblems

import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.parallel.batch import solve_batch

torch.set_num_threads(1)

POOL, POOL_SEED, NOISE = 4, 1, 0.02
HISTORY = ("cost", "c_max", "penalty_max", "gradient", "iterations_inner",
           "iterations")


def _carry(pj):
    return convert.problem_from_arrays(**convert.problem_arrays(pj),
                                       device="cpu")


def _pool(x0):
    rng = np.random.default_rng(POOL_SEED)
    x0 = np.asarray(x0)
    return x0[None] + rng.normal(size=(POOL, x0.shape[0])) * NOISE


def _assert_same_solves(ref, res, x_tol=1e-6, c_tol=1e-8):
    """Outer and inner iteration counts equal, X within ``x_tol``, c_max
    within ``c_tol``, and the per-outer-iteration history equal."""
    a, b = convert.result_arrays(ref), convert.result_arrays(res)
    assert sorted(a) == sorted(b)
    assert np.array_equal(a["iterations"], b["iterations"])
    assert np.array_equal(a["iterations_total"], b["iterations_total"])
    for k in HISTORY[-2:]:
        assert np.array_equal(a[f"history_{k}"], b[f"history_{k}"]), k
    assert np.abs(a["X"] - b["X"]).max() < x_tol
    assert np.abs(a["U"] - b["U"]).max() < 1e-5
    assert np.abs(a["c_max"] - b["c_max"]).max() < c_tol
    for k in ("J", "lam", "mu", "C", "history_cost", "history_c_max",
              "history_penalty_max"):
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_solve_batch_pendulum_matches_jax():
    """The canonical drive (pendulum swing-up with a control box and a goal
    constraint), four perturbed starts in one call: every solve reaches
    c_max < 1e-3 and the goal within 2e-3, and agrees with the JAX
    ``solve_batch``."""
    pj = jproblems.pendulum(dtype=jnp.float64)
    x0s = _pool(pj.x0)
    ref = jax_solve_batch(pj, tt_jax.ALOptions(), jnp.asarray(x0s))
    prob = _carry(pj)
    syncs = tt.solvers.ilqr.HostSyncs()
    res = solve_batch(prob, tt.ALOptions(), torch.as_tensor(x0s), syncs=syncs)
    assert res.X.shape == (POOL, prob.N, 2) and res.lam.shape == (POOL, 31, 4)
    assert float(res.c_max.max()) < 1e-3
    assert float((res.X[:, -1] - prob.xf).norm(dim=-1).max()) < 2e-3
    assert len(set(res.iterations_total.tolist())) > 1   # each its own count
    assert syncs.count > int(res.iterations.max())
    _assert_same_solves(ref, res)


def test_solve_batch_cartpole_matches_jax():
    """The cartpole swing-up with its horizon cut to N = 21 at the zoo
    problem's dt = 0.05, built by the JAX package and carried over through
    the arrays: P = 2 bound rows + 4 goal rows. One second is too short to
    swing up inside the control box, so both packages use all 30 outer
    iterations, with penalties up to 1e8, and must still agree."""
    N = 21
    jm = tt_jax.discretize(jzoo.cartpole, "rk3")
    xf = np.array([0.0, np.pi, 0.0, 0.0])
    obj = tt_jax.LQRObjective(np.eye(4) * 1e-2, np.eye(1) * 1e-1,
                              np.eye(4) * 100.0, xf, N)
    cons = tt_jax.ConstraintSetBuilder(N)
    cons.add(tt_jax.bound_constraint(4, 1, u_min=-3.0, u_max=3.0))
    cons.add(tt_jax.goal_constraint(xf))
    pj = tt_jax.problem(jm, obj, constraints=cons, x0=np.zeros(4), xf=xf, N=N,
                        dt=0.05, U0=np.full((N - 1, 1), 0.01))
    x0s = _pool(pj.x0)
    ref = jax_solve_batch(pj, tt_jax.ALOptions(), jnp.asarray(x0s))
    prob = _carry(pj)
    assert prob.constraints.P == 6 and prob.N == N
    res = solve_batch(prob, tt.ALOptions(), torch.as_tensor(x0s))
    assert res.iterations.tolist() == [30] * POOL
    _assert_same_solves(ref, res)


@pytest.mark.parametrize("name", ["doubleintegrator", "parallel_park"])
def test_al_solve_matches_jax(name):
    """One problem through ``al_solve``: the result has no leading problem
    dimension, as the JAX ``ALResult``, and every field agrees."""
    pj = getattr(jproblems, name)(dtype=jnp.float64)
    ref = tt_jax.al_solve(pj, tt_jax.ALOptions())
    prob = _carry(pj)
    res = tt.al_solve(prob, tt.ALOptions())
    assert res.X.shape == (prob.N, prob.n) and res.c_max.ndim == 0
    assert res.history["cost"].shape == (30,)
    assert float(res.c_max) < 1e-3
    _assert_same_solves(ref, res)


def test_al_solve_row_penalties_and_feedback_update_match_jax():
    """``mu_init`` / ``penalty_scaling`` as (P,) row vectors and the
    "feedback" outer update, on the double integrator."""
    pj = jproblems.doubleintegrator(dtype=jnp.float64)
    P = pj.constraints.P
    mu0 = np.linspace(1.0, 3.0, P)
    sca = np.linspace(5.0, 12.0, P)
    kw = dict(outer_loop_update_type="feedback", penalty_scaling_no=2.0)
    ref = tt_jax.al_solve(pj, tt_jax.ALOptions(**kw), mu_init=jnp.asarray(mu0),
                          penalty_scaling=jnp.asarray(sca))
    res = tt.al_solve(_carry(pj), tt.ALOptions(**kw),
                      mu_init=torch.as_tensor(mu0),
                      penalty_scaling=torch.as_tensor(sca))
    _assert_same_solves(ref, res)
