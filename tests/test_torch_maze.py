"""The port's quadrotor-maze slice against the JAX package, end to end.

``solve_batch_queued_altro_retry`` (infeasible-start transform, queued AL
stage with ``iLQROptions(fused=True)``, failed-lane retry) runs in both
packages on the miniature maze of tests/test_torch_constraints.py (N = 21,
three cylinders) with the maze benchmark's schedule, in float64 on the CPU,
a pool of 4 over 2 lanes. The port reaches the fused AL kernels' plain
versions here; the CUDA kernels are checked on the card by chip_smoke.py.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as tt_jax
from trajopt_tpu.parallel.batch import (
    solve_batch_queued_altro_retry as jax_altro_retry,
)
from trajopt_tpu.solvers.al import al_lane_stepper as jax_al_lane_stepper
from trajopt_tpu.solvers.altro import ALTROOptions as JaxALTROOptions
from trajopt_tpu.solvers.altro import infeasible_problem as jax_infeasible
from trajopt_tpu.solvers.ilqr import iLQROptions as JaxILQROptions

from test_torch_constraints import small_maze_jax
import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.parallel.batch import solve_batch_queued_altro_retry
from trajopt_tpu_torch.solvers.al import al_lane_stepper
from trajopt_tpu_torch.solvers.altro import infeasible_problem

torch.set_num_threads(1)

POOL, LANES = 4, 2
# Pool seed 0: three problems converge in the first AL round or two and
# one takes three, so a lane is refilled while the other carries on. With
# tol = 1e-4 two of the four miss the bar and are re-solved under mu0 x 4,
# which exercises the retry and its merge. Away from the convergence
# knife-edge of ROADMAP Queue 3 Q3-1 (seed 1's iteration counts also agree;
# seeds were not searched further).
POOL_SEED, RETRY_TOL = 0, 1e-4
ROOT = Path(__file__).resolve().parent.parent


def _schedule(pkg, ilqr_options):
    """The maze benchmark's AL schedule (bench.py:179-184)."""
    return pkg.ALOptions(
        iterations=40, opts_uncon=ilqr_options(iterations=10, fused=True),
        cost_tolerance=1e-5, cost_tolerance_intermediate=1e-3,
        constraint_tolerance=1e-3, penalty_initial=1.0, penalty_scaling=25.0)


def _pool(x0):
    rng = np.random.default_rng(POOL_SEED)
    x0s = np.tile(np.asarray(x0)[None], (POOL, 1))
    x0s[:, :3] += rng.normal(size=(POOL, 3)) * 0.05
    return x0s


def test_solve_batch_queued_altro_retry_matches_jax():
    """Inner iterations and n_retried equal, c_max and J at rtol 1e-6,
    final X within 1e-6, every problem below the reference's 1e-3 bar."""
    pj = small_maze_jax()
    x0s = _pool(pj.x0)
    ref, n_ref = jax_altro_retry(
        pj, JaxALTROOptions(R_inf=1e-8,
                            opts_al=_schedule(tt_jax, JaxILQROptions)),
        jnp.asarray(x0s), lanes=LANES, infeasible=True, tol=RETRY_TOL)

    prob = convert.problem_from_arrays(**convert.problem_arrays(pj),
                                       device="cpu")
    res, n_retried = solve_batch_queued_altro_retry(
        prob, tt.ALTROOptions(R_inf=1e-8,
                              opts_al=_schedule(tt, tt.iLQROptions)),
        torch.as_tensor(x0s), lanes=LANES, infeasible=True, tol=RETRY_TOL)

    assert n_retried == n_ref == 2
    assert np.array_equal(np.asarray(ref.iterations_total),
                          res.iterations_total.numpy())
    assert res.rounds == int(ref.rounds)
    assert res.X.shape == (POOL, 21, 13) and res.U.shape == (POOL, 20, 4)
    np.testing.assert_allclose(res.c_max.numpy(), np.asarray(ref.c_max),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(res.J.numpy(), np.asarray(ref.J), rtol=1e-6)
    assert np.max(np.abs(res.X.numpy() - np.asarray(ref.X))) < 1e-6
    assert float(res.c_max.max()) < 1e-3
    assert res.host_syncs > res.rounds


@pytest.mark.parametrize("update_type", ["default", "feedback"])
def test_al_lane_stepper_constrained_arm_matches_jax(update_type):
    """Two outer steps of the constrained stepper (2 inner iterations each)
    with per-row penalty schedules, the feedback switch and the
    max-penalty kickout: duals, penalties, c_max and flags against vmap of
    the JAX stepper, at rtol 1e-5 (the two unconverged iterations go
    through gain solves with kappa ~ 1e9, which amplifies float64 rounding
    to ~1e-7 relative)."""
    pj = jax_infeasible(small_maze_jax(), 1e-8)
    pt = infeasible_problem(convert.problem_from_arrays(
        **convert.problem_arrays(small_maze_jax()), device="cpu"), 1e-8)
    P = pj.constraints.P
    mu0 = np.linspace(1.0, 3.0, P)
    sca = np.linspace(5.0, 60.0, P)
    kw = dict(iterations=3, outer_loop_update_type=update_type,
              kickout_max_penalty=True, penalty_max=2000.0,
              constraint_decrease_ratio=0.9)
    x0s = _pool(pj.x0)[:LANES]
    U0s = np.tile(np.asarray(pj.U)[None], (LANES, 1, 1))

    init_j, step_j = jax_al_lane_stepper(
        pj, tt_jax.ALOptions(opts_uncon=JaxILQROptions(iterations=2), **kw),
        mu_init=jnp.asarray(mu0)[None, :], penalty_scaling=jnp.asarray(sca))
    st_j = jax.vmap(init_j)(jnp.asarray(x0s), jnp.asarray(U0s))
    init_t, step_t = al_lane_stepper(
        pt, tt.ALOptions(opts_uncon=tt.iLQROptions(iterations=2), **kw),
        mu_init=torch.as_tensor(mu0)[None, :],
        penalty_scaling=torch.as_tensor(sca))
    st_t = init_t(torch.as_tensor(x0s), torch.as_tensor(U0s))
    for _ in range(2):
        st_j = jax.vmap(step_j)(st_j)
        st_t = step_t(st_t)
        for name in ("lam", "mu", "c_max", "J", "X"):
            np.testing.assert_allclose(
                getattr(st_t, name).numpy(), np.asarray(getattr(st_j, name)),
                rtol=1e-5, atol=1e-8, err_msg=name)
        assert st_t.it_total.tolist() == np.asarray(st_j.it_total).tolist()
        assert st_t.converged.tolist() == np.asarray(st_j.converged).tolist()
    if update_type == "default":      # 60² > penalty_max: kicked out
        assert st_t.converged.all()


def test_port_imports_neither_jax_nor_the_jax_package():
    """No source of the port, and not chip_smoke.py, imports ``jax`` or
    ``trajopt_tpu``: only the tests know both packages."""
    sources = sorted((ROOT / "trajopt_tpu_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 20
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "trajopt_tpu"), \
                    f"{path.relative_to(ROOT)} imports {name}"
