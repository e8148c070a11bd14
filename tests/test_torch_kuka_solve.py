"""kuka_obstacles solved by the port against the JAX package, on the CPU.

One AL outer iteration with a small inner cap, float64, the AL options of
tests/test_altro.py:101-111 otherwise: J at rtol 1e-8 and X at 1e-6 of
scale against the JAX package's ``al_solve``, and the two dispatch arms
(phase-split, and the hybrid of ``fused_al_fk``, whose line search is K4's
plain version) agreeing with each other at the same bars. Both start from
the start held on every knot, the state the initial-rollout guard leaves
in float32: the open-loop rollout of the hold seed is chaotic (the undamped
arm at dt = 0.125 s), and two float64 rollouts that differ by 1e-18 in
their first step part by O(1) before the end, so from the unset seed the
packages would compare rounding, not the algorithm (ROADMAP Queue 3).
Nothing longer is compared value by value here: the whole solve is driven
on the card and judged by outcome (``chip_smoke.py``). The problem is built
by name in each package, and a JAX problem carried over by ``convert``
(the fk rows by their descriptor) is the same problem.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.problems import zoo as jzoo

import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

INNER = 4


def _options(pkg, **kw):
    return pkg.ALOptions(
        iterations=1, cost_tolerance=1e-6, cost_tolerance_intermediate=1e-5,
        constraint_tolerance=1e-3, penalty_scaling=50.0, penalty_initial=0.01,
        opts_uncon=pkg.iLQROptions(iterations=INNER, **kw))


@pytest.fixture(scope="module")
def solves():
    pj = jzoo.kuka_obstacles(dtype=jnp.float64)
    pt = convert.PROBLEMS["kuka_obstacles"](device="cpu")
    held = np.repeat(np.asarray(pj.x0)[None], pj.N, axis=0)
    rj = jtt.al_solve(jtt.update_problem(pj, X=jnp.asarray(held)),
                      _options(jtt))
    ph = tt.update_problem(pt, X=torch.as_tensor(held))
    return pj, rj, pt, [tt.al_solve(ph, _options(tt, fused_al_fk=fk))
                        for fk in (False, True)]


def test_one_outer_iteration_matches_jax(solves):
    """The first outer iteration, INNER inner ones, both arms: J at rtol
    1e-8 and X at 1e-6 of scale of the JAX package's; c_max at rtol 1e-6."""
    pj, rj, pt, arms = solves
    Xj = np.asarray(rj.X)
    for r in arms:
        assert int(r.iterations_total) == int(rj.iterations_total) == INNER
        np.testing.assert_allclose(float(r.J), float(rj.J), rtol=1e-8)
        assert np.abs(r.X.numpy() - Xj).max() <= 1e-6 * np.abs(Xj).max()
        np.testing.assert_allclose(float(r.c_max), float(rj.c_max),
                                   rtol=1e-6)


def test_the_two_arms_agree(solves):
    """The phase-split arm and the hybrid (K4's plain version for the line
    search) on the CPU: J at rtol 1e-10, X at 1e-9 of scale."""
    _, _, _, (a, b) = solves
    np.testing.assert_allclose(float(a.J), float(b.J), rtol=1e-10)
    assert (a.X - b.X).abs().max() <= 1e-9 * a.X.abs().max()


def test_carried_over_problem_is_the_zoo_problem(solves):
    """``problem_from_arrays(**problem_arrays(jax kuka))`` rebuilds the fk
    rows from their descriptor: its constraint values, Jacobians and
    objective equal the port's own kuka_obstacles at 1e-12 of scale."""
    pj, _, pt, _ = solves
    arrays = convert.problem_arrays(pj)
    assert [c["kind"] for c in arrays["constraints"]] == [
        "linear", "fk_sphere", "linear"]
    pc = convert.problem_from_arrays(**arrays, device="cpu")
    assert pc.model.cuda_step == pt.model.cuda_step == "kuka_rk3"
    assert np.array_equal(pc.model.chain_table, pt.model.chain_table)
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.uniform(-1.5, 1.5, size=(pt.N, 14)))
    U = torch.as_tensor(rng.normal(size=(pt.N - 1, 7)))
    for a, b in ((pc.constraints.evaluate(X, U),
                  pt.constraints.evaluate(X, U)),
                 *zip(pc.constraints.jacobian(X, U),
                      pt.constraints.jacobian(X, U)),
                 (pc.U, pt.U), (pc.obj.Q, pt.obj.Q)):
        assert (a - b).abs().max() <= 1e-12 * max(1.0, float(b.abs().max()))


def test_altro_solve_reports_the_held_seed():
    """``altro_solve`` from the unset seed (the hold torques, X unset): the
    open-loop seed rollout blows up in float32, the initial-rollout guard
    holds x0 for the problem, and the result says so (``seed_held``) beside
    the loop tests' device-to-host reads (at least one per inner
    iteration)."""
    prob = convert.PROBLEMS["kuka_obstacles"](dtype=torch.float32,
                                              device="cpu")
    res = tt.altro_solve(prob, tt.ALTROOptions(opts_al=tt.ALOptions(
        iterations=1, penalty_initial=0.01, penalty_scaling=50.0,
        opts_uncon=tt.iLQROptions(iterations=1))))
    assert res.seed_held == 1
    assert bool(torch.isfinite(res.X).all())
    assert res.host_syncs >= int(res.iterations_total) >= 1
