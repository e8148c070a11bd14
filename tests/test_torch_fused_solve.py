"""The port's fused unconstrained solve against the phase-split one and the
JAX package, end to end, on the CPU.

``al_solve`` and ``solve_batch`` on the unconstrained ``quadrotor_line`` with
``iLQROptions(fused=True)``: every iteration goes through the fused backward
and forward programs (``ops/cuda_fused.py``; their plain versions here, the
kernels K7a and K7b on a CUDA tensor).
"""
import jax.numpy as jnp
import numpy as np
import torch

import trajopt_tpu as tt_jax
from trajopt_tpu.problems import zoo as jproblems
from trajopt_tpu.solvers.ilqr import iLQROptions as JaxILQROptions

import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.parallel.batch import solve_batch

torch.set_num_threads(1)


def _carry(pj):
    return convert.problem_from_arrays(**convert.problem_arrays(pj),
                                       device="cpu")


def test_unconstrained_fused_solve_matches_unfused_and_jax():
    """``quadrotor_line(N=21)`` without constraints through ``al_solve``:
    with ``fused=True`` the solve goes through the fused backward and
    forward programs (their plain versions here), with ``fused=False``
    through the phase-split path; both give the same J and iteration count
    (tests/test_fused.py:112-149).

    Against the JAX ``al_solve`` the full-state quadrotor is held by outcome
    and not by trajectory (ROADMAP Queue 3, Q3-9): at rho = 0 its Quu is so
    badly conditioned that the two packages' elimination orders already
    differ by 1e-8 in X after ONE iteration in float64, and the slow tail of
    the descent amplifies that into other iteration counts (76 and 109).
    So: after one iteration X within 1e-6 and J at rtol 1e-8; at the end
    both within 5 mm of the goal and J within 10%."""
    pj = jproblems.quadrotor_line(N=21, dtype=jnp.float64, distance=20.0)
    prob = _carry(pj)
    out = {}
    for fused in (True, False):
        out[fused] = tt.al_solve(prob, tt.ALOptions(
            opts_uncon=tt.iLQROptions(fused=fused)))
    assert float(out[True].J) == float(out[False].J)
    assert int(out[True].iterations_total) == int(out[False].iterations_total)
    assert torch.equal(out[True].X, out[False].X)
    res = out[True]
    assert res.lam.shape == (21, 0) and int(res.iterations) == 1
    assert res.history["cost"].shape == (1,)

    ref = tt_jax.al_solve(pj, tt_jax.ALOptions(
        opts_uncon=JaxILQROptions(fused=True)))
    a, b = convert.result_arrays(ref), convert.result_arrays(res)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
    goal = np.asarray(pj.xf)[:3]
    for r in (a, b):
        assert np.linalg.norm(r["X"][-1, :3] - goal) < 5e-3
    assert abs(a["J"] - b["J"]) < 0.1 * a["J"]

    one = dict(iterations=1, fused=True)
    ref1 = tt_jax.al_solve(pj, tt_jax.ALOptions(
        opts_uncon=JaxILQROptions(**one)))
    res1 = tt.al_solve(prob, tt.ALOptions(opts_uncon=tt.iLQROptions(**one)))
    assert int(ref1.iterations_total) == int(res1.iterations_total) == 1
    assert np.abs(np.asarray(ref1.X) - res1.X.numpy()).max() < 1e-6
    np.testing.assert_allclose(float(res1.J), float(ref1.J), rtol=1e-8)


def test_solve_batch_unconstrained_fused_is_per_problem():
    """A batch through the fused arm: each problem stops at its own
    iteration count, and problem i of the batch equals problem i solved
    alone (``vmap`` semantics)."""
    pj = jproblems.quadrotor_line(N=21, dtype=jnp.float64, distance=20.0)
    prob = _carry(pj)
    x0s = np.tile(np.asarray(pj.x0)[None], (3, 1))
    x0s[:, :3] += np.random.default_rng(1).normal(size=(3, 3)) * 0.02
    opts = tt.ALOptions(opts_uncon=tt.iLQROptions(fused=True))
    res = solve_batch(prob, opts, torch.as_tensor(x0s))
    assert res.history["iterations_inner"].shape == (3, 1)
    alone = solve_batch(prob, opts, torch.as_tensor(x0s[1:2]))
    assert int(alone.iterations_total[0]) == int(res.iterations_total[1])
    np.testing.assert_allclose(alone.X[0].numpy(), res.X[1].numpy(), rtol=0,
                               atol=1e-9)
