"""The unconstrained fused kuka solve by the port against the JAX package, on
the CPU, in float64.

``kuka_obstacles`` with its constraint set replaced by an empty one, in both
packages, solved with ``fused=True``: every iteration goes through the plain
versions of the fused kernels K7a and K7b, which carry the arm's chain step
on a CUDA tensor. Both packages start from the start held on every knot,
the state the initial-rollout guard leaves (the open-loop rollout of the
hold seed is chaotic, ``tests/test_torch_kuka_solve.py``), and take one
outer iteration of 4 inner ones at the full horizon (N = 41): X at 1e-6 of
scale and J at rtol 1e-8 of the JAX package's. The phase-split and the
fused solve are the same computation on the CPU and are compared on the
card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import trajopt_tpu as jtt
from trajopt_tpu.ops.constraints import empty_constraints as jax_empty
from trajopt_tpu.problems import zoo as jzoo

import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.ops.constraints import empty_constraints
from trajopt_tpu_torch.solvers.ilqr import _fused_eligible

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)


def _options(pkg):
    return pkg.ALOptions(iterations=1, opts_uncon=pkg.iLQROptions(
        iterations=4, fused=True))


def test_unconstrained_fused_kuka_solve_matches_jax_f64():
    pj = jzoo.kuka_obstacles(dtype=jnp.float64)
    held = np.repeat(np.asarray(pj.x0)[None], pj.N, axis=0)
    pj = jtt.update_problem(pj, constraints=jax_empty(pj.N),
                            X=jnp.asarray(held))
    ref = jtt.al_solve(pj, _options(jtt))

    pt = convert.PROBLEMS["kuka_obstacles"](device="cpu")
    pt = tt.update_problem(pt, constraints=empty_constraints(pt.N,
                                                             device="cpu"),
                           X=torch.as_tensor(held))
    opts = _options(tt)
    assert pt.constraints.P == 0 and pt.model.cuda_step == "kuka"
    assert _fused_eligible(pt.model, opts.opts_uncon, pt.obj, like=pt.X)
    res = tt.al_solve(pt, opts)
    Xj = np.asarray(ref.X)
    assert int(res.iterations_total) == int(ref.iterations_total) == 4
    assert np.abs(res.X.numpy() - Xj).max() < 1e-6 * np.abs(Xj).max()
    np.testing.assert_allclose(float(res.J), float(ref.J), rtol=1e-8)
