"""The plain version of the fused kernel K7b on the kuka arm against the
JAX package's ``forward_pass``, on the CPU, in float64.

``ops/cuda_fused.py::fused_forward`` carries the arm's chain step
(``Chain<7,7>`` in K7b on a CUDA tensor); here it is held to the JAX
package's line search for an unconstrained kuka iteration at N = 9 with
the kuka objective and dt, three problems, one of whose searches runs out.
K7a's plain version is ``tests/test_torch_kuka_fused_kernels.py``, the
unconstrained solve ``tests/test_torch_kuka_fused.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_kuka import kuka_setup, t
from trajopt_tpu.solvers.ilqr import forward_pass as jax_forward_pass
from trajopt_tpu.solvers.ilqr import iLQROptions as JaxILQROptions

from trajopt_tpu_torch.ops.cuda_fused import (
    fused_backward_cuda, fused_forward_cuda,
)
from trajopt_tpu_torch.solvers.ilqr import _line_search_opts, iLQROptions

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)


def test_fused_forward_on_kuka_matches_jax_forward_pass_f64():
    """K7b's plain version on the arm against ``vmap(forward_pass)``,
    float64, N = 9, problem 2 given a cost no candidate can beat (its
    search runs out): α, ρ and dρ equal on every problem, J at rtol 1e-10,
    X̄ and Ū at 1e-9 of scale."""
    Bz, N = 3, 9
    jm, md, obj, tobj, x0s, X, U, dt_traj = kuka_setup(Bz, N, seed=1)
    K, d, v1, v2, fail = fused_backward_cuda(md, t(X), t(U), t(dt_traj),
                                             tobj, t(np.ones(Bz)))
    assert not bool(fail.any())
    J_prev = np.array(jax.vmap(lambda a, b: obj.total(a, b, dt_traj))(X, U))
    J_prev[2] = -1e30

    def search(x0_, X_, U_, K_, d_, a_, b_, J_):
        return jax_forward_pass(
            jm, lambda Xc, Uc: obj.total(Xc, Uc, dt_traj), x0_, X_, U_, K_,
            d_, a_, b_, J_, jnp.ones(()), jnp.ones(()), dt_traj,
            JaxILQROptions())

    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    ref = jax.vmap(search)(x0s, X, U, j(K), j(d), j(v1), j(v2),
                           jnp.asarray(J_prev))
    Xr, Ur, Jr, rhor, drhor, alphar = (np.asarray(a) for a in ref)
    one = t(np.ones(Bz))
    Xn, Un, J, rho, drho, alpha = fused_forward_cuda(
        md, t(x0s), t(X), t(U), K, d, v1, v2, t(J_prev), one, one, None,
        t(dt_traj), tobj, _line_search_opts(iLQROptions()))
    assert alpha.tolist() == alphar.tolist()
    assert rho.tolist() == rhor.tolist() and drho.tolist() == drhor.tolist()
    assert float(alpha[0]) > 0.0 and float(alpha[2]) == 0.0
    assert np.array_equal(Xn[2].numpy(), np.asarray(X)[2])
    np.testing.assert_allclose(J.numpy(), Jr, rtol=1e-10)
    for mine, r in ((Xn, Xr), (Un, Ur)):
        assert np.abs(mine.numpy() - r).max() < 1e-9 * np.abs(r).max()
