"""The plain version of the fused kernel K7a on the kuka arm against the
JAX package's scan path, on the CPU, in float64.

``ops/cuda_fused.py::fused_backward`` carries the arm's chain step
(``Chain<7,7>`` in K7a on a CUDA tensor); here it is held to what the JAX
package computes off the TPU for an unconstrained kuka iteration:
``jacobian_traj`` + the LQR expansion + ``_backward_pass_impl``, at N = 9
with the kuka objective and dt, three problems. K7b's plain version is
``tests/test_torch_kuka_fused_forward.py``, the unconstrained solve
``tests/test_torch_kuka_fused.py`` (each file about a minute: the JAX
reference's compile takes most of it); the inputs of both kernel files
come from ``tests/_torch_kuka.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_kuka import kuka_setup, t
from trajopt_tpu.solvers.ilqr import _backward_pass_impl
from trajopt_tpu.solvers.ilqr import iLQROptions as JaxILQROptions

from trajopt_tpu_torch.ops.cuda_fused import fused_backward_cuda

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)


def test_fused_backward_on_kuka_matches_jax_scan_path_f64():
    """K7a's plain version on the arm against what the JAX package computes
    off the TPU (``jacobian_traj`` + the LQR expansion +
    ``_backward_pass_impl``), float64, ρ = 1, N = 9: K, d, ΔV and the
    Jacobians A and B at 1e-10 of their scale."""
    Bz, N = 3, 9
    jm, md, obj, tobj, _, X, U, dt_traj = kuka_setup(Bz, N)
    jopts = JaxILQROptions()

    def one(X_, U_):
        A, Bm = jm.jacobian_traj(X_[:-1], U_, dt_traj)
        out = _backward_pass_impl(A, Bm, obj.expansion(X_, U_, dt_traj),
                                  jnp.ones(()), jnp.ones(()), jopts)
        return out, A, Bm

    (Kj, dj, v1j, v2j, _, _), Aj, Bj = jax.vmap(one)(X, U)
    K, d, v1, v2, fail, A, Bm = fused_backward_cuda(
        md, t(X), t(U), t(dt_traj), tobj, t(np.ones(Bz)),
        return_jacobians=True)
    assert not bool(fail.any())
    for mine, ref in ((K, Kj), (d, dj), (v1, v1j), (v2, v2j), (A, Aj),
                      (Bm, Bj)):
        ref = np.asarray(ref)
        assert np.abs(mine.numpy() - ref).max() < 1e-10 * np.abs(ref).max()
