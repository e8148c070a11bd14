"""kuka's steps under all six rules against the JAX package, in float64
(the rigs' in ``tests/test_torch_integrators_chains.py``; the arm's
Jacobians there too). The explicit rules' steps within 1e-12 of the JAX
package's, run op by op (``jax.disable_jit``). The JAX package's implicit
steps through the arm take 40–60 s each to compile or to run op by op (a
``jacfwd`` of the arm every Newton trip), so the port's implicit steps are
held to the JAX package's residual of the rule instead: the JAX package's
arm dynamics (compiled once) evaluated at the port's step y give
|G(y)| ≤ 1e-12·(1 + |x|), the JAX package's own stopping rule, and
‖G_y⁻¹‖ < 5 there, so the JAX package's root, which meets the same
tolerance, lies within 1e-11·(1 + |x|) of y."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import robots as jrobots

import trajopt_tpu_torch as tt
from trajopt_tpu_torch.models import zoo

from _torch_integrators import scale_close

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

DT = 0.05


def _point():
    rng = np.random.default_rng(7)
    return rng.normal(size=(3, 14)) * 0.3, rng.normal(size=(3, 7)) * 0.3


@pytest.mark.parametrize("rule", ("euler", "midpoint", "rk3", "rk4"))
def test_kuka_explicit_step_matches_jax(rule):
    x, u = _point()
    with jax.disable_jit():
        want = jax.vmap(jtt.discretize(jrobots.kuka_model(), rule).step,
                        (0, 0, None))(jnp.asarray(x), jnp.asarray(u), DT)
    got = tt.discretize(zoo.MODELS["kuka"], rule).step(
        torch.as_tensor(x), torch.as_tensor(u), DT)
    scale_close(got.numpy(), np.asarray(want), 1e-12)


@pytest.mark.parametrize("rule", ("midpoint_implicit", "rk3_implicit"))
def test_kuka_implicit_step_solves_the_jax_residual(rule):
    x, u = _point()
    y = tt.discretize(zoo.MODELS["kuka"], rule).step(
        torch.as_tensor(x), torch.as_tensor(u), DT).numpy()
    f = jrobots.kuka_model().dynamics

    def residual(y, x, u):
        if rule == "midpoint_implicit":
            return y - x - DT * f(0.5 * (x + y), u)
        f1, f3 = f(x, u), f(y, u)
        f2 = f(0.5 * (x + y) + DT / 8.0 * (f1 - f3), u)
        return (y - x - DT / 6.0 * f1 - 4.0 / 6.0 * DT * f2
                - DT / 6.0 * f3)

    # G at y and, for G_y by central differences (h = 1e-6), at y ± h e_j:
    # one compiled batch
    h, k = 1e-6, y.shape[0]
    eye = np.eye(14) * h
    ys = np.concatenate([y[:, None], y[:, None] + eye, y[:, None] - eye],
                        axis=1).reshape(-1, 14)
    g = np.asarray(jax.jit(jax.vmap(residual))(
        jnp.asarray(ys), jnp.asarray(np.repeat(x, 29, axis=0)),
        jnp.asarray(np.repeat(u, 29, axis=0)))).reshape(k, 29, 14)
    tol = 1e-12 * (1.0 + np.linalg.norm(x, axis=-1))
    assert (np.linalg.norm(g[:, 0], axis=-1) <= tol).all()
    # the JAX package's root y_j meets the same tolerance, so
    # |y − y_j| ≤ ‖G_y⁻¹‖ (|G(y)| + |G(y_j)|) ≤ 2 ‖G_y⁻¹‖ tol
    Gy = ((g[:, 1:15] - g[:, 15:]) / (2 * h)).transpose(0, 2, 1)
    inv = np.linalg.norm(np.linalg.inv(Gy), 2, axis=(-2, -1))
    assert (inv < 5.0).all(), inv
