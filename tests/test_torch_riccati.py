"""The plain version behind the Riccati kernel K5 against the JAX package, on
the CPU.

``ops/riccati.py::scan_sweep``, reached through the wrapper
``riccati_sweep_cuda`` (a CPU tensor goes to the plain version) and through
``solvers/ilqr.py::backward_pass`` with the default ``bp_type='scan'``:

- in float32 against the Pallas TPU kernel ``riccati_sweep_pallas`` in
  interpret mode, B = 128 (a lane tile), N = 11, on linearizations of the
  quadrotor (n, m) = (13, 4) and of the cartpole (4, 1), with control and
  with state regularization, and with one problem made indefinite;
- in float64 against ``vmap(_backward_pass_impl)`` with the ρ retry.

The CUDA kernel itself is compared with the plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as tt_jax
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.ops.pallas_riccati import riccati_sweep_pallas
from trajopt_tpu.ops.rollout import rollout as jax_rollout
from trajopt_tpu.solvers.ilqr import _backward_pass_impl
from trajopt_tpu.solvers.ilqr import iLQROptions as JaxILQROptions

from trajopt_tpu_torch.ops.cost import Expansion
from trajopt_tpu_torch.ops.cuda_models import CUDA_MODELS
from trajopt_tpu_torch.ops.cuda_riccati import SHAPES, riccati_sweep_cuda
from trajopt_tpu_torch.solvers.ilqr import backward_pass, iLQROptions

torch.set_num_threads(1)

FIELDS = ("x", "u", "xx", "uu", "ux")
# float32 at rho = 1: K and d at 1e-3 of their scale and ΔV at 1e-4, the
# tolerances at which tests/test_fused.py holds two Pallas kernels to each
# other on this kind of input. Where the sweep is worse conditioned than
# that (state regularization rho·BᵀB is weak, |B| ~ dt: on the quadrotor
# both float32 sides sit 2.6e-3 from float64), two float32 orders of
# summation that are each eps from float64 may sit 2·eps apart, so the bar
# is the larger of the two.
K_TOL, D_TOL, DV_TOL = 1e-3, 1e-3, 1e-4


def _linearization(name, batch, N, dtype, seed=0):
    """A, B and the LQR expansion of ``batch`` open-loop rollouts of model
    ``name`` from perturbed starts, by the JAX package, as numpy arrays."""
    jm = tt_jax.discretize(getattr(jzoo, name), "rk3")
    n, m = jm.n, jm.m
    rng = np.random.default_rng(seed)
    x0, xf = np.zeros(n), np.zeros(n)
    if name == "quadrotor":
        x0[3] = xf[3] = 1.0
        xf[1] = 5.0
        u0 = 1.22
    else:
        xf[1] = np.pi
        u0 = 0.3
    obj = tt_jax.LQRObjective(np.eye(n) * 1e-3, np.eye(m) * 1e-2,
                              np.eye(n) * 100.0, xf, N)
    x0s = x0[None] + rng.normal(size=(batch, n)) * 0.05
    U = u0 + rng.normal(size=(batch, N - 1, m)) * 0.1
    dt = jnp.full((N - 1,), 0.05)

    def one(x0_, U_):
        X = jax_rollout(jm, x0_, U_, dt)
        A, Bm = jm.jacobian_traj(X[:-1], U_, dt)
        return A, Bm, obj.expansion(X, U_, dt)

    A, Bm, exp = jax.vmap(one)(jnp.asarray(x0s), jnp.asarray(U))
    out = [np.asarray(A), np.asarray(Bm)] + [np.asarray(getattr(exp, k))
                                             for k in FIELDS]
    return [a.astype(dtype) for a in out]


def _t(a):
    return torch.as_tensor(np.array(a))


def _scaled_err(mine, ref, live):
    ref = np.asarray(ref)[live]
    return np.abs(mine.numpy()[live] - ref).max() / max(np.abs(ref).max(),
                                                        1e-12)


@pytest.mark.parametrize("reg_state", [False, True])
@pytest.mark.parametrize("name", ["quadrotor", "cartpole"])
def test_scan_sweep_matches_pallas_interpret_f32(name, reg_state):
    """Problem 9 gets a negative definite control Hessian at knot 4: it
    fails alone on both sides, its gains at that stage are zero, and the
    other problems agree at the float32 tolerances."""
    Bz, N = 128, 11
    arrs = _linearization(name, Bz, N, np.float32)
    m = arrs[1].shape[-1]
    arrs[5][9, 4] = -50.0 * np.eye(m, dtype=np.float32)
    rho = np.ones(Bz, np.float32)
    Kr, dr, v1r, v2r, failr = riccati_sweep_pallas(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(rho),
        reg_state=reg_state, interpret=True)
    K, d, v1, v2, fail = riccati_sweep_cuda(*(_t(a) for a in arrs), _t(rho),
                                            reg_state=reg_state)
    assert K.dtype == torch.float32 and K.shape == tuple(Kr.shape)
    assert (arrs[0].shape[-1], m) in SHAPES
    failr = np.asarray(failr)
    assert fail.tolist() == failr.tolist()
    assert np.flatnonzero(failr).tolist() == [9]
    assert not bool(K[9, 4].any()) and not bool(d[9, 4].any())
    live = ~failr
    ref64 = riccati_sweep_cuda(*(_t(a).double() for a in arrs),
                               _t(rho).double(), reg_state=reg_state)
    assert ref64[4].tolist() == failr.tolist()
    for mine, ref, r64, tol in zip((K, d, v1, v2), (Kr, dr, v1r, v2r), ref64,
                                   (K_TOL, D_TOL, DV_TOL, DV_TOL)):
        pallas_eps = _scaled_err(r64, np.asarray(ref, np.float64), live)
        assert _scaled_err(mine, ref, live) < max(tol, 2.0 * pallas_eps)


@pytest.mark.parametrize("reg_type", ["control", "state"])
def test_scan_backward_pass_matches_jax_f64(reg_type):
    """``backward_pass`` with the default ``bp_type='scan'`` on cartpole
    linearizations, float64, against ``vmap(_backward_pass_impl)``. Problems
    1 and 2 get a control Hessian that ρ must lift (the others are re-swept
    at their own ρ): ρ and dρ at rtol 1e-12, K, d and ΔV at 1e-10 of
    scale."""
    Bz, N = 4, 21
    arrs = _linearization("cartpole", Bz, N, np.float64, seed=1)
    arrs[5][1, 7] = -0.5
    arrs[5][2, 12] = -2.0
    jexp = tt_jax.ops.cost.Expansion(*(jnp.asarray(a) for a in arrs[2:]))
    jopts = JaxILQROptions(bp_reg_type=reg_type)
    rho0, drho0 = jnp.full((Bz,), 1e-3), jnp.ones((Bz,))
    Kj, dj, v1j, v2j, rhoj, drhoj = jax.vmap(
        lambda a, b, ex, r, dr: _backward_pass_impl(a, b, ex, r, dr, jopts))(
        jnp.asarray(arrs[0]), jnp.asarray(arrs[1]), jexp, rho0, drho0)
    K, d, v1, v2, rho, drho = backward_pass(
        _t(arrs[0]), _t(arrs[1]), Expansion(*(_t(a) for a in arrs[2:])),
        _t(rho0), _t(drho0), iLQROptions(bp_reg_type=reg_type))
    assert min(float(rho[1]), float(rho[2])) > 0.1 > float(rho[0])  # retried
    np.testing.assert_allclose(rho.numpy(), np.asarray(rhoj), rtol=1e-12)
    np.testing.assert_allclose(drho.numpy(), np.asarray(drhoj), rtol=1e-12)
    everyone = np.ones(Bz, bool)
    assert _scaled_err(K, Kj, everyone) < 1e-10
    assert _scaled_err(d, dj, everyone) < 1e-10
    assert _scaled_err(v1, v1j, everyone) < 1e-10
    assert _scaled_err(v2, v2j, everyone) < 1e-10


def test_riccati_wrapper_takes_the_ported_shapes():
    """Every (n, m) a ported model produces has an instantiation, with or
    without the slack controls (the quadrotor's (13, 17), the car's (3, 5),
    kuka's (14, 21), ...), in the minimum-time form of any model (the
    pendulum's (3, 2), the quadrotor's with slacks (14, 18), kuka's (15, 8)
    and with slacks (15, 22), the double pendulum's (5, 3) and (5, 7), ...),
    and the error state (12, 4); and no shape that no model gives."""
    assert len(CUDA_MODELS) == 52
    shapes = {(cm.n, cm.m) for cm in CUDA_MODELS.values()}
    assert shapes | {(12, 4)} == set(SHAPES)
    assert len(SHAPES) == len(set(SHAPES)) == 25
    assert (12, 4) in SHAPES and (13, 17) in SHAPES and (3, 5) in SHAPES
    assert (3, 2) in SHAPES and (14, 18) in SHAPES and (12, 16) in SHAPES
    assert {(15, 8), (15, 22), (5, 3), (5, 7)} <= set(SHAPES)
