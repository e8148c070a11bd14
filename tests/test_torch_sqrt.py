"""The square-root Riccati twin of kernel K1 against the JAX package.

``sqrt_sweep_cuda`` hands a tensor on the CPU to its plain twin
``ops/cuda_sqrt.py::sqrt_sweep``, which is held to ``jax.vmap(sqrt_sweep)``
(the plain reference that tests/test_pallas.py holds the Pallas kernel to)
on real quadrotor linearizations, raw and projected to the error state.
Two lanes are made ill-conditioned on purpose so that the equilibrated
Cholesky fallback and the batched rho retry of the backward pass run. The
CUDA kernel itself is compared with the twin on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.models import zoo as jax_dynamics
from trajopt_tpu.models.base import discretize as jax_discretize
from trajopt_tpu.models.quaternions import (
    project_error_state as jax_project_error_state,
)
from trajopt_tpu.ops.cost import Expansion as JExpansion
from trajopt_tpu.ops.cost import LQRObjective as JaxLQRObjective
from trajopt_tpu.ops.cost import cost_expansion as jax_cost_expansion
from trajopt_tpu.ops.rollout import rollout as jax_rollout
from trajopt_tpu.problems.zoo import quadrotor_line as jax_quadrotor_line
from trajopt_tpu.solvers.ilqr import backward_pass as jax_backward_pass
from trajopt_tpu.solvers.ilqr import iLQROptions as JaxILQROptions
from trajopt_tpu.solvers.ilqr import reg_noise_scale as jax_reg_noise_scale
from trajopt_tpu.solvers.ilqr import sqrt_sweep as jax_sqrt_sweep

from trajopt_tpu_torch.ops.cost import Expansion
from trajopt_tpu_torch.ops.cuda_sqrt import sqrt_sweep_cuda
from trajopt_tpu_torch.solvers.ilqr import (
    backward_pass, iLQROptions, reg_noise_scale,
)

torch.set_num_threads(1)

B, N = 8, 21
FIELDS = ("x", "u", "xx", "uu", "ux")


@functools.lru_cache(maxsize=None)
def _linearization_cached(error_state, seed=3):
    """The recipe of tests/test_pallas.py::_bp_batch_inputs at B=8, N=21:
    open-loop rollouts of quadrotor_line from perturbed starts, their
    Jacobians and cost expansion, optionally projected to the 12-wide
    quaternion error state. Returned as numpy arrays."""
    prob = jax_quadrotor_line(N=N, dtype=jnp.float64, distance=20.0)
    dt_traj = prob.dt_traj()
    rng = np.random.default_rng(seed)

    def one(x0):
        X = jax_rollout(prob.model, x0, prob.U, dt_traj)
        A, Bj = prob.model.jacobian_traj(X[:-1], prob.U, dt_traj)
        exp = jax_cost_expansion(prob.obj, X, prob.U, dt_traj)
        if error_state:
            A, Bj, exp = jax_project_error_state(X, A, Bj, exp, (3, 7))
        return A, Bj, exp

    x0s = jnp.asarray(np.tile(np.asarray(prob.x0)[None], (B, 1))
                      + rng.normal(size=(B, 13)) * 0.02)
    A, Bj, exp = jax.vmap(one)(x0s)
    return (np.asarray(A), np.asarray(Bj),
            {k: np.array(getattr(exp, k)) for k in FIELDS})


# The small shapes K1 is also checked at on the card: the cartpole (4, 1)
# and the car (3, 2) with the weights, goal and dt of the JAX package's
# zoo problems (problems/zoo.py cartpole, car_3obs), cut to N = 21
SMALL = {
    "cartpole": (jax_dynamics.cartpole, 1e-2, 1e-1, [0.0, np.pi, 0.0, 0.0],
                 0.05),
    "car": (jax_dynamics.car, 1.0, 1e-1, [1.0, 1.0, 0.0], 0.05),
}


@functools.lru_cache(maxsize=None)
def _small_linearization_cached(name, seed=5):
    """Open-loop rollouts of a SMALL model from perturbed starts under small
    random controls, their Jacobians and the LQR cost expansion (numpy)."""
    dyn, q, r, xf, dt = SMALL[name]
    model = jax_discretize(dyn, "rk3")
    n, m = model.n, model.m
    obj = JaxLQRObjective(np.eye(n) * q, np.eye(m) * r, np.eye(n) * 100.0,
                          np.asarray(xf), N)
    dt_traj = jnp.full((N - 1,), dt)
    rng = np.random.default_rng(seed)
    x0s = jnp.asarray(rng.normal(size=(B, n)) * 0.1)
    Us = jnp.asarray(rng.normal(size=(B, N - 1, m)) * 0.1)

    def one(x0, U):
        X = jax_rollout(model, x0, U, dt_traj)
        A, Bj = model.jacobian_traj(X[:-1], U, dt_traj)
        return A, Bj, jax_cost_expansion(obj, X, U, dt_traj)

    A, Bj, exp = jax.vmap(one)(x0s, Us)
    return (np.asarray(A), np.asarray(Bj),
            {k: np.array(getattr(exp, k)) for k in FIELDS})


def _linearization(error_state):
    """A fresh copy of the cached linearization (tests edit the
    expansion in place): the quadrotor's error state (True), its full state
    (False), or a SMALL model by name."""
    A, Bj, e = (_small_linearization_cached(error_state)
                if isinstance(error_state, str)
                else _linearization_cached(error_state))
    return A, Bj, {k: v.copy() for k, v in e.items()}


def _make_indefinite(e, lane, knot, off):
    """Replace one stage's control Hessian by c·[[1, off], [off, 1]] ⊕ c·I:
    indefinite for off > 1 (eigenvalue c·(1 − off))."""
    c = e["uu"][lane, knot, 0, 0]
    luu = c * np.eye(4)
    luu[0, 1] = luu[1, 0] = c * off
    e["uu"][lane, knot] = luu


def _run_both(A, Bj, e, rho, dtype):
    jexp = JExpansion(**{k: jnp.asarray(v, dtype) for k, v in e.items()})
    ref = jax.vmap(jax_sqrt_sweep)(jnp.asarray(A, dtype),
                                   jnp.asarray(Bj, dtype), jexp,
                                   jnp.asarray(rho, dtype))
    t = {k: torch.as_tensor(np.asarray(v, dtype)) for k, v in e.items()}
    out = sqrt_sweep_cuda(torch.as_tensor(np.asarray(A, dtype)),
                          torch.as_tensor(np.asarray(Bj, dtype)),
                          t["x"], t["u"], t["xx"], t["uu"], t["ux"],
                          torch.as_tensor(np.asarray(rho, dtype)))
    return [np.asarray(r) for r in ref], [o.numpy() for o in out]


def _assert_close(ref, out, ktol, dtol, vtol):
    K0, d0, v10, v20, fail0 = ref
    K1, d1, v11, v21, fail1 = out
    np.testing.assert_array_equal(fail1, fail0)
    assert np.max(np.abs(K1 - K0)) <= ktol * np.max(np.abs(K0))
    assert np.max(np.abs(d1 - d0)) <= dtol * (np.max(np.abs(d0)) + 1e-12)
    np.testing.assert_allclose(v11, v10, rtol=vtol, atol=1e-5)
    np.testing.assert_allclose(v21, v20, rtol=vtol, atol=1e-5)


@pytest.mark.parametrize("rho_val", [0.0, 1e-2])
@pytest.mark.parametrize("error_state", [True, False, "cartpole", "car"],
                         ids=["error_state", "full_state", "cartpole", "car"])
def test_twin_matches_jax_sqrt_sweep_f64(error_state, rho_val):
    """The twin against the JAX package's sqrt_sweep in float64: the
    quadrotor's error state (12, 4) and full state (13, 4), and the small
    shapes the card also checks K1 at, the cartpole's (4, 1) and the car's
    (3, 2)."""
    A, Bj, e = _linearization(error_state)
    ns, nu = {True: (12, 4), False: (13, 4), "cartpole": (4, 1),
              "car": (3, 2)}[error_state]
    assert A.shape == (B, N - 1, ns, ns) and Bj.shape == (B, N - 1, ns, nu)
    ref, out = _run_both(A, Bj, e, np.full(B, rho_val), np.float64)
    assert not ref[4].any()
    assert out[0].shape == (B, N - 1, nu, ns)
    assert out[1].shape == (B, N - 1, nu)
    _assert_close(ref, out, ktol=1e-8, dtol=1e-8, vtol=1e-10)


def test_equilibrated_fallback_f32_and_fail_f64():
    """A mildly indefinite stage (equilibrated pivot −4e-4) on one lane.
    In float32 the plain factor breaks down, and the equilibrated one
    clamps the pivot to its 1e-7 floor and succeeds; in float64 (no
    clamp) both break down and the sweep reports the failure. The twin
    takes the same branch as the JAX sweep in both."""
    A, Bj, e = _linearization(True)
    _make_indefinite(e, lane=5, knot=7, off=1.0 + 2e-4)
    rho = np.zeros(B)
    ref, out = _run_both(A, Bj, e, rho, np.float32)
    assert not ref[4].any()
    # the f32 row of tests/test_pallas.py: d is not f32-determined at
    # stiff knots
    _assert_close(ref, out, ktol=2e-3, dtol=1e-1, vtol=3e-2)
    ref, out = _run_both(A, Bj, e, rho, np.float64)
    assert ref[4].tolist() == [i == 5 for i in range(B)]
    _assert_close(ref, out, ktol=1e-8, dtol=1e-8, vtol=1e-10)


@pytest.mark.parametrize("jump", [0.0, 1e-3], ids=["no_jump", "jump"])
def test_backward_pass_rho_retry_matches_jax(jump):
    """Two lanes need rho > 0 to factor; the batched retry bumps only the
    failing lanes (the others are re-swept at their own rho) until every
    lane factors, then decreases rho. ``jump`` is the scale-aware floor on
    a failing lane's next rho."""
    A, Bj, e = _linearization(True)
    _make_indefinite(e, lane=2, knot=4, off=1.5)
    _make_indefinite(e, lane=6, knot=15, off=1.05)
    rho0 = np.array([0.0, 1e-3, 0.0, 0.0, 0.5, 0.0, 0.0, 0.0])
    drho0 = np.ones(B)
    opts_j = JaxILQROptions(error_state=True, bp_type="sqrt")
    jexp = JExpansion(**{k: jnp.asarray(v) for k, v in e.items()})
    ref = jax.vmap(lambda a, b, ex, r, dr, rs: jax_backward_pass(
        a, b, ex, r, dr, opts_j, reg_scale=rs))(
        jnp.asarray(A), jnp.asarray(Bj), jexp, jnp.asarray(rho0),
        jnp.asarray(drho0), jnp.full((B,), jump))
    t = {k: torch.as_tensor(v) for k, v in e.items()}
    out = backward_pass(torch.as_tensor(A), torch.as_tensor(Bj),
                        Expansion(**t), torch.as_tensor(rho0),
                        torch.as_tensor(drho0),
                        iLQROptions(error_state=True, bp_type="sqrt"),
                        reg_scale=torch.full((B,), jump, dtype=torch.float64))
    K0, d0, v10, v20, rho_r, drho_r = (np.asarray(r) for r in ref)
    K1, d1, v11, v21, rho_o, drho_o = (o.numpy() for o in out)
    # the retry ran: the failing lanes end above their starting rho
    assert rho_r[2] > 0.0 and rho_r[6] > 0.0 and rho_r[0] == 0.0
    np.testing.assert_allclose(rho_o, rho_r, rtol=1e-12, atol=0)
    np.testing.assert_allclose(drho_o, drho_r, rtol=1e-12, atol=0)
    assert np.max(np.abs(K1 - K0)) <= 1e-8 * np.max(np.abs(K0))
    assert np.max(np.abs(d1 - d0)) <= 1e-8 * np.max(np.abs(d0))
    np.testing.assert_allclose(v11, v10, rtol=1e-10, atol=1e-5)
    np.testing.assert_allclose(v21, v20, rtol=1e-10, atol=1e-5)


@pytest.mark.parametrize("P", [0, 3])
def test_reg_noise_scale_matches_jax(P):
    """Per-lane ρ jump target ~100·ε·(max μ + 1); 0 without constraints."""
    rng = np.random.default_rng(7)
    mu = rng.uniform(0.0, 1e4, size=(B, N, P))
    ref = np.stack([np.asarray(jax_reg_noise_scale(jnp.asarray(m_), jnp.float32))
                    for m_ in mu])
    out = reg_noise_scale(torch.as_tensor(mu), torch.float32)
    assert out.shape == (B,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)
