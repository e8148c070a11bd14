"""The port's model layer against the JAX package, in float64 on the CPU.

Quadrotor dynamics, its RK3 step and the trajectory Jacobians, the
quaternion error state and the error-state projection, and the problem
carry-over of ``trajopt_tpu_torch.convert``: the same numpy inputs go
through both packages and are compared at the stated tolerances.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as tt_jax
from trajopt_tpu.models import quaternions as jquat
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.ops.cost import cost_expansion as jax_cost_expansion
from trajopt_tpu.ops.cost import total_cost as jax_total_cost
from trajopt_tpu.problems.zoo import quadrotor_line as jax_quadrotor_line

from trajopt_tpu_torch import convert
from trajopt_tpu_torch.models import quaternions as quat
from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.ops.cost import Expansion, cost_expansion, total_cost

torch.set_num_threads(1)

N = 21


def _states(rng, batch):
    """Random quadrotor states with unit quaternions, and controls."""
    x = rng.normal(size=(batch, 13))
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=-1, keepdims=True)
    u = np.abs(rng.normal(size=(batch, 4))) + 1.0
    return x, u


def _quat_mul(q, p):
    w1, v1, w2, v2 = q[0], q[1:], p[0], p[1:]
    return np.concatenate([[w1 * w2 - v1 @ v2],
                           w1 * v2 + w2 * v1 + np.cross(v1, v2)])


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_quadrotor_dynamics_matches_jax():
    x, u = _states(np.random.default_rng(0), 64)
    ref = jax.vmap(jzoo.quadrotor.dynamics)(jnp.asarray(x), jnp.asarray(u))
    out = zoo.quadrotor.dynamics(_t(x), _t(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)


def test_rk3_step_matches_jax():
    x, u = _states(np.random.default_rng(1), 64)
    jm = tt_jax.discretize(jzoo.quadrotor, "rk3")
    ref = jax.vmap(lambda a, b: jm.step(a, b, 0.05))(jnp.asarray(x),
                                                       jnp.asarray(u))
    out = discretize(zoo.quadrotor, "rk3").step(_t(x), _t(u), 0.05)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-10)


def test_jacobian_traj_matches_jax():
    """A and B at every knot of a batch of trajectories: one
    ``torch.func.vmap`` over the B·(N-1) knots against JAX's vmap."""
    rng = np.random.default_rng(2)
    Bz = 3
    x, u = _states(rng, Bz * (N - 1))
    X = x.reshape(Bz, N - 1, 13)
    U = u.reshape(Bz, N - 1, 4)
    dt = 0.25
    jm = tt_jax.discretize(jzoo.quadrotor, "rk3")
    A_ref, B_ref = jax.vmap(lambda X_, U_: jm.jacobian_traj(X_, U_, dt))(
        jnp.asarray(X), jnp.asarray(U))
    A, B = discretize(zoo.quadrotor, "rk3").jacobian_traj(_t(X), _t(U), dt)
    assert A.shape == (Bz, N - 1, 13, 13) and B.shape == (Bz, N - 1, 13, 4)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_ref), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(B.numpy(), np.asarray(B_ref), rtol=0,
                               atol=1e-10)


def test_state_diff_matches_jax():
    """Quaternion error state, including a pair near the 180-degree
    singularity where the sign-preserving 1e-6 floor engages."""
    rng = np.random.default_rng(3)
    x, _ = _states(rng, 32)
    xr, _ = _states(rng, 32)
    # x_ref[0] = x[0] rotated by almost 180 degrees: the relative
    # quaternion's scalar part is 5e-7, below the floor
    c = 5e-7
    xr[0] = x[0]
    xr[0, 3:7] = _quat_mul(x[0, 3:7], np.array([c, np.sqrt(1 - c * c), 0, 0]))
    ref = jax.vmap(lambda a, b: jquat.state_diff(a, b, (3, 7)))(
        jnp.asarray(x), jnp.asarray(xr))
    out = quat.state_diff(_t(x), _t(xr), (3, 7))
    ref = np.asarray(ref)
    assert out.shape == (32, 12)
    assert abs(ref[0, 3]) > 1e6      # the floor engaged: 2·|v|/1e-6
    np.testing.assert_allclose(out.numpy()[1:], ref[1:], rtol=1e-12,
                               atol=1e-12)
    # relative to the floored lane's scale: its off-axis entries are
    # rounding noise of the vector part times 2e6
    np.testing.assert_allclose(out.numpy()[0], ref[0], rtol=1e-12,
                               atol=1e-12 * np.abs(ref[0]).max())
    plain = quat.state_diff(_t(x), _t(xr), None)
    np.testing.assert_array_equal(plain.numpy(), x - xr)


def _expansion_arrays(rng, Bz, n, m):
    return dict(
        x=rng.normal(size=(Bz, N, n)), u=rng.normal(size=(Bz, N - 1, m)),
        xx=rng.normal(size=(Bz, N, n, n)),
        uu=rng.normal(size=(Bz, N - 1, m, m)),
        ux=rng.normal(size=(Bz, N - 1, m, n)))


def test_project_error_state_matches_jax():
    rng = np.random.default_rng(4)
    Bz = 2
    x, _ = _states(rng, Bz * N)
    X = x.reshape(Bz, N, 13)
    A = rng.normal(size=(Bz, N - 1, 13, 13))
    B = rng.normal(size=(Bz, N - 1, 13, 4))
    e = _expansion_arrays(rng, Bz, 13, 4)
    from trajopt_tpu.ops.cost import Expansion as JExpansion

    jexp = JExpansion(**{k: jnp.asarray(v) for k, v in e.items()})
    A_r, B_r, e_r = jquat.project_error_state(
        jnp.asarray(X), jnp.asarray(A), jnp.asarray(B), jexp, (3, 7))
    A_e, B_e, e_e = quat.project_error_state(
        _t(X), _t(A), _t(B), Expansion(**{k: _t(v) for k, v in e.items()}),
        (3, 7))
    assert A_e.shape == (Bz, N - 1, 12, 12) and B_e.shape == (Bz, N - 1, 12, 4)
    for got, ref in ((A_e, A_r), (B_e, B_r), (e_e.x, e_r.x), (e_e.u, e_r.u),
                     (e_e.xx, e_r.xx), (e_e.uu, e_r.uu), (e_e.ux, e_r.ux)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("quantity", ["total_cost", "cost_expansion"])
def test_convert_round_trip_cost(quantity):
    """The JAX problem carried over by ``convert`` gives the same total
    cost and cost expansion on the same trajectories."""
    pj = jax_quadrotor_line(N=N, dtype=jnp.float64, distance=20.0)
    prob = convert.problem_from_arrays(**convert.problem_arrays(pj),
                                       device="cpu")
    assert (prob.N, prob.dt, prob.tf) == (N, float(pj.dt), float(pj.tf))
    rng = np.random.default_rng(5)
    X = np.asarray(pj.x0) + rng.normal(size=(3, N, 13))
    U = np.asarray(pj.U) + rng.normal(size=(3, N - 1, 4))
    dtj = pj.dt_traj()
    if quantity == "total_cost":
        ref = jax.vmap(lambda X_, U_: jax_total_cost(pj.obj, X_, U_, dtj))(
            jnp.asarray(X), jnp.asarray(U))
        out = total_cost(prob.obj, _t(X), _t(U), prob.dt_traj())
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)
    else:
        ref = jax.vmap(lambda X_, U_: jax_cost_expansion(pj.obj, X_, U_,
                                                         dtj))(
            jnp.asarray(X), jnp.asarray(U))
        out = cost_expansion(prob.obj, _t(X), _t(U), prob.dt_traj())
        for name in ("x", "u", "xx", "uu", "ux"):
            np.testing.assert_allclose(
                getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                rtol=1e-12, atol=1e-12, err_msg=name)


def test_import_leaves_jax_out():
    """The port never imports JAX, directly or through a dependency."""
    code = ("import sys, trajopt_tpu_torch, trajopt_tpu_torch.convert, "
            "trajopt_tpu_torch.parallel.batch, trajopt_tpu_torch.kernels."
            "_build; bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m == 'trajopt_tpu' or m.startswith(('jax.', 'jaxlib', "
            "'trajopt_tpu.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_jacobian_traj_keeps_float32():
    """float32 trajectories give float32 Jacobians (no promotion inside
    ``torch.func.jacfwd``), equal to the float64 ones to f32 accuracy."""
    x, u = _states(np.random.default_rng(6), 2 * (N - 1))
    X, U = x.reshape(2, N - 1, 13), u.reshape(2, N - 1, 4)
    model = discretize(zoo.quadrotor, "rk3")
    A32, B32 = model.jacobian_traj(_t(X).float(), _t(U).float(), 0.05)
    A64, B64 = model.jacobian_traj(_t(X), _t(U), 0.05)
    assert A32.dtype == B32.dtype == torch.float32
    np.testing.assert_allclose(A32.numpy(), A64.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(B32.numpy(), B64.numpy(), rtol=0, atol=1e-4)
