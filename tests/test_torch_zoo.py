"""The port's scalar models and zoo problems against the JAX package, on the
CPU.

Pendulum, double integrator, car and cartpole: dynamics, RK3 step and
trajectory Jacobians in float64 against ``trajopt_tpu.models.zoo`` on the
same numpy inputs at 1e-12, and float32 in, float32 out. The five zoo
problems that use them (``doubleintegrator``, ``pendulum``, ``cartpole``,
``parallel_park``, ``car_3obs``) against the JAX problems carried over as
numpy arrays by ``trajopt_tpu_torch.convert``. The full-state closed-loop
rollout (the plain version of kernel K2 at ``quat_slice=None``) against
``vmap(rollout_closed_loop)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as tt_jax
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.ops.rollout import rollout_closed_loop as jax_closed_loop
from trajopt_tpu.problems import zoo as jproblems

from trajopt_tpu_torch import convert
from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.ops.cuda_models import CUDA_STEPS, cuda_model
from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
from trajopt_tpu_torch.problems import zoo as problems

torch.set_num_threads(1)

MODELS = ("pendulum", "doubleintegrator", "car", "cartpole")
PROBLEMS = ("doubleintegrator", "pendulum", "cartpole", "parallel_park",
            "car_3obs")
TOL = 1e-12


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _inputs(name, batch, seed):
    m = getattr(zoo, name)
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, m.n)), rng.normal(size=(batch, m.m))


@pytest.mark.parametrize("name", MODELS)
def test_dynamics_matches_jax(name):
    x, u = _inputs(name, 64, 0)
    ref = jax.vmap(getattr(jzoo, name).dynamics)(jnp.asarray(x),
                                                  jnp.asarray(u))
    out = getattr(zoo, name).dynamics(_t(x), _t(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", MODELS)
def test_rk3_step_matches_jax(name):
    x, u = _inputs(name, 64, 1)
    jm = tt_jax.discretize(getattr(jzoo, name), "rk3")
    ref = jax.vmap(lambda a, b: jm.step(a, b, 0.07))(jnp.asarray(x),
                                                       jnp.asarray(u))
    out = discretize(getattr(zoo, name), "rk3").step(_t(x), _t(u), 0.07)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", MODELS)
def test_jacobian_traj_matches_jax(name):
    """A and B at every knot of a batch of trajectories, with a dt per
    knot."""
    Bz, Nm1 = 3, 20
    x, u = _inputs(name, Bz * Nm1, 2)
    n, m = x.shape[-1], u.shape[-1]
    X, U = x.reshape(Bz, Nm1, n), u.reshape(Bz, Nm1, m)
    dt = np.linspace(0.02, 0.1, Nm1)
    jm = tt_jax.discretize(getattr(jzoo, name), "rk3")
    Aj, Bj = jax.vmap(lambda a, b: jm.jacobian_traj(a, b, jnp.asarray(dt)))(
        jnp.asarray(X), jnp.asarray(U))
    A, Bm = discretize(getattr(zoo, name), "rk3").jacobian_traj(
        _t(X), _t(U), _t(dt))
    assert A.shape == (Bz, Nm1, n, n) and Bm.shape == (Bz, Nm1, n, m)
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), rtol=0, atol=TOL)
    np.testing.assert_allclose(Bm.numpy(), np.asarray(Bj), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", MODELS)
def test_float32_stays_float32(name):
    """Dynamics, step and the ``torch.func`` Jacobians of a float32 input
    are float32 (a Python float times a 0-d element would promote), and
    agree with float64 at 1e-5."""
    x, u = _inputs(name, 8, 3)
    md = discretize(getattr(zoo, name), "rk3")
    x32, u32 = _t(x, torch.float32), _t(u, torch.float32)
    outs32 = (md.model.dynamics(x32, u32), md.step(x32, u32, 0.05),
              *md.jacobian_traj(x32, u32, 0.05))
    outs64 = (md.model.dynamics(_t(x), _t(u)), md.step(_t(x), _t(u), 0.05),
              *md.jacobian_traj(_t(x), _t(u), 0.05))
    for a, b in zip(outs32, outs64):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MODELS + ("quadrotor",))
def test_rk3_models_carry_a_cuda_step(name):
    """The (model, "rk3") pairs the JAX package ships a lane step for are
    the ones the fused CUDA kernels carry; under another integrator only
    the rollout kernel K2 carries the model (k2_only), as the JAX package
    has no lane step for it."""
    jm = tt_jax.discretize(getattr(jzoo, name), "rk3")
    assert getattr(jm, "step_lanes", None) is not None
    md = discretize(getattr(zoo, name), "rk3")
    assert md.cuda_step in CUDA_STEPS
    cm = cuda_model(md, "test")
    assert (cm.n, cm.m, cm.label) == (md.n, md.m, name)
    other = discretize(getattr(zoo, name), "rk4")
    assert other.cuda_step == name
    with pytest.raises(NotImplementedError, match="K6"):
        cuda_model(other, "test")
    k2 = cuda_model(other, "test", k2_only_ok=True)
    assert k2.k2_only and (k2.id, k2.label) == (cm.id, f"{name}_under_rk4")


@pytest.mark.parametrize("name", PROBLEMS)
def test_zoo_problem_matches_jax(name):
    """The port's factory equals the JAX problem carried over as arrays:
    seeds, objective stacks, times, and the constraint set (mask, equality
    flags, and its values on a random trajectory at 1e-12)."""
    pj = getattr(jproblems, name)(dtype=jnp.float64)
    arrays = convert.problem_arrays(pj)
    assert arrays["model"] == pj.model.name and arrays["integrator"] == "rk3"
    carried = convert.problem_from_arrays(**arrays, device="cpu")
    mine = getattr(problems, name)(device="cpu")
    for field in ("x0", "xf", "X", "U"):
        a, b = getattr(mine, field).numpy(), getattr(carried, field).numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b)), field
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   rtol=0, atol=1e-15, err_msg=field)
        np.testing.assert_allclose(np.nan_to_num(a),
                                   np.nan_to_num(np.asarray(getattr(pj, field))),
                                   rtol=0, atol=1e-15, err_msg=field)
    for field in convert.OBJECTIVE_FIELDS:
        np.testing.assert_allclose(getattr(mine.obj, field).numpy(),
                                   getattr(carried.obj, field).numpy(),
                                   rtol=1e-15, atol=1e-15, err_msg=field)
    assert (mine.N, mine.model.name) == (carried.N, carried.model.name)
    assert abs(mine.dt - carried.dt) < 1e-15 and abs(mine.tf - carried.tf) < 1e-13
    assert mine.model.cuda_step == carried.model.cuda_step is not None

    cj = pj.constraints
    rng = np.random.default_rng(4)
    X = rng.normal(size=(mine.N, mine.n))
    U = rng.normal(size=(mine.N - 1, mine.m))
    Cj = np.asarray(cj.evaluate(jnp.asarray(X), jnp.asarray(U)))
    for prob in (mine, carried):
        cs = prob.constraints
        assert cs.P == cj.P
        assert np.array_equal(cs.mask.numpy(), np.asarray(cj.mask))
        assert np.array_equal(cs.is_eq.numpy(), np.asarray(cj.is_eq))
        np.testing.assert_allclose(cs.evaluate(_t(X), _t(U)).numpy(), Cj,
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ("cartpole", "car"))
def test_full_state_closed_loop_rollout_matches_jax(name):
    """The plain version of kernel K2 on the full state
    (``quat_slice=None``, ns = n) against ``vmap(rollout_closed_loop)``,
    float64: problem 1's feedforward is blown up so that it trips the
    divergence guard; ok masks equal, X̄ and Ū at 1e-10."""
    Bz, N = 4, 21
    md = discretize(getattr(zoo, name), "rk3")
    jm = tt_jax.discretize(getattr(jzoo, name), "rk3")
    n, m = md.n, md.m
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(Bz, n)) * 0.1
    X = rng.normal(size=(Bz, N, n)) * 0.1
    U = rng.normal(size=(Bz, N - 1, m)) * 0.1
    K = rng.normal(size=(Bz, N - 1, m, n)) * 0.3
    d = rng.normal(size=(Bz, N - 1, m)) * 0.1
    d[1] *= 1e12
    alpha = np.array([1.0, 0.5, 0.25, 0.125])
    ref = jax.vmap(lambda *a: jax_closed_loop(jm, *a, 0.05))(
        *(jnp.asarray(a) for a in (x0, X, U, K, d, alpha)))
    Xr, Ur, okr = (np.asarray(a) for a in ref)
    Xn, Un, ok = rollout_closed_loop_cuda(
        md, *(_t(a) for a in (x0, X, U, K, d, alpha)), 0.05)
    assert ok.tolist() == okr.tolist() == [True, False, True, True]
    np.testing.assert_allclose(Xn.numpy()[okr], Xr[okr], rtol=0, atol=1e-10)
    np.testing.assert_allclose(Un.numpy()[okr], Ur[okr], rtol=0, atol=1e-10)
