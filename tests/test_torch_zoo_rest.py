"""The rest of the zoo of the port against the JAX package, on the CPU in
float64.

``ballonbeam`` and ``quadrotor_euler`` (the dynamics, the rpy helpers, the
RK3 step and its ``torch.func`` Jacobians at 1e-12, the Euler model's Ġ by
``torch.func.jvp`` under ``jacfwd`` among them), the port of
tests/test_core.py:324-385 (the Euler-angle quadrotor traces the quaternion
quadrotor's motion, the same tolerances), the quaternion helpers at 1e-14,
``quadrotor()`` and ``quad_obs()`` (fields, constraint stacks' values,
Jacobians and canonical descriptors against the JAX package's at 1e-12, and
a canonical stack, so both run fused), ``initial_controls``, ``cost``,
``max_violation``, ``line_trajectory``, and the ``convert.py`` round trip of
a problem with the per-interval steps of a minimum-time solve. And
``fused=True`` on ballonbeam or the Euler-angle quadrotor runs phase-split,
as in the JAX package: the same iterates as ``fused=False``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import quaternions as jquat
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.problem import cost as jcost_of
from trajopt_tpu.problem import max_violation as jmax_violation
from trajopt_tpu.problems import zoo as jprobs
from trajopt_tpu.utils.interp import line_trajectory as jline

import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.models import quaternions as quat
from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.ops.canonical import canonical_stack
from trajopt_tpu_torch.ops.cuda_models import find_cuda_model
from trajopt_tpu_torch.problem import cost, max_violation
from trajopt_tpu_torch.problems import zoo as probs
from trajopt_tpu_torch.solvers.ilqr import (
    ALFusedMeta, _fused_al_eligible, _fused_eligible, iLQROptions,
)
from trajopt_tpu_torch.utils.interp import line_trajectory

torch.set_num_threads(1)

MODELS = ("ballonbeam", "quadrotor_euler")


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, float(np.abs(b).max()))


def _states(name, B, seed):
    """States a model meets: the Euler angles within ±0.6 rad."""
    x = _rand((B, zoo.MODELS[name].n), seed) * 0.5
    if name == "quadrotor_euler":
        x[:, 3:6] = np.clip(x[:, 3:6], -0.6, 0.6)
    return x


# ------------------------------------------------------------ the models

@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax(name):
    """Dynamics, RK3 step and the trajectory Jacobians of the model
    against the JAX package's at 1e-12, a batch of five; the model is in
    ``MODELS`` and has a K2-only CUDA step."""
    m_t, m_j = zoo.MODELS[name], jzoo.MODELS[name]
    assert (m_t.n, m_t.m) == (m_j.n, m_j.m)
    x, u = _states(name, 5, 1), _rand((5, m_t.m), 2)
    _close(m_t.dynamics(torch.tensor(x), torch.tensor(u)),
           jax.vmap(m_j.dynamics)(jnp.asarray(x), jnp.asarray(u)))
    dt_, dj = tt.discretize(m_t, "rk3"), jtt.discretize(m_j, "rk3")
    assert dt_.cuda_step == name
    cm = find_cuda_model(dt_, k2_only_ok=True)
    assert cm.label == name and cm.k2_only
    assert find_cuda_model(dt_) is None
    _close(dt_.step(torch.tensor(x), torch.tensor(u), 0.05),
           jax.vmap(lambda a, b: dj.step(a, b, 0.05))(jnp.asarray(x),
                                                      jnp.asarray(u)))
    A, B = dt_.jacobian_traj(torch.tensor(x)[None], torch.tensor(u)[None],
                             0.05)
    Aj, Bj = jax.vmap(dj._jac)(jnp.asarray(x), jnp.asarray(u),
                               jnp.full((5,), 0.05))
    _close(A[0], Aj)
    _close(B[0], Bj)
    A32, _ = dt_.jacobian_traj(torch.tensor(x, dtype=torch.float32)[None],
                               torch.tensor(u, dtype=torch.float32)[None],
                               0.05)
    assert A32.dtype == torch.float32


def test_rpy_helpers_match_jax():
    """The Euler model's rotation matrix and its two rate maps, a batch of
    four angle triples."""
    rpy = _rand((4, 3), 3) * 0.6
    for name in ("_rpy2rotmat", "_rpydot2angularvel_matrix",
                 "_angularvel2rpydot_matrix"):
        got = getattr(zoo, name)(torch.tensor(rpy))
        for b in range(4):
            _close(got[b], getattr(jzoo, name)(jnp.asarray(rpy[b])))


def test_quadrotor_euler_matches_quaternion_model():
    """tests/test_core.py:324-385: from a matched aggressive non-hover
    state under the same asymmetric controls, the Euler-angle quadrotor
    traces the quaternion quadrotor's motion over 0.3 s (RK4, dt = 1e-3):
    position within 1e-6, velocity, attitude and body rates within 1e-5."""
    f64 = torch.float64
    rpy0 = torch.tensor([0.3, -0.25, 0.6], dtype=f64)
    rpyd0 = torch.tensor([0.8, -0.5, 0.4], dtype=f64)
    vel0 = torch.tensor([1.0, -2.0, 0.5], dtype=f64)
    pos0 = torch.tensor([0.0, 0.0, 10.0], dtype=f64)
    R0 = zoo._rpy2rotmat(rpy0)
    omega0 = R0.T @ (zoo._rpydot2angularvel_matrix(rpy0) @ rpyd0)

    def rpy_to_quat(rpy):
        hr, hp, hy = rpy / 2.0
        z = torch.zeros((), dtype=f64)
        qx = torch.stack([torch.cos(hr), torch.sin(hr), z, z])
        qy = torch.stack([torch.cos(hp), z, torch.sin(hp), z])
        qz = torch.stack([torch.cos(hy), z, z, torch.sin(hy)])
        return zoo.quat_mul(qz, zoo.quat_mul(qy, qx))

    x_e = torch.cat([pos0, rpy0, vel0, rpyd0])
    x_q = torch.cat([pos0, rpy_to_quat(rpy0), vel0, omega0])
    u = torch.tensor([1.6, 1.1, 1.3, 0.9], dtype=f64)
    dt = 1e-3

    def sim(f, x):
        for _ in range(300):
            k1 = f(x, u)
            k2 = f(x + 0.5 * dt * k1, u)
            k3 = f(x + 0.5 * dt * k2, u)
            k4 = f(x + dt * k3, u)
            x = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        return x

    xe = sim(zoo.quadrotor_euler_dynamics, x_e)
    xq = sim(zoo.quadrotor_dynamics, x_q)
    assert np.allclose(xe[0:3], xq[0:3], atol=1e-6)
    assert np.allclose(xe[6:9], xq[7:10], atol=1e-5)
    R_e = zoo._rpy2rotmat(xe[3:6])
    q_T = xq[3:7] / xq[3:7].norm()
    R_q = torch.stack([zoo.quat_rotate(q_T, e) for e in torch.eye(
        3, dtype=f64)], dim=1)
    assert np.allclose(R_e.numpy(), R_q.numpy(), atol=1e-5)
    omega_e = R_e.T @ (zoo._rpydot2angularvel_matrix(xe[3:6]) @ xe[9:12])
    assert np.allclose(omega_e.numpy(), xq[10:13].numpy(), atol=1e-5)


def test_quaternion_helpers_match_jax():
    """skew, Lmult, Rmult, quat_to_rotmat, normalize, quat_error_jacobian,
    state_diff_jacobian and its inverse against the JAX package's for a
    batch of three, and the identities they encode."""
    q = _rand((3, 4), 4)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    v = _rand((3, 3), 5)
    x = _rand((3, 13), 6)
    x[:, 3:7] = qn
    p = _rand((3, 4), 7)
    pairs = [(quat.skew, jquat.skew, v), (quat.Lmult, jquat.Lmult, q),
             (quat.Rmult, jquat.Rmult, q),
             (quat.quat_to_rotmat, jquat.quat_to_rotmat, qn),
             (quat.normalize, jquat.normalize, q),
             (quat.quat_error_jacobian, jquat.quat_error_jacobian, qn)]
    for f_t, f_j, a in pairs:
        got = f_t(torch.tensor(a))
        for b in range(3):
            _close(got[b], f_j(jnp.asarray(a[b])), 1e-14)
    for f_t, f_j in ((quat.state_diff_jacobian, jquat.state_diff_jacobian),
                     (quat.state_diff_jacobian_inv,
                      jquat.state_diff_jacobian_inv)):
        got = f_t(torch.tensor(x), (3, 7))
        for b in range(3):
            _close(got[b], f_j(jnp.asarray(x[b]), (3, 7)), 1e-14)
    qt, pt = torch.tensor(qn), torch.tensor(p)
    _close((quat.Lmult(qt) @ pt[..., None])[..., 0], zoo.quat_mul(qt, pt),
           1e-14)
    _close((quat.Rmult(qt) @ pt[..., None])[..., 0], zoo.quat_mul(pt, qt),
           1e-14)
    E = quat.state_diff_jacobian(torch.tensor(x), (3, 7))
    Ei = quat.state_diff_jacobian_inv(torch.tensor(x), (3, 7))
    _close(Ei @ E, torch.eye(12, dtype=torch.float64).expand(3, 12, 12),
           1e-14)


# ------------------------------------------------------------ the problems

@pytest.mark.parametrize("name", ("quadrotor", "quad_obs"))
def test_quadrotor_problems_match_jax(name):
    """``quadrotor()`` and ``quad_obs()`` against the JAX package's: the
    fields, the constraint stack's labels, masks, values and Jacobians at
    random (X, U) at 1e-12 and its canonical descriptors; the port's stack
    is canonical (so the constrained solve runs fused on K3/K4), and the
    problem carried over as arrays equals the one built by name."""
    pt = getattr(probs, name)(device="cpu")
    pj = getattr(jprobs, name)()
    assert convert.PROBLEMS[name] is getattr(probs, name)
    for k in ("x0", "xf", "U"):
        _close(getattr(pt, k), getattr(pj, k), 0)
    for k in convert.OBJECTIVE_FIELDS:
        _close(getattr(pt.obj, k), getattr(pj.obj, k), 0)
    assert (pt.N, pt.dt, pt.tf) == (pj.N, float(pj.dt), float(pj.tf))
    cs, csj = pt.constraints, pj.constraints
    assert cs.labels() == csj.labels()
    np.testing.assert_array_equal(cs.mask.numpy(), np.asarray(csj.mask))
    np.testing.assert_array_equal(cs.is_eq.numpy(), np.asarray(csj.is_eq))
    X, U = _rand((pt.N, 13), 8) * 5.0, _rand((pt.N - 1, 4), 9)
    _close(cs.evaluate(torch.tensor(X), torch.tensor(U)),
           csj.evaluate(jnp.asarray(X), jnp.asarray(U)))
    for a, b in zip(cs.jacobian(torch.tensor(X), torch.tensor(U)),
                    csj.jacobian(jnp.asarray(X), jnp.asarray(U))):
        _close(a, b)
    for c, cj in zip(cs.cons, csj.cons):
        for a, b in zip(c.canon[1:], cj.canon[1:]):
            if isinstance(a, tuple):
                assert a == tuple(b)
            else:
                _close(a, b, 0)
    assert canonical_stack(cs, 13, 4, dtype=torch.float64) is not None
    carried = convert.problem_from_arrays(**convert.problem_arrays(pj),
                                          device="cpu")
    _close(carried.constraints.evaluate(torch.tensor(X), torch.tensor(U)),
           cs.evaluate(torch.tensor(X), torch.tensor(U)), 0)


def test_problem_helpers_match_jax():
    """``initial_controls`` (a trajectory, and one control held), ``cost``,
    ``max_violation`` and ``line_trajectory`` against the JAX package's."""
    pt, pj = probs.quad_obs(device="cpu"), jprobs.quad_obs()
    U = _rand((pt.N - 1, 4), 10) + 1.0
    for U0 in (U, U[0]):
        a = tt.initial_controls(pt, U0)
        b = jtt.initial_controls(pj, U0)
        _close(a.U, b.U, 0)
    X = _rand((pt.N, 13), 11)
    a = tt.update_problem(tt.initial_controls(pt, U), X=torch.tensor(X))
    b = jtt.update_problem(jtt.initial_controls(pj, U), X=jnp.asarray(X))
    _close(cost(a), jcost_of(b))
    _close(max_violation(a), jmax_violation(b))
    _close(line_trajectory(np.zeros(3), [1.0, 2.0, -1.0], 7),
           jline(np.zeros(3), [1.0, 2.0, -1.0], 7), 0)


def test_convert_round_trip_with_per_interval_dt():
    """A problem with the per-interval steps of a solved minimum-time
    problem (the JAX package's ``dt_traj`` of the result) carries over: its
    arrays, ``dt_traj`` and cost equal the JAX problem's, and a CPU solve
    runs on it; a uniform dt stays a float; the new models carry over by
    name."""
    pj = jprobs.pendulum()
    dts = np.linspace(0.1, 0.2, pj.N - 1)
    pjd = jtt.update_problem(pj, dt=jnp.asarray(dts))
    arrays = convert.problem_arrays(pjd)
    assert arrays["dt"].shape == (pj.N - 1,)
    pt = convert.problem_from_arrays(**arrays, device="cpu")
    _close(pt.dt_traj(), pjd.dt_traj(), 0)
    X = _rand((pj.N, 2), 12)
    _close(cost(tt.update_problem(pt, X=torch.tensor(X))),
           jcost_of(jtt.update_problem(pjd, X=jnp.asarray(X))))
    res = tt.al_solve(pt, tt.ALOptions(iterations=1, opts_uncon=iLQROptions(
        iterations=3)))
    assert bool(torch.isfinite(res.X).all())
    assert isinstance(convert.problem_from_arrays(
        **convert.problem_arrays(pj), device="cpu").dt, float)
    for name in MODELS:
        assert convert.MODELS[name] is zoo.MODELS[name]


# ------------------------------------------------------------ dispatch

def _small_problem(name, constrained):
    """A short LQR problem of the model (N = 11), with a control box if
    ``constrained``."""
    model = tt.discretize(zoo.MODELS[name], "rk3")
    n, m, N = model.n, model.m, 11
    x0 = np.zeros(n)
    x0[:3] = [0.3, -0.2, 0.1] if name == "quadrotor_euler" else [0.3, 0.1,
                                                                 0.0]
    u0 = 0.5 * 9.81 / 4.0 if name == "quadrotor_euler" else 0.0
    cons = None
    if constrained:
        cons = tt.ConstraintSetBuilder(N)
        cons.add(tt.bound_constraint(n, m, u_min=-5.0, u_max=5.0))
    return tt.problem(model, tt.LQRObjective(np.eye(n), np.eye(m) * 0.1,
                                             np.eye(n) * 10.0, np.zeros(n),
                                             N, device="cpu"),
                      constraints=cons, x0=x0, xf=np.zeros(n), N=N, dt=0.05,
                      U0=np.full((N - 1, m), u0), device="cpu")


@pytest.mark.parametrize("name", MODELS)
def test_fused_runs_phase_split_for_models_without_a_lane_step(name):
    """The JAX package gives ballonbeam and the Euler-angle quadrotor no
    lane step, so it never runs them fused: neither does the port.
    ``fused=True`` (unconstrained) and the default fused AL (constrained,
    a canonical stack) are not eligible, and their solves run the same
    iterates as ``fused=False`` / ``fused_al=False``."""
    p_free = _small_problem(name, False)
    p_con = _small_problem(name, True)
    fused = iLQROptions(iterations=5, fused=True)
    assert not _fused_eligible(p_free.model, fused, p_free.obj)
    canon = canonical_stack(p_con.constraints, p_con.n, p_con.m,
                            dtype=torch.float64)
    assert canon is not None
    meta = ALFusedMeta(objective=p_con.obj, cs=p_con.constraints,
                       canon=canon, lam=None, mu=None, atol=0.0)
    assert not _fused_al_eligible(p_con.model, fused, meta)
    for p, off in ((p_free, iLQROptions(iterations=5)),
                   (p_con, iLQROptions(iterations=5, fused_al=False))):
        a = tt.al_solve(p, tt.ALOptions(iterations=2, opts_uncon=fused))
        b = tt.al_solve(p, tt.ALOptions(iterations=2, opts_uncon=off))
        np.testing.assert_array_equal(a.X.numpy(), b.X.numpy())
        assert bool(torch.isfinite(a.X).all())
