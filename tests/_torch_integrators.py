"""Shared by ``tests/test_torch_integrators*.py``: points of the models,
the scale-relative comparison, and each rule's step and Jacobians of a
scalar model against the JAX package.

The explicit rules' Jacobians are ``torch.func.jacfwd`` through the step,
as the JAX package's, held within 1e-10. The implicit rules' come from the
implicit-function theorem at the converged step
(``models/base.py::implicit_jacobian``); the JAX package differentiates
through its Newton loop, whose tangent is the last trip's, taken at the
iterate before the last, so the two differ by about that iterate's residual
times the step's sensitivity. Measured on the scalar models at these points:
at most 3.4e-11 of scale (the cart-pole under the implicit midpoint;
7.7e-11 at seed 0's points, 1.8e-11 on the URDF cart-pole rig), 1e-12 or
less on the others; held at IMPLICIT_JAC_TOL = 1e-9, and against central
differences of the port's own converged step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import zoo as jzoo

import trajopt_tpu_torch as tt
from trajopt_tpu_torch.models import zoo

jax.config.update("jax_enable_x64", True)

RULES = ("euler", "midpoint", "rk3", "rk4", "midpoint_implicit",
         "rk3_implicit")
IMPLICIT_JAC_TOL = 1e-9
DT = 0.1


def points(name, count=4, seed=0):
    """``count`` states and controls of model ``name`` with N(0, 0.3²)
    entries (the quadrotor's quaternion near identity, its thrust near
    hover)."""
    model = zoo.MODELS[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(count, model.n)) * 0.3
    u = rng.normal(size=(count, model.m)) * 0.3
    if name == "quadrotor":
        x[:, 3] += 1.0
        u += 1.2
    return x, u


def scale_close(a, b, tol):
    """max |a − b| within ``tol`` of max(1, max |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(1.0, float(np.abs(b).max()))
    err = float(np.abs(a - b).max())
    assert err <= tol * scale, (err, tol * scale)
    return err / scale


def central_differences(step, x, u, dt, h=1e-6):
    """∂step/∂(x, u, dt) at (x, u, dt) by central differences, every
    perturbed point in one batched call."""
    Bz, n = x.shape
    m = u.shape[-1]
    k = n + m + 1
    eye = torch.eye(k, dtype=x.dtype) * h
    xs = torch.cat([x[:, None] + eye[None, :, :n], x[:, None]
                    - eye[None, :, :n]], dim=1)
    us = torch.cat([u[:, None] + eye[None, :, n:n + m], u[:, None]
                    - eye[None, :, n:n + m]], dim=1)
    dts = torch.cat([dt + eye[:, -1], dt - eye[:, -1]])
    y = step(xs.reshape(-1, n), us.reshape(-1, m),
             dts.repeat(Bz)[:, None]).reshape(Bz, 2, k, n)
    J = ((y[:, 0] - y[:, 1]) / (2 * h)).transpose(-1, -2)
    return J[..., :n], J[..., n:n + m], J[..., -1]


def steps_and_jacobians_match_jax(name, implicit_jac=True, rules=RULES):
    """Each rule's step of scalar model ``name`` at three points (dt = 0.1),
    batched, within 1e-12 of the JAX package's, and A, B
    (``jacobian_traj``) and ∂x⁺/∂dt against the JAX package's ``jacfwd``
    of its step (one compile a rule gives both): the explicit rules within
    1e-10, the implicit ones within IMPLICIT_JAC_TOL; with
    ``implicit_jac`` False the implicit rules' Jacobians are left to the
    central differences of ``tests/test_torch_integrators.py``. ``rules``:
    the rules to check (a JAX compile each)."""
    x, u = points(name, count=3, seed=1)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    dt = torch.full((3,), DT, dtype=torch.float64)
    for rule in rules:
        jstep = jtt.discretize(getattr(jzoo, name), rule).step
        implicit = "implicit" in rule
        if implicit and not implicit_jac:
            want = jax.jit(jax.vmap(jstep, (0, 0, None)))(
                jnp.asarray(x), jnp.asarray(u), DT)
        else:
            want, (JA, JB, Jt) = jax.jit(jax.vmap(lambda x, u, dt: (
                jstep(x, u, dt), jax.jacfwd(jstep, argnums=(0, 1, 2))(
                    x, u, dt)), (0, 0, None)))(
                jnp.asarray(x), jnp.asarray(u), DT)
        md = tt.discretize(zoo.MODELS[name], rule)
        scale_close(md.step(xt, ut, DT).numpy(), want, 1e-12)
        if implicit and not implicit_jac:
            continue
        A, B = md.jacobian_traj(xt, ut, DT)
        tol = IMPLICIT_JAC_TOL if implicit else 1e-10
        scale_close(A.numpy(), JA, tol)
        scale_close(B.numpy(), JB, tol)
        if md._jac_dt is None:
            sdt = torch.func.vmap(torch.func.jacfwd(md.step, argnums=2))(
                xt, ut, dt)
        else:
            _, _, sdt = md._jac_dt(xt, ut, dt)
        scale_close(sdt.numpy(), Jt, tol)
