"""Dynamics model abstraction.

Counterpart of ``trajopt_tpu/models/base.py``. A ``Model`` wraps a continuous
dynamics function ``f(x, u) -> xdot`` written in tensor ops that broadcast
over leading batch dimensions; ``discretize`` turns it into a
``DiscreteModel`` with a ``step(x, u, dt)`` and trajectory Jacobians from
``torch.func.jacfwd`` vmapped over every knot of every problem at once (for
a rigid-body chain under an explicit rule, from its structured
linearization chained through the stages instead; under an implicit rule,
for every model, from the implicit-function theorem at the converged step).
``discretize_uncertain`` gives the discrete step ``F(x, u, w, dt)`` of an
uncertain model ``f(x, u, w)``.
"""
from __future__ import annotations

import torch

from trajopt_tpu_torch.ops.cuda_models import CUDA_STEPS
from trajopt_tpu_torch.ops.integration import (
    IMPLICIT, INTEGRATORS, UNCERTAIN_INTEGRATORS, batched_jacfwd,
)


class Model:
    """Continuous-time dynamics model xdot = f(x, u) (reference
    src/model.jl:103-140). ``r`` is the disturbance dimension of an
    uncertain model, ``f(x, u, w)`` (reference src/model.jl:36-74)."""

    def __init__(self, f, n: int, m: int, name: str = "model", r: int = 0):
        self.n = n
        self.m = m
        self.r = r
        self.name = name
        # (a, b) slice of a unit-quaternion block in the state, if any —
        # enables quaternion-aware error-state solves (models/quaternions.py)
        self.quat_slice = None
        self._f = f

    def __call__(self, x, u, *w):
        return self._f(x, u, *w)

    def dynamics(self, x, u, *w):
        return self._f(x, u, *w)

    def __repr__(self):
        return f"Model({self.name}, n={self.n}, m={self.m}, r={self.r})"


class DiscreteModel:
    """Discrete dynamics x_{k+1} = step(x_k, u_k, dt).

    ``cuda_step`` names the model whose step the kernels inline
    (``ops/cuda_models.py::CUDA_STEPS``, ``csrc/models.cuh``), or is None;
    the rule they integrate it with is ``integrator``.
    ``slack_m`` is the base model's control width when this is a
    slack-augmented model of the infeasible-start transform
    (``solvers/altro.py::infeasible_problem``), else None.
    ``mintime`` marks the minimum-time model of
    ``solvers/altro.py::minimum_time_problem`` (it keeps its base model's
    ``cuda_step`` and ``slack_m``).
    ``chain_table`` is what the kernels' ``Chain`` trait reads for a
    rigid-body chain (``models/rigidbody_lanes.py::chain_table``), else
    None; ``chain_table_on`` holds its copy on each device the kernels
    ran on. ``_jac_dt``, where a model has a structured Jacobian (a chain
    under an explicit rule, every model under an implicit rule, and their
    slack forms), is ``(x, u, dt) -> (A, B, ∂x⁺/∂dt)``, which the
    minimum-time model chains through h = √dt; else None.
    """

    def __init__(self, step, n: int, m: int, model: Model | None = None,
                 integrator: str = "rk3", name: str = "discrete_model"):
        self.n = n
        self.m = m
        self.step = step
        self.model = model
        self.integrator = integrator
        self.name = name
        self.quat_slice = getattr(model, "quat_slice", None)
        self.cuda_step = None
        self.slack_m = None
        self.mintime = False
        self.chain_table = None     # a chain's table for the CUDA kernels
        self.chain_table_on = {}    # device -> that table on the device
        # (x (B, n), u (B, m), dt (B,)) -> A (B, n, n), B (B, n, m)
        self._jac = torch.func.vmap(torch.func.jacfwd(step, argnums=(0, 1)))
        self._jac_dt = None

    def __call__(self, x, u, dt):
        return self.step(x, u, dt)

    def jacobian_traj(self, X, U, dt):
        """Jacobians at every knot: X (..., N-1, n), U (..., N-1, m), dt a
        float or a tensor broadcastable to U.shape[:-1].
        Returns A (..., N-1, n, n), B (..., N-1, n, m)."""
        lead = U.shape[:-1]
        n, m = X.shape[-1], U.shape[-1]
        dt = torch.as_tensor(dt, dtype=X.dtype, device=X.device).expand(lead)
        A, B = self._jac(X.reshape(-1, n), U.reshape(-1, m), dt.reshape(-1))
        return A.reshape(*lead, n, n), B.reshape(*lead, n, m)

    def __repr__(self):
        return (f"DiscreteModel({self.name}, n={self.n}, m={self.m}, "
                f"{self.integrator})")


def rk3_jacobian(linearize, with_dt: bool = False):
    """``jac(x, u, dt) -> (A, B)`` of the RK3 step with zero-order hold
    (``ops/integration.py::rk3``) from ``linearize(x, u) -> (ẋ, ∂ẋ/∂x,
    ∂ẋ/∂u)``, the chain rule through the three stages written out:
    dk1 = dt F1 dz, dk2 = dt F2 (dz + ½dk1), dk3 = dt F3 (dz − dk1 + 2dk2),
    dx⁺ = dx + (dk1 + 4dk2 + dk3)/6. With ``with_dt`` it also returns
    ∂x⁺/∂dt by the same rule: ∂k1 = f1, ∂k2 = f2 + dt F2 (½∂k1),
    ∂k3 = f3 + dt F3 (2∂k2 − ∂k1), ∂x⁺ = (∂k1 + 4∂k2 + ∂k3)/6. Batched:
    x (…, n), u (…, m) and dt (…)."""

    def jac(x, u, dt):
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        dtm = dt[..., None, None]
        dt = dt[..., None]
        f1, Fx, Fu = linearize(x, u)
        k1, K1x, K1u = dt * f1, dtm * Fx, dtm * Fu
        f2, Fx, Fu = linearize(x + 0.5 * k1, u)
        X2x, X2u = eye + 0.5 * K1x, 0.5 * K1u
        k2, K2x, K2u = dt * f2, dtm * (Fx @ X2x), dtm * (Fx @ X2u + Fu)
        F2x = Fx
        f3, Fx, Fu = linearize(x - k1 + 2.0 * k2, u)
        X3x, X3u = eye - K1x + 2.0 * K2x, 2.0 * K2u - K1u
        K3x, K3u = dtm * (Fx @ X3x), dtm * (Fx @ X3u + Fu)
        A = eye + (K1x + 4.0 * K2x + K3x) / 6.0
        B = (K1u + 4.0 * K2u + K3u) / 6.0
        if not with_dt:
            return A, B
        s2 = f2 + dt * (F2x @ (0.5 * f1)[..., None])[..., 0]
        s3 = f3 + dt * (Fx @ (2.0 * s2 - f1)[..., None])[..., 0]
        return A, B, (f1 + 4.0 * s2 + s3) / 6.0

    return jac


# Butcher tableaux of the explicit rules other than RK3 (ops/integration.py):
# stage i evaluates f at x + Σ_j a[i][j] k_j, k_i = dt f(·), and
# x⁺ = x + Σ_i b_i k_i
TABLEAUX = {
    "euler": ((), (1.0,)),
    "midpoint": (((0.5,),), (0.0, 1.0)),
    "rk4": (((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
            (1.0 / 6.0, 2.0 / 6.0, 2.0 / 6.0, 1.0 / 6.0)),
}


def explicit_jacobian(linearize, tableau, with_dt: bool = False):
    """``jac(x, u, dt) -> (A, B[, ∂x⁺/∂dt])`` of the explicit rule with
    Butcher ``tableau`` (``TABLEAUX``) from ``linearize(x, u) -> (ẋ, ∂ẋ/∂x,
    ∂ẋ/∂u)``: :func:`rk3_jacobian`'s stage-by-stage chain rule for any
    number of stages, dz_i = dx + Σ_j a_ij dk_j, dk_i = dt F_i dz_i (plus
    f_i along dt). Batched: x (…, n), u (…, m) and dt (…)."""
    a, b = tableau

    def jac(x, u, dt):
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        dtm = dt[..., None, None]
        dt = dt[..., None]
        k, kx, ku, kt = [], [], [], []
        for i in range(len(b)):
            row = a[i - 1] if i else ()
            z, zx = x, eye
            zu = zt = None
            for j, c in enumerate(row):
                if c:
                    z = z + c * k[j]
                    zx = zx + c * kx[j]
                    zu = c * ku[j] if zu is None else zu + c * ku[j]
                    zt = c * kt[j] if zt is None else zt + c * kt[j]
            f, Fx, Fu = linearize(z, u)
            k.append(dt * f)
            kx.append(dtm * (Fx @ zx))
            ku.append(dtm * (Fu if zu is None else Fx @ zu + Fu))
            kt.append(f if zt is None else
                      f + dt * (Fx @ zt[..., None])[..., 0])
        terms = [(c, i) for i, c in enumerate(b) if c]
        A = eye + sum(c * kx[i] for c, i in terms)
        B = sum(c * ku[i] for c, i in terms)
        if not with_dt:
            return A, B
        return A, B, sum(c * kt[i] for c, i in terms)

    return jac


def jacfwd_linearize(f):
    """``linearize(x, u) -> (ẋ, ∂ẋ/∂x, ∂ẋ/∂u)`` of the continuous dynamics
    ``f`` by ``torch.func.jacfwd`` mapped over the leading dimensions of x
    (…, n) and u (…, m)."""
    jac = batched_jacfwd(f, (0, 1))

    def linearize(x, u):
        return (f(x, u), *jac(x, u))

    return linearize


def implicit_jacobian(integrator, linearize, step, with_dt: bool = False):
    """``jac(x, u, dt) -> (A, B[, ∂x⁺/∂dt])`` of the implicit rule
    ``integrator`` by the implicit-function theorem at the converged step
    y = step(x, u, dt): for the rule's residual G(y; x, u, dt) = 0,
    ∂y/∂(x, u, dt) = −G_y⁻¹ G_(x, u, dt), with ∂f from ``linearize(x, u) ->
    (ẋ, ∂ẋ/∂x, ∂ẋ/∂u)``. The JAX package differentiates through its Newton
    loop instead, whose tangent is the last trip's (at the previous
    iterate), so the two differ by about the last residual but one. A step
    that did not converge (NaN) has zero Jacobians, as the tangent of the
    JAX package's poisoned branch. Batched: x (…, n), u (…, m), dt (…)."""

    def jac(x, u, dt):
        n = x.shape[-1]
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        dtm = dt[..., None, None]
        dt = dt[..., None]
        y = step(x, u, dt)
        if integrator == "midpoint_implicit":
            # G = y − x − dt f((x + y)/2, u)
            f, Fx, Fu = linearize(0.5 * (x + y), u)
            Gy = eye - 0.5 * dtm * Fx
            rx, ru, rt = eye + 0.5 * dtm * Fx, dtm * Fu, f
        else:
            # G = y − x − dt/6 f1 − 4dt/6 f2 − dt/6 f3, f1 = f(x),
            # f3 = f(y), f2 = f(xm), xm = (x + y)/2 + dt/8 (f1 − f3)
            f1, F1x, F1u = linearize(x, u)
            f3, F3x, F3u = linearize(y, u)
            f2, F2x, F2u = linearize(0.5 * (x + y) + dt / 8.0 * (f1 - f3), u)
            Gy = (eye - 4.0 / 6.0 * dtm * F2x @ (0.5 * eye - dtm / 8.0 * F3x)
                  - dtm / 6.0 * F3x)
            rx = (eye + dtm / 6.0 * F1x
                  + 4.0 / 6.0 * dtm * F2x @ (0.5 * eye + dtm / 8.0 * F1x))
            ru = (dtm / 6.0 * F1u
                  + 4.0 / 6.0 * dtm * (F2x @ (dtm / 8.0 * (F1u - F3u)) + F2u)
                  + dtm / 6.0 * F3u)
            rt = (f1 / 6.0 + 4.0 / 6.0 * f2 + f3 / 6.0
                  + 4.0 / 6.0 * dt * (F2x @ ((f1 - f3) / 8.0)[..., None])[
                      ..., 0])
        rhs = torch.cat([rx, ru, rt[..., None]], dim=-1)
        sol = torch.linalg.solve_ex(Gy, rhs, check_errors=False)[0]
        sol = torch.where(torch.isfinite(y).all(-1)[..., None, None], sol,
                          torch.zeros_like(sol))
        A, B = sol[..., :n], sol[..., n:-1]
        return (A, B, sol[..., -1]) if with_dt else (A, B)

    return jac


def discretize(model: Model, integrator: str = "rk3") -> DiscreteModel:
    """Discretize a continuous model (reference src/model.jl:607-647)."""
    chain = getattr(model, "chain", None)
    linearize = getattr(model, "linearize", None)
    if integrator in IMPLICIT:
        # the Newton loop's ∂f/∂x: a chain's structured one
        step = INTEGRATORS[integrator](
            model.dynamics,
            jac_x=None if linearize is None else (
                lambda x, u: linearize(x, u)[1]))
    else:
        step = INTEGRATORS[integrator](model.dynamics)
    dmodel = DiscreteModel(step, model.n, model.m, model=model,
                           integrator=integrator, name=model.name)
    # the kernels inline these models' steps (csrc/models.cuh) under every
    # rule; the fused kernels only under RK3 and for the models the JAX
    # package has a lane step for (ops/cuda_models.py, k2_only)
    if model.name in CUDA_STEPS:
        dmodel.cuda_step = model.name
    if integrator in IMPLICIT:
        # the Newton loop has no torch.func rule: the implicit-function
        # theorem at the converged step
        lin = linearize or jacfwd_linearize(model.dynamics)
        dmodel._jac = implicit_jacobian(integrator, lin, step)
        dmodel._jac_dt = implicit_jacobian(integrator, lin, step,
                                           with_dt=True)
    elif chain is not None:
        # rigid-body chains: the structured Jacobians through the stages
        if integrator == "rk3":
            dmodel._jac = rk3_jacobian(linearize)
            dmodel._jac_dt = rk3_jacobian(linearize, with_dt=True)
        else:
            dmodel._jac = explicit_jacobian(linearize, TABLEAUX[integrator])
            dmodel._jac_dt = explicit_jacobian(
                linearize, TABLEAUX[integrator], with_dt=True)
    if chain is not None:
        # the table the kernels' Chain trait reads
        from trajopt_tpu_torch.models.rigidbody_lanes import chain_table

        dmodel.chain_table = chain_table(chain, **model.chain_meta)
    return dmodel


def discretize_uncertain(model: Model, integrator: str = "rk3"):
    """The discrete uncertain step ``F(x, u, w, dt)`` of a model with
    disturbance inputs, ``r > 0`` (reference discretize_model on uncertain
    models, model.jl:607-625): the raw step function, which DIRTREL and
    robust rollouts use. No kernel carries it: it runs wherever its tensors
    are. Raises ``ValueError`` for ``r == 0``."""
    if model.r == 0:
        raise ValueError("model has no disturbance inputs (r == 0)")
    return UNCERTAIN_INTEGRATORS[integrator](model.dynamics)
