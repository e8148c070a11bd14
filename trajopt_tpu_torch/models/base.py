"""Dynamics model abstraction.

Counterpart of ``trajopt_tpu/models/base.py``. A ``Model`` wraps a continuous
dynamics function ``f(x, u) -> xdot`` written in tensor ops that broadcast
over leading batch dimensions; ``discretize`` turns it into a
``DiscreteModel`` with a ``step(x, u, dt)`` and trajectory Jacobians from
``torch.func.jacfwd`` vmapped over every knot of every problem at once (for
a rigid-body chain under RK3, from its structured linearization chained
through the three stages instead). ``discretize_uncertain`` gives the
discrete step ``F(x, u, w, dt)`` of an uncertain model ``f(x, u, w)``.
"""
from __future__ import annotations

import torch

from trajopt_tpu_torch.ops.cuda_models import CUDA_STEPS
from trajopt_tpu_torch.ops.integration import (
    INTEGRATORS, UNCERTAIN_INTEGRATORS,
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

    ``cuda_step`` names the CUDA step that the kernels inline for this
    model (``ops/cuda_models.py``, ``csrc/models.cuh``), or is None.
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
    under RK3 and its slack form), is ``(x, u, dt) -> (A, B, ∂x⁺/∂dt)``,
    which the minimum-time model chains through h = √dt; else None.
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


def discretize(model: Model, integrator: str = "rk3") -> DiscreteModel:
    """Discretize a continuous model (reference src/model.jl:607-647)."""
    step = INTEGRATORS[integrator](model.dynamics)
    dmodel = DiscreteModel(step, model.n, model.m, model=model,
                           integrator=integrator, name=model.name)
    # the kernels inline the RK3 step of these models (csrc/models.cuh): the
    # pairs the JAX package registers a lane step for, and ballonbeam and
    # the Euler-angle quadrotor, which only K2 carries (k2_only)
    if f"{model.name}_{integrator}" in CUDA_STEPS:
        dmodel.cuda_step = f"{model.name}_{integrator}"
    chain = getattr(model, "chain", None)
    if chain is not None and integrator == "rk3":
        # rigid-body chains: the structured Jacobians, and the table the
        # kernels' Chain trait reads (models/rigidbody_lanes.py)
        from trajopt_tpu_torch.models.rigidbody_lanes import chain_table

        dmodel._jac = rk3_jacobian(model.linearize)
        dmodel._jac_dt = rk3_jacobian(model.linearize, with_dt=True)
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
