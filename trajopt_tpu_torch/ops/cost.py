"""Quadratic costs, objectives and their second-order expansions.

Counterpart of ``trajopt_tpu/ops/cost.py`` (reference src/cost.jl +
src/objective.jl). Per-knot costs are stacked along a leading knot axis, and
the trajectory functions take X/U with any leading batch dimensions in front
of the knot axis.

Conventions (reference src/cost.jl:112-198):
- stage cost  k < N-1:  dt_k * (½xᵀQx + ½uᵀRu + qᵀx + rᵀu + uᵀHx + c)
- terminal    k = N-1:  ½xᵀQx + qᵀx + c         (no dt, no control terms)

``GenericObjective`` is the nonquadratic objective: per-knot functions
ℓ(x, u) and ℓf(x), mapped over the leading dimensions by
``torch.func.vmap`` and expanded by ``torch.func`` unless analytic hooks are
given. It is not an ``Objective``, so its solves run phase-split, as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from trajopt_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Expansion:
    """Second-order expansion trajectory (reference src/cost.jl:21-37).

    x: (…, N, n), u: (…, N-1, m), xx: (…, N, n, n), uu: (…, N-1, m, m),
    ux: (…, N-1, m, n). Terminal entries live at knot N-1 of x/xx.
    """

    x: torch.Tensor
    u: torch.Tensor
    xx: torch.Tensor
    uu: torch.Tensor
    ux: torch.Tensor


@dataclasses.dataclass(frozen=True)
class QuadraticCost:
    """Single-knot quadratic cost (reference src/cost.jl:112-131), held as
    float64 numpy arrays until it is stacked into an ``Objective``."""

    Q: np.ndarray
    R: np.ndarray
    H: np.ndarray
    q: np.ndarray
    r: np.ndarray
    c: float

    @staticmethod
    def create(Q, R=None, H=None, q=None, r=None, c=0.0):
        # reference src/cost.jl:121-127: error on non-PSD Q, warn on non-PD R
        Q = np.asarray(Q, dtype=np.float64)
        if np.min(np.linalg.eigvalsh(0.5 * (Q + Q.T))) < -1e-10:
            raise ValueError("Q must be positive semi-definite")
        n = Q.shape[0]
        m = 0 if R is None else np.asarray(R).shape[0]
        R = np.zeros((m, m)) if R is None else np.asarray(R, np.float64)
        if R.size and np.min(np.linalg.eigvalsh(0.5 * (R + R.T))) <= 0:
            warnings.warn("R is not positive definite")
        H = np.zeros((m, n)) if H is None else np.asarray(H, np.float64)
        q = np.zeros((n,)) if q is None else np.asarray(q, np.float64)
        r = np.zeros((m,)) if r is None else np.asarray(r, np.float64)
        return QuadraticCost(Q, R, H, q, r, float(c))


def LQRCost(Q, R, xf):
    """½(x−xf)ᵀQ(x−xf) + ½uᵀRu (reference src/cost.jl:151-157)."""
    Q = np.asarray(Q, np.float64)
    xf = np.asarray(xf, np.float64)
    return QuadraticCost.create(Q, R, q=-Q @ xf, c=0.5 * xf @ Q @ xf)


def LQRCostTerminal(Qf, xf):
    """½(x−xf)ᵀQf(x−xf) (reference src/cost.jl:161-169)."""
    Qf = np.asarray(Qf, np.float64)
    xf = np.asarray(xf, np.float64)
    return QuadraticCost.create(Qf, q=-Qf @ xf, c=0.5 * xf @ Qf @ xf)


@dataclasses.dataclass(frozen=True)
class Objective:
    """Stacked per-knot quadratic objective (reference src/objective.jl:15-29).

    Every tensor has a leading knot axis of length N; knot N-1 holds the
    terminal cost (its R/H/r entries are ignored).
    """

    Q: torch.Tensor  # (N, n, n)
    R: torch.Tensor  # (N, m, m)
    H: torch.Tensor  # (N, m, n)
    q: torch.Tensor  # (N, n)
    r: torch.Tensor  # (N, m)
    c: torch.Tensor  # (N,)

    @property
    def N(self):
        return self.Q.shape[0]

    @property
    def n(self):
        return self.Q.shape[-1]

    @property
    def m(self):
        return self.R.shape[-1]

    def to(self, dtype=None, device=None):
        return Objective(**{f.name: getattr(self, f.name).to(
            dtype=dtype, device=device) for f in dataclasses.fields(self)})

    def total(self, X, U, dt):
        return total_cost(self, X, U, dt)

    def expansion(self, X, U, dt):
        return cost_expansion(self, X, U, dt)

    @staticmethod
    def from_costs(costs, dtype=torch.float64, device=None):
        """Stack a list of N QuadraticCost objects on ``device`` (None:
        the current CUDA device)."""
        device = resolve_device(device)

        def stack(name):
            return torch.as_tensor(
                np.stack([np.asarray(getattr(ci, name)) for ci in costs]),
                dtype=dtype, device=device)

        return Objective(Q=stack("Q"), R=stack("R"), H=stack("H"),
                         q=stack("q"), r=stack("r"), c=stack("c"))

    @staticmethod
    def uniform(stage: QuadraticCost, terminal: QuadraticCost, N: int,
                dtype=torch.float64, device=None):
        """Same stage cost at knots 0..N-2, terminal at N-1
        (reference src/objective.jl:20-27)."""
        m = stage.R.shape[0]
        term = QuadraticCost(
            Q=terminal.Q, R=np.zeros((m, m)),
            H=np.zeros((m, terminal.Q.shape[0])), q=terminal.q,
            r=np.zeros((m,)), c=terminal.c)
        return Objective.from_costs([stage] * (N - 1) + [term], dtype=dtype,
                                    device=device)


def LQRObjective(Q, R, Qf, xf, N: int, dtype=torch.float64, device=None):
    """(reference src/objective.jl:102-114)."""
    return Objective.uniform(LQRCost(Q, R, xf), LQRCostTerminal(Qf, xf), N,
                             dtype=dtype, device=device)


# ------------------------------------------------------------------ evaluation

def total_cost(obj: Objective, X, U, dt):
    """Trajectory cost (reference src/objective.jl:40-48): X (…, N, n),
    U (…, N-1, m) → (…,)."""
    dt = torch.as_tensor(dt, dtype=X.dtype, device=X.device).expand(
        U.shape[:-1])
    Xs = X[..., :-1, :]
    quad_x = 0.5 * torch.einsum("...ki,kij,...kj->...k", Xs, obj.Q[:-1], Xs)
    quad_u = 0.5 * torch.einsum("...ki,kij,...kj->...k", U, obj.R[:-1], U)
    cross = torch.einsum("...ki,kij,...kj->...k", U, obj.H[:-1], Xs)
    lin = (torch.einsum("ki,...ki->...k", obj.q[:-1], Xs)
           + torch.einsum("ki,...ki->...k", obj.r[:-1], U))
    J_stage = ((quad_x + quad_u + cross + lin + obj.c[:-1]) * dt).sum(-1)

    xN = X[..., -1, :]
    J_term = (0.5 * torch.einsum("...i,ij,...j->...", xN, obj.Q[-1], xN)
              + torch.einsum("i,...i->...", obj.q[-1], xN) + obj.c[-1])
    return J_stage + J_term


def cost_expansion(obj: Objective, X, U, dt) -> Expansion:
    """Second-order expansion along the trajectory (reference
    src/cost.jl:183-198). Stage entries are scaled by dt, the terminal
    entry is not. The Hessian blocks are broadcast views over the batch
    dimensions of X."""
    dt = torch.as_tensor(dt, dtype=X.dtype, device=X.device).expand(
        U.shape[:-1])
    Xs = X[..., :-1, :]
    batch = X.shape[:-2]
    N, n, m = X.shape[-2], X.shape[-1], U.shape[-1]

    lx_s = (torch.einsum("kij,...kj->...ki", obj.Q[:-1], Xs) + obj.q[:-1]
            + torch.einsum("kji,...kj->...ki", obj.H[:-1], U)) * dt[..., None]
    lu_s = (torch.einsum("kij,...kj->...ki", obj.R[:-1], U) + obj.r[:-1]
            + torch.einsum("kij,...kj->...ki", obj.H[:-1], Xs)) * dt[..., None]
    lxx_s = obj.Q[:-1] * dt[..., None, None]
    luu_s = obj.R[:-1] * dt[..., None, None]
    lux_s = obj.H[:-1] * dt[..., None, None]

    lxN = torch.einsum("ij,...j->...i", obj.Q[-1], X[..., -1, :]) + obj.q[-1]
    lx = torch.cat([lx_s, lxN[..., None, :]], dim=-2)
    lxx = torch.cat([lxx_s.expand(*batch, N - 1, n, n),
                     obj.Q[-1].expand(*batch, 1, n, n)], dim=-3)
    return Expansion(x=lx, u=lu_s, xx=lxx,
                     uu=luu_s.expand(*batch, N - 1, m, m),
                     ux=lux_s.expand(*batch, N - 1, m, n))


def stage_cost(obj: Objective, k, x, u, dt):
    """Running cost at knot k (reference src/cost.jl:175-177): x (…, n),
    u (…, m) → (…,)."""
    Q, R, H = obj.Q[k], obj.R[k], obj.H[k]
    q, r, c = obj.q[k], obj.r[k], obj.c[k]
    quad = (0.5 * torch.einsum("...i,ij,...j->...", x, Q, x)
            + 0.5 * torch.einsum("...i,ij,...j->...", u, R, u))
    lin = torch.einsum("i,...i->...", q, x) + torch.einsum("i,...i->...",
                                                           r, u)
    cross = torch.einsum("...i,ij,...j->...", u, H, x)
    return (quad + lin + c + cross) * dt


# ------------------------------------------------------------- generic costs

def _flat_map(f, *args):
    """``f`` of per-knot arguments, mapped with ``torch.func.vmap`` over
    the leading dimensions of ``args`` (each (…, ·) or, for a scalar per
    knot, (…)); the outputs come back with those dimensions in front."""
    lead = args[0].shape[:-1]
    flat = [a.reshape(-1) if a.shape == lead else a.reshape(-1, a.shape[-1])
            for a in args]
    out = torch.func.vmap(f)(*flat)

    def back(o):
        return o.reshape(lead + o.shape[1:])

    return tuple(back(o) for o in out) if isinstance(out, tuple) \
        else back(out)


@dataclasses.dataclass(frozen=True)
class GenericObjective:
    """Nonquadratic cost ℓ(x, u) + terminal ℓf(x) with an AD expansion
    (reference src/cost.jl:239-322, GenericCost via ForwardDiff): the
    counterpart of the JAX package's ``GenericObjective``. ``ell`` and
    ``ellf`` take per-knot vectors (x (n,), u (m,)) and return a scalar;
    the stage cost is multiplied by dt, as the quadratic one is.

    Optional analytic hooks (reference src/cost.jl:246-262), per knot:
    ``grad(x, u) -> (lx, lu)`` and ``hess(x, u) -> (lxx, luu, lux)`` of ℓ
    (unscaled: the expansion multiplies them by dt, as the AD path does),
    ``gradf(x) -> lx`` and ``hessf(x) -> lxx`` of ℓf. Provide all four or
    none; a missing hook falls back to ``torch.func`` for its piece."""

    ell: Callable
    ellf: Callable
    N: int
    grad: Optional[Callable] = None
    hess: Optional[Callable] = None
    gradf: Optional[Callable] = None
    hessf: Optional[Callable] = None

    @property
    def n(self):
        return None

    def to(self, dtype=None, device=None):
        """The functions hold no tensors: the same objective."""
        return self

    def stage(self, x, u, dt):
        return self.ell(x, u) * dt

    def terminal(self, x):
        return self.ellf(x)

    def total(self, X, U, dt):
        return generic_total_cost(self, X, U, dt)

    def expansion(self, X, U, dt):
        return generic_cost_expansion(self, X, U, dt)


def generic_total_cost(obj: GenericObjective, X, U, dt):
    """X (…, N, n), U (…, N-1, m) → (…,)."""
    dt = torch.as_tensor(dt, dtype=X.dtype, device=X.device).expand(
        U.shape[:-1])
    J_stage = _flat_map(obj.stage, X[..., :-1, :], U, dt).sum(-1)
    return J_stage + _flat_map(obj.terminal, X[..., -1, :])


def generic_cost_expansion(obj: GenericObjective, X, U, dt) -> Expansion:
    """The expansion of a ``GenericObjective``: its hooks where given,
    ``torch.func`` (``grad`` and ``jacfwd`` of it) for the rest."""
    dt = torch.as_tensor(dt, dtype=X.dtype, device=X.device).expand(
        U.shape[:-1])
    Xs = X[..., :-1, :]
    fn = torch.func
    if obj.grad is not None:
        lx_s, lu_s = _flat_map(
            lambda x, u, d: tuple(g * d for g in obj.grad(x, u)), Xs, U, dt)
    else:
        lx_s, lu_s = _flat_map(fn.grad(obj.stage, argnums=(0, 1)), Xs, U, dt)
    if obj.hess is not None:
        lxx_s, luu_s, lux_s = _flat_map(
            lambda x, u, d: tuple(h * d for h in obj.hess(x, u)), Xs, U, dt)
    else:
        gx = fn.grad(obj.stage, argnums=0)
        gu = fn.grad(obj.stage, argnums=1)
        lxx_s = _flat_map(fn.jacfwd(gx, argnums=0), Xs, U, dt)
        luu_s = _flat_map(fn.jacfwd(gu, argnums=1), Xs, U, dt)
        lux_s = _flat_map(fn.jacfwd(gu, argnums=0), Xs, U, dt)
    xN = X[..., -1, :]
    lxN = _flat_map(obj.gradf if obj.gradf is not None
                    else fn.grad(obj.terminal), xN)
    lxxN = _flat_map(obj.hessf if obj.hessf is not None
                     else fn.jacfwd(fn.grad(obj.terminal)), xN)
    lx = torch.cat([lx_s, lxN[..., None, :]], dim=-2)
    lxx = torch.cat([lxx_s, lxxN[..., None, :, :]], dim=-3)
    return Expansion(x=lx, u=lu_s, xx=lxx, uu=luu_s, ux=lux_s)
