"""Quadratic costs, objectives and their second-order expansions.

Counterpart of ``trajopt_tpu/ops/cost.py`` (reference src/cost.jl +
src/objective.jl). Per-knot costs are stacked along a leading knot axis, and
the trajectory functions take X/U with any leading batch dimensions in front
of the knot axis.

Conventions (reference src/cost.jl:112-198):
- stage cost  k < N-1:  dt_k * (½xᵀQx + ½uᵀRu + qᵀx + rᵀu + uᵀHx + c)
- terminal    k = N-1:  ½xᵀQx + qᵀx + c         (no dt, no control terms)
"""
from __future__ import annotations

import dataclasses
import warnings

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
