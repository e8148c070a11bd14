"""Stacked trajectory constraints — the empty set only.

Counterpart of ``trajopt_tpu/ops/constraints.py::ConstraintSet`` at P = 0,
which is all the unconstrained quadrotor path needs. The constraint
kinds, their AL expansion terms and ConstraintSetBuilder are slice 2
(ROADMAP Queue 1, "the constraint layer"). Every method keeps the
(…, N, P) layout of the JAX package, so the AL layer above it is written
for general P.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """Compiled constraints over the whole trajectory: mask (N, P) bool —
    row valid at knot — and is_eq (P,) bool."""

    mask: torch.Tensor
    is_eq: torch.Tensor
    N: int
    P: int

    @staticmethod
    def build(entries, N: int, device="cpu") -> "ConstraintSet":
        if entries:
            raise NotImplementedError(
                "constraints are not ported yet (ROADMAP Queue 1, slice 2: "
                "the constraint layer)")
        return ConstraintSet(
            mask=torch.zeros((N, 0), dtype=torch.bool, device=device),
            is_eq=torch.zeros((0,), dtype=torch.bool, device=device),
            N=N, P=0)

    def evaluate(self, X, U):
        """Constraint values C: (…, N, P) (reference update_constraints!,
        constraint_sets.jl:221-228)."""
        return X.new_zeros(X.shape[:-2] + (self.N, self.P))

    def al_expansion_terms(self, X, U, g, Imu):
        """AL expansion contributions (lx, lu, lxx, luu, lux), full N:
        identically zero without constraint rows."""
        batch, n, m = X.shape[:-2], X.shape[-1], U.shape[-1]
        z = X.new_zeros
        return (z(batch + (self.N, n)), z(batch + (self.N, m)),
                z(batch + (self.N, n, n)), z(batch + (self.N, m, m)),
                z(batch + (self.N, m, n)))

    def active_set(self, C, lam, tol=0.0):
        """a = eq | (c >= tol) | (λ > 0), masked (reference active_set!,
        constraint_sets.jl:255-259)."""
        a = self.is_eq | (C >= tol) | (lam > 0)
        return a & self.mask

    def max_violation(self, C):
        """Per-problem max violation (…,): zero without constraint rows."""
        return C.new_zeros(C.shape[:-2])


def empty_constraints(N: int, device="cpu") -> ConstraintSet:
    return ConstraintSet.build([], N, device=device)
