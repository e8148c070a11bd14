"""Constraint stack.

Counterpart of ``trajopt_tpu/ops/constraints.py`` (reference
src/constraints.jl + src/constraint_sets.jl). The whole trajectory's
constraints are compiled into one stacked layout:

- every registered constraint owns a fixed row slice of a (N, P) value array,
- a boolean ``mask`` (N, P) says where each row applies,
- ``is_eq`` (P,) splits equality from inequality rows,

so evaluation, Jacobians, the active-set rule and all AL algebra are
fixed-shape tensor ops. Where the JAX package maps a per-knot function with
``vmap``, a constraint function here takes X (…, n) and U (…, m) with any
leading dimensions (problems, knots) and returns (…, p).

The constraint kinds of the problem zoo are three row kinds written
relative to the state and control widths they are called with: ``sphere``
rows (circle and sphere obstacle fields), single-entry ``linear`` rows (box
bounds, goal equalities, the infeasible-start slack rows) and ``fk_sphere``
rows (collision bubbles on a rigid-body chain's forward kinematics, the
kuka arm's). The same constraint therefore serves a problem and its
slack-augmented transform (``solvers/altro.py::lift_constraint``), and each
carries the ``canon`` descriptor that ``ops/canonical.py`` compiles for the
fused AL kernels.
``custom_constraint``, ``sphere_constraint_fn`` and
``planar_obstacle_constraint`` are not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from trajopt_tpu_torch.ops.canonical import (
    fk_data, fk_rows, linear_canon, pad_terminal, sphere_canon,
)
from trajopt_tpu_torch.utils.device import resolve_device


class _Const:
    """A numpy constant handed out as a tensor of the caller's dtype and
    device, converted once per (dtype, device)."""

    def __init__(self, a):
        self.a = np.asarray(a)
        self._cache = {}

    def like(self, t):
        key = (t.dtype, t.device)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self.a, dtype=t.dtype,
                                               device=t.device)
        return self._cache[key]


class Constraint:
    """A single vector-valued constraint (reference src/constraints.jl:66-109).

    ``fn(X, U) -> (…, p)`` for X (…, n), U (…, m): equality rows mean
    c = 0, inequality rows c <= 0. At the terminal knot the function sees
    u = 0 (u-dependent rows are masked out there). ``jac_fn(X, U)`` returns
    (cx (…, p, n), cu (…, p, m)); every ported kind has an analytic one
    (Jacobians by AD arrive with ``custom_constraint``).
    """

    def __init__(self, fn: Callable, p: int, label: str, jac_fn: Callable,
                 equality: bool | np.ndarray = False, applies: str = "stage"):
        self.fn = fn
        self.p = p
        self.label = label
        if isinstance(equality, (bool, np.bool_)):
            equality = np.full((p,), bool(equality))
        self.equality = np.asarray(equality, dtype=bool)
        if self.equality.shape != (p,):
            raise ValueError(f"equality must have shape ({p},)")
        if applies not in ("stage", "terminal", "all"):
            raise ValueError(f"applies={applies!r}")
        self.applies = applies
        self.jac_fn = jac_fn
        self.al_terms = None     # structured AL expansion hook
        self.canon = None        # descriptor for ops/canonical.py
        self.term_rows = None    # rows of an 'all' constraint valid at N-1

    def __repr__(self):
        return f"Constraint({self.label}, p={self.p}, {self.applies})"


# --------------------------------------------------------------- primitives

def circle_constraint_fn(x, xc, yc, r):
    """(reference src/utils.jl:140-144): r² − (px−xc)² − (py−yc)² ≤ 0."""
    return r**2 - (x[..., 0] - xc) ** 2 - (x[..., 1] - yc) ** 2


def sphere_rows_constraint(coords, ctr, b, label, applies="stage"):
    """Rows c_p = b_p − Σ_d (x[coords[d]] − ctr[p, d])² ≤ 0: the one kind
    behind circle (D = 2) and sphere (D = 3) obstacle fields."""
    coords = tuple(int(c) for c in coords)
    ctr_np = np.asarray(ctr, np.float64)
    b_np = np.asarray(b, np.float64)
    p = b_np.shape[0]
    ctr_c, b_c = _Const(ctr_np), _Const(b_np)

    def offsets(x):
        ctr_t = ctr_c.like(x)
        return [x[..., c:c + 1] - ctr_t[:, d] for d, c in enumerate(coords)]

    def fn(x, u):
        out = b_c.like(x)
        for v in offsets(x):
            out = out - v * v
        return out

    def jac(x, u):
        cx = x.new_zeros(x.shape[:-1] + (p, x.shape[-1]))
        for v, c in zip(offsets(x), coords):
            cx[..., c] = -2.0 * v
        return cx, x.new_zeros(x.shape[:-1] + (p, u.shape[-1]))

    con = Constraint(fn, p, label, jac, equality=False, applies=applies)

    def al_terms(X, U_pad, g, imu):
        # ∂c_p/∂x is nonzero only in the D position coords, −2 v_d, so the
        # Gauss-Newton AL terms are a D-vector and a D×D block
        n = X.shape[-1]
        vs = offsets(X)
        lx = X.new_zeros(X.shape)
        lxx = X.new_zeros(X.shape + (n,))
        for a, ca in enumerate(coords):
            lx[..., ca] = -2.0 * (g * vs[a]).sum(-1)
            for bb in range(a, len(coords)):
                h = 4.0 * (imu * vs[a] * vs[bb]).sum(-1)
                lxx[..., ca, coords[bb]] = h
                lxx[..., coords[bb], ca] = h
        return {"x": lx, "xx": lxx}

    con.al_terms = al_terms
    con.canon = sphere_canon(coords, ctr_np, b_np)
    return con


def linear_rows_constraint(rows, off, label, equality=False, applies="all",
                           term_rows=None):
    """Single-entry rows c_p = sign_p · z[col_p] + off_p over z = [x; u]:
    the one kind behind box bounds, goal equalities and the slack rows.
    ``rows``: (is_u, idx, sign) per row, relative to the widths of the x
    and u it is called with."""
    rows = tuple((bool(a), int(i), float(s)) for a, i, s in rows)
    off_np = np.asarray(off, np.float64)
    p = len(rows)
    is_u = np.array([r[0] for r in rows], dtype=bool)
    idx = np.array([r[1] for r in rows], dtype=np.int64)
    sign_c, off_c = _Const([r[2] for r in rows]), _Const(off_np)
    has_x, has_u = bool((~is_u).any()), bool(is_u.any())
    sel_cache = {}

    def selection(x, u):
        """J (p, n + m): row r has sign_r at its z-column."""
        n, m = x.shape[-1], u.shape[-1]
        key = (n, m, x.dtype, x.device)
        if key not in sel_cache:
            if (idx[~is_u] >= n).any() or (idx[is_u] >= m).any():
                raise ValueError(f"constraint {label!r} does not fit "
                                 f"n={n}, m={m}")
            J = np.zeros((p, n + m))
            cols = idx + is_u * n
            J[np.arange(p), cols] = sign_c.a
            sel_cache[key] = (
                torch.as_tensor(cols, device=x.device),
                torch.as_tensor(J, dtype=x.dtype, device=x.device))
        return sel_cache[key]

    def fn(x, u):
        cols, _ = selection(x, u)
        z = torch.cat([x, u], dim=-1)
        return sign_c.like(x) * z[..., cols] + off_c.like(x)

    def jac(x, u):
        n = x.shape[-1]
        _, J = selection(x, u)
        lead = x.shape[:-1]
        return (J[:, :n].expand(lead + (p, n)),
                J[:, n:].expand(lead + (p, u.shape[-1])))

    con = Constraint(fn, p, label, jac, equality=equality, applies=applies)

    def al_terms(X, U_pad, g, imu):
        # rows are ±e_i selections: gᵀJ is one small matmul and the GN
        # Hessian JᵀIμJ is exactly diagonal (no u-x cross terms)
        n = X.shape[-1]
        _, J = selection(X, U_pad)
        lz = g @ J
        dH = imu @ (J * J)
        out = {}
        if has_x:
            out["x"] = lz[..., :n]
            out["xx"] = torch.diag_embed(dH[..., :n])
        if has_u:
            out["u"] = lz[..., n:]
            out["uu"] = torch.diag_embed(dH[..., n:])
        return out

    con.al_terms = al_terms
    con.canon = linear_canon(rows, off_np)
    if term_rows is not None:
        con.term_rows = np.asarray(term_rows, dtype=bool)
    return con


def fk_sphere_constraint(canon, label="obs", applies="stage"):
    """Rows c = b − Σ_{d ∈ dims} (p_i(q)[d] − ctr[d])² ≤ 0 of an
    ``fk_sphere`` descriptor (``ops/canonical.py::fk_sphere_canon``): sphere
    and cylinder bubbles on world points of a chain's forward kinematics
    from q = x[:J] (the kuka arm's, reference
    problems/kuka_obstacles.jl:14-60). The Jacobian is analytic, from one
    FK pass (∂p_i/∂q_k = z_k × (p_i − o_k) up to the point's joint), and the
    ``al_terms`` hook gives the Gauss-Newton AL terms in the q block only
    (the JAX package's obs_al_terms)."""
    meta = canon[1]
    J, p = meta[0], len(meta[4])
    cache = {}

    def data(x):
        key = (x.dtype, x.device)
        if key not in cache:
            cache[key] = fk_data(meta, x.dtype, x.device)
        return cache[key]

    def fn(x, u):
        return fk_rows(data(x), x)

    def jac(x, u):
        _, grow = fk_rows(data(x), x, with_jacobian=True)
        cx = torch.cat([grow, grow.new_zeros(grow.shape[:-1]
                                             + (x.shape[-1] - J,))], dim=-1)
        return cx, x.new_zeros(x.shape[:-1] + (p, u.shape[-1]))

    con = Constraint(fn, p, label, jac, equality=False, applies=applies)

    def al_terms(X, U_pad, g, imu):
        _, grow = fk_rows(data(X), X, with_jacobian=True)
        lx = X.new_zeros(X.shape)
        lxx = X.new_zeros(X.shape + (X.shape[-1],))
        lx[..., :J] = (g[..., None] * grow).sum(-2)
        lxx[..., :J, :J] = torch.einsum("...p,...pa,...pb->...ab", imu, grow,
                                        grow)
        return {"x": lx, "xx": lxx}

    con.al_terms = al_terms
    con.canon = canon
    return con


def obstacle_field_constraint(circles: Sequence[tuple], label="obstacles",
                              inflate: float = 0.0):
    """Batch of circular obstacles (xc, yc, r), e.g. the quadrotor maze
    cylinders (reference problems/quadrotor_maze.jl:27-67), evaluated as
    one vectorized op; ``inflate`` is added to every radius."""
    arr = np.asarray([[c[0], c[1], c[2] + inflate] for c in circles],
                     dtype=np.float64)
    return sphere_rows_constraint((0, 1), arr[:, :2], arr[:, 2] ** 2, label,
                                  applies="stage")


def goal_constraint(xf, label="goal"):
    """Terminal equality x_N = xf (reference src/constraints.jl:299-304)."""
    xf = np.asarray(xf, dtype=np.float64)
    return linear_rows_constraint(
        [(False, i, 1.0) for i in range(xf.shape[0])], -xf, label,
        equality=True, applies="terminal")


def infeasible_constraint(n, m, label="infeasible"):
    """Slack-control equality u_inf = 0 for infeasible-start ALTRO
    (reference src/constraints.jl:306-314). The augmented model has m + n
    controls; the last n are the slacks."""
    return linear_rows_constraint(
        [(True, m + j, 1.0) for j in range(n)], np.zeros(n), label,
        equality=True, applies="stage")


def bound_constraint(n, m, x_min=None, x_max=None, u_min=None, u_max=None,
                     label="bound"):
    """Box bounds with static trimming of infinite rows (reference
    src/constraints.jl:140-188, BoundConstraint with trim=true). Row order
    as in the reference: [x_max, u_max, x_min, u_min]; the u rows are
    masked out at the terminal knot by the stacker."""

    def _validate(vmax, vmin, size):
        vmin = np.full(size, -np.inf) if vmin is None else np.broadcast_to(
            np.asarray(vmin, dtype=np.float64), (size,)).copy()
        vmax = np.full(size, np.inf) if vmax is None else np.broadcast_to(
            np.asarray(vmax, dtype=np.float64), (size,)).copy()
        if not np.all(vmax >= vmin):
            raise ValueError("max bound must be >= min bound")
        return vmax, vmin

    x_max, x_min = _validate(x_max, x_min, n)
    u_max, u_min = _validate(u_max, u_min, m)
    ixmax, iumax = np.where(np.isfinite(x_max))[0], \
        np.where(np.isfinite(u_max))[0]
    ixmin, iumin = np.where(np.isfinite(x_min))[0], \
        np.where(np.isfinite(u_min))[0]

    rows, offs = [], []
    for i in ixmax:
        rows.append((False, int(i), 1.0))
        offs.append(-x_max[i])
    for j in iumax:
        rows.append((True, int(j), 1.0))
        offs.append(-u_max[j])
    for i in ixmin:
        rows.append((False, int(i), -1.0))
        offs.append(x_min[i])
    for j in iumin:
        rows.append((True, int(j), -1.0))
        offs.append(u_min[j])
    con = linear_rows_constraint(
        rows, np.asarray(offs), label, equality=False, applies="all",
        term_rows=[not r[0] for r in rows])
    con.bound_data = dict(x_max=x_max, x_min=x_min, u_max=u_max, u_min=u_min)
    return con


# ------------------------------------------------------------- constraint set

class ConstraintSetBuilder:
    """Per-knot constraint registry (reference Constraints,
    constraint_sets.jl:157-181). ``add(con, knots)`` attaches a constraint at
    the given knots (default: its natural range, stage constraints at
    0..N-2, terminal ones at N-1)."""

    def __init__(self, N: int):
        self.N = N
        self.entries: list[tuple[Constraint, np.ndarray]] = []

    def add(self, con: Constraint, knots=None):
        N = self.N
        mask = np.zeros(N, dtype=bool)
        if knots is None:
            if con.applies == "stage":
                mask[: N - 1] = True
            elif con.applies == "terminal":
                mask[N - 1] = True
            else:
                mask[:] = True
        else:
            mask[np.asarray(list(knots), dtype=int)] = True
            if con.applies == "stage":
                mask[N - 1] = False
            elif con.applies == "terminal":
                mask[: N - 1] = False
        self.entries.append((con, mask))
        return self

    def stack(self, device=None) -> "ConstraintSet":
        return ConstraintSet.build(self.entries, self.N, device=device)


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """Compiled constraints over the whole trajectory: mask (N, P) bool
    (row valid at knot) and is_eq (P,) bool on the device, the constraint
    descriptors and their row slices."""

    mask: torch.Tensor
    is_eq: torch.Tensor
    cons: tuple
    slices: tuple
    N: int
    P: int

    @staticmethod
    def build(entries, N: int, device=None) -> "ConstraintSet":
        device = resolve_device(device)
        cons, slices, masks, eqs = [], [], [], []
        r0 = 0
        for con, kmask in entries:
            p = con.p
            m2 = np.zeros((N, p), dtype=bool)
            m2[np.asarray(kmask, dtype=bool), :] = True
            # u-dependent rows of an 'all' constraint never apply at N-1
            if con.applies == "all" and con.term_rows is not None:
                m2[N - 1, :] &= con.term_rows
            elif con.applies == "stage":
                m2[N - 1, :] = False
            cons.append(con)
            slices.append((r0, r0 + p))
            masks.append(m2)
            eqs.append(con.equality)
            r0 += p
        mask = np.concatenate(masks, axis=1) if r0 else np.zeros((N, 0), bool)
        is_eq = np.concatenate(eqs) if r0 else np.zeros((0,), bool)
        return ConstraintSet(
            mask=torch.as_tensor(mask, device=device),
            is_eq=torch.as_tensor(is_eq, device=device),
            cons=tuple(cons), slices=tuple(slices), N=N, P=r0)

    @property
    def is_constrained(self) -> bool:
        return self.P > 0

    def labels(self):
        return tuple(c.label for c in self.cons)

    def row_slice(self, label: str):
        for c, s in zip(self.cons, self.slices):
            if c.label == label:
                return s
        raise KeyError(label)

    def to(self, device):
        return dataclasses.replace(self, mask=self.mask.to(device),
                                   is_eq=self.is_eq.to(device))

    # ------------------------------------------------------------ evaluation

    def evaluate(self, X, U):
        """Constraint values C (…, N, P), invalid rows zeroed (reference
        update_constraints!, constraint_sets.jl:221-228)."""
        if self.P == 0:
            return X.new_zeros(X.shape[:-2] + (self.N, 0))
        U_pad = pad_terminal(U)
        C = torch.cat([con.fn(X, U_pad) for con in self.cons], dim=-1)
        return torch.where(self.mask, C, torch.zeros_like(C))

    def jacobian(self, X, U):
        """Stacked Jacobians cx (…, N, P, n), cu (…, N, P, m) (reference
        jacobian!, constraint_sets.jl:231-238)."""
        n, m = X.shape[-1], U.shape[-1]
        if self.P == 0:
            lead = X.shape[:-2] + (self.N, 0)
            return X.new_zeros(lead + (n,)), X.new_zeros(lead + (m,))
        U_pad = pad_terminal(U)
        parts = [con.jac_fn(X, U_pad) for con in self.cons]
        cx = torch.cat([p[0] for p in parts], dim=-2)
        cu = torch.cat([p[1] for p in parts], dim=-2)
        mask3 = self.mask[:, :, None]
        return (torch.where(mask3, cx, torch.zeros_like(cx)),
                torch.where(mask3, cu, torch.zeros_like(cu)))

    def al_expansion_terms(self, X, U, g, Imu):
        """Augmented-Lagrangian expansion contributions

            lx += cxᵀ g,  lxx += cxᵀ Iμ cx   (and the u/ux analogs)

        with g = Iμ∘c + λ (reference cost_expansion!,
        augmented_lagrangian_methods.jl:186-229). Constraints with an
        ``al_terms`` hook contribute through their sparse Jacobian structure;
        the others through the dense Gauss-Newton products. ``g`` and ``Imu``
        must already be zero on invalid rows. Returns full-N
        (lx, lu, lxx, luu, lux); the caller drops the terminal u rows."""
        batch, n, m = X.shape[:-2], X.shape[-1], U.shape[-1]
        N = self.N
        z = X.new_zeros
        out = {"x": z(batch + (N, n)), "u": z(batch + (N, m)),
               "xx": z(batch + (N, n, n)), "uu": z(batch + (N, m, m)),
               "ux": z(batch + (N, m, n))}
        if self.P == 0:
            return tuple(out.values())
        U_pad = pad_terminal(U)
        for con, (r0, r1) in zip(self.cons, self.slices):
            gk, ik = g[..., r0:r1], Imu[..., r0:r1]
            if con.al_terms is not None:
                t = con.al_terms(X, U_pad, gk, ik)
            else:
                cx, cu = con.jac_fn(X, U_pad)
                t = {"x": torch.einsum("...pi,...p->...i", cx, gk),
                     "xx": torch.einsum("...pi,...p,...pj->...ij", cx, ik, cx),
                     "u": torch.einsum("...pi,...p->...i", cu, gk),
                     "uu": torch.einsum("...pi,...p,...pj->...ij", cu, ik, cu),
                     "ux": torch.einsum("...pi,...p,...pj->...ij", cu, ik, cx)}
            for k, v in t.items():
                out[k] = out[k] + v
        return tuple(out.values())

    # ------------------------------------------------------------ active set

    def active_set(self, C, lam, tol=0.0):
        """a = eq | (c >= tol) | (λ > 0), masked (reference active_set!,
        constraint_sets.jl:255-259)."""
        a = self.is_eq | (C >= tol) | (lam > 0)
        return a & self.mask

    def violation(self, C):
        """Per-row violation: |c| on equality rows, max(c, 0) on inequality
        rows, 0 on invalid rows (reference max_violation,
        augmented_lagrangian_methods.jl:171-184)."""
        v = torch.where(self.is_eq, C.abs(), C.clamp(min=0.0))
        return torch.where(self.mask, v, torch.zeros_like(v))

    def max_violation(self, C):
        """Per-problem max violation (…,): zero without constraint rows."""
        if self.P == 0:
            return C.new_zeros(C.shape[:-2])
        return self.violation(C).flatten(-2).amax(-1)


def empty_constraints(N: int, device=None) -> ConstraintSet:
    return ConstraintSet.build([], N, device=device)
