"""Canonical (data-representable) constraint stacks for the fused AL kernels.

Counterpart of ``trajopt_tpu/ops/canonical.py``. The AL-fused iteration
kernels (``ops/cuda_al_fused.py``) evaluate the whole (N, P) constraint
stack inside the kernel, per knot and per problem, so the constraint
functions have to be data. Every constraint of the problem zoo is one of
two row kinds:

- ``sphere``: c_p = b_p − Σ_d (x[coords[d]] − ctr[p, d])²   (inequality);
- ``linear`` single-entry rows: c_p = sign_p · z[col_p] + off_p, z = [x; u].

Constraints carry a ``canon`` descriptor (:func:`sphere_canon`,
:func:`linear_canon`); :func:`canonical_stack` compiles a ConstraintSet into
a static ``spec``, per-group tensors for the plain versions, and flat
row tables for the CUDA kernels. A stack with a constraint that has no
descriptor is not canonical and compiles to ``None``; the ``fk_sphere``
rows of the kuka arm (ROADMAP Queue 2, K8) are not ported, so they count
as such.

Knot-validity masks are not part of the canonical data: the AL caller's λ
and μ are already zero on invalid (N, P) rows (``solvers/al.py`` re-masks
them at every outer iteration), so masked rows add nothing to
g = Iμ∘c + λ or to the penalty cost. Nobody may hand these functions, or
the kernels, an unmasked μ.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# row kinds in the kernels' tables
KIND_LINEAR, KIND_SPHERE = 0, 1


def pad_terminal(U):
    """U (…, N-1, m) with a zero control appended for the terminal knot."""
    return torch.cat([U, torch.zeros_like(U[..., :1, :])], dim=-2)


def sphere_canon(coords, ctr, b):
    """Descriptor for sphere/circle rows: c = b − Σ_d (x[coords[d]] − ctr)².
    coords: state indices (len D ≤ 3); ctr (p, D); b (p,) = r²."""
    ctr = np.asarray(ctr, np.float64)
    b = np.asarray(b, np.float64)
    if ctr.shape != (b.shape[0], len(coords)) or len(coords) > 3:
        raise ValueError("sphere_canon: ctr must be (p, D) with D <= 3")
    return ("sphere", tuple(int(c) for c in coords), ctr, b)


def linear_canon(rows, off):
    """Descriptor for single-entry linear rows: c_p = sign·z[col] + off_p.
    rows: (is_u, idx, sign) per row; off (p,)."""
    off = np.asarray(off, np.float64)
    rows = tuple((bool(a), int(i), float(s)) for a, i, s in rows)
    if len(rows) != off.shape[0]:
        raise ValueError("linear_canon: one offset per row")
    return ("linear", rows, off)


def constraint_canon(con, n: int, m: int):
    """The constraint's descriptor re-targeted to problem widths (n, m),
    z-columns resolved, or None if it cannot be represented."""
    canon = getattr(con, "canon", None)
    if canon is None:
        return None
    if canon[0] == "sphere":
        _, coords, ctr, b = canon
        if any(c >= n for c in coords) or bool(np.any(con.equality)):
            return None
        return ("sphere", coords, ctr, b)
    if canon[0] == "linear":
        _, rows, off = canon
        zrows = []
        for is_u, idx, sign in rows:
            if idx >= (m if is_u else n):
                return None
            zrows.append((n + idx if is_u else idx, sign))
        return ("linear", tuple(zrows), off,
                tuple(bool(e) for e in con.equality))
    return None


class CanonStack(NamedTuple):
    """Compiled canonical constraint stack.

    ``spec``: static entries ("sphere", r0, r1, coords) or
    ("linear", r0, r1, used_cols). ``data``: per group, for the plain
    versions, tensors on the stack's device: sphere (ctr (p, D), b (p,)),
    linear (cols (p,) long, sign (p,), off (p,), eq (p,) bool).

    The kernels' tables, one entry per row of the stack: ``row_i`` (P, 4)
    int32 = (kind, c0, c1, c2) with the z-column in c0 for a linear row and
    the state coordinates (−1 = unused) for a sphere row; ``row_f`` (P, 4)
    float32 = (sign, off, eq, 0) or (ctr0, ctr1, ctr2, b). For the
    expansion, ``groups`` (G, 6) int32 = (r0, r1, D, c0, c1, c2) lists the
    sphere groups, and ``col_ptr`` (n + m + 1,) / ``col_rows`` list the
    linear rows by z-column (compressed columns, rows ascending), so each
    column's sum has one owner and one order.
    """

    spec: tuple
    data: tuple
    P: int
    n: int
    m: int
    row_i: torch.Tensor
    row_f: torch.Tensor
    groups: torch.Tensor
    col_ptr: torch.Tensor
    col_rows: torch.Tensor


def canonical_stack(cs, n: int, m: int, dtype=torch.float32,
                    device=None) -> Optional[CanonStack]:
    """Compile a ConstraintSet into a :class:`CanonStack` on ``device``
    (default: where the set's mask lives). None if any constraint lacks a
    canonical descriptor."""
    device = cs.mask.device if device is None else torch.device(device)
    P = cs.P
    spec, data, groups = [], [], []
    row_i = np.zeros((P, 4), np.int32)
    row_f = np.zeros((P, 4), np.float32)
    by_col = [[] for _ in range(n + m)]

    def tensor(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    for con, (r0, r1) in zip(cs.cons, cs.slices):
        c = constraint_canon(con, n, m)
        if c is None:
            return None
        if c[0] == "sphere":
            _, coords, ctr, b = c
            D = len(coords)
            spec.append(("sphere", r0, r1, coords))
            data.append((tensor(ctr), tensor(b)))
            pad = coords + (-1,) * (3 - D)
            groups.append((r0, r1, D) + pad)
            row_i[r0:r1] = (KIND_SPHERE,) + pad
            row_f[r0:r1, :D] = ctr
            row_f[r0:r1, 3] = b
        else:
            _, zrows, off, eqs = c
            cols = [col for col, _ in zrows]
            signs = [s for _, s in zrows]
            spec.append(("linear", r0, r1, tuple(sorted(set(cols)))))
            data.append((tensor(cols, torch.long), tensor(signs), tensor(off),
                         tensor(eqs, torch.bool)))
            row_i[r0:r1, 0] = KIND_LINEAR
            row_i[r0:r1, 1] = cols
            row_f[r0:r1, 0] = signs
            row_f[r0:r1, 1] = off
            row_f[r0:r1, 2] = eqs
            for i, col in enumerate(cols):
                by_col[col].append(r0 + i)
    col_ptr = np.concatenate([[0], np.cumsum([len(r) for r in by_col])])
    col_rows = np.asarray([r for rows in by_col for r in rows], np.int32)
    return CanonStack(
        spec=tuple(spec), data=tuple(data), P=P, n=n, m=m,
        row_i=tensor(row_i, torch.int32), row_f=tensor(row_f, torch.float32),
        groups=tensor(np.asarray(groups, np.int32).reshape(-1, 6),
                      torch.int32),
        col_ptr=tensor(col_ptr, torch.int32),
        col_rows=tensor(col_rows, torch.int32))


# ----------------------------------------------- plain math on the stack
#
# Batched torch evaluation of the canonical stack, (…, N, ·) layout: what
# the kernels compute per knot and per problem. canon_evaluate is pinned
# against ConstraintSet.evaluate by the tests.

def _group_values(entry, tensors, X, Z):
    """(C (…, N, p), offsets) of one group; offsets are the sphere's v_d."""
    if entry[0] == "sphere":
        ctr, b = tensors
        vs = [X[..., c:c + 1] - ctr[:, d] for d, c in enumerate(entry[3])]
        C = b
        for v in vs:
            C = C - v * v
        return C, vs
    cols, sign, off, _ = tensors
    return sign * Z[..., cols] + off, None


def canon_evaluate(stack: CanonStack, X, U_pad):
    """C (…, N, P) from canonical data, rows NOT masked (callers rely on
    masked λ/μ). X (…, N, n), U_pad (…, N, m) with a zero terminal row."""
    Z = torch.cat([X, U_pad], dim=-1)
    cols = [X.new_zeros(X.shape[:-1] + (0,))]
    for entry, tensors in zip(stack.spec, stack.data):
        cols.append(_group_values(entry, tensors, X, Z)[0])
    return torch.cat(cols, dim=-1)


def _weights(entry, tensors, C, lam_g, mu_g, atol):
    """Active-set rule per row: act = (c ≥ atol) | (λ > 0), and 1 on
    equality rows. Returns (g, Iμ)."""
    act = (C >= atol) | (lam_g > 0)
    if entry[0] == "linear":
        act = act | tensors[3]
    imu = torch.where(act, mu_g, torch.zeros_like(mu_g))
    return imu * C + lam_g, imu


def canon_al_cost(stack: CanonStack, X, U_pad, lam, mu, atol=0.0):
    """Σ_k Σ_p λ c + ½ c Iμ c over the stack → (…,)."""
    Z = torch.cat([X, U_pad], dim=-1)
    total = X.new_zeros(X.shape[:-2])
    for entry, tensors in zip(stack.spec, stack.data):
        r0, r1 = entry[1], entry[2]
        C, _ = _group_values(entry, tensors, X, Z)
        lam_g = lam[..., r0:r1]
        _, imu = _weights(entry, tensors, C, lam_g, mu[..., r0:r1], atol)
        total = total + (lam_g * C + 0.5 * C * imu * C).sum((-2, -1))
    return total


def canon_al_expansion(stack: CanonStack, X, U_pad, lam, mu, atol=0.0):
    """Gauss-Newton AL expansion of the stack, full N: (lx (…, N, n),
    lu (…, N, m), lxx (…, N, n, n), luu (…, N, m, m)); lz = Jᵀg,
    H = JᵀIμJ. No canonical kind has u-x cross terms."""
    n, m = X.shape[-1], U_pad.shape[-1]
    Z = torch.cat([X, U_pad], dim=-1)
    lz = Z.new_zeros(Z.shape)
    Hd = Z.new_zeros(Z.shape)                 # diagonal of the z-z Hessian
    lxx = X.new_zeros(X.shape + (n,))
    for entry, tensors in zip(stack.spec, stack.data):
        r0, r1 = entry[1], entry[2]
        C, vs = _group_values(entry, tensors, X, Z)
        g, imu = _weights(entry, tensors, C, lam[..., r0:r1],
                          mu[..., r0:r1], atol)
        if entry[0] == "sphere":
            coords = entry[3]
            for a, ca in enumerate(coords):
                lz[..., ca] = lz[..., ca] - 2.0 * (g * vs[a]).sum(-1)
                for bb in range(a, len(coords)):
                    cb = coords[bb]
                    h = 4.0 * (imu * vs[a] * vs[bb]).sum(-1)
                    lxx[..., ca, cb] = lxx[..., ca, cb] + h
                    if cb != ca:
                        lxx[..., cb, ca] = lxx[..., cb, ca] + h
        else:
            cols, sign = tensors[0], tensors[1]
            idx = cols.expand(g.shape)
            lz = lz.scatter_add(-1, idx, sign * g)
            Hd = Hd.scatter_add(-1, idx, sign * sign * imu)
    lxx = lxx + torch.diag_embed(Hd[..., :n])
    return lz[..., :n], lz[..., n:], lxx, torch.diag_embed(Hd[..., n:])
