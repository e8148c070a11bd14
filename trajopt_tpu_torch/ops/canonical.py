"""Canonical (data-representable) constraint stacks for the fused AL kernels.

Counterpart of ``trajopt_tpu/ops/canonical.py``. The AL-fused iteration
kernels (``ops/cuda_al_fused.py``) evaluate the whole (N, P) constraint
stack inside the kernel, per knot and per problem, so the constraint
functions have to be data. Every constraint of the problem zoo is one of
three row kinds:

- ``sphere``: c_p = b_p − Σ_d (x[coords[d]] − ctr[p, d])²   (inequality);
- ``linear`` single-entry rows: c_p = sign_p · z[col_p] + off_p, z = [x; u];
- ``fk_sphere``: c_p = b_p − Σ_{d ∈ dims_p} (p_i(q)[d] − ctr[p, d])²
  (inequality), p_i a world point of a rigid-body chain's forward
  kinematics from q = x[:J]: the kuka arm's collision bubbles (reference
  problems/kuka_obstacles.jl:14-60).

Constraints carry a ``canon`` descriptor (:func:`sphere_canon`,
:func:`linear_canon`, :func:`fk_sphere_canon`); :func:`canonical_stack`
compiles a ConstraintSet into a static ``spec``, per-group tensors for the
plain versions, and flat row tables for the CUDA kernels. A stack with a
constraint that has no descriptor is not canonical and compiles to
``None``.

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

# row kinds in the kernels' tables (csrc/canon.cuh)
KIND_LINEAR, KIND_SPHERE, KIND_FK = 0, 1, 2
# the kernels' FK workspace (csrc/canon.cuh kFkMaxJoints, kFkMaxPoints)
FK_MAX_JOINTS, FK_MAX_POINTS = 8, 16
# FK coefficients below this magnitude are exact zeros (the JAX kernel's
# _EPSF drops them)
_EPSF = 1e-12


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


def _tup(a):
    """Nested float tuple of a numpy array (a hashable spec constant)."""
    a = np.asarray(a, np.float64)
    if a.ndim == 1:
        return tuple(float(v) for v in a)
    return tuple(_tup(r) for r in a)


def _fk_affine_coeffs(chain):
    """Rotation-level FK coefficients per moving joint of a revolute chain:
    the local link ← parent transform is (E(q)·Ef, rf) with
    E(q) = (I + K²) − K²·cos q − K·sin q and (Ef, rf) the statically folded
    fixed-joint chain, so the world sweep is E_k = E1_k(q_k) E_parent,
    r_k = r_parent + E_parentᵀ rf_k, z_k = E_kᵀ a_k, o_k = r_k — what
    ``RigidBodyChain.forward_kinematics`` computes, affine in (sin q, cos q).
    Returns (coeffs, parents): coeffs[k] = (R0, Rs, Rc (3, 3), rf (3,),
    axis (3,)), parents[k] the parent's index (−1: the root). The JAX
    package's function."""
    from trajopt_tpu_torch.models.rigidbody import _rpy_to_R, _skew_np

    base = chain.all_joints[0].parent
    frame_of = {base: (-1, np.eye(3), np.zeros(3))}
    out, parents = [], []
    for j in chain.all_joints:
        p_idx, Ep, rp = frame_of[j.parent]
        Et = _rpy_to_R(j.origin_rpy).T
        pt = np.asarray(j.origin_xyz, np.float64)
        # X(Et, pt) ∘ X(Ep, rp) = (Et·Ep, rp + Epᵀ·pt)
        Ef = Et @ Ep
        rf = rp + Ep.T @ pt
        if j.jtype == "fixed":
            frame_of[j.child] = (p_idx, Ef, rf)
            continue
        if j.jtype not in ("revolute", "continuous"):
            raise ValueError(
                f"fk_sphere canon supports revolute chains only ({j.jtype})")
        axis = np.asarray(j.axis, np.float64)
        K = _skew_np(axis)
        K2 = K @ K
        out.append(((np.eye(3) + K2) @ Ef, -K @ Ef, -K2 @ Ef, rf, axis))
        parents.append(p_idx)
        frame_of[j.child] = (len(out) - 1, np.eye(3), np.zeros(3))
    return out, parents


def fk_sphere_canon(chain, points, rows):
    """Descriptor for FK-point sphere and cylinder rows (the kuka arm's
    collision constraints, reference problems/kuka_obstacles.jl:14-60):
    c_row = b_row − Σ_{d ∈ dims} (p_i[d] − ctr[d])², p_i a world point of
    the chain's forward kinematics from q = x[:ndof]: a moving joint's frame
    origin or an offset in a joint's frame. The descriptor embeds the
    chain's static rotation coefficients (:func:`_fk_affine_coeffs`), so the
    kernels run the FK, the rows and their Gauss-Newton expansion from
    tables; the Gauss-Newton rows use the geometric Jacobian
    ∂p/∂q_k = 1[k ≤ kmax] · z_k × (p − o_k), kmax the point's joint.

    points: (joint_idx, offset (3,) or None) per point; rows: (pt_idx,
    ctr (3,), b, dims) per row, in the constraint's row order."""
    coeffs, parents = _fk_affine_coeffs(chain)
    joints = tuple((_tup(R0), _tup(Rs), _tup(Rc), _tup(rf), _tup(ax))
                   for (R0, Rs, Rc, rf, ax) in coeffs)
    pts = tuple((int(jidx), None if off is None else _tup(off))
                for jidx, off in points)
    rws = tuple((int(pt), _tup(ctr), float(b), tuple(int(d) for d in dims))
                for pt, ctr, b, dims in rows)
    meta = (len(coeffs), tuple(int(p) for p in parents), joints, pts, rws)
    return ("fk_sphere", meta)


class FkData(NamedTuple):
    """The fk rows of one constraint as tensors for the plain versions:
    per joint R0, Rs, Rc (J, 3, 3), rf and axis (J, 3) (coefficients below
    1e-12 zeroed, as in the kernels' tables), per point its offset
    (npts, 3) (zero without one), per row its point, ctr (p, 3), b (p,)
    and a 0/1 mask of its dims (p, 3); parents and the points' joints as
    Python tuples."""

    R0: torch.Tensor
    Rs: torch.Tensor
    Rc: torch.Tensor
    rf: torch.Tensor
    ax: torch.Tensor
    off: torch.Tensor
    row_pt: torch.Tensor
    ctr: torch.Tensor
    b: torch.Tensor
    dims: torch.Tensor
    parents: tuple
    pt_joint: tuple


def _fk_numpy(meta):
    nd, parents, joints, pts, rows = meta

    def z(a):
        a = np.array(a, np.float64)
        a[np.abs(a) <= _EPSF] = 0.0
        return a

    dims = np.zeros((len(rows), 3))
    for i, r in enumerate(rows):
        dims[i, list(r[3])] = 1.0
    return dict(
        R0=z([j[0] for j in joints]), Rs=z([j[1] for j in joints]),
        Rc=z([j[2] for j in joints]), rf=z([j[3] for j in joints]),
        ax=z([j[4] for j in joints]),
        off=z([(0.0, 0.0, 0.0) if o is None else o for _, o in pts]),
        row_pt=np.asarray([r[0] for r in rows], np.int64),
        ctr=np.asarray([r[1] for r in rows], np.float64),
        b=np.asarray([r[2] for r in rows], np.float64), dims=dims,
        parents=tuple(parents), pt_joint=tuple(j for j, _ in pts))


def fk_data(meta, dtype=torch.float64, device="cpu") -> FkData:
    """:class:`FkData` of an ``fk_sphere`` meta on ``device``."""
    a = _fk_numpy(meta)
    t = {k: torch.as_tensor(v, device=device,
                            dtype=torch.long if k == "row_pt" else dtype)
         for k, v in a.items() if k not in ("parents", "pt_joint")}
    return FkData(parents=a["parents"], pt_joint=a["pt_joint"], **t)


def fk_frames(fk: FkData, X):
    """The chain's forward kinematics from q = X[..., :J]: joint origins
    (…, J, 3), world joint axes (…, J, 3) and the points (…, npts, 3), in
    the order of the kernels' fk_knot_warp."""
    J = fk.R0.shape[0]
    q = X[..., :J]
    s, c = torch.sin(q)[..., None, None], torch.cos(q)[..., None, None]
    E, r = [None] * J, [None] * J
    for k in range(J):
        E1 = fk.R0[k] + fk.Rs[k] * s[..., k, :, :] + fk.Rc[k] * c[..., k, :, :]
        p = fk.parents[k]
        if p < 0:
            E[k] = E1
            r[k] = fk.rf[k].expand(q.shape[:-1] + (3,))
        else:
            E[k] = E1 @ E[p]
            r[k] = r[p] + (E[p].transpose(-1, -2) @ fk.rf[k][:, None])[..., 0]
    axes = [(E[k].transpose(-1, -2) @ fk.ax[k][:, None])[..., 0]
            for k in range(J)]
    pts = [r[j] + (E[j].transpose(-1, -2) @ fk.off[i][:, None])[..., 0]
           for i, j in enumerate(fk.pt_joint)]
    return torch.stack(r, dim=-2), torch.stack(axes, dim=-2), \
        torch.stack(pts, dim=-2)


def fk_canon_points(meta, X):
    """World FK points (…, npts, 3) of an ``fk_sphere`` meta at states X
    (…, n): the plain version of the kernels' FK (JAX
    ``ops/canonical.py::fk_canon_points``)."""
    return fk_frames(fk_data(meta, X.dtype, X.device), X)[2]


def fk_rows(fk: FkData, X, with_jacobian=False):
    """C (…, p) of the fk rows, c = b − Σ_d dims_d (p[d] − ctr_d)²; with
    ``with_jacobian`` also their q-gradients (…, p, J) by the geometric
    Jacobian, −2 Σ_d v_d (z_k × (p − o_k))_d for k up to the point's
    joint."""
    origins, axes, pts = fk_frames(fk, X)
    v = (pts[..., fk.row_pt, :] - fk.ctr) * fk.dims          # (…, p, 3)
    C = fk.b - (v * v).sum(-1)
    if not with_jacobian:
        return C
    J = origins.shape[-2]
    arm = pts[..., :, None, :] - origins[..., None, :, :]    # (…, npts, J, 3)
    Jp = torch.linalg.cross(axes[..., None, :, :].expand_as(arm), arm, dim=-1)
    kmask = torch.as_tensor(
        [[k <= j for k in range(J)] for j in fk.pt_joint], dtype=X.dtype,
        device=X.device)                                     # (npts, J)
    Jp = Jp * kmask[..., None]
    grow = -2.0 * (v[..., :, None, :] * Jp[..., fk.row_pt, :, :]).sum(-1)
    return C, grow


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
    if canon[0] == "fk_sphere":
        meta = canon[1]
        if meta[0] > n or bool(np.any(con.equality)):
            return None
        return canon
    return None


class CanonStack(NamedTuple):
    """Compiled canonical constraint stack.

    ``spec``: static entries ("sphere", r0, r1, coords),
    ("linear", r0, r1, used_cols) or ("fk_sphere", r0, r1, meta). ``data``:
    per group, for the plain versions, tensors on the stack's device: sphere
    (ctr (p, D), b (p,)), linear (cols (p,) long, sign (p,), off (p,),
    eq (p,) bool), fk_sphere (:class:`FkData`,).

    The kernels' tables, one entry per row of the stack: ``row_i`` (P, 4)
    int32 = (kind, c0, c1, c2) with the z-column in c0 for a linear row, the
    state coordinates (−1 = unused) for a sphere row, and the point and a
    bit mask of the dims for an fk row; ``row_f`` (P, 4) float32 =
    (sign, off, eq, 0) or (ctr0, ctr1, ctr2, b). For the expansion,
    ``groups`` (G, 6) int32 = (r0, r1, D, c0, c1, c2) lists the sphere
    groups, and ``col_ptr`` (n + m + 1,) / ``col_rows`` list the linear rows
    by z-column (compressed columns, rows ascending), so each column's sum
    has one owner and one order. The chain of the fk rows: ``fk_joint``
    (J, 36) float32 = per joint R0, Rs, Rc (row-major 3×3), rf, axis,
    parent and two zeros, and ``fk_point`` (npts, 4) float32 = per point its
    offset and its joint (J = 0 without fk rows; every fk group of a stack
    must share one chain, their points are numbered across the groups).
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
    fk_joint: torch.Tensor
    fk_point: torch.Tensor


def canonical_stack(cs, n: int, m: int, dtype=torch.float32,
                    device=None) -> Optional[CanonStack]:
    """Compile a ConstraintSet into a :class:`CanonStack` on ``device``
    (default: where the set's mask lives). None if any constraint lacks a
    canonical descriptor, or if its fk groups differ in their chain or
    exceed the kernels' FK workspace."""
    device = cs.mask.device if device is None else torch.device(device)
    P = cs.P
    spec, data, groups = [], [], []
    row_i = np.zeros((P, 4), np.int32)
    row_f = np.zeros((P, 4), np.float32)
    by_col = [[] for _ in range(n + m)]
    chain, fk_points = None, []

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
        elif c[0] == "fk_sphere":
            meta = c[1]
            if chain is not None and chain != meta[:3]:
                return None
            chain = meta[:3]
            spec.append(("fk_sphere", r0, r1, meta))
            data.append((fk_data(meta, dtype, device),))
            a = _fk_numpy(meta)
            first = len(fk_points)
            fk_points += [(*a["off"][i], j) for i, j in enumerate(a["pt_joint"])]
            row_i[r0:r1, 0] = KIND_FK
            row_i[r0:r1, 1] = a["row_pt"] + first
            row_i[r0:r1, 2] = a["dims"] @ np.array([1, 2, 4])
            row_f[r0:r1, :3] = a["ctr"]
            row_f[r0:r1, 3] = a["b"]
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
    fk_joint = np.zeros((0, 36), np.float32)
    if chain is not None:
        a = _fk_numpy(chain + ((), ()))
        J = len(a["parents"])
        if J > FK_MAX_JOINTS or len(fk_points) > FK_MAX_POINTS:
            return None
        fk_joint = np.concatenate([
            a["R0"].reshape(J, 9), a["Rs"].reshape(J, 9),
            a["Rc"].reshape(J, 9), a["rf"], a["ax"],
            np.asarray(a["parents"], np.float64)[:, None],
            np.zeros((J, 2))], axis=1)
    col_ptr = np.concatenate([[0], np.cumsum([len(r) for r in by_col])])
    col_rows = np.asarray([r for rows in by_col for r in rows], np.int32)
    return CanonStack(
        spec=tuple(spec), data=tuple(data), P=P, n=n, m=m,
        row_i=tensor(row_i, torch.int32), row_f=tensor(row_f, torch.float32),
        groups=tensor(np.asarray(groups, np.int32).reshape(-1, 6),
                      torch.int32),
        col_ptr=tensor(col_ptr, torch.int32),
        col_rows=tensor(col_rows, torch.int32),
        fk_joint=tensor(fk_joint, torch.float32),
        fk_point=tensor(np.asarray(fk_points, np.float64).reshape(-1, 4),
                        torch.float32))


# ----------------------------------------------- plain math on the stack
#
# Batched torch evaluation of the canonical stack, (…, N, ·) layout: what
# the kernels compute per knot and per problem. canon_evaluate is pinned
# against ConstraintSet.evaluate by the tests.

def _group_values(entry, tensors, X, Z, with_jacobian=False):
    """(C (…, N, p), aux) of one group; aux is the sphere's offsets v_d and,
    ``with_jacobian``, the fk rows' q-gradients (…, N, p, J)."""
    if entry[0] == "fk_sphere":
        if with_jacobian:
            return fk_rows(tensors[0], X, with_jacobian=True)
        return fk_rows(tensors[0], X), None
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
        C, vs = _group_values(entry, tensors, X, Z, with_jacobian=True)
        g, imu = _weights(entry, tensors, C, lam[..., r0:r1],
                          mu[..., r0:r1], atol)
        if entry[0] == "fk_sphere":
            J = vs.shape[-1]
            lz[..., :J] = lz[..., :J] + (g[..., None] * vs).sum(-2)
            lxx[..., :J, :J] = lxx[..., :J, :J] + torch.einsum(
                "...p,...pa,...pb->...ab", imu, vs, vs)
        elif entry[0] == "sphere":
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
