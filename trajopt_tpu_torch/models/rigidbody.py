"""Rigid-body dynamics of kinematic chains.

Counterpart of ``trajopt_tpu/models/rigidbody.py`` (reference
src/model.jl:377-455 ``Model(urdf)``, dynamics/kuka.jl and the URDF
variants of acrobot, double pendulum and cartpole). A minimal URDF parser
reads a serial or branched chain of revolute, prismatic and fixed joints;
the dynamics are Featherstone spatial algebra on (…, 6, 6) tensors that
broadcast over any leading batch dimensions:

- the mass matrix H(q) by the Composite Rigid Body Algorithm (CRBA),
- the bias forces C(q, q̇)q̇ + G(q) and the inverse dynamics by the
  Recursive Newton-Euler Algorithm (RNEA),
- q̈ = H⁻¹ (B u − C − G − damping·q̇) by the equilibrated elimination of
  ``ops/linalg.py``.

The per-joint loops are Python loops over the (short) chain.
:func:`make_chain_dynamics` adds the structured linearization of the JAX
package's custom JVP: H dq̈ = dτ − damping·dq̇ − ∂ID·(dq, dq̇) with H⁻¹ held
as a primal constant, so the CRBA and the solve are never differentiated;
∂ID is the RNEA's forward-mode derivative written out over the batch
(:meth:`RigidBodyChain.inverse_dynamics_jacobian`), with no ``torch.func``
transform, whose per-op overhead would set the pace at these sizes.
Every component is taken as a width-1 slice, never a 0-d index: under
``torch.func.jacfwd`` a Python float times a 0-d element is promoted to
float64.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from trajopt_tpu_torch.models.base import Model
from trajopt_tpu_torch.ops.linalg import posdef_solve, spd_solve_vec


# ------------------------------------------------------------ URDF parsing

@dataclass
class UrdfJoint:
    name: str
    jtype: str                 # revolute | continuous | prismatic | fixed
    parent: str
    child: str
    origin_xyz: np.ndarray
    origin_rpy: np.ndarray
    axis: np.ndarray
    damping: float = 0.0


@dataclass
class UrdfLink:
    name: str
    mass: float = 0.0
    com: np.ndarray = field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = field(default_factory=lambda: np.zeros((3, 3)))
    inertia_rpy: np.ndarray = field(default_factory=lambda: np.zeros(3))


def _parse_vec(s, default):
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.array([float(v) for v in s.split()], dtype=np.float64)


def parse_urdf(path: str):
    """Links and joints of a URDF file: {name: UrdfLink}, [UrdfJoint]."""
    root = ET.parse(path).getroot()
    links: dict[str, UrdfLink] = {}
    joints: list[UrdfJoint] = []
    for le in root.findall("link"):
        link = UrdfLink(name=le.get("name"))
        ine = le.find("inertial")
        if ine is not None:
            me = ine.find("mass")
            link.mass = float(me.get("value")) if me is not None else 0.0
            oe = ine.find("origin")
            if oe is not None:
                link.com = _parse_vec(oe.get("xyz"), [0, 0, 0])
                link.inertia_rpy = _parse_vec(oe.get("rpy"), [0, 0, 0])
            ie = ine.find("inertia")
            if ie is not None:
                g = {k: float(ie.get(k, 0)) for k in
                     ("ixx", "iyy", "izz", "ixy", "ixz", "iyz")}
                link.inertia = np.array([[g["ixx"], g["ixy"], g["ixz"]],
                                         [g["ixy"], g["iyy"], g["iyz"]],
                                         [g["ixz"], g["iyz"], g["izz"]]])
        links[link.name] = link
    for je in root.findall("joint"):
        origin = je.find("origin")
        axis = je.find("axis")
        dyn = je.find("dynamics")
        joints.append(UrdfJoint(
            name=je.get("name"),
            jtype=je.get("type"),
            parent=je.find("parent").get("link"),
            child=je.find("child").get("link"),
            origin_xyz=_parse_vec(
                origin.get("xyz") if origin is not None else None, [0, 0, 0]),
            origin_rpy=_parse_vec(
                origin.get("rpy") if origin is not None else None, [0, 0, 0]),
            axis=_parse_vec(axis.get("xyz") if axis is not None else None,
                            [1, 0, 0]),
            damping=float(dyn.get("damping", 0)) if dyn is not None else 0.0,
        ))
    return links, joints


# ----------------------------------------------------- spatial algebra (np)

def _rpy_to_R(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def _skew_np(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _X_from_np(E, r):
    """Spatial motion transform [[E, 0], [−E·skew(r), E]] (Featherstone
    eq. 2.24-2.27): child frame at r (parent coordinates), rotation E
    (child ← parent)."""
    X = np.zeros((6, 6))
    X[:3, :3] = E
    X[3:, 3:] = E
    X[3:, :3] = -E @ _skew_np(r)
    return X


# ------------------------------------------------- spatial algebra (torch)

def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _mTv(A, v):
    return (A.transpose(-1, -2) @ v[..., None])[..., 0]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _crm_mv(v, w):
    """(v ×) w, the spatial motion cross product."""
    return torch.cat([_cross(v[..., :3], w[..., :3]),
                      _cross(v[..., 3:], w[..., :3])
                      + _cross(v[..., :3], w[..., 3:])], dim=-1)


def _crf_mv(v, w):
    """(v ×*) w = −(v ×)ᵀ w, the spatial force cross product."""
    return torch.cat([_cross(v[..., :3], w[..., :3])
                      + _cross(v[..., 3:], w[..., 3:]),
                      _cross(v[..., :3], w[..., 3:])], dim=-1)


class RigidBodyChain:
    """Serial (or branched-serial) kinematic chain with Featherstone
    dynamics, from a URDF file or from links and joints."""

    def __init__(self, urdf_path: Optional[str] = None, floating: bool = False,
                 links: Optional[dict] = None, joints: Optional[list] = None):
        if floating:
            raise NotImplementedError("floating-base chains are not ported")
        if urdf_path is not None:
            links, joints = parse_urdf(urdf_path)
        self.links = links
        # joints in traversal order from the root (the link no joint moves)
        children = {j.child for j in joints}
        roots = [nm for nm in links if nm not in children]
        if len(roots) != 1:
            raise ValueError(f"expected a single root link, got {roots}")
        order = []
        frontier = [roots[0]]
        while frontier:
            parent = frontier.pop(0)
            for j in joints:
                if j.parent == parent:
                    order.append(j)
                    frontier.append(j.child)
        self.all_joints = order
        self.moving = [j for j in order if j.jtype != "fixed"]
        self.ndof = len(self.moving)

        self._Et = {j.name: _rpy_to_R(j.origin_rpy).T for j in order}
        self._pt = {j.name: j.origin_xyz for j in order}
        # spatial inertia of each link in its own frame
        self._I = {}
        for nm, lk in links.items():
            Rrot = _rpy_to_R(lk.inertia_rpy)
            I_com = Rrot @ lk.inertia @ Rrot.T
            Sc = _skew_np(lk.com)
            I_o = I_com + lk.mass * (Sc @ Sc.T)
            self._I[nm] = np.block([[I_o, lk.mass * Sc],
                                    [lk.mass * Sc.T, lk.mass * np.eye(3)]])

        # the static part of _sweep: per moving joint the fixed transform
        # from its parent's moving frame (fixed joints folded in), its motion
        # subspace, the inertia of its link with the fixed children folded
        # onto it, and its parent's index among the moving joints
        frame_of = {order[0].parent: (-1, np.eye(6))}
        I_acc = {-1: np.zeros((6, 6))}
        self._statics = []
        for j in order:
            p_idx, Xp = frame_of[j.parent]
            Xtree = _X_from_np(self._Et[j.name], self._pt[j.name])
            if j.jtype == "fixed":
                Xf = Xtree @ Xp
                frame_of[j.child] = (p_idx, Xf)
                I_acc[p_idx] = I_acc.get(p_idx, np.zeros((6, 6))) \
                    + Xf.T @ self._I[j.child] @ Xf
                continue
            if j.jtype not in ("revolute", "continuous", "prismatic"):
                raise ValueError(f"joint type {j.jtype!r}")
            k = len(self._statics)
            axis = np.asarray(j.axis, np.float64)
            S = np.concatenate([axis, np.zeros(3)]) if j.jtype != \
                "prismatic" else np.concatenate([np.zeros(3), axis])
            self._statics.append((j.jtype, Xtree @ Xp, axis, S, p_idx))
            frame_of[j.child] = (k, np.eye(6))
            I_acc[k] = np.asarray(self._I[j.child], np.float64)
        self._Is = [I_acc[k] for k in range(self.ndof)]
        self._cache = {}

    def _consts(self, like):
        """The chain's static matrices as tensors of ``like``'s dtype and
        device, converted once per pair, stacked over the moving joints:
        XJ(q) = [[E, 0], [L, E]] with E = E0 + Es·sin q + Ec·cos q (the
        revolute rot(axis, q)ᵀ = (I + K²) − K·sin q − K²·cos q; E = I for a
        prismatic joint) and L = Kq·q (−skew(axis)·q for a prismatic joint,
        0 for a revolute one), and Xup = XJ · Xtp."""
        key = (like.dtype, like.device)
        if key not in self._cache:
            def t(a):
                return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                                       device=like.device)
            rows = []
            for jtype, _, axis, _, _ in self._statics:
                K = _skew_np(axis)
                z = np.zeros((3, 3))
                rows.append((np.eye(3), z, z, -K) if jtype == "prismatic"
                            else (np.eye(3) + K @ K, -K, -K @ K, z))
            E0, Es, Ec, Kq = zip(*rows)
            self._cache[key] = dict(
                E0=t(E0), Es=t(Es), Ec=t(Ec), Kq=t(Kq),
                Xtp=t([st[1] for st in self._statics]),
                S=[t(st[3]) for st in self._statics],
                I=[t(I) for I in self._Is])
        return self._cache[key]

    def _sweep(self, q):
        """Per moving joint: Xup (…, 6, 6), S (6,), I (6, 6) with the fixed
        children folded in, and the parent's index (−1: the root)."""
        c = self._consts(q)
        qs = q[..., :, None, None]                            # (…, nd, 1, 1)
        E = c["E0"] + c["Es"] * torch.sin(qs) + c["Ec"] * torch.cos(qs)
        XJ = torch.cat([torch.cat([E, torch.zeros_like(E)], dim=-1),
                        torch.cat([c["Kq"] * qs, E], dim=-1)], dim=-2)
        Xs = XJ @ c["Xtp"]                                    # (…, nd, 6, 6)
        return ([Xs[..., k, :, :] for k in range(self.ndof)], c["S"],
                c["I"], [st[4] for st in self._statics])

    def mass_matrix(self, q):
        """H(q) (…, nd, nd) by the CRBA (Featherstone alg. 6.2)."""
        Xup, S, I, parent = self._sweep(q)
        nd = self.ndof
        batch = q.shape[:-1]
        Ic = list(I)
        H = [[None] * nd for _ in range(nd)]
        for i in range(nd - 1, -1, -1):
            if parent[i] >= 0:
                Ic[parent[i]] = Ic[parent[i]] + \
                    Xup[i].transpose(-1, -2) @ Ic[i] @ Xup[i]
            F = _mv(Ic[i], S[i])
            H[i][i] = (S[i] * F).sum(-1)
            j = i
            while parent[j] >= 0:
                F = _mTv(Xup[j], F)
                j = parent[j]
                H[i][j] = H[j][i] = (S[j] * F).sum(-1)
        zero = q.new_zeros(batch)
        return torch.stack([torch.stack(
            [zero if h is None else h.expand(batch) for h in row], dim=-1)
            for row in H], dim=-2)

    def _rnea(self, q, qd, qdd, gravity):
        """τ = H q̈ + C q̇ + G by the RNEA (Featherstone alg. 5.1); q̈ = None
        is q̈ = 0, the bias forces."""
        Xup, S, I, parent = self._sweep(q)
        nd = self.ndof
        a_grav = torch.zeros(6, dtype=q.dtype, device=q.device)
        a_grav[5] = gravity
        v, a, f = [None] * nd, [None] * nd, [None] * nd
        for i in range(nd):
            vJ = S[i] * qd[..., i:i + 1]
            p = parent[i]
            if p >= 0:
                v[i] = _mv(Xup[i], v[p]) + vJ
                a[i] = _mv(Xup[i], a[p])
            else:
                v[i] = vJ
                a[i] = _mv(Xup[i], a_grav)
            if qdd is not None:
                a[i] = a[i] + S[i] * qdd[..., i:i + 1]
            a[i] = a[i] + _crm_mv(v[i], vJ)
            f[i] = _mv(I[i], a[i]) + _crf_mv(v[i], _mv(I[i], v[i]))
        tau = [None] * nd
        for i in range(nd - 1, -1, -1):
            tau[i] = (S[i] * f[i]).sum(-1, keepdim=True)
            if parent[i] >= 0:
                f[parent[i]] = f[parent[i]] + _mTv(Xup[i], f[i])
        return torch.cat(tau, dim=-1)

    def bias_forces(self, q, qd, gravity=9.81):
        """C(q, q̇)q̇ + G(q) by the RNEA with q̈ = 0 (Featherstone alg. 5.3)."""
        return self._rnea(q, qd, None, gravity)

    def inverse_dynamics(self, q, qd, qdd, gravity=9.81):
        """τ = H(q) q̈ + C(q, q̇)q̇ + G(q) by the full RNEA: the identity the
        structured linearization differentiates."""
        return self._rnea(q, qd, qdd, gravity)

    def forward_kinematics(self, q, point=None, dtype=None,
                           return_axes=False):
        """World positions (…, nd, 3) of every moving link frame's origin;
        with ``point`` also that point of the last link's frame (…, 3);
        with ``return_axes=True`` also the world joint axes (…, nd, 3), the
        ingredients of the geometric Jacobian
        ∂p/∂q_k = 1[k ⪯ link] · z_k × (p − o_k).
        (reference kuka FK helpers, dynamics/kuka.jl:34-60.)"""
        Xup, S, _, parent = self._sweep(q)
        nd = self.ndof
        Xw = [None] * nd
        origins, axes = [], []
        for i in range(nd):
            Xw[i] = Xup[i] if parent[i] < 0 else Xup[i] @ Xw[parent[i]]
            E = Xw[i][..., :3, :3]               # link ← world rotation
            r_skew = -(E.transpose(-1, -2) @ Xw[i][..., 3:, :3])
            origins.append(torch.stack([r_skew[..., 2, 1], r_skew[..., 0, 2],
                                        r_skew[..., 1, 0]], dim=-1))
            if return_axes:
                axes.append(_mTv(E, S[i][:3]))
        out = torch.stack(origins, dim=-2)
        extras = []
        if point is not None:
            pt = torch.as_tensor(point, dtype=q.dtype, device=q.device)
            extras.append(origins[-1] + _mTv(Xw[-1][..., :3, :3], pt))
        if return_axes:
            extras.append(torch.stack(axes, dim=-2))
        return (out, *extras) if extras else out

    def dynamics(self, x, u, B=None, gravity=9.81, use_damping=True):
        """ẋ = [q̇; H⁻¹(B u − bias − damping q̇)].

        ``use_damping=False`` matches the reference's RigidBodyDynamics.jl,
        which does not parse URDF ``<dynamics damping>`` (reference
        model.jl:411-415)."""
        nd = self.ndof
        q, qd = x[..., :nd], x[..., nd:]
        rhs = self._tau(u, B) - self.bias_forces(q, qd, gravity)
        if use_damping:
            rhs = rhs - self._damping(x) * qd
        qdd = spd_solve_vec(self.mass_matrix(q), rhs)
        return torch.cat([qd, qdd], dim=-1)

    def _tau(self, u, B):
        if B is None:
            return u
        return _mv(torch.as_tensor(np.asarray(B), dtype=u.dtype,
                                   device=u.device), u)

    def _damping(self, like):
        return torch.as_tensor([j.damping for j in self.moving],
                               dtype=like.dtype, device=like.device)

    def _sweep_dq(self, q):
        """∂Xup_k/∂q_k (…, 6, 6) per moving joint."""
        c = self._consts(q)
        qs = q[..., :, None, None]
        dE = c["Es"] * torch.cos(qs) - c["Ec"] * torch.sin(qs)
        dXJ = torch.cat([torch.cat([dE, torch.zeros_like(dE)], dim=-1),
                         torch.cat([c["Kq"].expand_as(dE), dE], dim=-1)],
                        dim=-2)
        Xs = dXJ @ c["Xtp"]
        return [Xs[..., k, :, :] for k in range(self.ndof)]

    def inverse_dynamics_jacobian(self, q, qd, qdd, gravity=9.81):
        """∂τ/∂q and ∂τ/∂q̇ (…, nd, nd) of :meth:`inverse_dynamics` at
        fixed q̈: the RNEA's forward-mode derivative written out, the 2·nd
        tangent directions (dq = e_k, then dq̇ = e_k) carried as one more
        batch dimension (…, 2nd, 6), so the whole batch is a few hundred
        tensor ops whatever its size."""
        Xup, S, I, parent = self._sweep(q)
        Xd = self._sweep_dq(q)
        nd = self.ndof
        eye = torch.eye(2 * nd, dtype=q.dtype, device=q.device)
        a_grav = torch.zeros(6, dtype=q.dtype, device=q.device)
        a_grav[5] = gravity

        def mvt(A, dv):             # A (…, 6, 6), dv (…, T, 6): rows A·dv_t
            return dv @ A.transpose(-1, -2)

        def mTvt(A, dv):            # rows Aᵀ dv_t
            return dv @ A

        def onehot(k, w):           # tangent k gets w (…, 6)
            return eye[k][:, None] * w[..., None, :]

        v, a, f, dv, da, df = ([None] * nd for _ in range(6))
        for i in range(nd):
            vJ = S[i] * qd[..., i:i + 1]
            dvJ = eye[nd + i][:, None] * S[i]                 # (T, 6)
            p = parent[i]
            if p >= 0:
                v[i] = _mv(Xup[i], v[p]) + vJ
                dv[i] = mvt(Xup[i], dv[p]) + onehot(i, _mv(Xd[i], v[p])) \
                    + dvJ
                a_in = _mv(Xup[i], a[p])
                da_in = mvt(Xup[i], da[p]) + onehot(i, _mv(Xd[i], a[p]))
            else:
                v[i] = vJ
                dv[i] = dvJ.expand(vJ.shape[:-1] + dvJ.shape)
                a_in = _mv(Xup[i], a_grav)
                da_in = onehot(i, _mv(Xd[i], a_grav))
            a[i] = a_in + S[i] * qdd[..., i:i + 1] + _crm_mv(v[i], vJ)
            da[i] = da_in + _crm_mv(dv[i], vJ[..., None, :].expand_as(dv[i])) \
                + _crm_mv(v[i][..., None, :].expand_as(dv[i]),
                          dvJ.expand_as(dv[i]))
            Iv = _mv(I[i], v[i])
            dIv = mvt(I[i], dv[i])
            f[i] = _mv(I[i], a[i]) + _crf_mv(v[i], Iv)
            df[i] = mvt(I[i], da[i]) \
                + _crf_mv(dv[i], Iv[..., None, :].expand_as(dv[i])) \
                + _crf_mv(v[i][..., None, :].expand_as(dv[i]), dIv)
        dtau = [None] * nd
        for i in range(nd - 1, -1, -1):
            dtau[i] = (S[i] * df[i]).sum(-1)                  # (…, T)
            p = parent[i]
            if p >= 0:
                f[p] = f[p] + _mTv(Xup[i], f[i])
                df[p] = df[p] + mTvt(Xup[i], df[i]) \
                    + onehot(i, _mTv(Xd[i], f[i]))
        D = torch.stack(dtau, dim=-2)                         # (…, nd, T)
        return D[..., :nd], D[..., nd:]

    def linearize(self, x, u, B=None, gravity=9.81, use_damping=True):
        """ẋ and its Jacobians (…, n, n), (…, n, m) at (x, u), structured:
        q̈ = H⁻¹ r with r = B u − bias − damping q̇, and
        ∂q̈ = H⁻¹ (B du − damping dq̇ − ∂ID(q, q̇; q̈ fixed)·(dq, dq̇)), with
        ∂ID from :meth:`inverse_dynamics_jacobian` and H⁻¹ from one solve
        against I: the CRBA and the solve are never differentiated."""
        nd = self.ndof
        q, qd = x[..., :nd], x[..., nd:]
        H = self.mass_matrix(q)
        eye = torch.eye(nd, dtype=x.dtype, device=x.device)
        Hinv, _ = posdef_solve(H, eye.expand(H.shape))
        rhs = self._tau(u, B) - self.bias_forces(q, qd, gravity)
        if use_damping:
            rhs = rhs - self._damping(x) * qd
        qdd = _mv(Hinv, rhs)
        dq, dqd = self.inverse_dynamics_jacobian(q, qd, qdd, gravity)
        if use_damping:
            dqd = dqd + torch.diag_embed(self._damping(x).expand(qd.shape))
        zero = torch.zeros_like(H)
        Fx = torch.cat([torch.cat([zero, eye.expand(H.shape)], dim=-1),
                        torch.cat([-(Hinv @ dq), -(Hinv @ dqd)], dim=-1)],
                       dim=-2)
        Bu = eye if B is None else torch.as_tensor(
            np.asarray(B), dtype=x.dtype, device=x.device)
        HB = Hinv @ Bu
        Fu = torch.cat([torch.zeros_like(HB), HB], dim=-2)
        return torch.cat([qd, qdd], dim=-1), Fx, Fu


def make_chain_dynamics(chain: RigidBodyChain, B=None, gravity: float = 9.81,
                        use_damping: bool = True):
    """``f(x, u) = [q̇; H⁻¹(B u − bias − damping·q̇)]`` with
    ``f.linearize(x, u) -> (ẋ, ∂ẋ/∂x, ∂ẋ/∂u)``, the structured Jacobians
    (:meth:`RigidBodyChain.linearize`) that ``models/base.py::discretize``
    chains through the RK3 stages in place of a ``jacfwd`` through CRBA and
    the solve. The JAX package attaches the same linearization as a custom
    JVP."""

    def f(x, u):
        return chain.dynamics(x, u, B=B, gravity=gravity,
                              use_damping=use_damping)

    def linearize(x, u):
        return chain.linearize(x, u, B=B, gravity=gravity,
                               use_damping=use_damping)

    f.linearize = linearize
    return f


def chain_model(chain: RigidBodyChain, actuated=None, name="robot",
                gravity=9.81, use_damping=True) -> Model:
    """A ``Model`` of the chain's dynamics: fully actuated (m = ndof) or,
    with ``actuated`` a 0/1 vector over the joints, only those."""
    nd = chain.ndof
    if actuated is None:
        B, m = None, nd
    else:
        actuated = np.asarray(actuated, dtype=np.float64)
        cols = np.where(actuated != 0)[0]
        B = np.zeros((nd, len(cols)))
        for i, c in enumerate(cols):
            B[c, i] = actuated[c]
        m = len(cols)
    f = make_chain_dynamics(chain, B=B, gravity=gravity,
                            use_damping=use_damping)
    model = Model(f, 2 * nd, m, name=name)
    model.chain = chain
    # what the chain's CUDA table is made of (models/rigidbody_lanes.py)
    model.chain_meta = dict(B=B, gravity=gravity, use_damping=use_damping)
    model.linearize = f.linearize
    return model


def model_from_urdf(urdf_path: str, actuated=None, name: Optional[str] = None,
                    gravity: float = 9.81) -> Model:
    """A Model from a URDF file (reference ``Model(urdf)``,
    model.jl:444-455, and ``Model(urdf, torques)`` for underactuation).
    ``actuated``: None (m = ndof) or a 0/1 vector over the joints."""
    return chain_model(RigidBodyChain(urdf_path), actuated,
                       name=name or f"urdf({urdf_path})", gravity=gravity)
