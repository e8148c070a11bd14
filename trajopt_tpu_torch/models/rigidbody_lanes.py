"""The chain step that the CUDA kernels inline, and its plain version.

Counterpart of ``trajopt_tpu/models/rigidbody_lanes.py``, which rebuilds
the chain dynamics for the Pallas kernels with every per-joint transform
affine in (sin q, cos q):

    Xup(q) = C0 + Cs·sin q + Cc·cos q      (revolute; C0 + Cs·q prismatic)

from three static 6×6 coefficient matrices, then the CRBA, the RNEA and the
equilibrated positive-definite solve of the 7×7 mass matrix. Two parts here:

- :func:`_joint_affine_coeffs` and :func:`chain_table` (numpy) build the
  table that the kernels' ``Chain`` trait reads from constant memory
  (``csrc/models.cuh``): per joint the coefficients, the motion subspace,
  the spatial inertia with the fixed children folded in, the parent and
  the joint kind, then the actuation map, the damping and gravity. Every
  coefficient below 1e-12 in magnitude is set to exactly zero, as the JAX
  lane code drops it (``_EPSC``), so the kernel's dense sums add exact
  zeros where the JAX code skips a term;
- :func:`make_chain_dynamics_lanes` and :func:`make_chain_step_lanes`, the
  plain PyTorch version of that trait, batched over leading dimensions,
  with the same table and the same solve (``ops/linalg.py::posdef_solve``,
  whose fail flag it drops, as the kernel does).
"""
from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.models.rigidbody import (
    RigidBodyChain, _crf_mv, _crm_mv, _rpy_to_R, _skew_np,
)
from trajopt_tpu_torch.ops.linalg import posdef_solve

# coefficients below this magnitude are exact zeros in the tables (the JAX
# lane code's _EPSC): cos(π/2) ≈ 6e-17 and its kin
_EPSC = 1e-12
# the most joints a chain table holds (csrc/models.cuh kChainMaxDof)
CHAIN_MAX_DOF = 8


def _xtree_np(Et, pt):
    """Static spatial transform [[E, 0], [−E·skew(r), E]] (numpy)."""
    X = np.zeros((6, 6))
    X[:3, :3] = Et
    X[3:, 3:] = Et
    X[3:, :3] = -Et @ _skew_np(pt)
    return X


def _joint_affine_coeffs(chain: RigidBodyChain):
    """Per moving joint [kind, C0, Cs, Cc, S] with
    Xup(q) = C0 + Cs·sin q + Cc·cos q (kind "rev") or C0 + Cs·q (kind
    "pri", Cc = 0), S the 6-vector motion subspace; the parents' indices
    among the moving joints (−1: the root) and the spatial inertias with
    the fixed children folded in, as ``RigidBodyChain._sweep`` folds them.
    The JAX package's function, line for line."""
    out = []
    base_name = chain.all_joints[0].parent
    frame_of = {base_name: (-1, np.eye(6))}
    I_acc = {}
    parents = []
    for j in chain.all_joints:
        p_idx, Xp = frame_of[j.parent]
        Et = _rpy_to_R(j.origin_rpy).T
        pt = j.origin_xyz
        Xtree = _xtree_np(Et, pt) @ Xp
        if j.jtype == "fixed":
            frame_of[j.child] = (p_idx, Xtree)
            Ic = chain._I[j.child]
            I_acc[p_idx] = I_acc.get(p_idx, np.zeros((6, 6))) \
                + Xtree.T @ Ic @ Xtree
            continue
        k = len(out)
        axis = np.asarray(j.axis, np.float64)
        if j.jtype in ("revolute", "continuous"):
            K = _skew_np(axis)
            K2 = K @ K

            def blk(E):
                M = np.zeros((6, 6))
                M[:3, :3] = E
                M[3:, 3:] = E
                return M
            # E(q) = (I + K²) − K²·cos q − K·sin q  (E = rot(axis, q)ᵀ)
            C0 = blk(np.eye(3) + K2) @ Xtree
            Cs = blk(-K) @ Xtree
            Cc = blk(-K2) @ Xtree
            S = np.concatenate([axis, np.zeros(3)])
            kind = "rev"
        elif j.jtype == "prismatic":
            # X_from(I, axis·q) = I₆ − q·[[0, 0], [skew(axis), 0]]
            C0 = Xtree.copy()
            Cq = np.zeros((6, 6))
            Cq[3:, :3] = -_skew_np(axis)
            Cs = Cq @ Xtree
            Cc = np.zeros((6, 6))
            S = np.concatenate([np.zeros(3), axis])
            kind = "pri"
        else:
            raise ValueError(j.jtype)
        out.append([kind, C0, Cs, Cc, S])
        parents.append(p_idx)
        frame_of[j.child] = (k, np.eye(6))
        I_acc[k] = np.asarray(chain._I[j.child], np.float64)
    Is = [I_acc[k] for k in range(chain.ndof)]
    return out, parents, Is


def _zeroed(a):
    a = np.array(a, np.float64)
    a[np.abs(a) < _EPSC] = 0.0
    return a


def chain_table(chain: RigidBodyChain, B=None, gravity: float = 9.81,
                use_damping: bool = True, dtype=np.float32) -> np.ndarray:
    """The kernels' chain table (float32 for the kernels), in the field
    order of ``ChainTable`` in ``csrc/models.cuh`` (every field a float):

    C (8, 3, 36): C0, Cs, Cc of each joint, row-major 6×6;
    S (8, 6); I (8, 36); Bact (8, 8): τ = Bact·u (rows joints, columns
    controls); damping (8,) (zero unless ``use_damping``); parent (8,);
    prismatic (8,); gravity, ndof, m.
    """
    coeffs, parents, Is = _joint_affine_coeffs(chain)
    nd, D = chain.ndof, CHAIN_MAX_DOF
    if nd > D:
        raise ValueError(f"a chain table holds at most {D} joints, got {nd}")
    Bm = np.eye(nd) if B is None else np.asarray(B, np.float64)
    m = Bm.shape[1]
    C = np.zeros((D, 3, 36))
    S = np.zeros((D, 6))
    I = np.zeros((D, 36))
    Bact = np.zeros((D, D))
    damping = np.zeros(D)
    parent = np.full(D, -1.0)
    prismatic = np.zeros(D)
    for k, (kind, C0, Cs, Cc, Sk) in enumerate(coeffs):
        C[k] = _zeroed(np.stack([C0, Cs, Cc]).reshape(3, 36))
        S[k] = _zeroed(Sk)
        I[k] = _zeroed(Is[k]).reshape(36)
        parent[k] = parents[k]
        prismatic[k] = kind == "pri"
        if use_damping:
            damping[k] = chain.moving[k].damping
    Bact[:nd, :m] = _zeroed(Bm)
    return np.concatenate([
        C.ravel(), S.ravel(), I.ravel(), Bact.ravel(), damping, parent,
        prismatic, [gravity, nd, m]]).astype(dtype)


def _lane_mv(A, v):
    """A v for (…, 6, 6) A and (…, 6) v, summed over k = 0..5 in order."""
    acc = A[..., :, 0] * v[..., 0:1]
    for k in range(1, 6):
        acc = acc + A[..., :, k] * v[..., k:k + 1]
    return acc


def _lane_mTv(A, v):
    """Aᵀ v, summed in the same order."""
    acc = A[..., 0, :] * v[..., 0:1]
    for k in range(1, 6):
        acc = acc + A[..., k, :] * v[..., k:k + 1]
    return acc


def _lane_mm(A, M):
    """A M for (…, 6, 6) A and M, summed over k = 0..5 in order."""
    acc = A[..., :, 0:1] * M[..., 0:1, :]
    for k in range(1, 6):
        acc = acc + A[..., :, k:k + 1] * M[..., k:k + 1, :]
    return acc


def make_chain_dynamics_lanes(chain: RigidBodyChain, B=None,
                              gravity: float = 9.81,
                              use_damping: bool = True):
    """``f(x (…, n), u (…, m)) -> ẋ (…, n)`` as the kernels' ``Chain``
    trait computes it, from the table of :func:`chain_table`: affine Xup,
    the CRBA, the RNEA and the equilibrated solve (fail flag dropped).
    Matches ``RigidBodyChain.dynamics`` to rounding."""
    tab = chain_table(chain, B, gravity, use_damping, dtype=np.float64)
    nd, D = chain.ndof, CHAIN_MAX_DOF
    o = 0
    C = tab[o:o + D * 108].reshape(D, 3, 6, 6)
    o += D * 108
    S = tab[o:o + D * 6].reshape(D, 6)
    o += D * 6
    I = tab[o:o + D * 36].reshape(D, 6, 6)
    o += D * 36
    Bact = tab[o:o + D * D].reshape(D, D)
    o += D * D
    damping = tab[o:o + D]
    parents = [int(p) for p in tab[o + D:o + D + nd]]
    prismatic = [bool(p) for p in tab[o + 2 * D:o + 2 * D + nd]]
    m = int(tab[-1])
    cache = {}

    def consts(like):
        key = (like.dtype, like.device)
        if key not in cache:
            def t(a):
                return torch.as_tensor(np.asarray(a), dtype=like.dtype,
                                       device=like.device)
            cache[key] = (t(C[:nd]), t(S[:nd]), t(I[:nd]),
                          t(Bact[:nd, :m]), t(damping[:nd]),
                          t([0, 0, 0, 0, 0, gravity]))
        return cache[key]

    def f(x, u):
        Ct, St, It, Bt, dt_, a_grav = consts(x)
        q, qd = x[..., :nd], x[..., nd:]
        Xup = []
        for k in range(nd):
            qk = q[..., k:k + 1, None]
            if prismatic[k]:
                Xup.append(Ct[k, 0] + Ct[k, 1] * qk)
            else:
                Xup.append(Ct[k, 0] + Ct[k, 1] * torch.sin(qk)
                           + Ct[k, 2] * torch.cos(qk))

        # CRBA
        Ic = [It[i] for i in range(nd)]
        H = [[None] * nd for _ in range(nd)]
        for i in range(nd - 1, -1, -1):
            p = parents[i]
            if p >= 0:
                XtI = _lane_mm(Xup[i].transpose(-1, -2), Ic[i])
                Ic[p] = Ic[p] + _lane_mm(XtI, Xup[i])
            F = _lane_mv(Ic[i], St[i])
            H[i][i] = (St[i] * F).sum(-1)
            j = i
            while parents[j] >= 0:
                F = _lane_mTv(Xup[j], F)
                j = parents[j]
                H[i][j] = H[j][i] = (St[j] * F).sum(-1)
        batch = q.shape[:-1]
        zero = q.new_zeros(batch)
        Hm = torch.stack([torch.stack(
            [zero if h is None else h.expand(batch) for h in row], dim=-1)
            for row in H], dim=-2)

        # RNEA with q̈ = 0
        v, a, fs = [None] * nd, [None] * nd, [None] * nd
        for i in range(nd):
            vJ = St[i] * qd[..., i:i + 1]
            p = parents[i]
            if p >= 0:
                v[i] = _lane_mv(Xup[i], v[p]) + vJ
                a[i] = _lane_mv(Xup[i], a[p]) + _crm_mv(v[i], vJ)
            else:
                v[i] = vJ
                a[i] = _lane_mv(Xup[i], a_grav) + _crm_mv(v[i], vJ)
            fs[i] = _lane_mv(It[i], a[i]) \
                + _crf_mv(v[i], _lane_mv(It[i], v[i]))
        tau = [None] * nd
        for i in range(nd - 1, -1, -1):
            tau[i] = (St[i] * fs[i]).sum(-1, keepdim=True)
            if parents[i] >= 0:
                fs[parents[i]] = fs[parents[i]] + _lane_mTv(Xup[i], fs[i])
        bias = torch.cat(tau, dim=-1)

        rhs = (Bt @ u[..., None])[..., 0] - bias - dt_ * qd
        qdd, _fail = posdef_solve(Hm, rhs[..., None])
        return torch.cat([qd, qdd[..., 0]], dim=-1)

    return f


def make_chain_step_lanes(chain: RigidBodyChain, B=None,
                          gravity: float = 9.81, use_damping: bool = True):
    """The RK3 step with zero-order hold (``ops/integration.py::rk3``) on
    :func:`make_chain_dynamics_lanes`: the plain version of the kernels'
    ``Chain`` step."""
    f = make_chain_dynamics_lanes(chain, B=B, gravity=gravity,
                                  use_damping=use_damping)

    def step(x, u, dt):
        k1 = dt * f(x, u)
        k2 = dt * f(x + 0.5 * k1, u)
        k3 = dt * f(x - k1 + 2.0 * k2, u)
        return x + (k1 + 4.0 * k2 + k3) / 6.0

    return step
