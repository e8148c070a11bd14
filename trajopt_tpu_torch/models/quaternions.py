"""Quaternion utilities (scalar-first [w, x, y, z]).

Counterpart of ``trajopt_tpu/models/quaternions.py``: the quaternion error
state, its Jacobians and the error-state projection of a linearization.
Every function broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import torch

from trajopt_tpu_torch.models.zoo import quat_mul


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_error(q, q_ref):
    """3-parameter attitude error: the Cayley/Rodrigues parameters of
    q_ref⁻¹ ⊗ q, δθ = 2·vec(dq)/w(dq).

    Cancellation-free form: conj(q_ref) ⊗ q = [|q_ref|², 0, 0, 0]
    + conj(q_ref) ⊗ (q − q_ref); the difference is exact in floating point,
    so the f32 error is relative to |δθ| instead of absolute ~ε. At a 180°
    relative rotation (w → 0) a sign-preserving floor of 1e-6 on the
    denominator keeps the output finite; the rollout's divergence guard
    handles the huge value.
    """
    de = quat_mul(quat_conj(q_ref), q - q_ref)
    w = (q_ref * q_ref).sum(-1) + de[..., 0]
    floor = w.new_full((), 1e-6)
    w_safe = torch.where(w.abs() < 1e-6, torch.where(w < 0, -floor, floor), w)
    return 2.0 * de[..., 1:] / w_safe[..., None]


def state_diff(x, x_ref, quat_slice=None):
    """δx with the ``quat_slice`` block replaced by ``quat_error``: n-1
    entries (linear difference when ``quat_slice`` is None)."""
    if quat_slice is None:
        return x - x_ref
    a, b = quat_slice
    dth = quat_error(x[..., a:b], x_ref[..., a:b])
    return torch.cat([x[..., :a] - x_ref[..., :a], dth,
                      x[..., b:] - x_ref[..., b:]], dim=-1)


def _att_jac_batch(Q):
    """G(q) (…, 4, 3): d q / d δθ at δθ = 0, 0.5·Lmult(q) columns 1:3."""
    w, x, y, z = Q[..., 0], Q[..., 1], Q[..., 2], Q[..., 3]
    return 0.5 * torch.stack([
        torch.stack([-x, -y, -z], -1),
        torch.stack([w, -z, y], -1),
        torch.stack([z, w, -x], -1),
        torch.stack([-y, x, w], -1)], -2)


def _att_jac_pinv_batch(Q):
    """G⁺(q) (…, 3, 4): 2·Lmult(q)ᵀ rows 1:3, the pseudo-inverse of G."""
    w, x, y, z = Q[..., 0], Q[..., 1], Q[..., 2], Q[..., 3]
    return 2.0 * torch.stack([
        torch.stack([-x, w, z, -y], -1),
        torch.stack([-y, -z, w, x], -1),
        torch.stack([-z, y, -x, w], -1)], -2)


def project_error_state(X, A, B, exp, quat_slice):
    """Project trajectory Jacobians + cost expansion into the error-state
    tangent space, using E's block structure: E(x) = blockdiag(I, G(q), I)
    and E⁺ = blockdiag(I, G⁺(q), I), so only the 4-wide quaternion blocks
    transform.

        A_e = E⁺(x') A E(x),  B_e = E⁺(x') B,
        lx_e = Eᵀ lx,  lxx_e = Eᵀ lxx E (Gauss-Newton),  lux_e = lux E.

    X: (…, N, n); A, B: (…, N-1, n, ·); exp: Expansion.
    Returns (A_e, B_e, exp_e) with state dimension n-1.
    """
    from trajopt_tpu_torch.ops.cost import Expansion

    a, b = quat_slice
    G = _att_jac_batch(X[..., a:b])          # (…, N, 4, 3)
    Gi = _att_jac_pinv_batch(X[..., a:b])    # (…, N, 3, 4)

    def cols(M, Gk):
        """M @ E: transform the last axis (columns)."""
        mid = (M[..., a:b][..., None] * Gk[..., None, :, :]).sum(-2)
        return torch.cat([M[..., :a], mid, M[..., b:]], dim=-1)

    def rows_pinv(M, Gik):
        """E⁺ @ M: transform the second-to-last axis (rows) by G⁺."""
        mid = (Gik[..., None] * M[..., None, a:b, :]).sum(-2)
        return torch.cat([M[..., :a, :], mid, M[..., b:, :]], dim=-2)

    def rows_T(M, Gk):
        """Eᵀ @ M: transform rows by Gᵀ."""
        mid = (Gk[..., :, :, None] * M[..., a:b, None, :]).sum(-3)
        return torch.cat([M[..., :a, :], mid, M[..., b:, :]], dim=-2)

    A_e = rows_pinv(cols(A, G[..., :-1, :, :]), Gi[..., 1:, :, :])
    B_e = rows_pinv(B, Gi[..., 1:, :, :])
    lx_mid = (G * exp.x[..., a:b, None]).sum(-2)
    lx_e = torch.cat([exp.x[..., :a], lx_mid, exp.x[..., b:]], dim=-1)
    xx_e = rows_T(cols(exp.xx, G), G)
    ux_e = cols(exp.ux, G[..., :-1, :, :])
    return A_e, B_e, Expansion(x=lx_e, u=exp.u, xx=xx_e, uu=exp.uu, ux=ux_e)
