"""Quaternion utilities (scalar-first [w, x, y, z]).

Counterpart of ``trajopt_tpu/models/quaternions.py`` (reference
dynamics/quaternions.jl): the product matrices, the rotation matrix, the
quaternion error state, its Jacobians and the error-state projection of a
linearization. Every function broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import torch

from trajopt_tpu_torch.models.zoo import quat_mul, quat_rotate  # noqa: F401


def _mat(rows):
    """A (…, r, c) matrix from rows of (…) entries."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def skew(v):
    """(reference quaternions.jl:42-48): skew(v) @ r == v × r."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return _mat([[o, -z, y], [z, o, -x], [-y, x, o]])


def Lmult(q):
    """Left-multiplication matrix: Lmult(q) @ p == quat_mul(q, p)
    (reference quaternions.jl:50-56)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _mat([[w, -x, -y, -z], [x, w, -z, y], [y, z, w, -x],
                 [z, -y, x, w]])


def Rmult(q):
    """Right-multiplication matrix: Rmult(q) @ p == quat_mul(p, q)
    (reference quaternions.jl:58-64)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _mat([[w, -x, -y, -z], [x, w, z, -y], [y, -z, w, x],
                 [z, y, -x, w]])


def quat_to_rotmat(q):
    """Direction-cosine matrix of a unit quaternion (reference conj(q)
    matrix form, quaternions.jl:66-75): vvᵀ + w²I + 2wS + S², S = skew(v)."""
    w, v = q[..., 0:1, None], q[..., 1:]
    S = skew(v)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return v[..., :, None] * v[..., None, :] + w * w * eye + 2.0 * w * S \
        + S @ S


def normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_error_jacobian(q):
    """Attitude Jacobian G(q) (…, 4, 3): d q / d δθ at δθ = 0 for the
    multiplicative perturbation q ⊗ [1; δθ/2], 0.5·Lmult(q) columns 1:3."""
    return 0.5 * Lmult(q)[..., :, 1:]


def state_diff_jacobian(x, quat_slice):
    """E(x) (…, n, n-1), E = blockdiag(I, G(q), I): maps error-state
    tangents to raw-state tangents."""
    a, b = quat_slice
    n = x.shape[-1]
    E = x.new_zeros(x.shape[:-1] + (n, n - 1))
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    E[..., :a, :a] = eye[:a, :a]
    E[..., a:b, a:a + 3] = quat_error_jacobian(x[..., a:b])
    E[..., b:, a + 3:] = eye[b:, b:]
    return E


def state_diff_jacobian_inv(x, quat_slice):
    """E⁺(x) (…, n-1, n): the Jacobian of ``state_diff(·, x)`` at
    coincidence, blockdiag(I, 2·Lmult(q)ᵀ rows 1:, I), the pseudo-inverse
    of E (GᵀG = I/4, so Eᵀ alone is not the inverse map)."""
    a, b = quat_slice
    n = x.shape[-1]
    Ei = x.new_zeros(x.shape[:-1] + (n - 1, n))
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    Ei[..., :a, :a] = eye[:a, :a]
    Ei[..., a:a + 3, a:b] = 2.0 * Lmult(x[..., a:b]).transpose(-1, -2)[
        ..., 1:, :]
    Ei[..., a + 3:, b:] = eye[b:, b:]
    return Ei


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
