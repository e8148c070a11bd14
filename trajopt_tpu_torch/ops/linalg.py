"""Small dense linear algebra, unrolled and batched.

Counterpart of ``trajopt_tpu/ops/linalg.py``: the solve the scan Riccati
sweep and the fused AL backward kernel share, and the mass-matrix solve of
the rigid-body chains. Batched over any leading dimensions in place of
``vmap``.
"""
from __future__ import annotations

import torch

# Equilibrated-space pivot policy (float32): a pivot below −NEG_TOL is
# genuinely indefinite (fail, ρ retry); pivots in (−tol, floor) have run out
# of float32 information and are clamped to the floor instead of failing.
# Same constants as the sqrt stage factorization (ops/cuda_sqrt.py).
PIVOT_NEG_TOL_F32 = 1e-3
PIVOT_FLOOR_F32 = 1e-7


def posdef_solve(S, rhs):
    """Solve S X = rhs for small symmetric positive-definite S (…, m, m),
    rhs (…, m, k), by fully unrolled Gaussian elimination without pivoting.
    Returns (X, fail (…,)); fail is True iff a pivot is not positive (the
    ``isposdef`` check of reference backward_pass.jl:52).

    The elimination runs Jacobi-equilibrated, on D·S·D with
    D = diag(1/√S_ii), and the solution is unscaled: an AL-decorated Quu
    mixes penalty rows ~μ with R_inf slack rows across ~16 decades, and
    raw float32 pivots fail at κ ~ 1/ε. Scaled pivots are O(1), so only
    genuine indefiniteness fails. float64 is strict: any pivot ≤ 0 fails.
    A failed problem's X may be non-finite: callers gate it on ``fail``.
    """
    m = S.shape[-1]
    f32 = S.dtype == torch.float32
    tiny = 1e-30 if f32 else 1e-300
    d = 1.0 / torch.sqrt(torch.diagonal(S, dim1=-2, dim2=-1).clamp(min=tiny))
    S = S * d[..., :, None] * d[..., None, :]
    rhs = rhs * d[..., :, None]
    aug = torch.cat([S, rhs], dim=-1)                      # (…, m, m+k)
    neg_tol, floor = (PIVOT_NEG_TOL_F32, PIVOT_FLOOR_F32) if f32 \
        else (0.0, 0.0)
    fail = torch.zeros(S.shape[:-2], dtype=torch.bool, device=S.device)
    row = torch.arange(m, device=S.device)
    pivs = []
    # one masked rank-1 update of the whole augmented matrix per pivot
    # (a few large ops instead of m − i row updates)
    for i in range(m):
        piv = aug[..., i, i]
        if neg_tol > 0.0:
            fail = fail | (piv < -neg_tol) | ~torch.isfinite(piv)
            piv = piv.clamp(min=floor)
        else:
            fail = fail | (piv <= 0.0) | ~torch.isfinite(piv)
        pivs.append(piv)
        f = (aug[..., :, i] / piv[..., None]) * (row > i)
        aug = aug - f[..., :, None] * aug[..., i, None, :]
    X = aug[..., m:]
    for i in range(m - 1, -1, -1):
        r_i = X[..., i, :] / pivs[i][..., None]
        X = X - (aug[..., :, i] * (row < i))[..., :, None] * r_i[..., None, :]
        X = torch.where((row == i)[:, None], r_i[..., None, :], X)
    return X * d[..., :, None], fail


def spd_solve_vec(H, b):
    """H⁻¹ b for small SPD matrices H (…, m, m) and vectors b (…, m): the
    mass-matrix solve of the rigid-body dynamics (reference dynamics/*.jl
    ``H\\…``). The elimination of :func:`posdef_solve`, solution only."""
    x, _ = posdef_solve(H, b[..., None])
    return x[..., 0]
