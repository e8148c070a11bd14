"""QR square-root Riccati sweep: the CUDA kernel K1 and its plain twin.

``sqrt_sweep`` is the plain PyTorch version, a batched port of
``trajopt_tpu/solvers/ilqr.py::sqrt_sweep``; it sets the semantics and runs
on the CPU. ``sqrt_sweep_cuda`` is the wrapper of ``csrc/sqrt_sweep.cu``,
the counterpart of ``trajopt_tpu/ops/pallas_sqrt.py::sqrt_sweep_pallas``: a
tensor on the CPU goes to the twin, a CUDA tensor to the kernel, and
anything the kernel does not take raises.
"""
from __future__ import annotations

import torch

from trajopt_tpu_torch.kernels import _build
from trajopt_tpu_torch.ops.cost import Expansion

# Equilibrated-space pivot policy for the stage factorization (f32): a
# pivot below -SQRT_PIVOT_NEG_TOL is genuinely indefinite (fail → ρ-retry);
# pivots in (-tol, floor) are rounding-exhausted PSD pivots, clamped to
# SQRT_PIVOT_FLOOR_F32 (trajopt_tpu/solvers/ilqr.py:188-196).
SQRT_PIVOT_NEG_TOL = 1e-3
SQRT_PIVOT_FLOOR_F32 = 1e-7


def _tiny(dtype):
    return 1e-30 if dtype == torch.float32 else 1e-300


def _chol_rows(M, scale, neg_tol, floor, plain):
    """Upper Cholesky of M (…, p, p) by deferred-update rows. ``plain``:
    pivot accepted at s_ii + 1e-14, fail on a non-positive pivot;
    otherwise the pivot fails below -neg_tol (or ≤ 0 when neg_tol is 0)
    and is clamped to ``floor``. Returns (U, fail)."""
    p = M.shape[-1]
    idx = torch.arange(p, device=M.device)
    out = []
    fail = torch.zeros(M.shape[:-2], dtype=torch.bool, device=M.device)
    for i in range(p):
        s = M[..., i, :] if scale is None \
            else M[..., i, :] * scale[..., i:i + 1] * scale
        for k in range(i):
            s = s - out[k][..., i:i + 1] * out[k]
        piv2 = s[..., i] + 1e-14 if plain else s[..., i]
        if neg_tol > 0.0:
            bad = piv2 < -neg_tol
        else:
            bad = piv2 <= 0.0
        fail = fail | bad | ~torch.isfinite(piv2)
        piv = torch.sqrt(piv2.clamp(min=floor))
        row = s / piv[..., None]
        row = torch.where(idx == i, piv[..., None], row)
        row = torch.where(idx < i, torch.zeros_like(row), row)
        out.append(row)
    return torch.stack(out, dim=-2), fail


def plain_chol_upper(M):
    """Plain elimination with the +1e-14 pivot acceptance, mirroring the
    kernel's plain path so both branch identically near breakdown."""
    return _chol_rows(M, None, 0.0, _tiny(M.dtype), plain=True)


def equilibrated_chol_upper(M):
    """chol(M)ᵀ via Jacobi equilibration: factor D·M·D (unit diagonal) and
    unscale the COLUMNS of its upper factor, (U D⁻¹)ᵀ(U D⁻¹) = M."""
    d_inv = 1.0 / torch.sqrt(torch.diagonal(M, dim1=-2, dim2=-1)
                             .clamp(min=1e-30))
    if M.dtype == torch.float32:
        neg_tol, floor = SQRT_PIVOT_NEG_TOL, SQRT_PIVOT_FLOOR_F32
    else:
        neg_tol, floor = 0.0, 1e-300
    U, fail = _chol_rows(M, d_inv, neg_tol, floor, plain=False)
    return U / d_inv[..., None, :], fail


def robust_chol_upper(M):
    """Plain Cholesky first, equilibrated factor only where it breaks
    down. Returns (U, plain_fail & equilibrated_fail)."""
    U_plain, bad = plain_chol_upper(M)
    U_eq, fail_eq = equilibrated_chol_upper(M)
    return torch.where(bad[..., None, None], U_eq, U_plain), bad & fail_eq


def sqrt_sweep(A, B, exp: Expansion, rho_val):
    """QR square-root Riccati sweep (reference _backwardpass_sqrt!,
    backward_pass.jl:87-169), batched over a leading problem dimension.

    Each knot does ONE QR of the stacked square root of the joint (u, x)
    Hessian, M = [chol([[luu + ρI, lux],[luxᵀ, lxx]]) ; Ssqrt·[B A]], whose
    R factor gives Ruu, Rux and Rxx (the next Ssqrt). ρ enters the joint
    stage block before the Cholesky, so a stage-factor failure is
    ρ-dependent and the retry loop can fix it.

    A (B, N-1, n, n), B (B, N-1, n, m), exp: batched Expansion, rho_val (B,).
    Returns (K (B, N-1, m, n), d (B, N-1, m), dV1 (B,), dV2 (B,), fail (B,)).
    """
    n = A.shape[-1]
    m = B.shape[-1]
    dtype = A.dtype
    Nm1 = A.shape[-3]
    batch = A.shape[:-3]
    eye_m = torch.eye(m, dtype=dtype, device=A.device)

    luu = exp.uu + rho_val[..., None, None, None] * eye_m
    joints = torch.cat([torch.cat([luu, exp.ux], dim=-1),
                        torch.cat([exp.ux.transpose(-1, -2),
                                   exp.xx[..., :-1, :, :]], dim=-1)], dim=-2)
    # the JAX twin skips the equilibrated pass when no stage breaks down;
    # computing it always and selecting gives the same factors
    Mstage, stage_fail = robust_chol_upper(joints)

    lxxN = exp.xx[..., -1, :, :] + 1e-14 * torch.eye(n, dtype=dtype,
                                                     device=A.device)
    Ssqrt, fail = robust_chol_upper(0.5 * (lxxN + lxxN.transpose(-1, -2)))
    Sx = exp.x[..., -1, :]
    dV1 = torch.zeros(batch, dtype=dtype, device=A.device)
    dV2 = torch.zeros_like(dV1)
    Ks, ds = [None] * Nm1, [None] * Nm1
    for k in reversed(range(Nm1)):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        BA = torch.cat([B_k, A_k], dim=-1)                    # (…, n, m+n)
        M = torch.cat([Mstage[..., k, :, :], Ssqrt @ BA], dim=-2)
        R = torch.linalg.qr(M, mode="r").R
        Ruu = R[..., :m, :m]
        Rux = R[..., :m, m:]
        Rxx = R[..., m:, m:]

        diag = torch.diagonal(Ruu, dim1=-2, dim2=-1).abs()
        fail_k = (diag.amin(-1) / diag.amax(-1).clamp(min=1e-300)) < 1e-8
        fail_k = fail_k | torch.isnan(R).flatten(-2).any(-1) \
            | stage_fail[..., k]

        Qx = exp.x[..., k, :] + (A_k.transpose(-1, -2) @ Sx[..., None])[..., 0]
        Qu = exp.u[..., k, :] + (B_k.transpose(-1, -2) @ Sx[..., None])[..., 0]

        K_k = -torch.linalg.solve_triangular(Ruu, Rux, upper=True)
        y = torch.linalg.solve_triangular(Ruu.transpose(-1, -2),
                                          Qu[..., None], upper=False)
        d_k = -torch.linalg.solve_triangular(Ruu, y, upper=True)[..., 0]
        K_k = torch.where(fail_k[..., None, None], torch.zeros_like(K_k), K_k)
        d_k = torch.where(fail_k[..., None], torch.zeros_like(d_k), d_k)

        Qux = Ruu.transpose(-1, -2) @ Rux
        Ruud = (Ruu @ d_k[..., None])[..., 0]
        KT = K_k.transpose(-1, -2)
        Sx = (Qx + (KT @ (Ruu.transpose(-1, -2) @ Ruud[..., None]))[..., 0]
              + (KT @ Qu[..., None])[..., 0]
              + (Qux.transpose(-1, -2) @ d_k[..., None])[..., 0])
        Ssqrt = Rxx
        dV1 = dV1 + (d_k * Qu).sum(-1)
        dV2 = dV2 + 0.5 * (Ruud * Ruud).sum(-1)
        fail = fail | fail_k
        Ks[k], ds[k] = K_k, d_k
    return torch.stack(Ks, dim=-3), torch.stack(ds, dim=-2), dV1, dV2, fail


def sqrt_sweep_cuda(A, B, lx, lu, lxx, luu, lux, rho):
    """Batched sqrt Riccati sweep on kernel K1 (``csrc/sqrt_sweep.cu``).

    Batch-first inputs as ``sqrt_sweep_pallas``: A (B, N-1, n, n),
    B (B, N-1, n, m), lx (B, N, n), lu (B, N-1, m), lxx (B, N, n, n),
    luu (B, N-1, m, m), lux (B, N-1, m, n), rho (B,). Returns
    (K, d, dV1, dV2, fail). CPU tensors run the plain twin; CUDA tensors
    must be contiguous float32 with n + m <= 32, or this raises.
    """
    if A.device.type == "cpu":
        return sqrt_sweep(A, B, Expansion(x=lx, u=lu, xx=lxx, uu=luu, ux=lux),
                          rho)
    Bz, Nm1, n, m = B.shape
    N = Nm1 + 1
    if n + m > 32:
        raise ValueError(f"sqrt_sweep_cuda: n + m = {n + m} > 32")
    for name, t, shape in (
            ("A", A, (Bz, Nm1, n, n)), ("B", B, (Bz, Nm1, n, m)),
            ("lx", lx, (Bz, N, n)), ("lu", lu, (Bz, Nm1, m)),
            ("lxx", lxx, (Bz, N, n, n)), ("luu", luu, (Bz, Nm1, m, m)),
            ("lux", lux, (Bz, Nm1, m, n)), ("rho", rho, (Bz,))):
        _build.check_input("sqrt_sweep_cuda", name, t, shape, A.device)

    lib = _build.load()
    K = torch.empty((Bz, Nm1, m, n), dtype=A.dtype, device=A.device)
    d = torch.empty((Bz, Nm1, m), dtype=A.dtype, device=A.device)
    dV = torch.empty((Bz, 2), dtype=A.dtype, device=A.device)
    fail = torch.empty((Bz,), dtype=torch.bool, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.trajopt_sqrt_sweep_f32(
        A.data_ptr(), B.data_ptr(), lx.data_ptr(), lu.data_ptr(),
        lxx.data_ptr(), luu.data_ptr(), lux.data_ptr(), rho.data_ptr(),
        K.data_ptr(), d.data_ptr(), dV.data_ptr(), fail.data_ptr(),
        Bz, N, n, m, stream)
    _build.check(err, "trajopt_sqrt_sweep_f32")
    sqrt_sweep_cuda.launches += 1
    return K, d, dV[:, 0], dV[:, 1], fail


sqrt_sweep_cuda.launches = 0
