"""The scan Riccati sweep as a batched plain function.

Counterpart of ``trajopt_tpu/solvers/ilqr.py::_backward_pass_impl``'s
``_scan_sweep`` (reference _backwardpass!, backward_pass.jl:9-85), which is
also what the plain Riccati TPU kernel ``ops/pallas_riccati.py`` computes.
It is the plain version of the Riccati kernel K5 (``csrc/riccati_sweep.cu``,
wrapper ``ops/cuda_riccati.py``), sets the semantics of the Riccati step
inside the fused backward kernels (``csrc/fused_backward.cu``,
``csrc/fused_al_backward.cu``), and runs on the CPU.
"""
from __future__ import annotations

import torch

from trajopt_tpu_torch.ops.cost import Expansion
from trajopt_tpu_torch.ops.linalg import posdef_solve


def scan_sweep(A, B, exp: Expansion, rho_val, reg_state: bool = False):
    """One backward sweep over the knots, batched over a leading problem
    dimension. Gains come from the regularized Quu (control
    regularization ρI, or state regularization ρBᵀB / ρBᵀA with
    ``reg_state``); the cost-to-go is updated with the unregularized Quu
    and Qux (backward_pass.jl:66-72). A stage whose Quu_reg is not positive
    definite gets zero gains, sets the problem's fail flag, and the sweep
    goes on.

    A (B, N-1, n, n), B (B, N-1, n, m), exp: batched Expansion, rho_val (B,).
    Returns (K (B, N-1, m, n), d (B, N-1, m), dV1 (B,), dV2 (B,), fail (B,)).
    """
    n, m = A.shape[-1], B.shape[-1]
    Nm1 = A.shape[-3]
    batch = A.shape[:-3]
    dtype, dev = A.dtype, A.device
    eye_m = torch.eye(m, dtype=dtype, device=dev)
    rho3 = rho_val[..., None, None]

    Sx = exp.x[..., -1, :]
    Sxx = exp.xx[..., -1, :, :]
    dV1 = torch.zeros(batch, dtype=dtype, device=dev)
    dV2 = torch.zeros_like(dV1)
    fail = torch.zeros(batch, dtype=torch.bool, device=dev)
    Ks, ds = [None] * Nm1, [None] * Nm1
    for k in reversed(range(Nm1)):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        At, Bt = A_k.transpose(-1, -2), B_k.transpose(-1, -2)
        SxxA = Sxx @ A_k
        SxxB = Sxx @ B_k
        Qx = exp.x[..., k, :] + (At @ Sx[..., None])[..., 0]
        Qu = exp.u[..., k, :] + (Bt @ Sx[..., None])[..., 0]
        Qxx = exp.xx[..., k, :, :] + At @ SxxA
        Quu = exp.uu[..., k, :, :] + Bt @ SxxB
        Qux = exp.ux[..., k, :, :] + Bt @ SxxA

        if reg_state:
            Quu_reg = Quu + rho3 * (Bt @ B_k)
            Qux_reg = Qux + rho3 * (Bt @ A_k)
        else:
            Quu_reg = Quu + rho3 * eye_m
            Qux_reg = Qux
        Quu_reg = 0.5 * (Quu_reg + Quu_reg.transpose(-1, -2))
        rhs = torch.cat([Qux_reg, Qu[..., None]], dim=-1)
        sol, fail_k = posdef_solve(Quu_reg, rhs)
        sol = torch.where(fail_k[..., None, None], torch.zeros_like(sol), sol)
        K_k = -sol[..., :n]
        d_k = -sol[..., n]

        Kt = K_k.transpose(-1, -2)
        Quu_d = (Quu @ d_k[..., None])[..., 0]
        Sx = (Qx + (Kt @ Quu_d[..., None])[..., 0]
              + (Kt @ Qu[..., None])[..., 0]
              + (Qux.transpose(-1, -2) @ d_k[..., None])[..., 0])
        Sxx = Qxx + Kt @ Quu @ K_k + Kt @ Qux + Qux.transpose(-1, -2) @ K_k
        Sxx = 0.5 * (Sxx + Sxx.transpose(-1, -2))

        dV1 = dV1 + (d_k * Qu).sum(-1)
        dV2 = dV2 + 0.5 * (d_k * Quu_d).sum(-1)
        fail = fail | fail_k
        Ks[k], ds[k] = K_k, d_k
    return torch.stack(Ks, dim=-3), torch.stack(ds, dim=-2), dV1, dV2, fail
