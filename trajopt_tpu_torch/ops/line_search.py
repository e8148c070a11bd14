"""The batched backtracking line search and what its loops share.

Counterpart of the loop inside ``trajopt_tpu/solvers/ilqr.py::forward_pass``
(reference forwardpass!, forward_pass.jl:5-85), written once for
``solvers/ilqr.py::forward_pass`` and for the plain versions of the fused
forward kernels (``ops/cuda_fused.py::fused_forward``,
``ops/cuda_al_fused.py::fused_al_forward``). The JAX
``while_loop`` becomes a Python loop with a per-problem mask; every loop
test reads one boolean from the device, and ``HostSyncs`` counts those
reads.
"""
from __future__ import annotations

import torch


class HostSyncs:
    """Counts the device-to-host reads the solver's Python loops make: each
    loop test waits for the device to finish and copies one boolean."""

    def __init__(self):
        self.count = 0
        # problems whose open-loop seed rollout blew up, so that the
        # initial-rollout guard of ilqr_solve held x0 instead
        self.held = 0

    def any(self, mask: torch.Tensor) -> bool:
        self.count += 1
        return bool(mask.any())

    def item(self, t: torch.Tensor):
        """One device value read to the host."""
        self.count += 1
        return t.item()


def where_rows(mask, a, b):
    """Per-problem select over a leading batch dimension."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def reg_increase(rho, drho, factor: float, reg_min: float):
    """(reference regularization_update! :increase, ilqr_methods.jl:164-171)."""
    drho = torch.clamp(drho * factor, min=factor)
    rho = torch.clamp(rho * drho, min=reg_min)
    return rho, drho


def line_search(rollout_fn, cost_fn, X, U, dV1, dV2, J_prev, rho, drho,
                alpha0, ls_lb, ls_ub, ls_iters, reg_min, reg_factor, reg_fp,
                active=None, syncs: HostSyncs | None = None):
    """Per-problem α halving, divergence retry, and restore + ρ bump once
    the search runs out. ``rollout_fn(alpha (B,)) -> (X̄, Ū, ok)`` rolls one
    candidate for all problems, ``cost_fn(X̄, Ū) -> J (B,)``; a problem
    leaves the search when its own condition is met. Returns
    (X̄, Ū, J, rho, drho, alpha_used): the accepted candidate, or X, U,
    J_prev and α = 0 where the search ran out."""
    syncs = HostSyncs() if syncs is None else syncs
    Bz = X.shape[0]
    dtype, dev = X.dtype, X.device
    alpha = torch.ones(Bz, dtype=dtype, device=dev) if alpha0 is None \
        else torch.as_tensor(alpha0, dtype=dtype, device=dev).expand(Bz)
    it = torch.zeros(Bz, dtype=torch.int32, device=dev)
    J = torch.full((Bz,), float("inf"), dtype=dtype, device=dev)
    z = -torch.ones(Bz, dtype=dtype, device=dev)
    Xb, Ub = X, U
    done = torch.zeros(Bz, dtype=torch.bool, device=dev)
    active = torch.ones(Bz, dtype=torch.bool, device=dev) if active is None \
        else active

    def searching():
        s = ((z <= ls_lb) | (z > ls_ub)) & (J >= J_prev)
        return s & ~done & active

    go = searching()
    passes = 0
    while syncs.any(go):
        over = it > ls_iters

        # exhausted branch (forward_pass.jl:22-37): restore & bump ρ
        rho_o, drho_o = reg_increase(rho, drho, reg_factor, reg_min)
        rho_o = rho_o + reg_fp

        # normal branch: rollout at the current α. A problem searches from
        # the first pass until it leaves for good, so every searching
        # problem has taken as many passes as the loop: past ls_iters all
        # of them take the exhausted branch, and no rollout is needed
        if passes <= ls_iters:
            Xc, Uc, ok = rollout_fn(alpha.contiguous())
            J_c = cost_fn(Xc, Uc)
            expected_c = -alpha * (dV1 + alpha * dV2)
            z_c = torch.where(expected_c > 0.0, (J_prev - J_c) / expected_c,
                              -torch.ones_like(J_c))

            # a diverged rollout keeps J = inf and just halves α
            J_n = torch.where(ok, J_c, J)
            z_n = torch.where(ok, z_c, z)
            Xb_n = where_rows(ok, Xc, Xb)
            Ub_n = where_rows(ok, Uc, Ub)
        else:
            J_n, z_n, Xb_n, Ub_n = J, z, Xb, Ub
        passes += 1

        # exhausted vs normal, applied only where the search is running
        zero = torch.zeros_like(alpha)
        alpha = torch.where(go, torch.where(over, zero, alpha / 2.0), alpha)
        it = torch.where(go, it + 1, it)
        J = torch.where(go, torch.where(over, J_prev, J_n), J)
        z = torch.where(go, torch.where(over, zero, z_n), z)
        Xb = where_rows(go, where_rows(over, X, Xb_n), Xb)
        Ub = where_rows(go, where_rows(over, U, Ub_n), Ub)
        rho = torch.where(go, torch.where(over, rho_o, rho), rho)
        drho = torch.where(go, torch.where(over, drho_o, drho), drho)
        done = torch.where(go, over, done)
        go = searching()
    return Xb, Ub, J, rho, drho, alpha * 2.0
