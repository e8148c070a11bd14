"""Dynamics propagation (rollouts).

Counterpart of ``trajopt_tpu/ops/rollout.py`` (reference src/rollout.jl).
The JAX ``lax.scan`` sweeps become Python loops over the knots, each step
batched over the leading problem dimensions. ``rollout_closed_loop`` is the
plain twin of the CUDA rollout kernel (``ops/cuda_rollout.py``).
"""
from __future__ import annotations

import torch

from trajopt_tpu_torch.models.quaternions import state_diff


def _dt_at(dt, k):
    return dt[..., k] if torch.is_tensor(dt) and dt.ndim > 0 else dt


def rollout(model, x0, U, dt):
    """Open-loop rollout (reference src/rollout.jl:25-48).

    x0: (…, n), U: (…, N-1, m), dt: float or (N-1,). Returns X (…, N, n).
    """
    xs = [x0]
    for k in range(U.shape[-2]):
        xs.append(model.step(xs[-1], U[..., k, :], _dt_at(dt, k)))
    return torch.stack(xs, dim=-2)


def rollout_closed_loop(model, x0, X, U, K, d, alpha, dt,
                        max_state_value=1e8, max_control_value=1e8,
                        quat_slice=None):
    """Closed-loop rollout with TVLQR feedback and line-search step
    ``alpha`` (reference src/rollout.jl:2-23):

        u_k = U_k + K_k δx_k + α d_k,   δx_k = state_diff(x̄_k, X_k)
        x̄_{k+1} = f(x̄_k, u_k)

    A problem whose state or control leaves the limits, or turns
    non-finite, is marked diverged and holds its last state for the rest of
    the sweep.

    x0 (…, n), X (…, N, n), U (…, N-1, m), K (…, N-1, m, ns), d (…, N-1, m),
    alpha (…,) or float. Returns (X̄ (…, N, n), Ū (…, N-1, m), ok (…,)).
    """
    alpha = torch.as_tensor(alpha, dtype=X.dtype, device=X.device)
    x = x0
    diverged = torch.zeros(x0.shape[:-1], dtype=torch.bool, device=x0.device)
    xs, us = [x0], []
    for k in range(U.shape[-2]):
        dx = state_diff(x, X[..., k, :], quat_slice)
        du = (K[..., k, :, :] @ dx[..., None])[..., 0] \
            + alpha[..., None] * d[..., k, :]
        u = U[..., k, :] + du
        x_next = model.step(x, u, _dt_at(dt, k))
        bad = ~((x_next.abs().amax(-1) < max_state_value)
                & (u.abs().amax(-1) < max_control_value))
        bad = bad | ~torch.isfinite(x_next).all(-1) \
            | ~torch.isfinite(u).all(-1)
        diverged = diverged | bad
        x = torch.where(diverged[..., None], x, x_next)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2), ~diverged
