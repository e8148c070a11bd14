"""Closed-loop rollout on the CUDA kernel K2.

``rollout_closed_loop_cuda`` wraps ``csrc/rollout_quadrotor.cu``, the
counterpart of ``trajopt_tpu/ops/pallas_rollout.py::
rollout_closed_loop_pallas`` with the quadrotor RK3 step and quaternion
error state inlined. A tensor on the CPU goes to the plain twin
``ops/rollout.py::rollout_closed_loop``; a CUDA tensor goes to the kernel,
and anything the kernel does not take raises.
"""
from __future__ import annotations

import numbers

import torch

from trajopt_tpu_torch.kernels import _build
from trajopt_tpu_torch.ops.rollout import rollout_closed_loop


def rollout_closed_loop_cuda(model, x0, X, U, K, d, alpha, dt,
                             max_state_value=1e8, max_control_value=1e8,
                             quat_slice=None):
    """Batched closed-loop rollout, batch-first like
    ``rollout_closed_loop_pallas``: x0 (B, n), X (B, N, n), U (B, N-1, m),
    K (B, N-1, m, ns), d (B, N-1, m), alpha (B,). Returns
    (X̄ (B, N, n), Ū (B, N-1, m), ok (B,) bool).

    On CUDA the model must carry the quadrotor RK3 step (``cuda_step``),
    ``dt`` must be one uniform Python float, and ``quat_slice`` must be
    the quadrotor's (3, 7): the kernel runs the error state (ns = 12) only.
    """
    if X.device.type == "cpu":
        return rollout_closed_loop(model, x0, X, U, K, d, alpha, dt,
                                   max_state_value=max_state_value,
                                   max_control_value=max_control_value,
                                   quat_slice=quat_slice)
    if getattr(model, "cuda_step", None) != "quadrotor_rk3":
        raise NotImplementedError(
            f"no CUDA rollout step for model {getattr(model, 'name', model)!r}"
            " (the other models' lane steps are ROADMAP Queue 2, K6)")
    if not isinstance(dt, numbers.Real):
        raise ValueError("rollout_closed_loop_cuda takes one uniform dt as a "
                         f"Python float, got {type(dt).__name__}")
    if quat_slice != (3, 7):
        raise ValueError(f"rollout_closed_loop_cuda: quat_slice {quat_slice}"
                         " is not the quadrotor's (3, 7); the kernel runs "
                         "the error state only (error_state=True)")
    ns = 12
    Bz, N, n = X.shape
    m = 4
    if n != 13:
        raise ValueError(f"rollout_closed_loop_cuda: state width {n} != 13")
    for name, t, shape in (
            ("x0", x0, (Bz, n)), ("X", X, (Bz, N, n)),
            ("U", U, (Bz, N - 1, m)), ("K", K, (Bz, N - 1, m, ns)),
            ("d", d, (Bz, N - 1, m)), ("alpha", alpha, (Bz,))):
        _build.check_input("rollout_closed_loop_cuda", name, t, shape,
                           X.device)

    lib = _build.load()
    Xout = torch.empty_like(X)
    Uout = torch.empty_like(U)
    ok = torch.empty((Bz,), dtype=torch.bool, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.trajopt_rollout_quadrotor_f32(
        x0.data_ptr(), X.data_ptr(), U.data_ptr(), K.data_ptr(),
        d.data_ptr(), alpha.data_ptr(), Xout.data_ptr(), Uout.data_ptr(),
        ok.data_ptr(), Bz, N, float(dt), float(max_state_value),
        float(max_control_value), stream)
    _build.check(err, "trajopt_rollout_quadrotor_f32")
    rollout_closed_loop_cuda.launches += 1
    return Xout, Uout, ok


rollout_closed_loop_cuda.launches = 0
