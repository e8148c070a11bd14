"""Closed-loop rollout on the CUDA kernel K2.

``rollout_closed_loop_cuda`` wraps ``csrc/rollout.cu``, the counterpart of
``trajopt_tpu/ops/pallas_rollout.py::rollout_closed_loop_pallas`` with the
model's RK3 step inlined (``csrc/models.cuh``): the full-state rollout
(``quat_slice=None``) for every model of ``ops/cuda_models.py`` (kuka's
rigid-body chain step among them), with or without the slack controls of
the infeasible-start transform, and the quaternion error state for the
quadrotor. A tensor on the CPU goes to the plain version
``ops/rollout.py::rollout_closed_loop``; a CUDA tensor goes to the kernel,
and anything the kernel does not take raises.
"""
from __future__ import annotations

import collections
import numbers

import torch

from trajopt_tpu_torch.kernels import _build
from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model
from trajopt_tpu_torch.ops.rollout import rollout_closed_loop


def rollout_closed_loop_cuda(model, x0, X, U, K, d, alpha, dt,
                             max_state_value=1e8, max_control_value=1e8,
                             quat_slice=None):
    """Batched closed-loop rollout, batch-first like
    ``rollout_closed_loop_pallas``: x0 (B, n), X (B, N, n), U (B, N-1, m),
    K (B, N-1, m, ns), d (B, N-1, m), alpha (B,). Returns
    (X̄ (B, N, n), Ū (B, N-1, m), ok (B,) bool).

    On CUDA the model must have a CUDA step (``ops/cuda_models.py``), ``dt``
    must be one uniform Python float, and ``quat_slice`` must be None (full
    state, ns = n) or the quadrotor's (3, 7) (error state, ns = 12).
    """
    if X.device.type == "cpu":
        return rollout_closed_loop(model, x0, X, U, K, d, alpha, dt,
                                   max_state_value=max_state_value,
                                   max_control_value=max_control_value,
                                   quat_slice=quat_slice)
    fn = "rollout_closed_loop_cuda"
    cm = cuda_model(model, fn, slack_ok=True)
    if not isinstance(dt, numbers.Real):
        raise NotImplementedError(
            f"{fn} takes one uniform dt as a Python float, got "
            f"{type(dt).__name__}: a per-interval dt has no rollout kernel "
            "(ROADMAP Queue 1, the minimum-time transform)")
    error_state = quat_slice is not None
    if error_state and (quat_slice != (3, 7) or cm.label != "quadrotor"):
        raise ValueError(f"{fn}: quat_slice {quat_slice} on model "
                         f"{cm.label!r}: the kernel's error state is the "
                         "quadrotor's (3, 7)")
    Bz, N, n = X.shape
    m = cm.m
    ns = n - 1 if error_state else n
    if n != cm.n:
        raise ValueError(f"{fn}: state width {n} != {cm.n}")
    for name, t, shape in (
            ("x0", x0, (Bz, n)), ("X", X, (Bz, N, n)),
            ("U", U, (Bz, N - 1, m)), ("K", K, (Bz, N - 1, m, ns)),
            ("d", d, (Bz, N - 1, m)), ("alpha", alpha, (Bz,))):
        _build.check_input(fn, name, t, shape, X.device)

    lib = _build.load()
    chain = chain_table_ptr(model, cm, X.device)
    Xout = torch.empty_like(X)
    Uout = torch.empty_like(U)
    ok = torch.empty((Bz,), dtype=torch.bool, device=X.device)
    err = lib.trajopt_rollout_f32(
        x0.data_ptr(), X.data_ptr(), U.data_ptr(), K.data_ptr(),
        d.data_ptr(), alpha.data_ptr(), Xout.data_ptr(), Uout.data_ptr(),
        ok.data_ptr(), chain, Bz, N, cm.id, int(error_state), float(dt),
        float(max_state_value), float(max_control_value),
        _build.stream(X.device))
    _build.check(err, "trajopt_rollout_f32")
    rollout_closed_loop_cuda.launches += 1
    rollout_closed_loop_cuda.launches_by[
        cm.label + ("_error_state" if error_state else "")] += 1
    return Xout, Uout, ok


# launches in all, and by the kernel's instantiation
rollout_closed_loop_cuda.launches = 0
rollout_closed_loop_cuda.launches_by = collections.Counter()
