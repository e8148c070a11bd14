"""The fused unconstrained iLQR iteration: CUDA kernels K7a and K7b and their
plain versions.

Counterpart of ``trajopt_tpu/ops/pallas_fused.py``. With
``iLQROptions(fused=True)`` and a plain quadratic objective, one iLQR
iteration is two programs:

- backward (K7a, ``csrc/fused_backward.cu``): per knot, inside the backward
  sweep, the discrete-step Jacobians, the quadratic stage expansion and the
  Riccati step; A, B and the expansion never reach device memory; producer
  warps expand the knots ahead of the consumer warps that run the Riccati
  step (``fused_backward_shape`` tells the block it takes);
- forward (K7b, ``csrc/fused_forward.cu``): the whole backtracking line
  search, the rollout and the cost of every candidate (W candidates of a
  problem at once, ``csrc/line_search_rounds.cuh``), per-problem α, the
  restore and ρ bump when a search runs out.

``fused_backward`` and ``fused_forward`` are the plain PyTorch versions:
model-generic, they set the semantics and run on the CPU.
``fused_backward_cuda`` and ``fused_forward_cuda`` are the wrappers: a tensor
on the CPU goes to the plain version, a CUDA tensor to the kernel, and
anything the kernels do not take raises. The kernels carry the RK3 step of
the models of ``ops/cuda_models.py`` as compile-time traits; N and the
batch are run-time arguments, and the divergence limits are the defaults
(1e8).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from trajopt_tpu_torch.kernels import _build
from trajopt_tpu_torch.ops.cost import Objective, cost_expansion, total_cost
from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model
from trajopt_tpu_torch.ops.line_search import HostSyncs, line_search
from trajopt_tpu_torch.ops.riccati import scan_sweep
from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

# the divergence limits the kernels carry (iLQROptions' defaults)
MAX_VALUE = 1e8


# ------------------------------------------------------------ plain versions

def fused_backward(model, X, U, dt_traj, obj: Objective, rho,
                   reg_state=False, return_jacobians=False):
    """Plain version of K7a: ``jacobian_traj`` + LQR expansion + the scan
    Riccati sweep. X (B, N, n), U (B, N-1, m), dt_traj (N-1,), rho (B,).
    Returns (K (B, N-1, m, n), d (B, N-1, m), dV1, dV2, fail (B,)) and, with
    ``return_jacobians``, also A (B, N-1, n, n) and B (B, N-1, n, m)."""
    A, Bm = model.jacobian_traj(X[:, :-1], U, dt_traj)
    out = scan_sweep(A, Bm, cost_expansion(obj, X, U, dt_traj), rho,
                     reg_state=reg_state)
    return out + (A, Bm) if return_jacobians else out


def fused_forward(model, x0, X, U, K, d, dV1, dV2, J_prev, rho, drho, alpha0,
                  dt_traj, obj: Objective, opts_t, active=None,
                  syncs: HostSyncs | None = None):
    """Plain version of K7b: the batched backtracking line search on
    ``ops/rollout.py::rollout_closed_loop`` (full state) under the
    objective's cost. ``opts_t`` = (line_search_lower_bound,
    line_search_upper_bound, iterations_linesearch, bp_reg_min,
    bp_reg_increase_factor, bp_reg_fp). Problems outside ``active`` (B,)
    bool are not searched; what comes back for them is unspecified. Returns
    (X̄, Ū, J, rho, drho, alpha_used)."""

    def rollout_fn(alpha):
        return rollout_closed_loop(model, x0, X, U, K, d, alpha, dt_traj,
                                   max_state_value=MAX_VALUE,
                                   max_control_value=MAX_VALUE)

    def cost_fn(Xc, Uc):
        return total_cost(obj, Xc, Uc, dt_traj)

    return line_search(rollout_fn, cost_fn, X, U, dV1, dV2, J_prev, rho,
                       drho, alpha0, *opts_t, active=active, syncs=syncs)


# ------------------------------------------------------------ the wrappers

def _check_common(fn, model, X, U, dt_traj, obj):
    cm = cuda_model(model, fn)
    Bz, N, n = X.shape
    m, dev = cm.m, X.device
    for name, t, shape in (
            ("X", X, (Bz, N, cm.n)), ("U", U, (Bz, N - 1, m)),
            ("dt_traj", dt_traj, (N - 1,)), ("Q", obj.Q, (N, n, n)),
            ("R", obj.R, (N, m, m)), ("H", obj.H, (N, m, n)),
            ("q", obj.q, (N, n)), ("r", obj.r, (N, m)), ("c", obj.c, (N,))):
        _build.check_input(fn, name, t, shape, dev)
    return cm, Bz, N


def fused_backward_cuda(model, X, U, dt_traj, obj: Objective, rho,
                        reg_state=False, return_jacobians=False):
    """Fused backward sweep on kernel K7a. Arguments and results as
    :func:`fused_backward`; with ``return_jacobians`` the kernel also writes
    out its in-kernel A and B. CPU tensors run the plain version; CUDA
    tensors must be contiguous float32."""
    if X.device.type == "cpu":
        return fused_backward(model, X, U, dt_traj, obj, rho, reg_state,
                              return_jacobians)
    fn = "fused_backward_cuda"
    cm, Bz, N = _check_common(fn, model, X, U, dt_traj, obj)
    _build.check_input(fn, "rho", rho, (Bz,), X.device)

    lib = _build.load()
    new = lambda *s: torch.empty(s, dtype=X.dtype, device=X.device)  # noqa
    K, d, dV = new(Bz, N - 1, cm.m, cm.n), new(Bz, N - 1, cm.m), new(2, Bz)
    fail = torch.empty((Bz,), dtype=torch.bool, device=X.device)
    Aout = new(Bz, N - 1, cm.n, cm.n) if return_jacobians else None
    Bout = new(Bz, N - 1, cm.n, cm.m) if return_jacobians else None
    err = lib.trajopt_fused_backward_f32(
        X.data_ptr(), U.data_ptr(), dt_traj.data_ptr(), obj.Q.data_ptr(),
        obj.R.data_ptr(), obj.H.data_ptr(), obj.q.data_ptr(),
        obj.r.data_ptr(), rho.data_ptr(),
        chain_table_ptr(model, cm, X.device), K.data_ptr(), d.data_ptr(),
        dV.data_ptr(), fail.data_ptr(),
        Aout.data_ptr() if return_jacobians else None,
        Bout.data_ptr() if return_jacobians else None,
        Bz, N, cm.id, int(bool(reg_state)), _build.stream(X.device))
    _build.check(err, "trajopt_fused_backward_f32")
    fused_backward_cuda.launches += 1
    fused_backward_cuda.launches_by[cm.label] += 1
    out = (K, d, dV[0], dV[1], fail)
    return out + (Aout, Bout) if return_jacobians else out


# launches in all, and by the kernel's instantiation
fused_backward_cuda.launches = 0
fused_backward_cuda.launches_by = collections.Counter()


def fused_backward_shape(model, batch: int) -> dict:
    """The block K7a launches for ``model`` at ``batch`` problems on the
    current CUDA device (``csrc/knot_pipeline.cuh``): its consumer and
    producer warps, the slots of its ring, its shared-memory bytes and the
    knots a producer warp expands at once."""
    cm = cuda_model(model, "fused_backward_shape")
    out = (ctypes.c_int * 5)()
    _build.check(_build.load().trajopt_fused_backward_shape(
        cm.id, batch, ctypes.addressof(out)), "trajopt_fused_backward_shape")
    return dict(consumers=out[0], producers=out[1], slots=out[2],
                smem_bytes=out[3], knots_a_step=out[4])


def fused_forward_cuda(model, x0, X, U, K, d, dV1, dV2, J_prev, rho, drho,
                       alpha0, dt_traj, obj: Objective, opts_t, active=None,
                       syncs: HostSyncs | None = None):
    """The whole line search on kernel K7b. Arguments and results as
    :func:`fused_forward` (``syncs`` counts the plain version's loop tests;
    the kernel makes none). A problem outside ``active`` gets X, U and
    J_prev back with α = 0. CPU tensors run the plain version; CUDA tensors
    must be contiguous float32. The kernel picks W, the candidates a problem
    tries at once, from the batch and its occupancy
    (``trajopt_fused_forward_warps``); the wrapper allocates the candidates'
    workspace for it and records it as ``warps``."""
    if X.device.type == "cpu":
        return fused_forward(model, x0, X, U, K, d, dV1, dV2, J_prev, rho,
                             drho, alpha0, dt_traj, obj, opts_t,
                             active=active, syncs=syncs)
    fn = "fused_forward_cuda"
    cm, Bz, N = _check_common(fn, model, X, U, dt_traj, obj)
    dev = X.device
    alpha0 = torch.ones(Bz, dtype=X.dtype, device=dev) if alpha0 is None \
        else alpha0
    if active is not None and not (
            active.dtype == torch.bool and active.shape == (Bz,)
            and active.device == dev and active.is_contiguous()):
        raise ValueError(f"{fn}: active must be a contiguous bool tensor "
                         f"of shape ({Bz},) on {dev}")
    for name, t, shape in (
            ("x0", x0, (Bz, cm.n)), ("K", K, (Bz, N - 1, cm.m, cm.n)),
            ("d", d, (Bz, N - 1, cm.m)), ("dV1", dV1, (Bz,)),
            ("dV2", dV2, (Bz,)), ("J_prev", J_prev, (Bz,)),
            ("rho", rho, (Bz,)), ("drho", drho, (Bz,)),
            ("alpha0", alpha0, (Bz,))):
        _build.check_input(fn, name, t, shape, dev)
    ls_lb, ls_ub, ls_iters, reg_min, reg_factor, reg_fp = opts_t

    lib = _build.load()
    # W warps a problem, from the batch and the kernel's occupancy; with
    # W > 1 each warp's candidate goes to its own buffer in a workspace
    W = lib.trajopt_fused_forward_warps(cm.id, Bz)
    if W < 1:
        raise RuntimeError(f"{fn}: no launch shape for {cm.label!r} at "
                           f"B={Bz}")
    ws = torch.empty(Bz * W * (N * cm.n + (N - 1) * cm.m) if W > 1 else 0,
                     dtype=X.dtype, device=dev)
    Xout, Uout = torch.empty_like(X), torch.empty_like(U)
    # per problem: J, rho, drho, alpha_used
    scal = torch.empty((4, Bz), dtype=X.dtype, device=dev)
    err = lib.trajopt_fused_forward_f32(
        x0.data_ptr(), X.data_ptr(), U.data_ptr(), K.data_ptr(),
        d.data_ptr(), dV1.data_ptr(), dV2.data_ptr(), J_prev.data_ptr(),
        rho.data_ptr(), drho.data_ptr(), alpha0.data_ptr(),
        dt_traj.data_ptr(), obj.Q.data_ptr(), obj.R.data_ptr(),
        obj.H.data_ptr(), obj.q.data_ptr(), obj.r.data_ptr(),
        obj.c.data_ptr(), None if active is None else active.data_ptr(),
        chain_table_ptr(model, cm, dev),
        ws.data_ptr() if ws.numel() else None, ws.numel(), Xout.data_ptr(),
        Uout.data_ptr(), scal.data_ptr(), Bz, N, cm.id, int(ls_iters),
        float(ls_lb), float(ls_ub), float(reg_min), float(reg_factor),
        float(reg_fp), _build.stream(dev))
    _build.check(err, "trajopt_fused_forward_f32")
    fused_forward_cuda.launches += 1
    fused_forward_cuda.launches_by[cm.label] += 1
    fused_forward_cuda.warps = W
    return Xout, Uout, scal[0], scal[1], scal[2], scal[3]


fused_forward_cuda.launches = 0
fused_forward_cuda.launches_by = collections.Counter()
# the warps a problem took in the last launch (its block is 32·W threads)
fused_forward_cuda.warps = None
