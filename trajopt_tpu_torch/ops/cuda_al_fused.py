"""The fused AL-iLQR iteration: CUDA kernels K3 and K4 and their plain
versions.

Counterpart of ``trajopt_tpu/ops/pallas_al_fused.py``. One constrained iLQR
iteration is two programs:

- backward (K3, ``csrc/fused_al_backward.cu``): per knot, inside the
  backward sweep, the discrete-step Jacobians (the slack columns of an
  infeasible-start model are the identity), the quadratic stage expansion,
  the Gauss-Newton AL expansion lx += cxᵀg, lxx += cxᵀIμcx (g = Iμ∘c + λ)
  of the canonical constraint stack, then the Riccati step; producer warps
  expand the knots ahead of the consumer warps that run the Riccati step;
- forward (K4, ``csrc/fused_al_forward.cu``): the whole backtracking line
  search, with the AL cost J + Σ λᵀc + ½cᵀIμc of every candidate rollout;
  a block of W warps per problem tries W candidates at a time and takes
  the lowest accepted one, which is the serial search's result.

``fused_al_backward`` and ``fused_al_forward`` are the plain PyTorch
versions: model-generic, they set the semantics and run on the CPU.
``fused_al_backward_cuda`` and ``fused_al_forward_cuda`` are the wrappers: a
tensor on the CPU goes to the plain version, a CUDA tensor to the kernel,
and anything the kernels do not take raises. The kernels carry the RK3 step
of every model of ``ops/cuda_models.py`` (kuka's rigid-body chain step
among them), with or without the n slack controls of the infeasible-start
transform, as compile-time traits (twelve instantiations each); the
constraint stack (with the forward-kinematics rows of a chain, K8), N and
the batch are run-time arguments.

λ and μ must arrive zero on invalid (knot, row) pairs: the constraint
masks are not part of the canonical data (``ops/canonical.py``).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from trajopt_tpu_torch.kernels import _build
from trajopt_tpu_torch.ops.canonical import (
    CanonStack, canon_al_cost, canon_al_expansion, pad_terminal,
)
from trajopt_tpu_torch.ops.cost import (
    Expansion, Objective, cost_expansion, total_cost,
)
from trajopt_tpu_torch.ops.cuda_models import (
    chain_table_ptr, cuda_model, find_cuda_model,
)
from trajopt_tpu_torch.ops.line_search import HostSyncs, line_search
from trajopt_tpu_torch.ops.riccati import scan_sweep
from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

# the divergence limits the kernels carry (iLQROptions' defaults)
MAX_VALUE = 1e8


# ------------------------------------------------------------ plain versions

def fused_al_backward(model, canon: CanonStack, X, U, lam, mu, dt_traj,
                      obj: Objective, rho, atol=0.0, reg_state=False,
                      return_jacobians=False):
    """Plain version of K3: ``jacobian_traj`` + LQR expansion + canonical AL
    expansion + the scan Riccati sweep. X (B, N, n), U (B, N-1, m),
    lam/mu (B, N, P), dt_traj (N-1,), rho (B,). Returns
    (K (B, N-1, m, n), d (B, N-1, m), dV1, dV2, fail (B,)) and, with
    ``return_jacobians``, also A (B, N-1, n, n) and B (B, N-1, n, m)."""
    A, Bm = model.jacobian_traj(X[:, :-1], U, dt_traj)
    e = cost_expansion(obj, X, U, dt_traj)
    tx, tu, txx, tuu = canon_al_expansion(canon, X, pad_terminal(U), lam, mu,
                                          atol)
    # no canonical kind has u-x cross terms: lux stays the objective's
    exp = Expansion(x=e.x + tx, u=e.u + tu[:, :-1], xx=e.xx + txx,
                    uu=e.uu + tuu[:, :-1], ux=e.ux)
    out = scan_sweep(A, Bm, exp, rho, reg_state=reg_state)
    return out + (A, Bm) if return_jacobians else out


def fused_al_forward(model, canon: CanonStack, x0, X, U, K, d, dV1, dV2,
                     J_prev, rho, drho, alpha0, lam, mu, dt_traj,
                     obj: Objective, opts_t, atol=0.0, active=None,
                     syncs: HostSyncs | None = None):
    """Plain version of K4: the batched backtracking line search on
    ``ops/rollout.py::rollout_closed_loop`` (full state, no error map)
    under the AL cost of the canonical stack. ``opts_t`` =
    (line_search_lower_bound, line_search_upper_bound,
    iterations_linesearch, bp_reg_min, bp_reg_increase_factor, bp_reg_fp).
    Problems outside ``active`` (B,) bool are not searched; what comes back
    for them is unspecified. Returns (X̄, Ū, J, rho, drho, alpha_used)."""

    def rollout_fn(alpha):
        return rollout_closed_loop(model, x0, X, U, K, d, alpha, dt_traj,
                                   max_state_value=MAX_VALUE,
                                   max_control_value=MAX_VALUE)

    def cost_fn(Xc, Uc):
        return total_cost(obj, Xc, Uc, dt_traj) \
            + canon_al_cost(canon, Xc, pad_terminal(Uc), lam, mu, atol)

    return line_search(rollout_fn, cost_fn, X, U, dV1, dV2, J_prev, rho,
                       drho, alpha0, *opts_t, active=active, syncs=syncs)


# ------------------------------------------------------------ the wrappers

def cuda_model_supported(model) -> bool:
    """True for the models the kernels carry: an RK3 step of
    ``ops/cuda_models.py``, with or without the slack controls, that is not
    marked ``k2_only`` (ballonbeam, the Euler-angle quadrotor and the
    minimum-time forms have no lane step in the JAX package, which runs
    them phase-split)."""
    return find_cuda_model(model, slack_ok=True) is not None


def _check_common(fn, model, canon, X, U, lam, mu, dt_traj, obj):
    cm = cuda_model(model, fn, slack_ok=True)
    Bz, N, _ = X.shape
    n, m, dev = cm.n, cm.m, X.device
    if canon.n != n or canon.m != m or canon.row_i.device != dev:
        raise ValueError(f"{fn}: the canonical stack must be compiled for "
                         f"n={n}, m={m} on {dev}")
    P = canon.P
    for name, t, shape in (
            ("X", X, (Bz, N, n)), ("U", U, (Bz, N - 1, m)),
            ("lam", lam, (Bz, N, P)), ("mu", mu, (Bz, N, P)),
            ("dt_traj", dt_traj, (N - 1,)), ("Q", obj.Q, (N, n, n)),
            ("R", obj.R, (N, m, m)), ("H", obj.H, (N, m, n)),
            ("q", obj.q, (N, n)), ("r", obj.r, (N, m)), ("c", obj.c, (N,))):
        _build.check_input(fn, name, t, shape, dev)
    return cm, Bz, N, P


def fused_al_backward_cuda(model, canon: CanonStack, X, U, lam, mu, dt_traj,
                           obj: Objective, rho, atol=0.0, reg_state=False,
                           return_jacobians=False):
    """Fused AL backward sweep on kernel K3. Arguments and results as
    :func:`fused_al_backward`; with ``return_jacobians`` the kernel also
    writes out its in-kernel A and the base-control columns of B (slack
    columns are the identity, which the kernel never forms). CPU tensors
    run the plain version; CUDA tensors must be contiguous float32. The
    kernel picks its block, Wc consumer and Wp producer warps a problem,
    from the batch and its occupancy; the wrapper records it as ``warps``
    and ``shape``."""
    if X.device.type == "cpu":
        return fused_al_backward(model, canon, X, U, lam, mu, dt_traj, obj,
                                 rho, atol, reg_state, return_jacobians)
    fn = "fused_al_backward_cuda"
    cm, Bz, N, P = _check_common(fn, model, canon, X, U, lam, mu, dt_traj,
                                 obj)
    _build.check_input(fn, "rho", rho, (Bz,), X.device)
    n, m = cm.n, cm.m

    lib = _build.load()
    new = lambda *s: torch.empty(s, dtype=X.dtype, device=X.device)  # noqa
    K, d, dV = new(Bz, N - 1, m, n), new(Bz, N - 1, m), new(2, Bz)
    fail = torch.empty((Bz,), dtype=torch.bool, device=X.device)
    Aout = new(Bz, N - 1, n, n) if return_jacobians else None
    Bout = new(Bz, N - 1, n, cm.m_base) if return_jacobians else None
    shape = (ctypes.c_int * 4)()
    err = lib.trajopt_fused_al_backward_f32(
        X.data_ptr(), U.data_ptr(), lam.data_ptr(), mu.data_ptr(),
        dt_traj.data_ptr(), obj.Q.data_ptr(), obj.R.data_ptr(),
        obj.H.data_ptr(), obj.q.data_ptr(), obj.r.data_ptr(), rho.data_ptr(),
        canon.row_i.data_ptr(), canon.row_f.data_ptr(),
        canon.groups.data_ptr(), canon.col_ptr.data_ptr(),
        canon.col_rows.data_ptr(), canon.fk_joint.data_ptr(),
        canon.fk_point.data_ptr(), chain_table_ptr(model, cm, X.device),
        K.data_ptr(), d.data_ptr(), dV.data_ptr(),
        fail.data_ptr(), Aout.data_ptr() if return_jacobians else None,
        Bout.data_ptr() if return_jacobians else None,
        Bz, N, P, canon.groups.shape[0], canon.fk_joint.shape[0],
        canon.fk_point.shape[0], cm.id, int(bool(reg_state)),
        float(atol), ctypes.addressof(shape), _build.stream(X.device))
    _build.check(err, "trajopt_fused_al_backward_f32")
    fused_al_backward_cuda.launches += 1
    fused_al_backward_cuda.launches_by[cm.label] += 1
    fused_al_backward_cuda.warps = (shape[0], shape[1])
    fused_al_backward_cuda.shape = dict(consumers=shape[0],
                                        producers=shape[1], slots=shape[2],
                                        smem_bytes=shape[3])
    out = (K, d, dV[0], dV[1], fail)
    if return_jacobians:
        if cm.m != cm.m_base:       # the slack columns the kernel never forms
            eye = torch.eye(n, dtype=X.dtype, device=X.device)
            Bout = torch.cat([Bout, eye.expand(Bz, N - 1, n, n)], -1)
        out += (Aout, Bout)
    return out


# launches in all, and by the kernel's instantiation
fused_al_backward_cuda.launches = 0
fused_al_backward_cuda.launches_by = collections.Counter()
# the last launch's block: (consumer, producer) warps, and with the slots of
# its ring and its shared-memory bytes
fused_al_backward_cuda.warps = None
fused_al_backward_cuda.shape = None


def fused_al_forward_cuda(model, canon: CanonStack, x0, X, U, K, d, dV1, dV2,
                          J_prev, rho, drho, alpha0, lam, mu, dt_traj,
                          obj: Objective, opts_t, atol=0.0, active=None,
                          syncs: HostSyncs | None = None):
    """The whole AL line search on kernel K4. Arguments and results as
    :func:`fused_al_forward` (``syncs`` counts the plain version's loop
    tests; the kernel makes none). CPU tensors run the plain version; CUDA
    tensors must be contiguous float32. The kernel picks W, the candidates
    a problem tries at once, from the batch and its occupancy
    (``trajopt_fused_al_forward_warps``); the wrapper allocates the
    candidates' workspace for it and records it as ``warps``."""
    if X.device.type == "cpu":
        return fused_al_forward(model, canon, x0, X, U, K, d, dV1, dV2,
                                J_prev, rho, drho, alpha0, lam, mu, dt_traj,
                                obj, opts_t, atol, active=active,
                                syncs=syncs)
    fn = "fused_al_forward_cuda"
    cm, Bz, N, P = _check_common(fn, model, canon, X, U, lam, mu, dt_traj,
                                 obj)
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
    W = lib.trajopt_fused_al_forward_warps(cm.id, Bz)
    if W < 1:
        raise RuntimeError(f"{fn}: no launch shape for {cm.label!r} at "
                           f"B={Bz}")
    ws = torch.empty(Bz * W * (N * cm.n + (N - 1) * cm.m) if W > 1 else 0,
                     dtype=X.dtype, device=dev)
    Xout, Uout = torch.empty_like(X), torch.empty_like(U)
    # per problem: J, rho, drho, alpha_used
    scal = torch.empty((4, Bz), dtype=X.dtype, device=dev)
    err = lib.trajopt_fused_al_forward_f32(
        x0.data_ptr(), X.data_ptr(), U.data_ptr(), K.data_ptr(),
        d.data_ptr(), dV1.data_ptr(), dV2.data_ptr(), J_prev.data_ptr(),
        rho.data_ptr(), drho.data_ptr(), alpha0.data_ptr(), lam.data_ptr(),
        mu.data_ptr(), dt_traj.data_ptr(), obj.Q.data_ptr(),
        obj.R.data_ptr(), obj.H.data_ptr(), obj.q.data_ptr(),
        obj.r.data_ptr(), obj.c.data_ptr(), canon.row_i.data_ptr(),
        canon.row_f.data_ptr(), canon.fk_joint.data_ptr(),
        canon.fk_point.data_ptr(),
        None if active is None else active.data_ptr(),
        chain_table_ptr(model, cm, dev),
        ws.data_ptr() if ws.numel() else None, ws.numel(), Xout.data_ptr(),
        Uout.data_ptr(), scal.data_ptr(), Bz, N, P, canon.fk_joint.shape[0],
        canon.fk_point.shape[0], cm.id, int(ls_iters),
        float(ls_lb), float(ls_ub),
        float(reg_min), float(reg_factor), float(reg_fp), float(atol),
        _build.stream(dev))
    _build.check(err, "trajopt_fused_al_forward_f32")
    fused_al_forward_cuda.launches += 1
    fused_al_forward_cuda.launches_by[cm.label] += 1
    fused_al_forward_cuda.warps = W
    return Xout, Uout, scal[0], scal[1], scal[2], scal[3]


fused_al_forward_cuda.launches = 0
fused_al_forward_cuda.launches_by = collections.Counter()
# the warps a problem took in the last launch (its block is 32·W threads)
fused_al_forward_cuda.warps = None
