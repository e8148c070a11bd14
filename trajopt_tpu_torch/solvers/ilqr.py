"""Batched iLQR solver (inner loop of ALTRO).

Counterpart of ``trajopt_tpu/solvers/ilqr.py`` (reference
src/solvers/ilqr/), written for a batch of problems in one call: every
tensor carries a leading problem dimension where the JAX package uses
``vmap``. The JAX ``while_loop``s become Python loops that carry an explicit
per-problem mask and freeze a problem once its own loop condition is false,
which is what ``vmap`` of a ``while_loop`` does: the main iteration loop,
the line search and the ρ-retry of the backward pass.

Each loop test reads one boolean from the device; ``HostSyncs`` counts
those reads. Four iteration paths are ported:

- the phase-split path, the default: Jacobians and the cost expansion as
  torch ops, the backward pass on kernel K5 (``bp_type='scan'``,
  ``ops/cuda_riccati.py``) or K1 (``bp_type='sqrt'``, ``ops/cuda_sqrt.py``),
  every line-search candidate on kernel K2 (``ops/cuda_rollout.py``), on
  the full state or, with ``error_state``, the quadrotor's error state;
- the fused path (``fused=True``, ``objective`` given and
  ``_fused_eligible``): the backward pass is kernel K7a and the whole line
  search kernel K7b (``ops/cuda_fused.py``), two launches per iteration;
- the fused AL path (``al_meta`` given and ``_fused_al_eligible``, the
  default of a constrained solve whose constraints are all canonical):
  kernels K3 and K4 (``ops/cuda_al_fused.py``), for every model with a CUDA
  step, with or without the slack controls of the infeasible-start
  transform. A stack with the forward-kinematics rows of a chain (kuka's
  ``fk_sphere`` rows) is eligible only with ``fused_al_fk=True``, and then
  runs the hybrid: the phase-split backward pass (K5) and the fused line
  search (K4); K3 is never launched for such a stack (the JAX package's
  rule, trajopt_tpu ilqr.py:1315-1326).

``tvlqr_projection`` (one backward pass and one closed-loop rollout at α = 0)
runs on K5 and K2.

A tensor on the CPU runs the kernels' plain versions instead; on a CUDA
tensor no plain version stands in for a kernel: a model without a CUDA step
(``ops/cuda_models.py``), float64, or a per-interval ``dt`` on the
phase-split path raises. The parallel backward pass, the proximal step
limit, time sharding and the live printing/plotting options raise
``NotImplementedError`` (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from trajopt_tpu_torch.ops import line_search as _ls
from trajopt_tpu_torch.ops.cost import Expansion, Objective
from trajopt_tpu_torch.ops.cuda_al_fused import (
    cuda_model_supported, fused_al_backward_cuda, fused_al_forward_cuda,
)
from trajopt_tpu_torch.ops.cuda_fused import (
    fused_backward_cuda, fused_forward_cuda,
)
from trajopt_tpu_torch.ops.cuda_models import cuda_model, find_cuda_model
from trajopt_tpu_torch.ops.cuda_riccati import riccati_sweep_cuda
from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
from trajopt_tpu_torch.ops.cuda_sqrt import (  # noqa: F401  (re-export)
    SQRT_PIVOT_FLOOR_F32, SQRT_PIVOT_NEG_TOL, sqrt_sweep, sqrt_sweep_cuda,
)
from trajopt_tpu_torch.ops.line_search import HostSyncs  # noqa: F401
from trajopt_tpu_torch.ops.rollout import rollout
from trajopt_tpu_torch.utils.tree import precise


@dataclasses.dataclass(frozen=True)
class iLQROptions:
    """(reference iLQRSolverOptions, ilqr_solver.jl:7-81). Field for field
    the JAX package's ``iLQROptions``, with the same defaults; see there for
    what each option means."""

    cost_tolerance: float = 1e-4
    gradient_norm_tolerance: float = 1e-5
    iterations: int = 300
    dJ_counter_limit: int = 10
    square_root: bool = False
    line_search_lower_bound: float = 1e-8
    line_search_upper_bound: float = 10.0
    iterations_linesearch: int = 20
    bp_reg_initial: float = 0.0
    bp_reg_increase_factor: float = 1.6
    bp_reg_max: float = 1e8
    bp_reg_min: float = 1e-8
    bp_reg_type: str = "control"
    bp_reg_fp: float = 10.0
    max_cost_value: float = 1e8
    max_state_value: float = 1e8
    max_control_value: float = 1e8
    gradient_type: str = "todorov"
    live_plotting: str = "off"
    bp_max_attempts: int = 50
    fused: bool = False
    fused_al: bool = True
    fused_al_fk: bool = False
    bp_step_limit: float = 0.0
    line_search_warm_start: bool = False
    verbose: bool = False
    error_state: bool = False
    bp_type: str = "scan"
    tp_mesh: Optional[object] = None
    tp_axis: str = "tp"


def _check_supported(opts: iLQROptions):
    """Raise for the options whose code paths are not ported yet."""
    sqrt = opts.square_root or opts.bp_type == "sqrt"
    if not sqrt and opts.bp_type != "scan":
        raise NotImplementedError(
            f"bp_type={opts.bp_type!r}: the square-root and scan backward "
            "passes are ported (parallel: ROADMAP Queue 1 #5)")
    if opts.bp_reg_type not in ("control", "state"):
        raise ValueError(f"bp_reg_type={opts.bp_reg_type!r}")
    for name, off in (("bp_step_limit", 0.0), ("verbose", False),
                      ("live_plotting", "off"), ("tp_mesh", None)):
        if getattr(opts, name) != off:
            raise NotImplementedError(f"iLQROptions.{name} is not ported yet")


def _check_card_path(model, X0, dt):
    """On a CUDA tensor the phase-split path runs on kernels K5 or K1 and
    K2: raise before the first iteration for what they do not take (a model
    without a CUDA step, a per-interval ``dt`` tensor), so that no plain
    version runs on the card in a kernel's place."""
    if X0.device.type != "cuda":
        return
    cuda_model(model, "ilqr_solve", slack_ok=True, k2_only_ok=True)
    if torch.is_tensor(dt):
        raise NotImplementedError(
            "a per-interval dt tensor on a CUDA tensor: the rollout kernel "
            "K2 takes one uniform dt (a minimum-time model takes its dt from "
            "its controls: pass the problem's seed dt); the fused path "
            "(fused=True) takes dt per knot")


class ILQRResult(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    K: torch.Tensor
    d: torch.Tensor
    J: torch.Tensor
    iterations: torch.Tensor
    gradient: torch.Tensor
    dJ: torch.Tensor
    rho: torch.Tensor
    drho: torch.Tensor
    converged: torch.Tensor


_where = _ls.where_rows


def reg_increase(rho, drho, opts: iLQROptions):
    """(reference regularization_update! :increase, ilqr_methods.jl:164-171)."""
    return _ls.reg_increase(rho, drho, opts.bp_reg_increase_factor,
                            opts.bp_reg_min)


def reg_decrease(rho, drho, opts: iLQROptions):
    """(reference regularization_update! :decrease, ilqr_methods.jl:171-176)."""
    drho = torch.clamp(drho / opts.bp_reg_increase_factor,
                       max=1.0 / opts.bp_reg_increase_factor)
    rho = rho * drho * (rho * drho > opts.bp_reg_min)
    return rho, drho


def reg_noise_scale(mu, dtype):
    """ρ jump target for the scale-aware retry, per problem:
    ~100·ε·(max μ + 1) over the trailing (N, P) axes of ``mu``; 0 when μ is
    empty (no constraints), which is the exact reference escalation."""
    batch = mu.shape[:-2]
    if mu.numel() == 0:
        return torch.zeros(batch, dtype=dtype, device=mu.device)
    eps = torch.finfo(dtype).eps
    return (100.0 * eps) * (mu.flatten(-2).amax(-1) + 1.0)


def _rho_retry(sweep, rho, drho, opts: iLQROptions, reg_scale=None,
               active=None, syncs: HostSyncs | None = None):
    """The reference's per-problem ρ retry around a batched sweep
    ``sweep(rho) -> (K, d, dV1, dV2, fail)`` (counterpart of
    ``_bp_batched_pallas`` and of the retry around the fused AL backward
    kernel, trajopt_tpu ilqr.py:1063-1102): every attempt re-sweeps all
    problems, but only failing ones get ρ bumped, to at least the
    rounding-noise scale ``reg_scale``, so the others are re-swept at their
    own ρ; the attempts counter is shared. Problems outside ``active`` do
    not keep the retry going. Returns (K, d, dV1, dV2, rho, drho) with the
    ρ decrease applied."""
    syncs = HostSyncs() if syncs is None else syncs
    K, d, v1, v2, fail = sweep(rho)
    jump = torch.zeros_like(rho) if reg_scale is None else reg_scale
    live = fail if active is None else fail & active
    attempts = 0
    while attempts < opts.bp_max_attempts and syncs.any(live):
        rho_i, drho_i = reg_increase(rho, drho, opts)
        rho = torch.where(fail, torch.maximum(rho_i, jump), rho)
        drho = torch.where(fail, drho_i, drho)
        K, d, v1, v2, fail = sweep(rho)
        live = fail if active is None else fail & active
        attempts += 1
    rho, drho = reg_decrease(rho, drho, opts)
    return K, d, v1, v2, rho, drho


def backward_pass(A, B, exp: Expansion, rho, drho, opts: iLQROptions,
                  reg_scale=None, active=None, syncs: HostSyncs | None = None):
    """Batched Riccati sweep with the ρ retry (:func:`_rho_retry`): the QR
    square-root sweep on kernel K1 for ``bp_type='sqrt'``, the standard
    sweep on kernel K5 for ``bp_type='scan'`` (``reg_state`` from
    ``bp_reg_type``).

    A (B, N-1, n, n), B (B, N-1, n, m), exp batched, rho/drho (B,).
    Returns (K, d, dV1, dV2, rho, drho).
    """
    args = [t.contiguous() for t in (A, B, exp.x, exp.u, exp.xx, exp.uu,
                                     exp.ux)]
    if opts.square_root or opts.bp_type == "sqrt":
        def sweep(rho_v):
            return sqrt_sweep_cuda(*args, rho_v.contiguous())
    else:
        reg_state = opts.bp_reg_type == "state"

        def sweep(rho_v):
            return riccati_sweep_cuda(*args, rho_v.contiguous(),
                                      reg_state=reg_state)

    return _rho_retry(sweep, rho, drho, opts, reg_scale, active, syncs)


def _line_search_opts(opts: iLQROptions):
    return (opts.line_search_lower_bound, opts.line_search_upper_bound,
            opts.iterations_linesearch, opts.bp_reg_min,
            opts.bp_reg_increase_factor, opts.bp_reg_fp)


def forward_pass(model, cost_fn, x0, X, U, K, d, dV1, dV2, J_prev, rho, drho,
                 dt, opts: iLQROptions, alpha0=None, active=None,
                 syncs: HostSyncs | None = None):
    """Batched backtracking line search (reference forwardpass!,
    forward_pass.jl:5-85; the loop is ``ops/line_search.py``). Each
    candidate is one launch of kernel K2 over all problems; a problem
    leaves the search when its own condition is met. Returns
    (X̄, Ū, J, rho, drho, alpha_used).
    """
    qs = getattr(model, "quat_slice", None) if opts.error_state else None

    def rollout_fn(alpha):
        return rollout_closed_loop_cuda(
            model, x0, X, U, K, d, alpha, dt,
            max_state_value=opts.max_state_value,
            max_control_value=opts.max_control_value, quat_slice=qs)

    return _ls.line_search(rollout_fn, cost_fn, X, U, dV1, dV2, J_prev, rho,
                           drho, alpha0, *_line_search_opts(opts),
                           active=active, syncs=syncs)


def gradient_todorov(d, U):
    """(reference gradient_todorov, ilqr_methods.jl:122-129), per problem."""
    return (d.abs() / (U.abs() + 1.0)).amax(-1).mean(-1)


def gradient_feedforward(d):
    """‖d‖∞ per problem (reference gradient_feedforward,
    ilqr_methods.jl:135-137)."""
    return d.abs().flatten(-2).amax(-1)


def calculate_gradient(gradient_type, d, U, expansion_fn, X):
    """Dispatch on iLQROptions.gradient_type (reference calculate_gradient,
    ilqr_methods.jl:91-102): 'todorov' (the default), 'feedforward', and
    'l2'/'linf' of the stacked cost-expansion gradient [lx₁ lu₁ … lx_N]."""
    if gradient_type == "todorov":
        return gradient_todorov(d, U)
    if gradient_type == "feedforward":
        return gradient_feedforward(d)
    if gradient_type not in ("l2", "linf"):
        raise ValueError(f"unknown gradient_type {gradient_type!r} "
                         "(todorov | feedforward | l2 | linf)")
    exp = expansion_fn(X, U)
    g = torch.cat([exp.x.flatten(-2), exp.u.flatten(-2)], dim=-1)
    if gradient_type == "l2":
        return torch.linalg.vector_norm(g, dim=-1)
    return g.abs().amax(-1)


class ALFusedMeta(NamedTuple):
    """What the fused AL iteration (``ops/cuda_al_fused.py``) needs of a
    constrained inner solve: the plain quadratic objective, the constraint
    set, its canonical stack, and the current duals and penalties
    (B, N, P), zero on invalid rows. The decorated cost and expansion they
    imply must equal the closures the solver was called with
    (``solvers/al.py`` builds both from the same data)."""

    objective: object          # ops.cost.Objective
    cs: object                 # ops.constraints.ConstraintSet
    canon: object              # ops.canonical.CanonStack or None
    lam: torch.Tensor
    mu: torch.Tensor
    atol: float


def _fused_al_eligible(model, opts: iLQROptions, meta, like=None):
    """Whether a constrained inner solve runs as the fused AL iteration.
    The rules the JAX package shares (a canonical stack, a plain quadratic
    objective, the scan backward pass on the full state, the default
    limits), and for a CUDA tensor ``like`` the Hopper kernels' own:
    float32 and a model they carry (``ops/cuda_models.py``, with or without
    slack controls). Never, on either device, a ``k2_only`` entry
    (ballonbeam, the Euler-angle quadrotor, a minimum-time model, whose
    objective and τ row rule it out besides). A stack with fk rows needs ``fused_al_fk``. Nothing of
    the TPU dispatch (batch % 128, VMEM budgets, chunking) applies."""
    ok = ((opts.fused or opts.fused_al)
          and meta is not None and meta.canon is not None
          and isinstance(meta.objective, Objective)
          and opts.bp_type == "scan" and not opts.square_root
          and not opts.error_state and opts.bp_step_limit == 0.0
          and opts.max_state_value == 1e8 and opts.max_control_value == 1e8)
    ok = ok and (opts.fused_al_fk or not _canon_has_fk(meta.canon))
    ok = ok and not _k2_only(model)
    if ok and like is not None and like.device.type == "cuda":
        ok = like.dtype == torch.float32 and cuda_model_supported(model)
    return ok


def _k2_only(model) -> bool:
    """Whether ``model`` is an entry of ``ops/cuda_models.py`` marked
    ``k2_only``: a model the JAX package gives no lane step, which it never
    runs fused."""
    found = find_cuda_model(model, slack_ok=True, k2_only_ok=True)
    return found is not None and found.k2_only


def _canon_has_fk(canon) -> bool:
    """Whether a canonical stack carries ``fk_sphere`` rows (a chain's
    forward-kinematics bubbles, ``ops/canonical.py``)."""
    return canon is not None and any(e[0] == "fk_sphere" for e in canon.spec)


def _fused_eligible(model, opts: iLQROptions, objective, like=None):
    """Whether an unconstrained solve runs as the fused iteration (kernels
    K7a and K7b). The rules the JAX package shares (``fused``, a plain
    quadratic objective, a model whose step the kernels carry and that has
    a lane step in the JAX package, so not a ``k2_only`` entry of
    ``ops/cuda_models.py``: ballonbeam, the Euler-angle quadrotor and a
    minimum-time model run phase-split on either device; the scan
    backward pass on the full state, the default limits), and for a CUDA
    tensor ``like`` the Hopper kernels' own: float32. Nothing of the TPU
    dispatch (batch % 128, VMEM budgets, chunking) applies."""
    ok = (opts.fused and isinstance(objective, Objective)
          and find_cuda_model(model) is not None
          and opts.bp_type == "scan" and not opts.square_root
          and not opts.error_state
          and opts.max_state_value == 1e8 and opts.max_control_value == 1e8)
    if ok and like is not None and like.device.type == "cuda":
        ok = like.dtype == torch.float32
    return ok


@precise
def ilqr_solve(model, cost_fn, expansion_fn, x0, X0, U0, dt,
               opts: iLQROptions = iLQROptions(), cost_tol=None,
               grad_tol=None, rho0=None, do_rollout: bool = True,
               objective: Optional[Objective] = None,
               al_meta: Optional[ALFusedMeta] = None, reg_scale=None,
               active=None, syncs: HostSyncs | None = None) -> ILQRResult:
    """Solve a batch of unconstrained (or AL-decorated) problems with iLQR
    (reference solve!, ilqr_methods.jl:3-45).

    ``cost_fn(X, U) -> J (B,)`` and ``expansion_fn(X, U) -> Expansion``
    define the objective for a batch X (B, N, n), U (B, N-1, m); x0 (B, n).
    ``dt`` is the uniform step as a Python float (the rollout kernel K2
    takes it as an argument) or a per-interval tensor.
    ``objective``: the plain quadratic ``Objective`` whose total and
    expansion (with this ``dt``) equal ``cost_fn`` and ``expansion_fn``.
    With it, an eligible solve (:func:`_fused_eligible`) runs every
    iteration as the fused backward and forward programs; its ρ retry
    escalates without the rounding-noise jump of ``reg_scale``.
    ``al_meta``: with it, an eligible solve (:func:`_fused_al_eligible`)
    runs every iteration as the fused AL backward and forward programs.
    ``active`` (B,) bool: problems outside it are left as they are (the
    queued pool solver passes its idle lanes here). Convergence follows the
    reference rules, including the ``dJ_zero`` counter.
    """
    _check_supported(opts)
    use_fused = _fused_eligible(model, opts, objective, like=X0)
    use_fused_al = _fused_al_eligible(model, opts, al_meta, like=X0)
    # fk stacks run the hybrid: phase-split backward pass, fused line search
    use_fused_al_bp = use_fused_al and not _canon_has_fk(al_meta.canon)
    if not (use_fused or use_fused_al):
        _check_card_path(model, X0, dt)
    syncs = HostSyncs() if syncs is None else syncs
    dtype, dev = X0.dtype, X0.device
    Bz, Nm1, m = U0.shape
    n = X0.shape[-1]

    def per_problem(v, default):
        v = default if v is None else v
        if torch.is_tensor(v):
            return v.to(dtype=dtype, device=dev).expand(Bz)
        return torch.full((Bz,), float(v), dtype=dtype, device=dev)

    cost_tol = per_problem(cost_tol, opts.cost_tolerance)
    grad_tol = per_problem(grad_tol, opts.gradient_norm_tolerance)
    dt_traj = torch.as_tensor(dt, dtype=dtype,
                              device=dev).expand(Nm1).contiguous()
    active = torch.ones(Bz, dtype=torch.bool, device=dev) if active is None \
        else active

    if do_rollout:
        # initial rollout where there is no valid state seed (reference
        # rollout!, rollout.jl:25-31); an open-loop seed that blows up holds
        # x0 instead, so J0 stays finite (trajopt_tpu ilqr.py:1276-1284: the
        # kuka hold torques cancel gravity only to the rounding of the host
        # that computed them, and the free arm diverges in float32);
        # syncs.held counts the problems it held
        needs = ~torch.isfinite(X0).flatten(1).all(-1) & active
        if syncs.any(needs):
            X_roll = rollout(model, x0, U0, dt_traj)
            blew = ~torch.isfinite(X_roll).flatten(1).all(-1)
            X_roll = _where(blew, x0[:, None, :].expand_as(X_roll), X_roll)
            X0 = _where(needs, X_roll, X0)
            syncs.held += syncs.item((blew & needs).sum())

    J0 = cost_fn(X0, U0)
    rho = per_problem(rho0, opts.bp_reg_initial).clone()
    drho = torch.ones(Bz, dtype=dtype, device=dev)

    qs = getattr(model, "quat_slice", None) if opts.error_state else None
    ns = n - 1 if qs is not None else n     # error-state tangent dim
    if qs is not None:
        from trajopt_tpu_torch.models.quaternions import project_error_state

    X, U = X0.contiguous(), U0.contiguous()     # the kernels' layout
    K = torch.zeros((Bz, Nm1, m, ns), dtype=dtype, device=dev)
    d = torch.zeros((Bz, Nm1, m), dtype=dtype, device=dev)
    J_prev = J0
    inf = torch.full((Bz,), float("inf"), dtype=dtype, device=dev)
    dJ, grad = inf, inf
    dJ_zero = torch.zeros(Bz, dtype=torch.int32, device=dev)
    it = torch.zeros(Bz, dtype=torch.int32, device=dev)
    converged = torch.zeros(Bz, dtype=torch.bool, device=dev)
    a_prev = torch.ones(Bz, dtype=dtype, device=dev)

    def running():
        return (~converged & (it < opts.iterations)
                & (J_prev < opts.max_cost_value) & active)

    reg_state = opts.bp_reg_type == "state"
    if use_fused_al:
        canon, atol = al_meta.canon, al_meta.atol
        lam_al, mu_al = al_meta.lam.contiguous(), al_meta.mu.contiguous()
        obj_al = al_meta.objective
        # the same scale-aware retry jump as the closure path gets from
        # solvers/al.py
        al_scale = reg_noise_scale(mu_al, dtype)

    go = running()
    while syncs.any(go):
        if use_fused:
            def sweep(rho_v):
                return fused_backward_cuda(
                    model, X, U, dt_traj, objective, rho_v.contiguous(),
                    reg_state=reg_state)

            K_n, d_n, dV1, dV2, rho_n, drho_n = _rho_retry(
                sweep, rho, drho, opts, active=go, syncs=syncs)
        elif use_fused_al_bp:
            def sweep(rho_v):
                return fused_al_backward_cuda(
                    model, canon, X, U, lam_al, mu_al, dt_traj, obj_al,
                    rho_v.contiguous(), atol=atol, reg_state=reg_state)

            K_n, d_n, dV1, dV2, rho_n, drho_n = _rho_retry(
                sweep, rho, drho, opts, reg_scale=al_scale, active=go,
                syncs=syncs)
        else:
            A, B = model.jacobian_traj(X[:, :-1], U, dt_traj)
            exp = expansion_fn(X, U)
            if qs is not None:
                A, B, exp = project_error_state(X, A, B, exp, qs)
            K_n, d_n, dV1, dV2, rho_n, drho_n = backward_pass(
                A, B, exp, rho, drho, opts, reg_scale=reg_scale, active=go,
                syncs=syncs)
        alpha0 = None
        if opts.line_search_warm_start:
            # grow from the last accepted step; reset to 1 after exhaustion
            alpha0 = torch.where(a_prev > 0.0,
                                 (2.0 * a_prev).clamp(2.0 ** -10, 1.0),
                                 torch.ones_like(a_prev))
        if use_fused:
            Xn, Un, J, rho_n, drho_n, alpha = fused_forward_cuda(
                model, x0, X, U, K_n, d_n, dV1, dV2, J_prev, rho_n, drho_n,
                alpha0, dt_traj, objective, _line_search_opts(opts),
                active=go, syncs=syncs)
        elif use_fused_al:
            Xn, Un, J, rho_n, drho_n, alpha = fused_al_forward_cuda(
                model, canon, x0, X, U, K_n, d_n, dV1, dV2, J_prev, rho_n,
                drho_n, alpha0, lam_al, mu_al, dt_traj, obj_al,
                _line_search_opts(opts), atol=atol, active=go, syncs=syncs)
        else:
            Xn, Un, J, rho_n, drho_n, alpha = forward_pass(
                model, cost_fn, x0, X, U, K_n, d_n, dV1, dV2, J_prev, rho_n,
                drho_n, dt, opts, alpha0=alpha0, active=go, syncs=syncs)

        dJ_n = (J - J_prev).abs()
        grad_n = calculate_gradient(opts.gradient_type, d_n, Un,
                                    expansion_fn, Xn)
        dJ_zero_n = torch.where(dJ_n == 0.0, dJ_zero + 1,
                                torch.zeros_like(dJ_zero))
        conv_n = (((0.0 < dJ_n) & (dJ_n < cost_tol)) | (grad_n < grad_tol)
                  | (dJ_zero_n > opts.dJ_counter_limit))

        X, U = _where(go, Xn, X), _where(go, Un, U)
        K, d = _where(go, K_n, K), _where(go, d_n, d)
        J_prev = torch.where(go, J, J_prev)
        dJ = torch.where(go, dJ_n, dJ)
        grad = torch.where(go, grad_n, grad)
        rho = torch.where(go, rho_n, rho)
        drho = torch.where(go, drho_n, drho)
        dJ_zero = torch.where(go, dJ_zero_n, dJ_zero)
        converged = torch.where(go, conv_n, converged)
        a_prev = torch.where(go, alpha, a_prev)
        it = it + go.to(it.dtype)
        go = running()
    return ILQRResult(X=X, U=U, K=K, d=d, J=J_prev, iterations=it,
                      gradient=grad, dJ=dJ, rho=rho, drho=drho,
                      converged=converged)


@precise
def tvlqr_projection(model, expansion_fn, x0, X, U, dt, opts: iLQROptions):
    """Project dynamically infeasible trajectories into feasible space with
    TVLQR tracking (reference projection!, ilqr_methods.jl:179-190): one
    backward pass from ρ = 0 (kernel K5, or K1 with ``bp_type='sqrt'``; the ρ
    retry climbs where float32 needs it), then one closed-loop rollout with
    α = 0 (kernel K2, full state). Batched: x0 (B, n), X (B, N, n),
    U (B, N-1, m); ``dt`` the uniform step as a Python float.
    ``expansion_fn(X, U) -> Expansion``. Returns (X̄, Ū)."""
    _check_supported(opts)
    _check_card_path(model, X, dt)
    dtype, dev = X.dtype, X.device
    Bz, Nm1 = U.shape[0], U.shape[1]
    dt_traj = torch.as_tensor(dt, dtype=dtype,
                              device=dev).expand(Nm1).contiguous()
    X, U = X.contiguous(), U.contiguous()
    A, B = model.jacobian_traj(X[:, :-1], U, dt_traj)
    exp = expansion_fn(X, U)
    zero = torch.zeros(Bz, dtype=dtype, device=dev)
    K, d, _, _, _, _ = backward_pass(A, B, exp, zero, torch.ones_like(zero),
                                     opts)
    Xn, Un, _ = rollout_closed_loop_cuda(
        model, x0.contiguous(), X, U, K.contiguous(), d.contiguous(), zero,
        dt, max_state_value=opts.max_state_value,
        max_control_value=opts.max_control_value)
    return Xn, Un
