"""Augmented Lagrangian outer loop: ``al_solve`` and the per-lane stepper
of the queued pool solver (``parallel/batch.py::solve_batch_queued``).

Counterpart of ``trajopt_tpu/solvers/al.py``: ``ALOptions``, ``ALResult``,
``ALLaneState``, ``al_cost_fns``, ``dual_update``, ``penalty_update``,
``al_lane_stepper`` and ``al_solve``, batched over a leading problem
dimension.

Which kernels a solve on a CUDA tensor runs on follows from what it is, not
from a fallback. An unconstrained ``al_solve`` with ``fused=True`` runs on
K7a and K7b. A constrained solve with a canonical stack, of any model with
a CUDA step, with or without slack controls, runs on K3 and K4
(``fused_al``, the default). Every other solve is phase-split: the Jacobians, the cost expansion and the
AL terms of ``al_cost_fns`` as torch ops, the backward pass on K5 (or K1
with ``bp_type='sqrt'``), the line search's rollouts on K2.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from trajopt_tpu_torch.ops.constraints import ConstraintSet
from trajopt_tpu_torch.ops.cost import Expansion
from trajopt_tpu_torch.ops.line_search import where_rows
from trajopt_tpu_torch.problem import Problem
from trajopt_tpu_torch.solvers.ilqr import (
    ALFusedMeta, HostSyncs, iLQROptions, ilqr_solve, reg_noise_scale,
)
from trajopt_tpu_torch.utils.tree import precise


def _al_fused_canon(prob: Problem, opts: "ALOptions"):
    """Canonical constraint stack for the fused AL iteration, built once
    per stepper when the inner solver has ``fused`` or ``fused_al`` on
    (``fused_al`` defaults to True) and every constraint is
    data-representable (ops/canonical.py); None otherwise."""
    if not (opts.opts_uncon.fused or opts.opts_uncon.fused_al):
        return None
    from trajopt_tpu_torch.ops.canonical import canonical_stack

    return canonical_stack(prob.constraints, prob.model.n, prob.model.m,
                           dtype=prob.U.dtype)


@dataclasses.dataclass(frozen=True)
class ALOptions:
    """(reference AugmentedLagrangianSolverOptions,
    augmented_lagrangian_solver.jl:8-66). Field for field the JAX
    package's ``ALOptions``, with the same defaults."""

    opts_uncon: iLQROptions = iLQROptions()
    cost_tolerance: float = 1e-4
    cost_tolerance_intermediate: float = 1e-3
    gradient_norm_tolerance: float = 1e-5
    gradient_norm_tolerance_intermediate: float = 1e-5
    constraint_tolerance: float = 1e-3
    constraint_tolerance_intermediate: float = 1e-3
    iterations: int = 30
    dual_min: float = -1e8
    dual_max: float = 1e8
    penalty_max: float = 1e8
    penalty_initial: float = 1.0
    penalty_scaling: float = 10.0
    penalty_scaling_no: float = 1.0
    constraint_decrease_ratio: float = 0.25
    outer_loop_update_type: str = "default"
    active_constraint_tolerance: float = 0.0
    kickout_max_penalty: bool = False
    verbose: bool = False


class ALResult(NamedTuple):
    """Result of :func:`al_solve`. ``history`` holds the per-outer-iteration
    stats (reference stats dicts, augmented_lagrangian_methods.jl:79-97):
    ``cost``, ``c_max``, ``penalty_max``, ``gradient`` and
    ``iterations_inner`` with a trailing axis of ``opts.iterations`` entries
    (zero past the last outer iteration run), and ``iterations``, the outer
    iterations run."""

    X: torch.Tensor
    U: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    C: torch.Tensor
    c_max: torch.Tensor
    J: torch.Tensor
    iterations: torch.Tensor
    iterations_total: torch.Tensor
    gradient: torch.Tensor
    history: dict


def _empty_history(batch: int, iterations: int, dtype, device):
    z = torch.zeros((batch, iterations), dtype=dtype, device=device)
    return {"cost": z, "c_max": z.clone(), "penalty_max": z.clone(),
            "gradient": z.clone(),
            "iterations_inner": torch.zeros((batch, iterations),
                                            dtype=torch.int32, device=device)}


def _record_history(hist, at, it, J, c_max, penalty_max, inner, grad):
    """Write one outer iteration's stats into column ``it`` (B,) of the
    problems ``at`` (B,) bool."""
    col = torch.nn.functional.one_hot(
        it.long(), hist["cost"].shape[1]).bool() & at[:, None]
    new = dict(cost=J, c_max=c_max, penalty_max=penalty_max, gradient=grad,
               iterations_inner=inner)
    return {k: torch.where(col, new[k][:, None].to(hist[k].dtype), hist[k])
            for k in hist}


def al_cost_fns(obj, cs: ConstraintSet, dt_traj, lam, mu, tol=0.0):
    """(cost_fn, expansion_fn) of the AL-decorated objective for a batch:

        J + Σ_k λᵀc + ½ cᵀ Iμ c,   Iμ = diag(active ⊙ μ)

    (reference aula_cost, augmented_lagrangian_methods.jl:186-229, 284-286).
    lam, mu: (B, N, P)."""

    def cost_fn(X, U):
        J = obj.total(X, U, dt_traj)
        C = cs.evaluate(X, U)
        a = cs.active_set(C, lam, tol)
        Imu = torch.where(a, mu, torch.zeros_like(mu))
        return J + (lam * C + 0.5 * C * Imu * C).sum((-2, -1))

    def expansion_fn(X, U):
        e = obj.expansion(X, U, dt_traj)
        C = cs.evaluate(X, U)
        a = cs.active_set(C, lam, tol)
        Imu = torch.where(a, mu, torch.zeros_like(mu))
        g = Imu * C + lam
        tx, tu, txx, tuu, tux = cs.al_expansion_terms(X, U, g, Imu)
        return Expansion(x=e.x + tx, u=e.u + tu[..., :-1, :],
                         xx=e.xx + txx, uu=e.uu + tuu[..., :-1, :, :],
                         ux=e.ux + tux[..., :-1, :, :])

    return cost_fn, expansion_fn


def dual_update(cs: ConstraintSet, C, lam, mu, opts: ALOptions):
    """λ ← clamp(λ + μ∘c, dual_min, dual_max); inequality rows projected to
    λ ≥ 0 (reference dual_update!, augmented_lagrangian_methods.jl:107-118)."""
    lam_new = torch.clamp(lam + mu * C, opts.dual_min, opts.dual_max)
    lam_new = torch.where(cs.is_eq, lam_new, lam_new.clamp(min=0.0))
    return torch.where(cs.mask, lam_new, torch.zeros_like(lam_new))


def penalty_update(cs: ConstraintSet, mu, scaling, opts: ALOptions):
    """μ ← min(scaling·μ, μ_max) (reference penalty_update!, :121-126)."""
    mu_new = torch.clamp(scaling * mu, 0.0, opts.penalty_max)
    return torch.where(cs.mask, mu_new, torch.zeros_like(mu_new))


class ALLaneState(NamedTuple):
    """Resumable per-lane AL state for the queued pool solver
    (parallel/batch.py): one outer iteration per step, so a converged lane
    can hand its slot to a fresh problem. Every field has a leading lane
    dimension."""

    x0: torch.Tensor
    X: torch.Tensor
    U: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    c_max: torch.Tensor
    J: torch.Tensor
    it: torch.Tensor            # outer iterations done
    it_total: torch.Tensor      # inner iLQR iterations total
    gradient: torch.Tensor
    converged: torch.Tensor


def al_lane_stepper(prob: Problem, opts: ALOptions, constraint_tolerance=None,
                    mu_init=None, penalty_scaling=None,
                    syncs: HostSyncs | None = None):
    """(init, step) pair for one AL OUTER iteration per call, the semantics
    of one trip of ``al_solve``'s loop, for a batch of lanes.

    ``init(x0s (L, n), U0s (L, N-1, m))`` makes fresh lane states;
    ``step(state, active=None)`` advances every lane in ``active`` (all by
    default) by one outer iteration and returns the others unchanged.
    """
    cs = prob.constraints
    syncs = HostSyncs() if syncs is None else syncs
    dtype, dev = prob.U.dtype, prob.device
    dt_traj = prob.dt_traj()
    N, P = cs.N, cs.P
    ctol = opts.constraint_tolerance if constraint_tolerance is None \
        else constraint_tolerance
    scaling = torch.as_tensor(
        opts.penalty_scaling if penalty_scaling is None else penalty_scaling,
        dtype=dtype, device=dev).expand(P)
    mu0_row = torch.as_tensor(
        opts.penalty_initial if mu_init is None else mu_init, dtype=dtype,
        device=dev).expand(N, P) * cs.mask
    atol = opts.active_constraint_tolerance
    unconstrained = P == 0
    canon = None if unconstrained else _al_fused_canon(prob, opts)
    meta0 = ALFusedMeta(objective=prob.obj, cs=cs, canon=canon, lam=None,
                        mu=None, atol=atol)

    def init(x0s, U0s):
        L = x0s.shape[0]
        X0 = prob.X.expand(L, -1, -1).clone()
        X0[:, 0] = x0s
        inf = torch.full((L,), float("inf"), dtype=dtype, device=dev)
        return ALLaneState(
            x0=x0s.contiguous(), X=X0, U=U0s.contiguous(),
            lam=torch.zeros((L, N, P), dtype=dtype, device=dev),
            mu=mu0_row.expand(L, N, P).clone(), c_max=inf, J=inf.clone(),
            it=torch.zeros(L, dtype=torch.int32, device=dev),
            it_total=torch.zeros(L, dtype=torch.int32, device=dev),
            gradient=inf.clone(),
            converged=torch.zeros(L, dtype=torch.bool, device=dev))

    def step(st: ALLaneState, active=None) -> ALLaneState:
        if unconstrained:
            # no duals/penalties to stitch tolerances around: every round
            # runs at FINAL tolerances (al_solve's unconstrained arm)
            cost_tol = opts.cost_tolerance
            grad_tol = opts.gradient_norm_tolerance
        else:
            # tolerance stitching (reference set_tolerances!, :39-50)
            last = st.it == opts.iterations - 1
            pick = lambda a, b: torch.where(  # noqa: E731
                last, torch.full_like(st.J, a), torch.full_like(st.J, b))
            cost_tol = pick(opts.cost_tolerance,
                            opts.cost_tolerance_intermediate)
            grad_tol = pick(opts.gradient_norm_tolerance,
                            opts.gradient_norm_tolerance_intermediate)
        cost_fn, expansion_fn = al_cost_fns(prob.obj, cs, dt_traj, st.lam,
                                            st.mu, atol)
        meta = None if canon is None else meta0._replace(lam=st.lam,
                                                         mu=st.mu)
        res = ilqr_solve(prob.model, cost_fn, expansion_fn, st.x0, st.X,
                         st.U, prob.dt, opts.opts_uncon, cost_tol=cost_tol,
                         grad_tol=grad_tol, al_meta=meta,
                         reg_scale=reg_noise_scale(st.mu, dtype),
                         active=active, syncs=syncs)
        C = cs.evaluate(res.X, res.U)
        c_max_new = cs.max_violation(C)
        if opts.outer_loop_update_type == "feedback":
            # Bertsekas switch: good progress → dual step and mild penalty
            # growth; a stall → hold the duals, grow the penalties
            good = c_max_new <= opts.constraint_decrease_ratio * st.c_max
            lam = torch.where(good[:, None, None],
                              dual_update(cs, C, st.lam, st.mu, opts), st.lam)
            sc = torch.where(good[:, None],
                             torch.full_like(scaling, opts.penalty_scaling_no),
                             scaling)
            mu = penalty_update(cs, st.mu, sc[:, None, :], opts)
        else:
            lam = dual_update(cs, C, st.lam, st.mu, opts)
            mu = penalty_update(cs, st.mu, scaling, opts)
        converged = c_max_new < ctol
        if unconstrained:
            # c_max is identically 0: a lane is done only when the INNER
            # solve converged by its own dJ/grad rules rather than being
            # cut by the round boundary
            converged = converged & res.converged
        elif opts.kickout_max_penalty:
            converged = converged | (mu.flatten(1).amax(-1)
                                     >= opts.penalty_max)
        return ALLaneState(
            x0=st.x0, X=res.X, U=res.U, lam=lam, mu=mu, c_max=c_max_new,
            J=res.J, it=st.it + 1, it_total=st.it_total + res.iterations,
            gradient=res.gradient, converged=converged)

    return init, step


@precise
def al_solve_batch(prob: Problem, opts: ALOptions, x0s, X0s, U0s,
                   constraint_tolerance=None, mu_init=None,
                   penalty_scaling=None,
                   syncs: HostSyncs | None = None) -> ALResult:
    """:func:`al_solve` for a batch of problems that share ``prob`` and
    differ in the start x0s (B, n) and the seeds X0s (B, N, n),
    U0s (B, N-1, m): what ``vmap(al_solve)`` is in the JAX package. Each
    problem runs its own outer loop; one that has converged, or has used up
    its iterations, is frozen while the others go on. Every field of the
    result, the history included, has a leading problem dimension."""
    cs = prob.constraints
    syncs = HostSyncs() if syncs is None else syncs
    dtype, dev = prob.U.dtype, prob.device
    Bz = x0s.shape[0]
    x0s, X0s, U0s = x0s.contiguous(), X0s.contiguous(), U0s.contiguous()

    if not cs.is_constrained:
        # unconstrained: plain iLQR (reference
        # augmented_lagrangian_methods.jl:33-36); the objective rides along,
        # which is what makes the solve eligible for the fused iteration
        dt_traj = prob.dt_traj()
        res = ilqr_solve(
            prob.model, lambda X, U: prob.obj.total(X, U, dt_traj),
            lambda X, U: prob.obj.expansion(X, U, dt_traj), x0s, X0s, U0s,
            prob.dt, opts.opts_uncon, cost_tol=opts.cost_tolerance,
            grad_tol=opts.gradient_norm_tolerance, objective=prob.obj,
            syncs=syncs)
        zp = torch.zeros((Bz, prob.N, 0), dtype=dtype, device=dev)
        zero = torch.zeros(Bz, dtype=dtype, device=dev)
        one = torch.ones(Bz, dtype=torch.int32, device=dev)
        hist = {"cost": res.J[:, None], "c_max": zero[:, None],
                "penalty_max": zero[:, None],
                "gradient": res.gradient[:, None],
                "iterations_inner": res.iterations[:, None],
                "iterations": one}
        return ALResult(X=res.X, U=res.U, lam=zp, mu=zp, C=zp, c_max=zero,
                        J=res.J, iterations=one,
                        iterations_total=res.iterations,
                        gradient=res.gradient, history=hist)

    init, step = al_lane_stepper(prob, opts, constraint_tolerance, mu_init,
                                 penalty_scaling, syncs=syncs)
    st = init(x0s, U0s)._replace(X=X0s)
    hist = _empty_history(Bz, opts.iterations, dtype, dev)
    go = ~st.converged & (st.it < opts.iterations)
    while syncs.any(go):
        new = step(st, go)
        hist = _record_history(
            hist, go, st.it, new.J, new.c_max, new.mu.flatten(1).amax(-1),
            new.it_total - st.it_total, new.gradient)
        st = ALLaneState(*(where_rows(go, a, b) for a, b in zip(new, st)))
        go = ~st.converged & (st.it < opts.iterations)
    hist["iterations"] = st.it
    return ALResult(X=st.X, U=st.U, lam=st.lam, mu=st.mu,
                    C=cs.evaluate(st.X, st.U), c_max=st.c_max, J=st.J,
                    iterations=st.it, iterations_total=st.it_total,
                    gradient=st.gradient, history=hist)


def al_solve(prob: Problem, opts: ALOptions = ALOptions(),
             constraint_tolerance=None, mu_init=None,
             penalty_scaling=None) -> ALResult:
    """AL solve of one problem (reference solve!,
    augmented_lagrangian_methods.jl:2-31): a batch of one through
    :func:`al_solve_batch`, the leading dimension taken off the result.

    ``mu_init`` / ``penalty_scaling`` may be (P,) row vectors, so that the
    infeasible and minimum-time rows of ALTRO get their own penalty schedule
    (reference altro_solver.jl:26-53 options).
    """
    return _al_solve_one(prob, opts, constraint_tolerance, mu_init,
                         penalty_scaling, HostSyncs())


def _al_solve_one(prob: Problem, opts: ALOptions, constraint_tolerance,
                  mu_init, penalty_scaling, syncs: HostSyncs) -> ALResult:
    """:func:`al_solve`, its loop tests counted in ``syncs``."""
    res = al_solve_batch(prob, opts, prob.x0[None], prob.X[None],
                         prob.U[None], constraint_tolerance, mu_init,
                         penalty_scaling, syncs=syncs)
    return res._replace(
        **{k: getattr(res, k)[0] for k in res._fields if k != "history"},
        history={k: v[0] for k, v in res.history.items()})
