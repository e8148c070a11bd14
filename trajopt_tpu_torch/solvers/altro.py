"""ALTRO meta-solver.

Counterpart of ``trajopt_tpu/solvers/altro.py`` (reference
src/solvers/altro/). ALTRO = problem transforms (infeasible start) + the
AL-iLQR primary solve + the optional projected-Newton polish + result
post-processing (reference altro_methods.jl:2-124): the options, the
infeasible-start slack transform, ALTRO's per-row penalty schedules (which
``parallel/batch.py::solve_batch_queued_altro`` also drives) and
``altro_solve``. The minimum-time transform is not ported yet (ROADMAP
Queue 1 #11): ``altro_solve`` raises for it, and ``ALTROOptions`` keeps its
fields so options carry across.

On a CUDA tensor the AL stages run on the fused AL kernels K3 and K4 (the
slack-augmented model first, the base model in the feasible re-solve), the
TVLQR projection on K5 and K2; the polish is plain tensor code
(``solvers/projected_newton.py``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from trajopt_tpu_torch.models.base import DiscreteModel
from trajopt_tpu_torch.ops.constraints import (
    Constraint, ConstraintSet, infeasible_constraint,
)
from trajopt_tpu_torch.ops.cost import Objective
from trajopt_tpu_torch.problem import Problem, update_problem
from trajopt_tpu_torch.solvers.al import ALOptions, _al_solve_one
from trajopt_tpu_torch.solvers.ilqr import HostSyncs, tvlqr_projection
from trajopt_tpu_torch.solvers.projected_newton import PNOptions, pn_solve


@dataclasses.dataclass(frozen=True)
class ALTROOptions:
    """(reference ALTROSolverOptions, altro_solver.jl:6-65). Field for
    field the JAX package's ``ALTROOptions``, with the same defaults."""

    opts_al: ALOptions = ALOptions()
    # infeasible start
    constraint_tolerance_infeasible: float = 1e-5
    R_inf: float = 1.0
    dynamically_feasible_projection: bool = True
    resolve_feasible_problem: bool = True
    penalty_initial_infeasible: float = 1.0
    penalty_scaling_infeasible: float = 10.0
    # minimum time
    R_minimum_time: float = 1.0
    dt_max: float = 1.0
    dt_min: float = 1e-3
    penalty_initial_minimum_time_inequality: float = 1.0
    penalty_initial_minimum_time_equality: float = 1.0
    penalty_scaling_minimum_time_inequality: float = 1.0
    penalty_scaling_minimum_time_equality: float = 1.0
    # projected newton
    projected_newton: bool = False
    opts_pn: Optional[PNOptions] = None
    projected_newton_tolerance: float = 1e-3


class ALTROResult(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    J: torch.Tensor
    c_max: torch.Tensor
    iterations: torch.Tensor
    iterations_total: torch.Tensor
    gradient: torch.Tensor
    dt_traj: torch.Tensor  # per-interval dt
    tt: torch.Tensor       # total trajectory time
    host_syncs: int        # device-to-host reads of the AL stages' loops
    seed_held: int         # 1 if the open-loop seed blew up and x0 was held


# ------------------------------------------------------------ constraint lift

def lift_constraint(con: Constraint, n: int, m: int) -> Constraint:
    """Re-target a constraint built for (n, m) onto an augmented problem
    with extra trailing state/control dims (reference
    update_constraint_set_jacobians, constraint_sets.jl:286-302). The
    port's constraint kinds index x and u relative to whatever widths they
    are called with (``ops/constraints.py``), and their canonical
    descriptors are dimension-relative too, so the same object serves the
    augmented problem."""
    if con.canon is None:
        raise NotImplementedError(
            f"constraint {con.label!r} has no canonical descriptor: lifting "
            "a custom constraint is not ported yet (ROADMAP Queue 1)")
    return con


def _lift_entries(cs: ConstraintSet, n: int, m: int):
    """Lift every constraint of a stacked set onto augmented dims, keeping
    the original knot masks."""
    mask_np = cs.mask.cpu().numpy()
    entries = []
    for con, (r0, r1) in zip(cs.cons, cs.slices):
        # per-knot mask from any row of the block (rows share knots except
        # bound u-rows at the terminal knot, which term_rows re-handles)
        kmask = mask_np[:, r0:r1].any(axis=1)
        entries.append((lift_constraint(con, n, m), kmask))
    return entries


# ---------------------------------------------------------- infeasible start

def infeasible_problem(prob: Problem, R_inf: float = 1.0) -> Problem:
    """Augment with n slack controls that make the dynamics artificially
    fully actuated (reference infeasible_problem, infeasible.jl:2-34 +
    add_slack_controls, model.jl:761-779)."""
    base = prob.model
    n, m, N = base.n, base.m, prob.N
    dtype, dev = prob.U.dtype, prob.device

    def step(x, u, dt):
        return base.step(x, u[..., :m], dt) + u[..., m:]

    model_inf = DiscreteModel(step, n, m + n, model=base.model,
                              integrator=base.integrator,
                              name=base.name + "_infeasible")
    model_inf.quat_slice = base.quat_slice
    model_inf.slack_m = m
    # the fused AL kernels (ops/cuda_al_fused.py) inline the base step and
    # add the slack themselves
    model_inf.cuda_step = base.cuda_step
    model_inf.chain_table = base.chain_table

    # structured Jacobian: the slacks enter linearly with an identity
    # block, so only the base step is differentiated (n + m tangents
    # instead of 2n + m)
    base_jac = base._jac

    def jac_inf(x, u, dt):
        A, Bm = base_jac(x, u[..., :m], dt)
        eye = torch.eye(n, dtype=Bm.dtype, device=Bm.device)
        return A, torch.cat([Bm, eye.expand(Bm.shape[:-1] + (n,))], dim=-1)

    model_inf._jac = jac_inf

    # objective: R ← blkdiag(R, R_inf/dt · I)  (infeasible.jl:8-15)
    obj = prob.obj
    Rpad = torch.zeros((N, m + n, m + n), dtype=dtype, device=dev)
    Rpad[:, :m, :m] = obj.R
    Rpad[:-1, m:, m:] = (R_inf / prob.dt) * torch.eye(n, dtype=dtype,
                                                      device=dev)
    Hpad = torch.zeros((N, m + n, n), dtype=dtype, device=dev)
    Hpad[:, :m, :] = obj.H
    rpad = torch.zeros((N, m + n), dtype=dtype, device=dev)
    rpad[:, :m] = obj.r
    obj_inf = Objective(Q=obj.Q, R=Rpad, H=Hpad, q=obj.q, r=rpad, c=obj.c)

    # constraints: lifted originals + u_inf = 0 equality (infeasible.jl:17-29)
    entries = _lift_entries(prob.constraints, n, m)
    kmask = np.zeros(N, bool)
    kmask[: N - 1] = True
    entries.append((infeasible_constraint(n, m), kmask))
    cs_inf = ConstraintSet.build(entries, N, device=dev)

    # slack seeding from state-trajectory defects (infeasible.jl:62-80)
    Xc = torch.cat([prob.x0[None], prob.X[1:-1]], dim=0)
    u_slack = prob.X[1:] - base.step(Xc, prob.U, prob.dt_traj()[:, None])
    U_inf = torch.cat([prob.U, u_slack], dim=1)

    return update_problem(prob, model=model_inf, obj=obj_inf,
                          constraints=cs_inf, U=U_inf)


# ------------------------------------------------------------ penalty rows

def _penalty_rows(cs: ConstraintSet, opts: ALTROOptions, dtype):
    """Per-row penalty_initial / penalty_scaling vectors (P,) with the
    ALTRO-specific schedules for infeasible and min-time rows."""
    P = cs.P
    mu0 = np.full(P, float(opts.opts_al.penalty_initial))
    sca = np.full(P, float(opts.opts_al.penalty_scaling))
    for con, (r0, r1) in zip(cs.cons, cs.slices):
        if con.label == "infeasible":
            mu0[r0:r1] = opts.penalty_initial_infeasible
            sca[r0:r1] = opts.penalty_scaling_infeasible
        elif con.label == "min_time_bnd":
            mu0[r0:r1] = opts.penalty_initial_minimum_time_inequality
            sca[r0:r1] = opts.penalty_scaling_minimum_time_inequality
        elif con.label == "min_time_eq":
            mu0[r0:r1] = opts.penalty_initial_minimum_time_equality
            sca[r0:r1] = opts.penalty_scaling_minimum_time_equality
    dev = cs.mask.device
    return (torch.as_tensor(mu0, dtype=dtype, device=dev),
            torch.as_tensor(sca, dtype=dtype, device=dev))


# --------------------------------------------------------------- main solve

def _al_fields(o: ALOptions):
    return {f.name: getattr(o, f.name) for f in dataclasses.fields(o)}


def altro_solve(prob: Problem, opts: ALTROOptions = ALTROOptions(),
                infeasible: Optional[bool] = None,
                minimum_time: Optional[bool] = None) -> ALTROResult:
    """(reference solve!, altro_methods.jl:2-53).

    The infeasible-start transform is selected from the problem's data (a
    finite state seed, reference altro_methods.jl:98-124) unless
    ``infeasible`` says otherwise. With it: the AL solve of the
    slack-augmented problem, the optional projected-Newton polish, the
    slacks stripped, and with ``resolve_feasible_problem`` the AL re-solve
    of the original problem from the TVLQR projection of that trajectory
    onto the dynamics (``dynamically_feasible_projection``). ``c_max`` of
    the result is scored on the original constraints. A minimum-time problem
    (``minimum_time=True`` or ``tf == 0``) raises ``NotImplementedError``.
    ``host_syncs`` counts the device-to-host reads of the AL stages' loop
    tests; ``seed_held`` whether the initial-rollout guard held x0.
    """
    dtype = prob.U.dtype
    if infeasible is None:
        infeasible = bool(torch.isfinite(prob.X).all())
    if minimum_time is None:
        minimum_time = prob.tf == 0.0
    if minimum_time:
        raise NotImplementedError(
            "altro_solve: the minimum-time transform (minimum_time=True or "
            "tf == 0) is not ported yet (ROADMAP Queue 1 #11)")

    prob_altro = infeasible_problem(prob, opts.R_inf) if infeasible else prob

    # PN handoff tolerance (altro_methods.jl:6-14)
    ctol = opts.opts_al.constraint_tolerance
    kickout = opts.opts_al.kickout_max_penalty
    if opts.projected_newton:
        if opts.projected_newton_tolerance >= 0:
            ctol = opts.projected_newton_tolerance
        else:
            ctol = 0.0
            kickout = True
    opts_al = ALOptions(**{**_al_fields(opts.opts_al),
                           "constraint_tolerance": ctol,
                           "kickout_max_penalty": kickout})

    mu0, sca = _penalty_rows(prob_altro.constraints, opts, dtype)
    syncs = HostSyncs()
    res_al = _al_solve_one(prob_altro, opts_al, None, mu0[None, :], sca,
                           syncs)
    X_a, U_a = res_al.X, res_al.U
    iterations_total = res_al.iterations_total
    J = res_al.J

    # projected newton polish (altro_methods.jl:30-40)
    if opts.projected_newton:
        pn_opts = opts.opts_pn if opts.opts_pn is not None else PNOptions()
        res_pn = pn_solve(update_problem(prob_altro, X=X_a, U=U_a), pn_opts)
        X_a, U_a, J = res_pn.X, res_pn.U, res_pn.J

    # ---------------- process results (altro_methods.jl:56-95)
    n, m = prob.model.n, prob.model.m
    X_out = X_a[:, :n].contiguous()
    U_out = U_a[:, :m].contiguous()

    if infeasible:
        # strip the slacks, project to feasible, optionally re-solve
        # (infeasible.jl:38-59)
        prob_feas = update_problem(prob, X=X_out, U=U_out)
        if opts.dynamically_feasible_projection:
            dtf = prob_feas.dt_traj()
            Xp, Up = tvlqr_projection(
                prob_feas.model,
                lambda X, U: prob_feas.obj.expansion(X, U, dtf),
                prob_feas.x0[None], prob_feas.X[None], prob_feas.U[None],
                prob_feas.dt, opts.opts_al.opts_uncon)
            # as in the JAX package, the projection seeds the re-solve;
            # without one the stripped trajectory is what comes back
            prob_feas = update_problem(prob_feas, X=Xp[0], U=Up[0])

        if opts.resolve_feasible_problem:
            mu0f, scaf = _penalty_rows(prob_feas.constraints, opts, dtype)
            res2 = _al_solve_one(prob_feas, opts_al, None, mu0f[None, :],
                                 scaf, syncs)
            iterations_total = iterations_total + res2.iterations_total
            J = res2.J
            X_out, U_out = res2.X, res2.U

    dt_out = prob.dt_traj()
    # the final violation on the ORIGINAL constraints (reference
    # max_violation(prob) post-solve, problem.jl:242-267: the augmented rows
    # are internal)
    cs = prob.constraints
    c_max = cs.max_violation(cs.evaluate(X_out, U_out))
    return ALTROResult(X=X_out, U=U_out, J=J, c_max=c_max,
                       iterations=res_al.iterations,
                       iterations_total=iterations_total,
                       gradient=res_al.gradient, dt_traj=dt_out,
                       tt=dt_out.sum(), host_syncs=syncs.count,
                       seed_held=syncs.held)
