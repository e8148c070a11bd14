"""Batch and queued batch solving.

Counterpart of ``trajopt_tpu/parallel/batch.py``'s ``solve_batch`` (the
whole AL solve for a batch of starts in one call) and of
``solve_batch_queued``, ``solve_batch_queued_altro``,
``solve_batch_queued_altro_retry`` and ``pn_polish_batch``: a pool
of problems streams through a fixed number of lanes, one AL outer iteration
per round, and a lane whose problem finishes takes the next problem from the
front of the pool. The JAX package runs this as one compiled
``while_loop``; here the round loop is Python, the refill is a masked
gather/scatter on the device, and only the loop tests read from the device.
The port compiles nothing, so the jitted-program cache of the JAX package's
retry function has no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from trajopt_tpu_torch.problem import Problem
from trajopt_tpu_torch.solvers.al import (
    ALLaneState, ALOptions, ALResult, al_lane_stepper, al_solve_batch,
)
from trajopt_tpu_torch.solvers.ilqr import HostSyncs


def solve_batch(prob: Problem, opts: ALOptions, x0s, U0s=None,
                syncs: HostSyncs | None = None) -> ALResult:
    """Solve the same problem from a batch of initial states x0s (B, n),
    optionally with a batch of control seeds U0s (B, N-1, m): every problem
    runs its whole AL solve in the one call, until the slowest is done.
    Returns an ALResult with a leading problem dimension on every field.
    ``syncs`` counts the device-to-host reads of the loop tests."""
    Bz = x0s.shape[0]
    if U0s is None:
        U0s = prob.U.expand((Bz,) + prob.U.shape)
    X0s = prob.X.expand((Bz,) + prob.X.shape).clone()
    X0s[:, 0] = x0s
    return al_solve_batch(prob, opts, x0s, X0s, U0s, syncs=syncs)


class QueuedBatchResult(NamedTuple):
    """Pool-ordered outputs of :func:`solve_batch_queued`."""

    X: torch.Tensor                 # (Bp, N, n)
    U: torch.Tensor                 # (Bp, N-1, m)
    c_max: torch.Tensor             # (Bp,)
    J: torch.Tensor                 # (Bp,)
    iterations_total: torch.Tensor  # (Bp,) inner iLQR iterations
    rounds: int                     # outer rounds executed
    host_syncs: int                 # device-to-host reads of the loop tests


def _select(mask, new: ALLaneState, old: ALLaneState) -> ALLaneState:
    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)),
                           a, b)

    return ALLaneState(*(pick(a, b) for a, b in zip(new, old)))


def solve_batch_queued(prob: Problem, opts: ALOptions, x0s, lanes: int = 128,
                       U0s=None, constraint_tolerance=None, mu_init=None,
                       penalty_scaling=None) -> QueuedBatchResult:
    """Streaming batched AL solve of the pool x0s (Bp, n) [and control seeds
    U0s (Bp, N-1, m)] over ``lanes`` lanes. Throughput is bound by the mean
    iteration count rather than the slowest problem: a straggler holds one
    lane while the rest of the pool streams through the others. At most
    ``iterations·ceil(Bp/L) + iterations`` rounds run.
    """
    Bp = x0s.shape[0]
    L = min(lanes, Bp)
    if U0s is None:
        U0s = prob.U.expand((Bp,) + prob.U.shape)
    syncs = HostSyncs()
    init, step = al_lane_stepper(prob, opts, constraint_tolerance, mu_init,
                                 penalty_scaling, syncs=syncs)
    dtype, dev = prob.U.dtype, prob.device
    N, n = prob.X.shape
    m = prob.U.shape[-1]

    # outputs padded by one slot: the scatter of unfinished lanes lands in it
    X_out = torch.zeros((Bp + 1, N, n), dtype=dtype, device=dev)
    U_out = torch.zeros((Bp + 1, N - 1, m), dtype=dtype, device=dev)
    c_max_out = torch.full((Bp + 1,), float("inf"), dtype=dtype, device=dev)
    J_out = torch.full((Bp + 1,), float("inf"), dtype=dtype, device=dev)
    it_out = torch.zeros((Bp + 1,), dtype=torch.int32, device=dev)

    state = init(x0s[:L], U0s[:L])
    active = torch.ones(L, dtype=torch.bool, device=dev)
    idx = torch.arange(L, device=dev)
    ptr = torch.tensor(L, device=dev)
    max_rounds = opts.iterations * ((Bp + L - 1) // L) + opts.iterations
    rounds = 0
    while rounds < max_rounds and syncs.any(active):
        state = _select(active, step(state, active), state)
        finished = active & (state.converged | (state.it >= opts.iterations))
        tgt = torch.where(finished, idx, torch.full_like(idx, Bp))
        X_out[tgt] = state.X
        U_out[tgt] = state.U
        c_max_out[tgt] = state.c_max
        J_out[tgt] = state.J
        it_out[tgt] = state.it_total
        rounds += 1

        # refill finished lanes from the pool front
        ranks = torch.cumsum(finished.long(), 0) - 1
        new_idx = ptr + ranks
        has_work = finished & (new_idx < Bp)
        src = torch.where(has_work, new_idx,
                          torch.zeros_like(new_idx)).clamp(0, Bp - 1)
        state = _select(has_work, init(x0s[src], U0s[src]), state)
        idx = torch.where(has_work, new_idx, idx)
        active = (active & ~finished) | has_work
        ptr = ptr + finished.sum()
    return QueuedBatchResult(
        X=X_out[:Bp], U=U_out[:Bp], c_max=c_max_out[:Bp], J=J_out[:Bp],
        iterations_total=it_out[:Bp], rounds=rounds,
        host_syncs=syncs.count)


def solve_batch_queued_altro(prob: Problem, opts, x0s, lanes: int = 128,
                             infeasible: Optional[bool] = None,
                             constraint_tolerance=None,
                             mu_scale: float = 1.0) -> QueuedBatchResult:
    """Streaming batched AL stage of ALTRO: applies the infeasible-start
    slack transform and ALTRO's per-row penalty schedules, streams the pool
    through :func:`solve_batch_queued`, strips the slack controls, and
    re-scores ``c_max`` on the ORIGINAL constraints.

    ``opts``: ALTROOptions. PN polish, the feasible re-solve and minimum
    time are not applied here (they are single-solve polish stages). With
    ``infeasible=None`` a finite state seed selects the transform.
    ``mu_scale`` scales the initial penalties (the failed-lane retry of
    :func:`solve_batch_queued_altro_retry`).
    """
    from trajopt_tpu_torch.solvers.altro import (
        _penalty_rows, infeasible_problem,
    )

    n, m = prob.model.n, prob.model.m
    if infeasible is None:
        infeasible = bool(torch.isfinite(prob.X).all())
    prob_t = infeasible_problem(prob, opts.R_inf) if infeasible else prob
    mu0, sca = _penalty_rows(prob_t.constraints, opts, prob.U.dtype)
    mu0 = mu0 * mu_scale
    U0s = None
    if infeasible:
        # the transform seeds the slacks from the TEMPLATE x0's knot-0
        # defect (u_slack[0] = X[1] − f(x0, u0)); re-derive it per problem
        # so each seed trajectory is dynamically consistent at step 0
        s0 = prob.X[1] - prob.model.step(
            x0s, prob.U[0].expand(x0s.shape[0], m), prob.dt)
        U0s = prob_t.U.expand((x0s.shape[0],) + prob_t.U.shape).clone()
        U0s[:, 0, m:] = s0
    res = solve_batch_queued(prob_t, opts.opts_al, x0s, lanes=lanes, U0s=U0s,
                             constraint_tolerance=constraint_tolerance,
                             mu_init=mu0[None, :], penalty_scaling=sca)
    Xs = res.X[:, :, :n].contiguous()
    Us = res.U[:, :, :m].contiguous()
    c_max = prob.constraints.max_violation(prob.constraints.evaluate(Xs, Us))
    return res._replace(X=Xs, U=Us, c_max=c_max)


def solve_batch_queued_altro_retry(prob: Problem, opts, x0s,
                                   lanes: int = 128,
                                   infeasible: Optional[bool] = None,
                                   constraint_tolerance=None,
                                   tol: float = 1e-3,
                                   mu_retry_scale: float = 4.0,
                                   max_retries: int = 1):
    """Queued-pool ALTRO solve, then a host-level re-solve of the problems
    that did not reach ``c_max < tol`` under a scaled initial-penalty
    schedule (mu0 × ``mu_retry_scale`` per trip).

    About 6% of maze-pool problems fail under any one float32 rounding
    pattern and solve under a perturbed iterate path: the failures are
    chaotic, not hard. The retry pool holds exactly the failed problems,
    cycled to fill the lanes, so it costs about (n_failed / Bp) of the main
    pass. A retry result replaces the first one only where it reached
    ``tol``. Returns (QueuedBatchResult, n_retried); ``rounds`` and
    ``host_syncs`` add up over the passes.
    """
    def solve(xs, scale):
        return solve_batch_queued_altro(
            prob, opts, xs, lanes=lanes, infeasible=infeasible,
            constraint_tolerance=constraint_tolerance, mu_scale=scale)

    r = solve(x0s, 1.0)
    n_retried = 0
    for trip in range(1, max_retries + 1):
        c = r.c_max.cpu().numpy()
        fail = np.where(~(c < tol))[0]
        if fail.size == 0:
            break
        n_retried += int(fail.size)
        L = min(lanes, x0s.shape[0])
        K = max(L, ((fail.size + L - 1) // L) * L)
        pad = np.resize(fail, K)              # cycle failed idx into pads
        r2 = solve(x0s[torch.as_tensor(pad, device=x0s.device)],
                   float(mu_retry_scale ** trip))
        r = r._replace(rounds=r.rounds + r2.rounds,
                       host_syncs=r.host_syncs + r2.host_syncs)
        # merge: keep the retry result where it solved a failed problem
        c2 = r2.c_max.cpu().numpy()
        took = {}
        for row, pidx in enumerate(pad):
            if c2[row] < tol and (pidx not in took
                                  or c2[row] < c2[took[pidx]]):
                took[pidx] = row
        if not took:
            continue
        rows = torch.as_tensor(sorted(took.values()), device=x0s.device)
        idxs = torch.as_tensor(pad, device=x0s.device)[rows]

        def upd(a, b):
            a = a.clone()
            a[idxs] = b[rows]
            return a

        r = r._replace(
            X=upd(r.X, r2.X), U=upd(r.U, r2.U),
            c_max=upd(r.c_max, r2.c_max), J=upd(r.J, r2.J),
            iterations_total=upd(r.iterations_total, r2.iterations_total))
    return r, n_retried


def pn_polish_batch(prob: Problem, Xs, Us, opts=None, syncs=None):
    """Batched projected-Newton polish of a pool of AL-converged
    trajectories Xs (B, N, n), Us (B, N-1, m): the batch-scale version of
    ALTRO's AL → PN handoff (reference altro_methods.jl:30-40 +
    projected_newton.jl:200-324). Each problem is the template ``prob``
    re-seeded with its solved (X, U), its start taken from the trajectory
    (the dispersed pool), then projected to machine-precision feasibility.
    Returns a PNResult with a leading problem dimension. float64 in, float64
    out: cast a float32 AL result up first where c_max below ~1e-6 is
    wanted."""
    from trajopt_tpu_torch.solvers.projected_newton import (
        PNOptions, pn_solve_batch,
    )

    return pn_solve_batch(prob, Xs[:, 0], Xs, Us,
                          PNOptions() if opts is None else opts, syncs=syncs)
