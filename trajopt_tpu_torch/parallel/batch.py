"""Queued batch solving.

Counterpart of ``trajopt_tpu/parallel/batch.py::solve_batch_queued``: a pool
of problems streams through a fixed number of lanes, one AL outer iteration
per round, and a lane whose problem finishes takes the next problem from the
front of the pool. The JAX package runs this as one compiled
``while_loop``; here the round loop is Python, the refill is a masked
gather/scatter on the device, and only the loop tests read from the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from trajopt_tpu_torch.problem import Problem
from trajopt_tpu_torch.solvers.al import ALLaneState, ALOptions, al_lane_stepper
from trajopt_tpu_torch.solvers.ilqr import HostSyncs


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
