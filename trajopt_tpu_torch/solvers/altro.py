"""ALTRO meta-solver.

Counterpart of ``trajopt_tpu/solvers/altro.py`` (reference
src/solvers/altro/). ALTRO = problem transforms (infeasible start, minimum
time) + the AL-iLQR primary solve + the optional projected-Newton polish +
result post-processing (reference altro_methods.jl:2-124): the options, the
infeasible-start slack transform, the minimum-time transform (τ = √dt as one
more control and state, ``MinTimeObjective``, ``mintime_equality``,
``minimum_time_problem``, ``total_time``), ALTRO's per-row penalty schedules
(which ``parallel/batch.py::solve_batch_queued_altro`` also drives) and
``altro_solve``.

On a CUDA tensor the AL stages run on the fused AL kernels K3 and K4 (the
slack-augmented model first, the base model in the feasible re-solve), the
TVLQR projection on K5 and K2; the polish is plain tensor code
(``solvers/projected_newton.py``). A minimum-time problem runs phase-split
on K5 and K2 (its objective is not an ``Objective`` and its τ row has no
canonical descriptor, as in the JAX package): K2 carries the minimum-time
form of every scalar model, with and without the slacks
(``ops/cuda_models.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from trajopt_tpu_torch.models.base import DiscreteModel
from trajopt_tpu_torch.ops.constraints import (
    Constraint, ConstraintSet, bound_constraint, infeasible_constraint,
)
from trajopt_tpu_torch.ops.cost import Expansion, Objective
from trajopt_tpu_torch.problem import Problem, update_problem
from trajopt_tpu_torch.solvers.al import ALOptions, al_solve_batch
from trajopt_tpu_torch.solvers.ilqr import HostSyncs, tvlqr_projection
from trajopt_tpu_torch.solvers.projected_newton import (
    PNOptions, pn_solve_batch,
)


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
    port's row kinds (those with a canonical descriptor) index x and u
    relative to whatever widths they are called with
    (``ops/constraints.py``), and their descriptors are dimension-relative
    too, so the same object serves the augmented problem. Any other
    constraint (a ``custom_constraint``) is lifted as the JAX package lifts
    it: its function and Jacobian are evaluated on the leading n and m
    columns and the Jacobian zero-padded, and so are its ``al_terms``."""
    if con.canon is not None:
        return con

    def fn(x, u):
        return con.fn(x[..., :n], u[..., :m])

    def pad(t, *widths):
        """t zero-padded on its trailing axes to ``widths``."""
        out = t.new_zeros(t.shape[:t.ndim - len(widths)] + widths)
        out[(...,) + tuple(slice(0, w) for w in t.shape[-len(widths):])] = t
        return out

    def jac(x, u):
        cx, cu = con.jac_fn(x[..., :n], u[..., :m])
        return pad(cx, x.shape[-1]), pad(cu, u.shape[-1])

    lifted = Constraint(fn, con.p, con.label, jac, equality=con.equality,
                        applies=con.applies)
    lifted.term_rows = con.term_rows
    if con.al_terms is not None:
        hook = con.al_terms

        def al_terms(X, U_pad, g, imu):
            t = hook(X[..., :n], U_pad[..., :m], g, imu)
            nb, mb = X.shape[-1], U_pad.shape[-1]
            widths = {"x": (nb,), "u": (mb,), "xx": (nb, nb),
                      "uu": (mb, mb), "ux": (mb, nb)}
            return {k: pad(v, *widths[k]) for k, v in t.items()}

        lifted.al_terms = al_terms
    return lifted


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
    base_jac_dt = base._jac_dt
    if base_jac_dt is not None:
        # the same with ∂x⁺/∂dt, which the slacks do not change
        def jac_dt_inf(x, u, dt):
            A, Bm, sdt = base_jac_dt(x, u[..., :m], dt)
            eye = torch.eye(n, dtype=Bm.dtype, device=Bm.device)
            return A, torch.cat([Bm, eye.expand(Bm.shape[:-1] + (n,))],
                                dim=-1), sdt

        model_inf._jac_dt = jac_dt_inf

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

    return update_problem(prob, model=model_inf, obj=obj_inf,
                          constraints=cs_inf,
                          U=_slack_seed(base, prob.x0, prob.X, prob.U,
                                        prob.dt_traj()))


def _slack_seed(base, x0, X, U, dt_traj):
    """The infeasible start's controls [U, slacks] with the slacks seeded
    from the state seed's defects, u_slack_k = X_{k+1} − f(X_k, U_k) with
    X_0 = x0 (infeasible.jl:62-80). Leading batch dimensions allowed."""
    Xc = torch.cat([x0[..., None, :], X[..., 1:-1, :]], dim=-2)
    return torch.cat([U, X[..., 1:, :] - base.step(Xc, U, dt_traj[:, None])],
                     dim=-1)


# --------------------------------------------------------------- minimum time

@dataclasses.dataclass(frozen=True)
class MinTimeObjective:
    """Objective of the τ = √dt augmented problem (reference MinTimeCost,
    minimum_time.jl:150-281): stage = ℓ(x̄, ū)·h² + R_mt·h² with ℓ the base
    stage cost on the base states and controls and h = τ = u[-1],
    terminal = the base terminal cost on the original states. The dt
    arguments are ignored: the step is h².

    The expansion is the closed form of the JAX package's AD one (the
    reference's analytic τ chain rule): with g_x = ∇ₓℓ, g_u = ∇ᵤℓ,
        lx = h² g_x,  lu = [h² g_u; 2h(ℓ + R_mt)],
        lxx = h² ∇²ₓₓℓ,  luu = [[h² ∇²ᵤᵤℓ, 2h g_u], [2h g_uᵀ, 2(ℓ + R_mt)]],
        lux = [[h² ∇²ᵤₓℓ], [2h g_xᵀ]],
    zero in the τ state's rows and columns. It is held against
    ``torch.func`` AD of :meth:`total` and against the JAX package
    (tests/test_torch_mintime.py). AD here takes many times the tensor
    operations of the closed form, and a minimum-time solve is bound by its
    host's tensor operations on either device."""

    base: Objective
    R_mt: torch.Tensor

    @property
    def N(self):
        return self.base.N

    def _ell(self, X, U):
        """h (…, N-1, 1) and ℓ (…, N-1, 1) at the stage knots, and what
        the expansion reuses: Q and R symmetrized, Qx̄, Rū, Hx̄, x̄, ū."""
        b = self.base
        Q = 0.5 * (b.Q[:-1] + b.Q[:-1].transpose(-1, -2))
        R = 0.5 * (b.R[:-1] + b.R[:-1].transpose(-1, -2))
        # h as a width-1 slice, never a 0-d index (Q3-4)
        h = U[..., -1:]
        xb, ub = X[..., :-1, :-1], U[..., :-1]
        Qx = torch.einsum("kij,...kj->...ki", Q, xb)
        Ru = torch.einsum("kij,...kj->...ki", R, ub)
        Hx = torch.einsum("kij,...kj->...ki", b.H[:-1], xb)
        ell = (((0.5 * Qx + b.q[:-1]) * xb).sum(-1)
               + ((0.5 * Ru + b.r[:-1] + Hx) * ub).sum(-1)
               + b.c[:-1])[..., None]
        return h, ell, (Q, R, Qx, Ru, Hx, xb, ub)

    def total(self, X, U, dt_ignored=None):
        h, ell, _ = self._ell(X, U)
        b = self.base
        xN = X[..., -1, :-1]
        return (((ell + self.R_mt) * h * h)[..., 0].sum(-1)
                + 0.5 * torch.einsum("...i,ij,...j->...", xN, b.Q[-1], xN)
                + torch.einsum("i,...i->...", b.q[-1], xN) + b.c[-1])

    def expansion(self, X, U, dt_ignored=None) -> Expansion:
        h, ell, (Q, R, Qx, Ru, Hx, xb, ub) = self._ell(X, U)
        b = self.base
        gx = Qx + b.q[:-1] + torch.einsum("kji,...kj->...ki", b.H[:-1], ub)
        gu = Ru + b.r[:-1] + Hx
        lead, (Nm1, nu) = U.shape[:-2], U.shape[-2:]
        nx = X.shape[-1]
        h2 = (h * h)[..., None]
        z = X.new_zeros
        lx = z(lead + (Nm1 + 1, nx))
        lx[..., :-1, :-1] = h * h * gx
        lx[..., -1, :-1] = torch.einsum("ij,...j->...i", b.Q[-1],
                                        X[..., -1, :-1]) + b.q[-1]
        lu = torch.cat([h * h * gu, 2.0 * h * (ell + self.R_mt)], dim=-1)
        lxx = z(lead + (Nm1 + 1, nx, nx))
        lxx[..., :-1, :-1, :-1] = h2 * Q
        lxx[..., -1, :-1, :-1] = b.Q[-1]
        luu = z(lead + (Nm1, nu, nu))
        luu[..., :-1, :-1] = h2 * R
        luu[..., :-1, -1] = 2.0 * h * gu
        luu[..., -1, :-1] = 2.0 * h * gu
        luu[..., -1, -1] = (2.0 * (ell + self.R_mt))[..., 0]
        lux = z(lead + (Nm1, nu, nx))
        lux[..., :-1, :-1] = h2 * b.H[:-1]
        lux[..., -1, :-1] = 2.0 * h * gx
        return Expansion(x=lx, u=lu, xx=lxx, uu=luu, ux=lux)


def mintime_equality(n: int, m: int) -> Constraint:
    """τ consistency across knots: u[end] − x[end] = 0 (reference
    mintime_equality, minimum_time.jl:112-124), with its analytic Jacobian
    and its structured AL terms. Two entries in one row, so no canonical
    descriptor, as in the JAX package."""

    def fn(x, u):
        return u[..., -1:] - x[..., -1:]

    def jac(x, u):
        cx = x.new_zeros(x.shape[:-1] + (1, x.shape[-1]))
        cu = x.new_zeros(x.shape[:-1] + (1, u.shape[-1]))
        cx[..., 0, -1] = -1.0
        cu[..., 0, -1] = 1.0
        return cx, cu

    con = Constraint(fn, 1, "min_time_eq", jac, equality=True,
                     applies="stage")

    def al_terms(X, U_pad, g, imu):
        # cx = −e_last, cu = +e_last: scalar terms on the τ entries
        nb, mb = X.shape[-1], U_pad.shape[-1]
        g0, i0 = g[..., 0], imu[..., 0]
        lx, lu = X.new_zeros(X.shape), X.new_zeros(U_pad.shape)
        lxx = X.new_zeros(X.shape + (nb,))
        luu = X.new_zeros(U_pad.shape + (mb,))
        lux = X.new_zeros(U_pad.shape + (nb,))
        lx[..., -1] = -g0
        lu[..., -1] = g0
        lxx[..., -1, -1] = i0
        luu[..., -1, -1] = i0
        lux[..., -1, -1] = -i0
        return {"x": lx, "u": lu, "xx": lxx, "uu": luu, "ux": lux}

    con.al_terms = al_terms
    return con


def minimum_time_problem(prob: Problem, R_min_time: float = 1.0,
                         dt_max: float = 1.0, dt_min: float = 1e-3) -> Problem:
    """τ = √dt state/control augmentation (reference minimum_time_problem,
    minimum_time.jl:2-37 + add_min_time_controls, :85-110). The model's
    step is x⁺ = [base_step(x[:-1], u[:-1], h²); h] with h = u[-1]; it
    ignores its dt argument. It keeps the base model's CUDA step name,
    slack width and chain table and is marked ``mintime``: K2's ``MinTime``
    entry (``ops/cuda_models.py``). Where the base model has a structured
    Jacobian with its dt column (``_jac_dt``: a rigid-body chain and its
    slack form), the Jacobian is that one with h's column
    ∂x⁺/∂h = 2h·∂step/∂dt, and ∂h⁺/∂h = 1; else ``torch.func.jacfwd``
    through the step."""
    base = prob.model
    n, m, N = base.n, base.m, prob.N
    dtype, dev = prob.U.dtype, prob.device

    def step(x, u, dt):
        h = u[..., -1:]
        return torch.cat([base.step(x[..., :-1], u[..., :-1], h * h), h],
                         dim=-1)

    model_mt = DiscreteModel(step, n + 1, m + 1, model=base.model,
                             integrator=base.integrator,
                             name=base.name + "_mintime")
    model_mt.cuda_step = base.cuda_step
    model_mt.slack_m = base.slack_m
    model_mt.mintime = True
    model_mt.chain_table = base.chain_table
    base_jac_dt = base._jac_dt
    if base_jac_dt is not None:
        def jac_mt(x, u, dt):
            h = u[..., -1:]
            A, Bm, sdt = base_jac_dt(x[..., :-1], u[..., :-1], (h * h)[..., 0])
            lead = A.shape[:-2]
            Amt = A.new_zeros(lead + (n + 1, n + 1))
            Amt[..., :n, :n] = A
            Bmt = A.new_zeros(lead + (n + 1, m + 1))
            Bmt[..., :n, :m] = Bm
            Bmt[..., :n, m] = 2.0 * h * sdt
            Bmt[..., n, m] = 1.0
            return Amt, Bmt

        model_mt._jac = jac_mt

    obj_mt = MinTimeObjective(base=prob.obj, R_mt=torch.as_tensor(
        R_min_time, dtype=dtype, device=dev))

    # constraints: the lifted originals, the τ bounds at every stage knot
    # and the τ equality at the interior knots (minimum_time.jl:126-147)
    entries = _lift_entries(prob.constraints, n, m)
    tau_bnd = bound_constraint(n + 1, m + 1,
                               u_min=[-np.inf] * m + [math.sqrt(dt_min)],
                               u_max=[np.inf] * m + [math.sqrt(dt_max)],
                               label="min_time_bnd")
    kmask_b = np.zeros(N, bool)
    kmask_b[: N - 1] = True
    entries.append((tau_bnd, kmask_b))
    kmask_eq = np.zeros(N, bool)
    kmask_eq[1: N - 1] = True   # 1 < k < N in 1-based == knots 1..N-2 here
    entries.append((mintime_equality(n, m), kmask_eq))
    cs_mt = ConstraintSet.build(entries, N, device=dev)

    x0_mt, X_mt, U_mt = _mintime_seed(prob.x0, prob.X, prob.U, prob.dt)
    return update_problem(prob, model=model_mt, obj=obj_mt,
                          constraints=cs_mt, U=U_mt, X=X_mt, x0=x0_mt,
                          xf=torch.cat([prob.xf, prob.xf.new_zeros(1)]))


def _mintime_seed(x0, X, U, dt: float):
    """The minimum-time problem's start and seeds: τ = 0 appended to x0,
    √dt appended to every control, and to every state of a finite state
    seed (τ_0 = 0); a seed that is not finite becomes all NaN
    (minimum_time.jl:20-31). Leading batch dimensions allowed."""
    sqrt_dt = math.sqrt(dt)
    U_mt = torch.cat([U, torch.full_like(U[..., :1], sqrt_dt)], dim=-1)
    X_mt = torch.cat([X, torch.full_like(X[..., :1], sqrt_dt)], dim=-1)
    X_mt[..., 0, -1] = 0.0
    finite = torch.isfinite(X).flatten(-2).all(-1)[..., None, None]
    X_mt = torch.where(finite, X_mt, torch.full_like(X_mt, float("nan")))
    return torch.cat([x0, x0.new_zeros(x0.shape[:-1] + (1,))], dim=-1), \
        X_mt, U_mt


def total_time(prob: Problem, U=None) -> torch.Tensor:
    """(reference total_time, minimum_time.jl:74-82): Σ τ² for a
    minimum-time problem (tf == 0), else dt·(N−1)."""
    U = prob.U if U is None else U
    if prob.tf == 0.0:
        return (U[..., -1] ** 2).sum(-1)
    return torch.as_tensor(prob.dt * (prob.N - 1), dtype=U.dtype,
                           device=U.device)


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
    """(reference solve!, altro_methods.jl:2-53): :func:`altro_solve_batch`
    for the problem's own start and seeds, the leading dimension taken off
    the result.

    The transforms are selected from the problem's data unless the flags
    say otherwise: a finite state seed asks for the infeasible start, and
    ``tf == 0`` for minimum time (reference altro_methods.jl:98-124). With
    the infeasible start: the AL solve of the slack-augmented problem, the
    optional projected-Newton polish, the slacks stripped, and with
    ``resolve_feasible_problem`` the AL re-solve of the original problem
    from the TVLQR projection of that trajectory onto the dynamics
    (``dynamically_feasible_projection``). With minimum time the slacks
    come first and τ second, the feasible stage is the minimum-time problem
    again, seeded with the τ the first stage found, and ``dt_traj`` and
    ``tt`` report τ². ``c_max`` of the result is scored on the original
    constraints. ``host_syncs`` counts the device-to-host reads of the AL
    stages' loop tests; ``seed_held`` whether the initial-rollout guard
    held x0.
    """
    res = altro_solve_batch(prob, opts, prob.x0[None], prob.X[None],
                            prob.U[None], infeasible, minimum_time)
    return res._replace(**{k: getattr(res, k)[0] for k in res._fields
                           if k not in ("host_syncs", "seed_held")})


def altro_solve_batch(prob: Problem, opts: ALTROOptions, x0s, X0s=None,
                      U0s=None, infeasible: Optional[bool] = None,
                      minimum_time: Optional[bool] = None) -> ALTROResult:
    """:func:`altro_solve` for a batch of starts x0s (B, n) of the template
    ``prob``, with state seeds X0s (B, N, n) and control seeds
    U0s (B, N-1, m) (default: the problem's own, from each start): what
    ``vmap(altro_solve)`` is in the JAX package. Every stage runs for the
    whole batch at once (each problem frozen once its own loop is done), and
    every field of the result but ``host_syncs`` and ``seed_held`` has a
    leading problem dimension. The transforms are chosen from the template
    (``prob.X`` finite, ``prob.tf == 0``) unless the flags say otherwise;
    each start's slacks are seeded from its own defects."""
    dtype = prob.U.dtype
    Bz = x0s.shape[0]
    if X0s is None:
        X0s = prob.X.expand((Bz,) + prob.X.shape).clone()
        X0s[:, 0] = x0s
    if U0s is None:
        U0s = prob.U.expand((Bz,) + prob.U.shape)
    if infeasible is None:
        infeasible = bool(torch.isfinite(prob.X).all())
    if minimum_time is None:
        minimum_time = prob.tf == 0.0

    prob_altro, x0a, Xa, Ua = prob, x0s, X0s, U0s
    if infeasible:
        prob_altro = infeasible_problem(prob_altro, opts.R_inf)
        Ua = _slack_seed(prob.model, x0a, Xa, Ua, prob.dt_traj())
    if minimum_time:
        prob_altro = minimum_time_problem(prob_altro, opts.R_minimum_time,
                                          opts.dt_max, opts.dt_min)
        x0a, Xa, Ua = _mintime_seed(x0a, Xa, Ua, prob.dt)

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
    res_al = al_solve_batch(prob_altro, opts_al, x0a, Xa, Ua, None,
                            mu0[None, :], sca, syncs=syncs)
    X_a, U_a = res_al.X, res_al.U
    iterations_total = res_al.iterations_total
    J = res_al.J

    # projected newton polish (altro_methods.jl:30-40)
    if opts.projected_newton:
        pn_opts = opts.opts_pn if opts.opts_pn is not None else PNOptions()
        res_pn = pn_solve_batch(prob_altro, x0a, X_a, U_a, pn_opts)
        X_a, U_a, J = res_pn.X, res_pn.U, res_pn.J

    # ---------------- process results (altro_methods.jl:56-95)
    n, m = prob.model.n, prob.model.m
    X_out = X_a[..., :n].contiguous()
    U_out = U_a[..., :m].contiguous()
    dt_out = U_a[..., -1] ** 2 if minimum_time \
        else prob.dt_traj().expand(Bz, -1)

    if infeasible:
        # strip the slacks, project to feasible, optionally re-solve
        # (infeasible.jl:38-59)
        prob_feas, x0f, Xf, Uf = prob, x0s, X_out, U_out
        if minimum_time:
            prob_feas = minimum_time_problem(prob, opts.R_minimum_time,
                                             opts.dt_max, opts.dt_min)
            # seeded with the τ the first stage found (τ_0 = 0)
            tau = X_a[..., -1:].clone()
            tau[:, 0] = 0.0
            x0f = torch.cat([x0s, x0s.new_zeros(Bz, 1)], dim=-1)
            Xf = torch.cat([X_out, tau], dim=-1)
            Uf = torch.cat([U_out, U_a[..., -1:]], dim=-1)
        if opts.dynamically_feasible_projection:
            # as in the JAX package, the projection seeds the re-solve;
            # without one the stripped trajectory is what comes back (Q3-14;
            # a minimum-time step ignores the dt it is given)
            dtf = prob_feas.dt_traj()
            Xf, Uf = tvlqr_projection(
                prob_feas.model,
                lambda X, U: prob_feas.obj.expansion(X, U, dtf),
                x0f, Xf, Uf, prob_feas.dt, opts.opts_al.opts_uncon)

        if opts.resolve_feasible_problem:
            mu0f, scaf = _penalty_rows(prob_feas.constraints, opts, dtype)
            res2 = al_solve_batch(prob_feas, opts_al, x0f, Xf, Uf, None,
                                  mu0f[None, :], scaf, syncs=syncs)
            iterations_total = iterations_total + res2.iterations_total
            J = res2.J
            X_out = res2.X[..., :n].contiguous()
            U_out = res2.U[..., :m].contiguous()
            if minimum_time:
                dt_out = res2.U[..., -1] ** 2

    # the final violation on the ORIGINAL constraints (reference
    # max_violation(prob) post-solve, problem.jl:242-267: the augmented rows
    # are internal)
    cs = prob.constraints
    c_max = cs.max_violation(cs.evaluate(X_out, U_out))
    return ALTROResult(X=X_out, U=U_out, J=J, c_max=c_max,
                       iterations=res_al.iterations,
                       iterations_total=iterations_total,
                       gradient=res_al.gradient, dt_traj=dt_out,
                       tt=dt_out.sum(-1), host_syncs=syncs.count,
                       seed_held=syncs.held)
