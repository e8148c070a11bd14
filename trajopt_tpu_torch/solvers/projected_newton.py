"""Projected Newton solver (machine-precision feasibility polish).

Counterpart of ``trajopt_tpu/solvers/projected_newton.py`` (reference
src/solvers/direct/projected_newton.jl). The reference assembles a banded
sparse KKT Jacobian Y (dynamics defects + active constraint rows) and
projects the primals by

    δZ = −H⁻¹ Yᵀ (Y H⁻¹ Yᵀ + ρI)⁻¹ y        (H = diagonal cost Hessian)

Here the Schur complement S = Y H⁻¹ Yᵀ is never formed as one matrix: its
exact block-tridiagonal structure (row block k couples only knots k−1, k) is
kept as two stacked block arrays and factorized by a block-tridiagonal
Cholesky recursion over the knots. Active-set changes are row masking:
inactive rows keep a zero Y row and a zero right-hand side, and the +ρI
ridge keeps S well-posed.

Every function takes a leading problem dimension where the JAX package uses
``vmap``: X (B, N, n), U (B, N-1, m). The JAX ``while_loop``s become Python
loops with a per-problem mask that freezes a problem once its own loop
condition is false, so each problem follows the path its own single solve
would. The q×q blocks go to ``torch.linalg.cholesky_ex`` and
``solve_triangular`` (no Pallas kernel lies on this path in the JAX package,
and no hand-written kernel here); a block that is not positive definite
yields NaN factors, as ``jnp.linalg.cholesky`` does, and a line search that
runs out, or meets NaN, returns its entry state. float32 and float64 both
run on the CPU and on a CUDA device: the recursion is 2(N−1) dependent steps
of small launches per solve and is bound by the host.

One deviation from the JAX package: the Jacobi equilibration scale
1/sqrt(diag S) is floored relative to the largest diagonal entry of the
problem (``_equilibration_scale``) instead of at an absolute 1e-30, whose
reciprocal square root overflows float32 products (ROADMAP fault R3). With
the default ridge the floor never binds.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from trajopt_tpu_torch.ops.line_search import HostSyncs, where_rows
from trajopt_tpu_torch.problem import Problem
from trajopt_tpu_torch.utils.tree import precise


@dataclasses.dataclass(frozen=True)
class PNOptions:
    """(reference ProjectedNewtonSolverOptions, direct_solvers.jl:14-30).
    Field for field the JAX package's ``PNOptions``, with the same
    defaults; see there for what each option means."""

    n_steps: int = 2
    solve_type: str = "feasible"  # 'feasible' | 'optimal'
    active_set_tolerance: float = 1e-3
    feasibility_tolerance: float = 1e-6
    ridge: float = 1e-2            # ρ in S + ρI (projected_newton.jl:243)
    refine_iters: int = 25         # iterative refinement (reg_solve, :306-324)
    refine_tol: float = 1e-8
    max_projection_iters: int = 10
    max_refinements: int = 10
    linesearch_iters: int = 10
    # factor diag(s)·S·diag(s) with unit diagonal and unscale the solve;
    # refinement still runs against the unscaled unregularized S
    equilibrate: bool = True


class PNResult(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    J: torch.Tensor
    c_max: torch.Tensor
    viol: torch.Tensor
    iterations: torch.Tensor


# --------------------------------------------- block-tridiagonal Cholesky ops

def _cholesky(A):
    """Lower Cholesky factor of the blocks A (…, q, q); NaN where a block is
    not positive definite (what ``jnp.linalg.cholesky`` returns)."""
    G, info = torch.linalg.cholesky_ex(A)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(G, float("nan")).tril(), G)


def _tri(G, b, upper=False):
    """Solve G x = b (or Gᵀ x = b with ``upper``) for lower-triangular
    blocks G (…, q, q) and right-hand sides b (…, q, r)."""
    if upper:
        return torch.linalg.solve_triangular(G.mT, b, upper=True)
    return torch.linalg.solve_triangular(G, b, upper=False)


def block_tridiag_cholesky(D, L):
    """Cholesky factor of a symmetric positive-definite block-tridiagonal
    matrix given its diagonal blocks D (…, N, q, q) and sub-diagonal blocks
    L (…, N-1, q, q) (block (k+1, k)). Returns (G, M): the diagonal factors
    G (lower) and the off-diagonal factors M, with S = 𝓛 𝓛ᵀ and the block
    rows of 𝓛 being [M_{k-1}, G_k]."""
    G = [_cholesky(D[..., 0, :, :])]
    M = []
    for k in range(L.shape[-3]):
        # M_k = L_k G_{k}^{-T}
        M_k = _tri(G[-1], L[..., k, :, :].mT).mT
        G.append(_cholesky(D[..., k + 1, :, :] - M_k @ M_k.mT))
        M.append(M_k)
    Ms = torch.stack(M, dim=-3) if M else L
    return torch.stack(G, dim=-3), Ms


def block_tridiag_solve(G, M, b):
    """Solve S x = b given the block Cholesky factors. b (…, N, q)."""
    N = G.shape[-3]
    b = b[..., None]
    w = [_tri(G[..., 0, :, :], b[..., 0, :, :])]
    for k in range(1, N):
        w.append(_tri(G[..., k, :, :], b[..., k, :, :]
                      - M[..., k - 1, :, :] @ w[-1]))
    x = [_tri(G[..., N - 1, :, :], w[N - 1], upper=True)]
    for k in range(N - 2, -1, -1):
        x.append(_tri(G[..., k, :, :],
                      w[k] - M[..., k, :, :].mT @ x[-1], upper=True))
    return torch.stack(x[::-1], dim=-3)[..., 0]


def block_tridiag_matvec(D, L, x):
    """y = S x for block-tridiagonal S. x (…, N, q)."""
    y = torch.einsum("...kij,...kj->...ki", D, x)
    lo = torch.einsum("...kij,...kj->...ki", L, x[..., :-1, :])
    up = torch.einsum("...kji,...kj->...ki", L, x[..., 1:, :])
    zero = torch.zeros_like(y[..., :1, :])
    return y + torch.cat([zero, lo], dim=-2) + torch.cat([up, zero], dim=-2)


# ----------------------------------------------------------------- assembly

def _dynamics_defects(prob: Problem, x0, X, U):
    """(…, N, n): [x_0 − x0; f(x_k, u_k) − x_{k+1}] (reference
    dynamics_constraints!, projected_newton.jl:37-45)."""
    f_next = prob.model.step(X[..., :-1, :], U, prob.dt_traj()[:, None])
    return torch.cat([(X[..., 0, :] - x0)[..., None, :],
                      f_next - X[..., 1:, :]], dim=-2)


def _assemble(prob: Problem, X, U, active):
    """The per-knot row-block pieces of Y and the diagonal H⁻¹.

    Row block k (q = n + P rows): [defect rows; constraint rows at knot k].
    Ya_k couples it to variable block k−1 = (x_{k-1}, u_{k-1}), Yb_k to
    variable block k = (x_k, u_k) (u_{N-1} is a phantom). Returns
    Ya, Yb (…, N, q, n + m), hinv (…, N, n + m) and the cost gradient
    g (…, N, n + m)."""
    n, m, N = prob.n, prob.m, prob.N
    cs = prob.constraints
    batch = X.shape[:-2]
    dt_traj = prob.dt_traj()
    new = X.new_zeros

    A, B = prob.model.jacobian_traj(X[..., :-1, :], U, dt_traj)
    cx, cu = cs.jacobian(X, U)                         # (…,N,P,n), (…,N,P,m)
    act = active.to(X.dtype)[..., None]
    cx, cu = cx * act, cu * act

    # Ya[0] = 0; the top rows of Ya[k] are [A_{k-1} B_{k-1}]
    AB = torch.cat([A, B], dim=-1)                     # (…, N-1, n, n+m)
    Ya_top = torch.cat([new(batch + (1, n, n + m)), AB], dim=-3)
    Ya = torch.cat([Ya_top, new(batch + (N, cs.P, n + m))], dim=-2)

    # Yb: defect rows −I on x (+I at k = 0); constraint rows [cx cu]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    sign = torch.cat([X.new_ones(1), -X.new_ones(N - 1)])
    top = torch.cat([(sign[:, None, None] * eye).expand(batch + (N, n, n)),
                     new(batch + (N, n, m))], dim=-1)
    Yb = torch.cat([top, torch.cat([cx, cu], dim=-1)], dim=-2)
    # the phantom u at the terminal knot: zero its columns
    keep = X.new_ones((N, 1, n + m))
    keep[N - 1, :, n:] = 0.0
    Yb = Yb * keep

    # diagonal cost Hessian (reference cost_expansion! → Diagonal(H),
    # projected_newton.jl:122-149, 231)
    e = prob.obj.expansion(X, U, dt_traj)
    hx = torch.diagonal(e.xx, dim1=-2, dim2=-1)        # (…, N, n)
    hu = torch.diagonal(e.uu, dim1=-2, dim2=-1)        # (…, N-1, m)
    pad = new(batch + (1, m))
    hz = torch.cat([hx, torch.cat([hu, pad], dim=-2)], dim=-1)
    hinv = torch.where(hz > 1e-12, 1.0 / hz.clamp(min=1e-12),
                       torch.zeros_like(hz))
    hinv = hinv * keep[:, 0, :]                        # phantom u
    g = torch.cat([e.x, torch.cat([e.u, pad], dim=-2)], dim=-1)
    return Ya, Yb, hinv, g


def _rhs(prob: Problem, x0, X, U, active):
    """y (…, N, q) = [defects; active constraint values]."""
    C = prob.constraints.evaluate(X, U)
    d = _dynamics_defects(prob, x0, X, U)
    return torch.cat([d, torch.where(active, C, torch.zeros_like(C))],
                     dim=-1)


def _schur_blocks(Ya, Yb, hinv, ridge):
    """S = Y H⁻¹ Yᵀ + ρI as block-tridiagonal (D, L)."""
    q = Ya.shape[-2]
    Hb = hinv[..., None, :]                            # (…, N, 1, nm)
    D = torch.einsum("...kin,...kjn->...kij", Yb * Hb, Yb)
    Ya1 = Ya[..., 1:, :, :] * Hb[..., :-1, :, :]
    Da = torch.einsum("...kin,...kjn->...kij", Ya1, Ya[..., 1:, :, :])
    D = D + torch.cat([torch.zeros_like(D[..., :1, :, :]), Da], dim=-3)
    D = D + ridge * torch.eye(q, dtype=Ya.dtype, device=Ya.device)
    # L_k = S_{k+1,k} = Ya_{k+1} H_k⁻¹ Yb_kᵀ
    L = torch.einsum("...kin,...kjn->...kij", Ya1, Yb[..., :-1, :, :])
    return D, L


def _apply_Yt(Ya, Yb, lam):
    """Yᵀ λ (…, N, nm)."""
    dz = torch.einsum("...kqn,...kq->...kn", Yb, lam)
    up = torch.einsum("...kqn,...kq->...kn", Ya[..., 1:, :, :],
                      lam[..., 1:, :])
    return dz + torch.cat([up, torch.zeros_like(dz[..., :1, :])], dim=-2)


def _apply_Y(Ya, Yb, dz):
    """Y δz (…, N, q)."""
    y = torch.einsum("...kqn,...kn->...kq", Yb, dz)
    lo = torch.einsum("...kqn,...kn->...kq", Ya[..., 1:, :, :],
                      dz[..., :-1, :])
    return y + torch.cat([torch.zeros_like(y[..., :1, :]), lo], dim=-2)


def _split_z(dz, n):
    return dz[..., :, :n], dz[..., :-1, n:]


def _equilibration_scale(D):
    """s (…, N, q) = 1/sqrt(diag D), the diagonal floored at ε·max(diag) of
    the problem (ε the dtype's machine epsilon), so that the products
    s·D·s stay finite in float32 whatever the smallest entry is."""
    dg = torch.diagonal(D, dim1=-2, dim2=-1)
    info = torch.finfo(D.dtype)
    floor = (info.eps * dg.flatten(-2).amax(-1)).clamp(min=info.tiny)
    return torch.rsqrt(torch.maximum(dg, floor[..., None, None]))


class _Ctx(NamedTuple):
    """What the projection closes over: the problem, the per-problem start
    states and the options."""

    prob: Problem
    x0: torch.Tensor
    opts: PNOptions
    syncs: HostSyncs


def _active_set(ctx: _Ctx, X, U):
    cs = ctx.prob.constraints
    C = cs.evaluate(X, U)
    # a = eq | (c >= -tol) (projected_newton.jl:87-93; note the -tol)
    return (cs.is_eq | (C >= -ctx.opts.active_set_tolerance)) & cs.mask


def _full_viol(ctx: _Ctx, X, U):
    """The feasibility measure the projection is scored on: dynamics defects
    and the violation of every constraint row, not only the frozen active
    set (in float32 a poor Newton direction can shrink the active rows while
    pushing inactive inequalities positive)."""
    cs = ctx.prob.constraints
    d = _dynamics_defects(ctx.prob, ctx.x0, X, U)
    return torch.maximum(d.abs().flatten(-2).amax(-1),
                         cs.max_violation(cs.evaluate(X, U)))


def _projection_iteration(ctx: _Ctx, X, U, go):
    """One projection iteration for the problems ``go`` (B,) bool: freeze
    the active set, factor S, one line search, then further line searches
    on the same factors while they converge fast (projected_newton.jl:
    244-259). Returns (X, U, viol) for every problem; those outside ``go``
    come back unspecified."""
    prob, opts, syncs = ctx.prob, ctx.opts, ctx.syncs
    n = prob.n
    dtype = X.dtype
    act = _active_set(ctx, X, U)
    Ya, Yb, hinv, _ = _assemble(prob, X, U, act)
    D, L = _schur_blocks(Ya, Yb, hinv, opts.ridge)
    if opts.equilibrate:
        s = _equilibration_scale(D)
        G, M = block_tridiag_cholesky(
            D * s[..., :, None] * s[..., None, :],
            L * s[..., 1:, :, None] * s[..., :-1, None, :])
    else:
        s = None
        G, M = block_tridiag_cholesky(D, L)
    D0 = D - opts.ridge * torch.eye(D.shape[-1], dtype=dtype, device=D.device)

    def scaled_solve(b):
        if s is None:
            return block_tridiag_solve(G, M, b)
        return s * block_tridiag_solve(G, M, s * b)

    def refine_solve(y):
        """δλ = reg_solve(S, y): Cholesky of S + ρI and iterative refinement
        against the unregularized S (projected_newton.jl:306-324)."""
        lam = scaled_solve(y)
        for _ in range(opts.refine_iters):
            lam = lam + scaled_solve(y - block_tridiag_matvec(D0, L, lam))
        return lam

    def linesearch(X_c, U_c, on):
        """Backtracking on the full violation from (X_c, U_c) for the
        problems ``on``. Returns (X, U, viol, viol0); a search that runs out
        (or meets NaN) hands back its entry state."""
        y = _rhs(prob, ctx.x0, X_c, U_c, act)
        viol0 = _full_viol(ctx, X_c, U_c)
        # the Newton direction does not depend on the trial step
        dz = -hinv * _apply_Yt(Ya, Yb, refine_solve(y))
        dX, dU = _split_z(dz, n)
        Xn, Un = X_c, U_c
        violn = torch.full_like(viol0, float("inf"))
        alpha, cnt = 1.0, 1
        searching = on
        while cnt <= opts.linesearch_iters and syncs.any(searching):
            X_t, U_t = X_c + alpha * dX, U_c + alpha * dU
            viol_t = _full_viol(ctx, X_t, U_t)
            Xn = where_rows(searching, X_t, Xn)
            Un = where_rows(searching, U_t, Un)
            violn = torch.where(searching, viol_t, violn)
            alpha, cnt = alpha * 0.5, cnt + 1
            searching = searching & (violn >= viol0)
        ok = violn < viol0
        return (where_rows(ok, Xn, X_c), where_rows(ok, Un, U_c),
                torch.where(ok, violn, viol0), viol0)

    def fast(viol_c, viol_prev):
        rate = torch.log10(viol_c.clamp(min=1e-300)) \
            / torch.log10(viol_prev.clamp(min=1e-300))
        return (rate >= 1.1) & (viol_c > opts.feasibility_tolerance)

    Xn, Un, violn, v0 = linesearch(X, U, go)
    viol_prev = v0.clamp(min=1e-300)
    keep = go & fast(violn, viol_prev)
    cnt = 1
    while cnt < opts.max_refinements and syncs.any(keep):
        X2, U2, viol2, _ = linesearch(Xn, Un, keep)
        viol_prev = torch.where(keep, violn, viol_prev)
        Xn, Un = where_rows(keep, X2, Xn), where_rows(keep, U2, Un)
        violn = torch.where(keep, viol2, violn)
        cnt += 1
        keep = keep & fast(violn, viol_prev)
    return Xn, Un, violn


def _project(ctx: _Ctx, X, U, on=None):
    """Projection iterations until each problem is feasible to
    ``feasibility_tolerance`` or has used ``max_projection_iters``. Returns
    (X, U, iterations, viol); problems outside ``on`` are left alone."""
    opts = ctx.opts
    viol = _full_viol(ctx, X, U)
    it = torch.zeros(X.shape[0], dtype=torch.int32, device=X.device)
    on = torch.ones_like(it, dtype=torch.bool) if on is None else on

    def running():
        return (viol > opts.feasibility_tolerance) \
            & (it < opts.max_projection_iters) & on

    go = running()
    while ctx.syncs.any(go):
        Xn, Un, violn = _projection_iteration(ctx, X, U, go)
        X, U = where_rows(go, Xn, X), where_rows(go, Un, U)
        viol = torch.where(go, violn, viol)
        it = it + go.to(it.dtype)
        go = running()
    return X, U, it, viol


def _kkt_newton_step(ctx: _Ctx, X, U):
    """One primal-dual KKT step (reference multiplier_projection! +
    solveKKT_Shur + line_search, projected_newton.jl:407-547):

        λ*  = argmin ‖g + Yᵀλ‖        (dual least squares via Y Yᵀ)
        δλ  = S⁻¹ (y − Y H⁻¹ r),  r = g + Yᵀλ*
        δz  = −H⁻¹ (r + Yᵀ δλ)
        line search on α with re-projection to feasibility.
    """
    prob, opts = ctx.prob, ctx.opts
    n, N = prob.n, prob.N

    act = _active_set(ctx, X, U)
    Ya, Yb, hinv, g = _assemble(prob, X, U, act)
    y = _rhs(prob, ctx.x0, X, U, act)

    # multiplier projection: solve (Y Yᵀ + ρI) λ = −Y g
    ones_h = torch.ones_like(hinv)
    ones_h[..., N - 1, n:] = 0.0
    G_I, M_I = block_tridiag_cholesky(*_schur_blocks(Ya, Yb, ones_h,
                                                     opts.ridge))
    lam = -block_tridiag_solve(G_I, M_I, _apply_Y(Ya, Yb, g))

    # KKT Schur step with the diagonal cost metric
    G, M = block_tridiag_cholesky(*_schur_blocks(Ya, Yb, hinv, opts.ridge))
    r = g + _apply_Yt(Ya, Yb, lam)
    dlam = block_tridiag_solve(G, M, y - _apply_Y(Ya, Yb, hinv * r))
    dz = -hinv * (r + _apply_Yt(Ya, Yb, dlam))
    dX, dU = _split_z(dz, n)

    def residual_norm(Xc, Uc, lamc):
        actc = _active_set(ctx, Xc, Uc)
        Ya2, Yb2, _, g2 = _assemble(prob, Xc, Uc, actc)
        y2 = _rhs(prob, ctx.x0, Xc, Uc, actc)
        res = g2 + _apply_Yt(Ya2, Yb2, lamc)
        return torch.sqrt((res ** 2).flatten(-2).sum(-1)
                          + (y2 ** 2).flatten(-2).sum(-1))

    res0 = residual_norm(X, U, lam)
    alpha, cnt = 1.0, 0
    bestX, bestU = X, U
    searching = torch.ones_like(res0, dtype=torch.bool)
    while cnt < 10 and ctx.syncs.any(searching):
        # re-project to feasibility (reference line_search calls projection!)
        Xt, Ut, _, _ = _project(ctx, X + alpha * dX, U + alpha * dU,
                                on=searching)
        ok = searching & (residual_norm(Xt, Ut, lam + alpha * dlam) < res0)
        bestX, bestU = where_rows(ok, Xt, bestX), where_rows(ok, Ut, bestU)
        searching = searching & ~ok
        alpha, cnt = alpha * 0.5, cnt + 1

    actn = _active_set(ctx, bestX, bestU)
    violn = _rhs(prob, ctx.x0, bestX, bestU, actn).abs().flatten(-2).amax(-1)
    return bestX, bestU, violn


@precise
def pn_solve_batch(prob: Problem, x0s, Xs, Us, opts: PNOptions = PNOptions(),
                   syncs: HostSyncs | None = None) -> PNResult:
    """:func:`pn_solve` for a batch of trajectories of the template
    ``prob``: starts x0s (B, n), Xs (B, N, n), Us (B, N-1, m). What
    ``vmap(pn_solve)`` is in the JAX package; every field of the result has
    a leading problem dimension. ``syncs`` counts the device-to-host reads
    of the loop tests."""
    if opts.solve_type not in ("feasible", "optimal"):
        raise ValueError(f"solve_type={opts.solve_type!r}")
    ctx = _Ctx(prob, x0s, opts, HostSyncs() if syncs is None else syncs)
    X, U, it, viol = _project(ctx, Xs, Us)
    if opts.solve_type == "optimal":
        # full KKT Newton steps on top of the feasibility projection
        # (reference newton_step!, projected_newton.jl:501-547)
        for _ in range(opts.n_steps):
            X, U, viol = _kkt_newton_step(ctx, X, U)
            it = it + 1
    cs = prob.constraints
    return PNResult(X=X, U=U, J=prob.obj.total(X, U, prob.dt_traj()),
                    c_max=cs.max_violation(cs.evaluate(X, U)), viol=viol,
                    iterations=it)


def pn_solve(prob: Problem, opts: PNOptions = PNOptions()) -> PNResult:
    """Feasibility projection solve of one problem from its (X, U)
    (reference solve! + projection_solve!, projected_newton.jl:6-20,
    200-264): a batch of one through :func:`pn_solve_batch`.
    ``solve_type='feasible'`` is the mode ALTRO uses for its polish."""
    res = pn_solve_batch(prob, prob.x0[None], prob.X[None], prob.U[None],
                         opts)
    return PNResult(*(v[0] for v in res))


# ------------------------------------------------------------ flat primals
# (reference Primals pack/unpack, src/solvers/direct/primals.jl:23-142)

def pack_primals(X, U):
    """Interleave into the flat decision vector Z = [x0;u0;x1;u1;…;xN]."""
    return torch.cat([torch.cat([X[:-1], U], dim=1).reshape(-1), X[-1]])


def unpack_primals(Z, n, m, N):
    """Inverse of :func:`pack_primals`."""
    body = Z[: (N - 1) * (n + m)].reshape(N - 1, n + m)
    X = torch.cat([body[:, :n], Z[-n:][None]], dim=0)
    return X, body[:, n:]
