"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a GPU and
skips without one, so on a CPU-only machine the file collects and skips.
On a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Small shapes (B=16, N=21 for K1, K2, K5, K7a and K7b; B=16 on the N=101 maze
stack and on each other model's own stack for K3 and K4) in float32, at the f32 tolerances of tests/test_pallas.py
and of chip_smoke.py, which repeats the comparisons at the main paths'
shapes.
"""
import numpy as np
import pytest
import torch

from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.models.base import Model, discretize
from trajopt_tpu_torch.models.quaternions import project_error_state
from trajopt_tpu_torch.ops.canonical import (
    canon_al_cost, canonical_stack, pad_terminal,
)
from trajopt_tpu_torch.ops.cost import Expansion, cost_expansion, total_cost
from trajopt_tpu_torch.ops.cuda_al_fused import (
    fused_al_backward, fused_al_backward_cuda, fused_al_forward,
    fused_al_forward_cuda,
)
from trajopt_tpu_torch.ops.cuda_fused import (
    fused_backward, fused_backward_cuda, fused_forward, fused_forward_cuda,
)
from trajopt_tpu_torch.ops.cuda_riccati import riccati_sweep_cuda
from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
from trajopt_tpu_torch.ops.cuda_sqrt import (
    equilibrated_chol_upper, plain_chol_upper, sqrt_sweep, sqrt_sweep_cuda,
)
from trajopt_tpu_torch.ops.riccati import scan_sweep
from trajopt_tpu_torch.ops.rollout import rollout, rollout_closed_loop
from trajopt_tpu_torch.problems import zoo as problems
from trajopt_tpu_torch.problems.zoo import quadrotor_line, quadrotor_maze
from trajopt_tpu_torch.solvers.altro import infeasible_problem

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

B, N = 16, 21


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def linearization(cuda_device):
    prob = quadrotor_line(N=N, dtype=torch.float64, device=cuda_device,
                          distance=20.0)
    rng = np.random.default_rng(3)
    x0s = torch.as_tensor(prob.x0.cpu().numpy()[None]
                          + rng.normal(size=(B, 13)) * 0.02,
                          device=cuda_device)
    U = prob.U.expand(B, -1, -1)
    dt = prob.dt_traj()
    X = rollout(prob.model, x0s, U, dt)
    A, Bm = prob.model.jacobian_traj(X[:, :-1], U, dt)
    A, Bm, e = project_error_state(X, A, Bm, cost_expansion(prob.obj, X, U,
                                                             dt), (3, 7))
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    return (f32(A), f32(Bm), Expansion(*(f32(getattr(e, k)) for k in
                                         ("x", "u", "xx", "uu", "ux"))),
            f32(X), f32(U), prob.dt)


@pytest.mark.parametrize("rho_val", [0.0, 1e-2])
def test_sqrt_kernel_matches_twin(linearization, rho_val):
    A, Bm, e, _, _, _ = linearization
    rho = torch.full((B,), rho_val, device=A.device)
    before = sqrt_sweep_cuda.launches
    K1, d1, v11, v21, f1 = sqrt_sweep_cuda(A, Bm, e.x, e.u, e.xx, e.uu, e.ux,
                                           rho)
    torch.cuda.synchronize()
    assert sqrt_sweep_cuda.launches == before + 1
    K0, d0, v10, v20, f0 = sqrt_sweep(A, Bm, e, rho)
    assert torch.equal(f1, f0)
    assert (K1 - K0).abs().max() < 2e-3 * K0.abs().max()
    assert (d1 - d0).abs().max() < 1e-1 * (d0.abs().max() + 1e-12)
    torch.testing.assert_close(v11, v10, rtol=3e-2, atol=1e-5)
    torch.testing.assert_close(v21, v20, rtol=3e-2, atol=1e-5)


def _make_indefinite(luu, lane, knot, off):
    """Replace one stage's control Hessian by c·[[1, off], [off, 1]] ⊕ c·I
    (tests/test_torch_sqrt.py): indefinite for off > 1."""
    c = luu[lane, knot, 0, 0]
    M = c * torch.eye(4, dtype=luu.dtype, device=luu.device)
    M[0, 1] = M[1, 0] = c * off
    luu[lane, knot] = M


def test_sqrt_kernel_branches_match_twin(linearization):
    """At rho = 0, lane 5 has a mildly indefinite stage: the plain float32
    factor breaks down and the equilibrated one succeeds on its pivot
    floor. Lane 9 has a strongly indefinite stage: both factors break down,
    the lane fails and its gains at that stage are zero."""
    A, Bm, e, _, _, _ = linearization
    luu = e.uu.clone()
    _make_indefinite(luu, 5, 7, 1.0 + 2e-4)
    _make_indefinite(luu, 9, 12, 1.5)
    joint = torch.cat([torch.cat([luu[5, 7], e.ux[5, 7]], -1),
                       torch.cat([e.ux[5, 7].T, e.xx[5, 7]], -1)], -2)
    assert bool(plain_chol_upper(joint)[1])
    assert not bool(equilibrated_chol_upper(joint)[1])
    rho = torch.zeros(B, device=A.device)
    K1, d1, v11, v21, f1 = sqrt_sweep_cuda(A, Bm, e.x, e.u, e.xx, luu, e.ux,
                                           rho)
    torch.cuda.synchronize()
    e_indef = Expansion(x=e.x, u=e.u, xx=e.xx, uu=luu, ux=e.ux)
    K0, d0, v10, v20, f0 = sqrt_sweep(A, Bm, e_indef, rho)
    assert f1.nonzero().flatten().tolist() == [9]
    assert torch.equal(f1, f0)
    assert not bool(K1[9, 12].any()) and not bool(d1[9, 12].any())
    assert (K1 - K0).abs().max() < 2e-3 * K0.abs().max()
    assert (d1 - d0).abs().max() < 1e-1 * (d0.abs().max() + 1e-12)
    torch.testing.assert_close(v11, v10, rtol=3e-2, atol=1e-5)
    torch.testing.assert_close(v21, v20, rtol=3e-2, atol=1e-5)


def test_rollout_kernel_matches_twin(linearization):
    A, Bm, e, X, U, dt = linearization
    K, d, _, _, _ = sqrt_sweep_cuda(A, Bm, e.x, e.u, e.xx, e.uu, e.ux,
                                    torch.zeros(B, device=A.device))
    d = d.clone()
    d[5] *= 1e9
    alpha = torch.full((B,), 0.5, device=A.device)
    model = discretize(zoo.quadrotor, "rk3")
    x0 = X[:, 0].contiguous()
    Xk, Uk, okk = rollout_closed_loop_cuda(model, x0, X, U, K, d, alpha, dt,
                                           quat_slice=(3, 7))
    torch.cuda.synchronize()
    Xt, Ut, okt = rollout_closed_loop(model, x0, X, U, K, d, alpha, dt,
                                      quat_slice=(3, 7))
    assert torch.equal(okk, okt) and not bool(okk[5])
    torch.testing.assert_close(Xk[okk], Xt[okt], rtol=0, atol=1e-4)
    torch.testing.assert_close(Uk[okk], Ut[okt], rtol=0, atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    z = lambda *s, dt=torch.float64: torch.zeros(  # noqa: E731
        s, dtype=dt, device=cuda_device)
    with pytest.raises(ValueError):
        sqrt_sweep_cuda(z(2, 3, 12, 12), z(2, 3, 12, 4), z(2, 4, 12),
                        z(2, 3, 4), z(2, 4, 12, 12), z(2, 3, 4, 4),
                        z(2, 3, 4, 12), z(2))
    quad = discretize(zoo.quadrotor, "rk3")
    with pytest.raises(ValueError):
        rollout_closed_loop_cuda(quad, z(2, 13), z(2, 4, 13), z(2, 3, 4),
                                 z(2, 3, 4, 12), z(2, 3, 4), z(2), 0.05,
                                 quat_slice=(3, 7))
    f = torch.float32
    # the full-state rollout (ns = 13) runs: level, with zero gains and zero
    # thrust, the quadrotor falls freely and stays alive
    hover = z(2, 4, 13, dt=f)
    hover[..., 3] = 1.0
    Xn, Un, ok = rollout_closed_loop_cuda(
        quad, hover[:, 0].contiguous(), hover, z(2, 3, 4, dt=f),
        z(2, 3, 4, 13, dt=f), z(2, 3, 4, dt=f), z(2, dt=f), 0.05,
        quat_slice=None)
    assert Xn.shape == (2, 4, 13) and bool(ok.all())
    with pytest.raises(ValueError):     # gains of the error state's width
        rollout_closed_loop_cuda(quad, z(2, 13, dt=f), z(2, 4, 13, dt=f),
                                 z(2, 3, 4, dt=f), z(2, 3, 4, 12, dt=f),
                                 z(2, 3, 4, dt=f), z(2, dt=f), 0.05,
                                 quat_slice=None)
    with pytest.raises(NotImplementedError):    # a per-interval dt
        rollout_closed_loop_cuda(quad, z(2, 13, dt=f), z(2, 4, 13, dt=f),
                                 z(2, 3, 4, dt=f), z(2, 3, 4, 13, dt=f),
                                 z(2, 3, 4, dt=f), z(2, dt=f), z(3, dt=f),
                                 quat_slice=None)
    other = discretize(Model(zoo.quadrotor_dynamics, 13, 4, name="custom"),
                       "rk3")
    with pytest.raises(NotImplementedError):
        rollout_closed_loop_cuda(other, z(2, 13, dt=f), z(2, 4, 13, dt=f),
                                 z(2, 3, 4, dt=f), z(2, 3, 4, 12, dt=f),
                                 z(2, 3, 4, dt=f), z(2, dt=f), 0.05,
                                 quat_slice=(3, 7))


# ------------------------------------------------------------ K3 and K4

LS_OPTS = (1e-8, 10.0, 20, 1e-8, 1.6, 10.0)   # iLQROptions' defaults


@pytest.fixture(scope="module")
def maze(cuda_device):
    """The infeasible-start maze stack (N = 101, P = 89) with a batch of
    inputs around the transform's seed and exercised duals."""
    prob = infeasible_problem(
        quadrotor_maze(dtype=torch.float32, device=cuda_device), 1e-8)
    canon = canonical_stack(prob.constraints, 13, 17, dtype=torch.float32)
    rng = np.random.default_rng(5)
    Nm, P = prob.N, prob.constraints.P

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda_device)

    mask = prob.constraints.mask
    return dict(
        prob=prob, canon=canon,
        X=(prob.X[None] + t(rng.normal(size=(B, Nm, 13)) * .05)).contiguous(),
        U=(prob.U[None]
           + t(rng.normal(size=(B, Nm - 1, 17)) * .02)).contiguous(),
        lam=(t(rng.uniform(0.0, 0.5, size=(B, Nm, P))) * mask).contiguous(),
        mu=(t(rng.uniform(0.5, 20.0, size=(B, Nm, P))) * mask).contiguous())


def _backward(maze, fn, mu=None, **kw):
    p = maze["prob"]
    return fn(p.model, maze["canon"], maze["X"], maze["U"], maze["lam"],
              maze["mu"] if mu is None else mu, p.dt_traj(), p.obj,
              torch.ones(B, device=maze["X"].device), **kw)


def test_fused_al_backward_kernel_matches_plain_version(maze):
    """Benign duals, rho = 1: fail flags equal (none), K at 1e-2 and d at
    1e-1 of scale (the float32 plain version is itself ~2e-3 and ~1e-2 from
    float64 on this stack), dV at 1e-3, in-kernel Jacobians at 1e-5."""
    before = fused_al_backward_cuda.launches
    k = _backward(maze, fused_al_backward_cuda, return_jacobians=True)
    torch.cuda.synchronize()
    assert fused_al_backward_cuda.launches == before + 1
    p = _backward(maze, fused_al_backward, return_jacobians=True)
    assert torch.equal(k[4], p[4]) and not bool(k[4].any())
    assert (k[0] - p[0]).abs().max() < 1e-2 * p[0].abs().max()
    assert (k[1] - p[1]).abs().max() < 1e-1 * p[1].abs().max()
    torch.testing.assert_close(k[2], p[2], rtol=1e-3, atol=0)
    torch.testing.assert_close(k[3], p[3], rtol=1e-3, atol=0)
    torch.testing.assert_close(k[5], p[5], rtol=0, atol=1e-5)
    torch.testing.assert_close(k[6], p[6], rtol=0, atol=1e-5)


def test_fused_al_backward_kernel_fail_branch(maze):
    """Negative penalties on problem 7's slack rows at knot 40 make its
    Quu indefinite: kernel and plain version fail exactly that problem, and
    the kernel's gains at the failed stage are zero."""
    mu = maze["mu"].clone()
    r0, r1 = maze["prob"].constraints.row_slice("infeasible")
    mu[7, 40, r0:r1] = -1e3
    k = _backward(maze, fused_al_backward_cuda, mu=mu)
    torch.cuda.synchronize()
    p = _backward(maze, fused_al_backward, mu=mu)
    assert k[4].nonzero().flatten().tolist() == [7]
    assert torch.equal(k[4], p[4])
    assert not bool(k[0][7, 40].any()) and not bool(k[1][7, 40].any())
    live = ~k[4]
    assert (k[0] - p[0])[live].abs().max() < 1e-2 * p[0][live].abs().max()


def test_fused_al_forward_kernel_matches_plain_version(maze):
    """Searches started at alpha0 = 2^-6..2^-9 (tame candidates), problem 5
    with a blown-up feedforward (its first candidates diverge) and problem
    11 with a cost no candidate can beat (its search runs out: restore and
    rho bump): steps equal, J at 1e-3, X and U at 1e-4 of scale."""
    p = maze["prob"]
    dev = maze["X"].device
    K, d, dV1, dV2, fail = _backward(maze, fused_al_backward_cuda)
    assert not bool(fail.any())
    X, U, lam, mu = (maze[k] for k in ("X", "U", "lam", "mu"))
    dt = p.dt_traj()
    J_prev = (total_cost(p.obj, X, U, dt)
              + canon_al_cost(maze["canon"], X, pad_terminal(U), lam,
                              mu)).contiguous()
    d = d.clone()
    d[5] *= 1e6
    J_prev[11] = -1e30
    alpha0 = (0.5 ** (6 + torch.arange(B, device=dev) % 4)).float()
    ones = torch.ones(B, device=dev)
    args = (p.model, maze["canon"], X[:, 0].contiguous(), X, U, K, d, dV1,
            dV2, J_prev, ones, ones, alpha0, lam, mu, dt, p.obj, LS_OPTS)
    before = fused_al_forward_cuda.launches
    Xk, Uk, Jk, rk, drk, ak = fused_al_forward_cuda(*args)
    torch.cuda.synchronize()
    assert fused_al_forward_cuda.launches == before + 1
    Xp, Up, Jp, rp, drp, ap = fused_al_forward(*args)
    assert torch.equal(ak, ap) and torch.equal(rk, rp)
    assert torch.equal(drk, drp)
    assert float(ak[11]) == 0.0 and float(rk[11]) > 10.0
    assert torch.equal(Xk[11], X[11]) and torch.equal(Uk[11], U[11])
    assert float(Jk[11]) == float(J_prev[11])
    calm = torch.ones(B, dtype=torch.bool, device=dev)
    calm[5] = False
    torch.testing.assert_close(Jk[calm], Jp[calm], rtol=1e-3, atol=1e-3)
    assert (Xk - Xp)[calm].abs().max() < 1e-4 * Xp.abs().max()
    assert (Uk - Up)[calm].abs().max() < 1e-4 * max(
        1.0, float(Up[calm].abs().max()))


def test_constrained_solve_outside_the_fused_path_raises_on_the_card(maze):
    """With fused_al off a constrained maze solve on a CUDA tensor no longer
    raises: it runs phase-split on K5 (13, 17) and K2's slack instantiation,
    and is held to the fused solve's outcome on 2 problems: c_max < 1e-3 on
    both. What still has no kernel raises (a model without a CUDA step)."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.parallel.batch import (
        solve_batch_queued, solve_batch_queued_altro)

    base = quadrotor_maze(dtype=torch.float32, device=maze["X"].device)
    rng = np.random.default_rng(0)
    x0s = (base.x0[None] + torch.as_tensor(
        np.concatenate([rng.normal(size=(2, 3)) * 0.05, np.zeros((2, 10))],
                       axis=1), dtype=torch.float32,
        device=base.device)).contiguous()
    out = {}
    for fused_al in (True, False):
        opts = tt.ALTROOptions(R_inf=1e-8, opts_al=tt.ALOptions(
            iterations=40, opts_uncon=tt.iLQROptions(iterations=10,
                                                     fused_al=fused_al),
            cost_tolerance=1e-5, cost_tolerance_intermediate=1e-3,
            penalty_scaling=25.0))
        k5, k2 = riccati_sweep_cuda.launches, rollout_closed_loop_cuda.launches
        k3 = fused_al_backward_cuda.launches
        out[fused_al] = solve_batch_queued_altro(base, opts, x0s, lanes=2,
                                                 infeasible=True)
        ran_split = (riccati_sweep_cuda.launches > k5
                     and rollout_closed_loop_cuda.launches > k2)
        assert ran_split == (not fused_al)
        assert (fused_al_backward_cuda.launches > k3) == fused_al
    assert riccati_sweep_cuda.launches_by["13x17"] > 0
    assert rollout_closed_loop_cuda.launches_by["quadrotor_slack"] > 0
    assert bool((out[True].c_max < 1e-3).all())
    assert bool((out[False].c_max < 1e-3).all())

    other = tt.update_problem(maze["prob"], model=discretize(
        Model(zoo.quadrotor_dynamics, 13, 17, name="custom"), "rk3"))
    with pytest.raises(NotImplementedError, match="K6"):
        solve_batch_queued(other, tt.ALOptions(), maze["X"][:2, 0].contiguous(),
                           lanes=2)


def test_fused_al_wrappers_refuse_what_the_kernels_do_not_take(maze):
    p = maze["prob"]
    f64 = lambda t: t.double()  # noqa: E731
    with pytest.raises(ValueError):
        fused_al_backward_cuda(
            p.model, maze["canon"], f64(maze["X"]), f64(maze["U"]),
            f64(maze["lam"]), f64(maze["mu"]), p.dt_traj(), p.obj,
            torch.ones(B, dtype=torch.float64, device=maze["X"].device))
    # the plain quadrotor has its own instantiation, but this stack is
    # compiled for the slack-augmented widths
    base = quadrotor_maze(dtype=torch.float32, device=maze["X"].device)
    with pytest.raises(ValueError, match="canonical stack"):
        _backward(dict(maze, prob=base), fused_al_backward_cuda)
    other = discretize(Model(zoo.quadrotor_dynamics, 13, 17, name="custom"),
                       "rk3")
    with pytest.raises(NotImplementedError, match="K6"):
        fused_al_backward_cuda(
            other, maze["canon"], maze["X"], maze["U"], maze["lam"],
            maze["mu"], p.dt_traj(), p.obj,
            torch.ones(B, device=maze["X"].device))


# ------------------------------- K3 and K4 for the other instantiations

def _line_seeded(prob):
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.utils.interp import interp_rows

    ends = np.stack([prob.x0.cpu().numpy(), prob.xf.cpu().numpy()], axis=1)
    return tt.initial_states(prob, interp_rows(prob.N, prob.tf, ends))


def _al_setup(name, slack, device):
    """Inputs of K3 and K4 for one (model, slack) pair at B = 16 on the
    problem's own stack: ``car_escape`` (P = 177, 180 with slacks),
    ``cartpole``, ``pendulum`` (with slacks from a line seed) or the maze
    without the transform; float64 and float32 copies."""
    factory = dict(car=problems.car_escape, cartpole=problems.cartpole,
                   pendulum=problems.pendulum, quadrotor=quadrotor_maze)[name]
    out = {}
    rng = np.random.default_rng(9)
    for dtype in (torch.float64, torch.float32):
        prob = factory(dtype=dtype, device=device)
        if slack:
            if not bool(torch.isfinite(prob.X).all()):
                prob = _line_seeded(prob)
            prob = infeasible_problem(prob, 1e-1 if name == "car" else 1.0)
        out[dtype] = prob
    p64 = out[torch.float64]
    n, m, Nk, P = p64.n, p64.m, p64.N, p64.constraints.P

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    U = p64.U[None] + t(rng.normal(size=(B, Nk - 1, m)) * 0.02)
    if slack:
        X = p64.X[None] + t(rng.normal(size=(B, Nk, n)) * 0.05)
    else:
        if name == "quadrotor":
            U = p64.U.expand(B, -1, -1)
        X = rollout(p64.model, p64.x0[None]
                    + t(rng.normal(size=(B, n)) * 0.02), U, p64.dt_traj())
    mask = p64.constraints.mask
    # the plain quadrotor gets a thousandth of the duals: 44 active cylinder
    # rows tens of metres away at μ ~ 10 make gains whose float32 rollouts
    # are chaotic in kernel and plain version alike
    scale = 1e-3 if name == "quadrotor" else 1.0
    lam = t(rng.uniform(0.0, 0.5, size=(B, Nk, P)) * scale) * mask
    mu = t(rng.uniform(0.5, 20.0, size=(B, Nk, P)) * scale) * mask
    data64 = [a.contiguous() for a in (X, U, lam, mu)]
    return dict(
        p64=p64, p32=out[torch.float32], data64=data64,
        data=[a.float().contiguous() for a in data64],
        canon64=canonical_stack(p64.constraints, n, m, dtype=torch.float64),
        canon=canonical_stack(out[torch.float32].constraints, n, m,
                              dtype=torch.float32))


AL_CASES = [("car", True), ("car", False), ("cartpole", True),
            ("pendulum", False), ("quadrotor", False)]


@pytest.mark.parametrize("name,slack", AL_CASES)
def test_fused_al_kernels_match_plain_versions_for_every_model(
        cuda_device, name, slack):
    """K3 and K4 of one instantiation against their plain versions, B = 16,
    float32, benign duals, rho = 1: no failure, K and d at 2e-3 of scale
    (tests/test_fused_al.py:261-267) or three times the float32 plain
    version's own distance from float64, dV at 1e-3, Jacobians at 1e-5 with
    the identity slack columns; then the line search on those gains, lane 5
    with a blown-up feedforward and lane 11 running out: steps, rho and drho
    equal, J at 1e-3, X at 1e-4 of scale (or three times the float32 plain
    version's distance from float64). The launch counts move under the
    instantiation's label."""
    st = _al_setup(name, slack, cuda_device)
    p32, p64, canon = st["p32"], st["p64"], st["canon"]
    X, U, lam, mu = st["data"]
    label = name + ("_slack" if slack else "")
    n, m = p32.n, p32.m
    ones = torch.ones(B, device=cuda_device)
    dt = p32.dt_traj()
    before = fused_al_backward_cuda.launches_by[label]
    k = fused_al_backward_cuda(p32.model, canon, X, U, lam, mu, dt, p32.obj,
                               ones, return_jacobians=True)
    torch.cuda.synchronize()
    assert fused_al_backward_cuda.launches_by[label] == before + 1
    p = fused_al_backward(p32.model, canon, X, U, lam, mu, dt, p32.obj, ones,
                          return_jacobians=True)
    X64, U64, lam64, mu64 = st["data64"]
    q = fused_al_backward(p64.model, st["canon64"], X64, U64, lam64, mu64,
                          p64.dt_traj(), p64.obj, ones.double())
    assert k[0].shape == (B, p32.N - 1, m, n)
    assert torch.equal(k[4], p[4]) and not bool(k[4].any())
    for i in (0, 1):
        _close(k[i], p[i], q[i], 2e-3)
    torch.testing.assert_close(k[2], p[2], rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(k[5], p[5], rtol=0, atol=1e-5)
    torch.testing.assert_close(k[6], p[6], rtol=0, atol=1e-5)
    assert k[6].shape[-1] == m

    K, d, dV1, dV2 = k[0], k[1].clone(), k[2], k[3]
    quad = name == "quadrotor"
    d[5] *= 1e6 if quad else 1e5
    J_prev = (total_cost(p32.obj, X, U, dt) + canon_al_cost(
        canon, X, pad_terminal(U), lam, mu)).contiguous()
    J_prev[11] = -1e30
    alpha0 = (0.5 ** (6 + torch.arange(B, device=cuda_device) % 4)).float() \
        if quad else ones
    args = (p32.model, canon, X[:, 0].contiguous(), X, U, K, d, dV1, dV2,
            J_prev, ones, ones, alpha0, lam, mu, dt, p32.obj, LS_OPTS)
    before = fused_al_forward_cuda.launches_by[label]
    Xk, Uk, Jk, rk, drk, ak = fused_al_forward_cuda(*args)
    torch.cuda.synchronize()
    assert fused_al_forward_cuda.launches_by[label] == before + 1
    Xp, Up, Jp, rp, drp, ap = fused_al_forward(*args)
    same = ak == ap
    assert float(same.float().mean()) >= 0.9
    assert torch.equal(rk[same], rp[same])
    assert torch.equal(drk[same], drp[same])
    assert float(ak[11]) == 0.0 and float(rk[11]) > 10.0
    assert torch.equal(Xk[11], X[11]) and torch.equal(Uk[11], U[11])
    # the same search by the plain version in float64: where the gains are
    # stiff (|K| ~ 1e2 on the car_escape stack without slacks) float32
    # rounding of the state is amplified, and the bars widen to three times
    # the float32 plain version's own distance from float64
    args64 = (p64.model, st["canon64"]) + tuple(
        a.double() for a in args[2:-3]) + (p64.dt_traj(), p64.obj, LS_OPTS)
    Xq, _, Jq, _, _, aq = fused_al_forward(*args64)
    calm = same & (aq == ap.double())
    calm[5] = False
    assert int(calm.sum()) >= B // 2
    eJ = float(((Jp.double() - Jq).abs() / Jq.abs().clamp(min=1.0))[calm].max())
    eX = float((Xp.double() - Xq)[calm].abs().max())
    scale = max(1.0, float(Xp[calm].abs().max()))
    assert float(((Jk - Jp).abs() / Jp.abs().clamp(min=1.0))[calm].max()) \
        < max(1e-3, 3.0 * eJ)
    assert float((Xk - Xp)[calm].abs().max()) < max(1e-4 * scale, 3.0 * eX)


def test_altro_solve_on_the_card(cuda_device):
    """``altro_solve`` on the line-seeded pendulum in float32 on the card:
    the AL stage on K3/K4 of the slack pendulum, the projection on K5 (2, 1)
    and K2, the re-solve on K3/K4 of the pendulum; the goal within 5e-3 and
    c_max < 1e-3. Then the float64 polish of that result by ``pn_solve`` on
    the card, which launches no kernel: violation below 1e-6."""
    import trajopt_tpu_torch as tt

    prob = _line_seeded(problems.pendulum(dtype=torch.float32,
                                          device=cuda_device))
    counts = lambda: (  # noqa: E731
        fused_al_backward_cuda.launches_by["pendulum_slack"],
        fused_al_forward_cuda.launches_by["pendulum_slack"],
        fused_al_backward_cuda.launches_by["pendulum"],
        fused_al_forward_cuda.launches_by["pendulum"],
        riccati_sweep_cuda.launches_by["2x1"],
        rollout_closed_loop_cuda.launches_by["pendulum"])
    before = counts()
    res = tt.altro_solve(prob, tt.ALTROOptions(
        opts_al=tt.ALOptions(), resolve_feasible_problem=True))
    assert all(b > a for a, b in zip(before, counts()))
    assert rollout_closed_loop_cuda.launches_by["pendulum"] == before[5] + 1
    assert float(res.c_max) < 1e-3
    assert float((res.X[-1] - prob.xf).norm()) < 5e-3

    p64 = problems.pendulum(dtype=torch.float64, device=cuda_device)
    before = counts()
    pol = tt.pn_solve(tt.update_problem(p64, X=res.X.double(),
                                        U=res.U.double()))
    assert counts() == before
    assert pol.X.dtype == torch.float64 and float(pol.viol) <= 1e-6
    assert float(pol.c_max) <= 1e-6
    with pytest.raises(NotImplementedError, match="#11"):
        tt.altro_solve(prob, tt.ALTROOptions(), minimum_time=True)


# ------------------------------------------------------ K5, K7a, K7b, K2

MODEL_PROBLEMS = dict(quadrotor=lambda **kw: quadrotor_line(
    N=101, distance=5.0, **kw), cartpole=problems.cartpole,
    car=problems.parallel_park, pendulum=problems.pendulum,
    doubleintegrator=problems.doubleintegrator)


def _model_setup(name, device):
    """Model ``name`` with its zoo problem's objective and dt, the horizon
    cut to N = 21 (for the quadrotor: a goal 5 m away at dt = 0.05, the
    recipe of tests/test_fused.py; at a coarser dt its float32 sweep fails
    at any moderate rho): B perturbed starts, the control seed plus noise,
    open-loop rollouts computed in float64, handed out in float32 with the
    float64 originals."""
    p64 = MODEL_PROBLEMS[name](dtype=torch.float64, device=device)
    obj = type(p64.obj)(**{k: torch.cat([getattr(p64.obj, k)[:N - 1],
                                         getattr(p64.obj, k)[-1:]])
                           for k in ("Q", "R", "H", "q", "r", "c")})
    rng = np.random.default_rng(7)
    x0s = p64.x0[None] + torch.as_tensor(rng.normal(size=(B, p64.n)) * 0.02,
                                         device=device)
    U = p64.U[:N - 1][None] + torch.as_tensor(
        rng.normal(size=(B, N - 1, p64.m)) * 0.02, device=device)
    dtt = p64.dt_traj()[:N - 1].contiguous()
    X = rollout(p64.model, x0s, U, dtt)
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    return dict(model=p64.model, obj64=obj, obj=obj.to(dtype=torch.float32),
                X64=X, U64=U, dt64=dtt, X=f32(X), U=f32(U), dtt=f32(dtt),
                dt=p64.dt)


def _close(a, b, b64, tol):
    """|a − b| within ``tol`` of scale, or within three times b's own
    distance from its float64 version ``b64`` where the conditioning is
    worse (the bar of chip_smoke.py)."""
    scale = float(b64.abs().max())
    eps = float((b.double() - b64).abs().max())
    assert float((a - b).abs().max()) <= max(tol * scale, 3.0 * eps)


@pytest.mark.parametrize("name", ["quadrotor", "cartpole", "car"])
def test_riccati_kernel_matches_plain_version(cuda_device, name):
    """K5 at rho = 1, control and state regularization: fail flags equal
    (none), K and d at 1e-3 of scale, ΔV at 1e-4 (or three times the plain
    version's distance from float64)."""
    ms = _model_setup(name, cuda_device)
    A, Bm = ms["model"].jacobian_traj(ms["X64"][:, :-1], ms["U64"],
                                      ms["dt64"])
    e = cost_expansion(ms["obj64"], ms["X64"], ms["U64"], ms["dt64"])
    ins64 = [A, Bm, e.x, e.u, e.xx, e.uu, e.ux]
    ins = [t.float().contiguous() for t in ins64]
    rho = torch.ones(B, device=cuda_device)
    for reg_state in (False, True):
        before = riccati_sweep_cuda.launches
        k = riccati_sweep_cuda(*ins, rho, reg_state=reg_state)
        torch.cuda.synchronize()
        assert riccati_sweep_cuda.launches == before + 1
        p = scan_sweep(ins[0], ins[1], Expansion(*ins[2:]), rho,
                       reg_state=reg_state)
        p64 = scan_sweep(A, Bm, e, rho.double(), reg_state=reg_state)
        assert torch.equal(k[4], p[4]) and not bool(k[4].any())
        for i, tol in ((0, 1e-3), (1, 1e-3), (2, 1e-4), (3, 1e-4)):
            _close(k[i], p[i], p64[i], tol)


def test_riccati_kernel_fail_branch(cuda_device):
    """A negative definite control Hessian at one stage of problem 9: kernel
    and plain version fail exactly that problem, and the kernel's gains at
    the failed stage are zero."""
    ms = _model_setup("cartpole", cuda_device)
    A, Bm = ms["model"].jacobian_traj(ms["X64"][:, :-1], ms["U64"],
                                      ms["dt64"])
    e = cost_expansion(ms["obj64"], ms["X64"], ms["U64"], ms["dt64"])
    ins = [t.float().contiguous() for t in (A, Bm, e.x, e.u, e.xx, e.uu,
                                            e.ux)]
    ins[5][9, 12] = -50.0
    rho = torch.ones(B, device=cuda_device)
    k = riccati_sweep_cuda(*ins, rho)
    torch.cuda.synchronize()
    p = scan_sweep(ins[0], ins[1], Expansion(*ins[2:]), rho)
    assert k[4].nonzero().flatten().tolist() == [9]
    assert torch.equal(k[4], p[4])
    assert not bool(k[0][9, 12].any()) and not bool(k[1][9, 12].any())
    live = ~k[4]
    assert (k[0] - p[0])[live].abs().max() < 1e-3 * p[0][live].abs().max()


@pytest.mark.parametrize("name", ["quadrotor", "cartpole", "pendulum"])
def test_fused_backward_kernel_matches_plain_version(cuda_device, name):
    """K7a at rho = 1: no failure, K and d at 1e-3 of scale, ΔV at 1e-4 (or
    three times the plain version's distance from float64), in-kernel
    Jacobians at 1e-5."""
    ms = _model_setup(name, cuda_device)
    rho = torch.ones(B, device=cuda_device)
    before = fused_backward_cuda.launches
    k = fused_backward_cuda(ms["model"], ms["X"], ms["U"], ms["dtt"],
                            ms["obj"], rho, return_jacobians=True)
    torch.cuda.synchronize()
    assert fused_backward_cuda.launches == before + 1
    p = fused_backward(ms["model"], ms["X"], ms["U"], ms["dtt"], ms["obj"],
                       rho, return_jacobians=True)
    p64 = fused_backward(ms["model"], ms["X64"], ms["U64"], ms["dt64"],
                         ms["obj64"], rho.double())
    assert torch.equal(k[4], p[4]) and not bool(k[4].any())
    for i, tol in ((0, 1e-3), (1, 1e-3), (2, 1e-4), (3, 1e-4)):
        _close(k[i], p[i], p64[i], tol)
    torch.testing.assert_close(k[5], p[5], rtol=0, atol=1e-5)
    torch.testing.assert_close(k[6], p[6], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["quadrotor", "cartpole"])
def test_fused_forward_kernel_matches_plain_version(cuda_device, name):
    """K7b with problem 5's feedforward blown up (its first candidates
    diverge) and problem 11 given a cost no candidate can beat (its search
    runs out: restore, alpha = 0, rho bump): alpha, rho and drho equal on
    every problem, J at 1e-4, X at 1e-5 of scale."""
    ms = _model_setup(name, cuda_device)
    one = torch.ones(B, device=cuda_device)
    K, d, v1, v2, fail = fused_backward_cuda(
        ms["model"], ms["X"], ms["U"], ms["dtt"], ms["obj"], one)
    assert not bool(fail.any())
    d = d.clone()
    d[5] *= 1e5
    x0 = ms["X"][:, 0].contiguous()
    assert not bool(rollout_closed_loop(ms["model"], x0, ms["X"], ms["U"], K,
                                        d, one, ms["dt"])[2][5])
    J_prev = total_cost(ms["obj"], ms["X"], ms["U"], ms["dtt"]).contiguous()
    J_prev[11] = -1e30
    args = (ms["model"], x0, ms["X"], ms["U"], K, d, v1, v2, J_prev, one, one,
            None, ms["dtt"], ms["obj"], LS_OPTS)
    before = fused_forward_cuda.launches
    Xk, Uk, Jk, rk, drk, ak = fused_forward_cuda(*args)
    torch.cuda.synchronize()
    assert fused_forward_cuda.launches == before + 1
    Xp, Up, Jp, rp, drp, ap = fused_forward(*args)
    assert torch.equal(ak, ap) and torch.equal(rk, rp)
    assert torch.equal(drk, drp)
    assert 0.0 < float(ak[5]) < 1.0
    assert float(ak[11]) == 0.0 and float(rk[11]) > 10.0
    assert torch.equal(Xk[11], ms["X"][11]) and torch.equal(Uk[11],
                                                             ms["U"][11])
    assert float(Jk[11]) == float(J_prev[11])
    calm = torch.ones(B, dtype=torch.bool, device=cuda_device)
    calm[5] = False
    torch.testing.assert_close(Jk[calm], Jp[calm], rtol=1e-4, atol=0)
    assert (Xk - Xp)[calm].abs().max() < 1e-5 * max(
        1.0, float(Xp[calm].abs().max()))


@pytest.mark.parametrize("name", ["quadrotor", "cartpole", "car", "pendulum",
                                  "doubleintegrator"])
def test_full_state_rollout_kernel_matches_plain_version(cuda_device, name):
    """K2 on the full state (``quat_slice=None``) for each model, on the
    gains of K7a at rho = 1: ok masks equal, X and U at 1e-5 of scale."""
    ms = _model_setup(name, cuda_device)
    one = torch.ones(B, device=cuda_device)
    K, d, _, _, _ = fused_backward_cuda(ms["model"], ms["X"], ms["U"],
                                        ms["dtt"], ms["obj"], one)
    alpha = (0.5 ** (torch.arange(B, device=cuda_device) % 4)).float()
    ins = (ms["model"], ms["X"][:, 0].contiguous(), ms["X"], ms["U"], K, d,
           alpha, ms["dt"])
    before = rollout_closed_loop_cuda.launches_by[name]
    Xk, Uk, okk = rollout_closed_loop_cuda(*ins)
    torch.cuda.synchronize()
    assert rollout_closed_loop_cuda.launches_by[name] == before + 1
    Xp, Up, okp = rollout_closed_loop(*ins)
    assert torch.equal(okk, okp) and bool(okk.any())
    assert (Xk - Xp)[okk].abs().max() < 1e-5 * max(
        1.0, float(Xp[okk].abs().max()))
    assert (Uk - Up)[okk].abs().max() < 1e-5 * max(
        1.0, float(Up[okk].abs().max()))


def test_slice3_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """float64 on the card is a ValueError; a shape with no instantiation
    and a model without a CUDA step are NotImplementedErrors that name the
    ROADMAP entry."""
    ms = _model_setup("cartpole", cuda_device)
    z = lambda *s, dt=torch.float32: torch.zeros(  # noqa: E731
        s, dtype=dt, device=cuda_device)
    rho64 = torch.ones(B, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        fused_backward_cuda(ms["model"], ms["X64"], ms["U64"], ms["dt64"],
                            ms["obj64"], rho64)
    with pytest.raises(ValueError):
        riccati_sweep_cuda(*(z(*s, dt=torch.float64) for s in (
            (2, 3, 4, 4), (2, 3, 4, 1), (2, 4, 4), (2, 3, 1), (2, 4, 4, 4),
            (2, 3, 1, 1), (2, 3, 1, 4), (2,))))
    with pytest.raises(NotImplementedError, match="K6"):
        riccati_sweep_cuda(z(2, 3, 5, 5), z(2, 3, 5, 2), z(2, 4, 5),
                           z(2, 3, 2), z(2, 4, 5, 5), z(2, 3, 2, 2),
                           z(2, 3, 2, 5), z(2))
    rk4 = discretize(zoo.cartpole, "rk4")
    with pytest.raises(NotImplementedError, match="K6"):
        fused_backward_cuda(rk4, ms["X"], ms["U"], ms["dtt"], ms["obj"],
                            torch.ones(B, device=cuda_device))
    with pytest.raises(NotImplementedError, match="K6"):
        fused_forward_cuda(rk4, ms["X"][:, 0].contiguous(), ms["X"], ms["U"],
                           z(B, N - 1, 1, 4), z(B, N - 1, 1), z(B), z(B),
                           z(B), z(B), z(B), None, ms["dtt"], ms["obj"],
                           LS_OPTS)


def test_default_options_solve_on_the_card(cuda_device):
    """``iLQROptions()`` (scan, full state) and ``iLQROptions(fused=True)``
    through ``solve_batch`` in float32 on the card for the pendulum: the
    constrained solve reaches c_max < 1e-3 on K3 and K4 alone (``fused_al``
    is on by default), with ``fused_al=False`` on K5 and K2; the
    unconstrained fused one runs on K7a and K7b alone and agrees with the
    phase-split one; float64 on the card raises."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.ops.constraints import empty_constraints
    from trajopt_tpu_torch.parallel.batch import solve_batch

    prob = problems.pendulum(dtype=torch.float32, device=cuda_device)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(rng.normal(size=(8, 2)) * 0.02, dtype=torch.float32,
                          device=cuda_device)
    k5 = riccati_sweep_cuda.launches_by["2x1"]
    k3 = fused_al_backward_cuda.launches_by["pendulum"]
    res = solve_batch(prob, tt.ALOptions(), x0s)
    assert riccati_sweep_cuda.launches_by["2x1"] == k5
    assert fused_al_backward_cuda.launches_by["pendulum"] > k3
    assert bool((res.c_max < 1e-3).all())
    assert float((res.X[:, -1] - prob.xf).norm(dim=-1).max()) < 5e-3
    k3 = fused_al_backward_cuda.launches_by["pendulum"]
    res = solve_batch(prob, tt.ALOptions(
        opts_uncon=tt.iLQROptions(fused_al=False)), x0s)
    assert riccati_sweep_cuda.launches_by["2x1"] > k5
    assert fused_al_backward_cuda.launches_by["pendulum"] == k3
    assert bool((res.c_max < 1e-3).all())

    free = tt.update_problem(prob, constraints=empty_constraints(
        prob.N, device=cuda_device))
    k5 = riccati_sweep_cuda.launches
    k7 = fused_backward_cuda.launches_by["pendulum"]
    fused = solve_batch(free, tt.ALOptions(
        opts_uncon=tt.iLQROptions(fused=True)), x0s)
    assert riccati_sweep_cuda.launches == k5
    assert fused_backward_cuda.launches_by["pendulum"] > k7
    split = solve_batch(free, tt.ALOptions(), x0s)
    torch.testing.assert_close(fused.J, split.J, rtol=1e-2, atol=1e-4)

    prob64 = problems.pendulum(dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        solve_batch(prob64, tt.ALOptions(), x0s.double())


# ------------------------------------------------------------ kuka (slice 5)

def _kuka_setup(slack, device, seed=5):
    """The kuka stack's kernel inputs of chip_smoke.py's kuka_setup at
    B = 16: starts around the hold pose, each start's hold torques plus 0.05
    noise, the start held on every knot (with slacks 0.1 off it and the
    slack controls the defects plus 0.02), exercised duals; float64 and
    float32."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        prob = problems.kuka_obstacles(dtype=dtype, device=device)
        out[dtype] = infeasible_problem(prob, 1e-8) if slack else prob
    base = problems.kuka_obstacles(dtype=torch.float64, device=device)
    p64 = out[torch.float64]
    n, m, Nk, P = p64.n, p64.m, p64.N, p64.constraints.P
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    x0s = base.x0[None] + t(np.concatenate(
        [rng.normal(size=(B, 7)) * 0.05, np.zeros((B, 7))], axis=1))
    q = x0s[:, :7]
    hold = base.model.model.chain.bias_forces(q, torch.zeros_like(q))
    U = hold[:, None] + t(rng.normal(size=(B, Nk - 1, 7)) * 0.05)
    X = x0s[:, None].expand(B, Nk, n)
    if slack:
        X = torch.cat([X[:, :1], X[:, 1:] + t(rng.normal(
            size=(B, Nk - 1, n)) * 0.1)], dim=1)
        defect = X[:, 1:] - base.model.step(X[:, :-1], U,
                                            base.dt_traj()[:, None])
        U = torch.cat([U, defect + t(rng.normal(size=(B, Nk - 1, n)) * 0.02)],
                      -1)
    mask = p64.constraints.mask
    lam = t(rng.uniform(0.0, 0.5, size=(B, Nk, P))) * mask
    mu = t(rng.uniform(0.5, 20.0, size=(B, Nk, P))) * mask
    data64 = [a.contiguous() for a in (X, U, lam, mu)]
    p32 = out[torch.float32]
    return dict(
        p64=p64, p32=p32, data64=data64,
        data=[a.float().contiguous() for a in data64],
        canon64=canonical_stack(p64.constraints, n, m, dtype=torch.float64),
        canon=canonical_stack(p32.constraints, n, m, dtype=torch.float32))


@pytest.mark.parametrize("slack", [False, True])
def test_kuka_kernels_match_plain_versions(cuda_device, slack):
    """The kuka instantiations, B = 16, float32, on the kuka stack (fk rows
    in it): K3 at rho = 1 with its in-kernel Jacobians, K and d at 2e-3 of
    scale or three times the float32 plain version's distance from float64,
    the Jacobians at 1e-5 of their scale; K4 on those gains (lane 11's
    search runs out): steps, rho, drho equal on at least 0.9 of the
    problems, X at 1e-4 of scale or three times the float32 plain version's
    distance from float64; K2 at K4's steps; K5 (14, 7) or (14, 21) on the
    AL expansion of the same inputs."""
    from trajopt_tpu_torch.solvers.al import al_cost_fns

    st = _kuka_setup(slack, cuda_device)
    p32, p64, canon = st["p32"], st["p64"], st["canon"]
    X, U, lam, mu = st["data"]
    X64, U64, lam64, mu64 = st["data64"]
    label = "kuka_slack" if slack else "kuka"
    n, m = p32.n, p32.m
    ones = torch.ones(B, device=cuda_device)
    dt = p32.dt_traj()
    before = fused_al_backward_cuda.launches_by[label]
    k = fused_al_backward_cuda(p32.model, canon, X, U, lam, mu, dt, p32.obj,
                               ones, return_jacobians=True)
    torch.cuda.synchronize()
    assert fused_al_backward_cuda.launches_by[label] == before + 1
    p = fused_al_backward(p32.model, canon, X, U, lam, mu, dt, p32.obj, ones,
                          return_jacobians=True)
    q = fused_al_backward(p64.model, st["canon64"], X64, U64, lam64, mu64,
                          p64.dt_traj(), p64.obj, ones.double(),
                          return_jacobians=True)
    assert torch.equal(k[4], p[4]) and not bool(k[4].any())
    for i in (0, 1):
        _close(k[i], p[i], q[i], 2e-3)
    for i in (5, 6):
        _close(k[i], p[i], q[i], 1e-5)

    K, d, dV1, dV2 = k[0], k[1], k[2], k[3]
    J_prev = (total_cost(p32.obj, X, U, dt) + canon_al_cost(
        canon, X, pad_terminal(U), lam, mu)).contiguous()
    J_prev[11] = -1e30
    args = (p32.model, canon, X[:, 0].contiguous(), X, U, K, d, dV1, dV2,
            J_prev, ones, ones, ones, lam, mu, dt, p32.obj, LS_OPTS)
    before = fused_al_forward_cuda.launches_by[label]
    Xk, Uk, Jk, rk, drk, ak = fused_al_forward_cuda(*args)
    torch.cuda.synchronize()
    assert fused_al_forward_cuda.launches_by[label] == before + 1
    Xp, Up, Jp, rp, drp, ap = fused_al_forward(*args)
    same = ak == ap
    assert float(same.float().mean()) >= 0.9
    assert torch.equal(rk[same], rp[same]) and torch.equal(drk[same],
                                                           drp[same])
    assert float(ak[11]) == 0.0 and torch.equal(Xk[11], X[11])
    args64 = (p64.model, st["canon64"]) + tuple(
        a.double() for a in args[2:-3]) + (p64.dt_traj(), p64.obj, LS_OPTS)
    Xq, _, _, _, _, aq = fused_al_forward(*args64)
    calm = same & (aq == ap.double())
    assert int(calm.sum()) >= B // 2
    _close(Xk[calm], Xp[calm], Xq[calm], 1e-4)

    ins = [X[:, 0].contiguous(), X, U, K, d, ak.contiguous()]
    before = rollout_closed_loop_cuda.launches_by[label]
    Xr, Ur, okr = rollout_closed_loop_cuda(p32.model, *ins, p32.dt)
    torch.cuda.synchronize()
    assert rollout_closed_loop_cuda.launches_by[label] == before + 1
    Xs, Us, oks = rollout_closed_loop(p32.model, *ins, p32.dt)
    X6, _, _ = rollout_closed_loop(p64.model, *(a.double() for a in ins),
                                   p32.dt)
    assert torch.equal(okr, oks) and int(okr.sum()) >= B // 2
    _close(Xr[okr], Xs[okr], X6[okr], 1e-5)

    A, Bm = p64.model.jacobian_traj(X64[:, :-1], U64, p64.dt_traj())
    e = al_cost_fns(p64.obj, p64.constraints, p64.dt_traj(), lam64,
                    mu64)[1](X64, U64)
    ins64 = [A, Bm, e.x, e.u, e.xx, e.uu, e.ux]
    ins = [a.float().contiguous() for a in ins64]
    k5 = riccati_sweep_cuda(*ins, ones)
    torch.cuda.synchronize()
    p5 = scan_sweep(ins[0], ins[1], Expansion(*ins[2:]), ones)
    q5 = scan_sweep(A, Bm, e, ones.double())
    assert torch.equal(k5[4], p5[4])
    for i in (0, 1):
        _close(k5[i], p5[i], q5[i], 1e-3)


@pytest.mark.parametrize("fk", [False, True])
def test_kuka_solve_on_the_card(cuda_device, fk):
    """Two inner iterations of kuka_obstacles on the card in float32: the
    default dispatch launches K5 (14, 7) and K2 kuka only, ``fused_al_fk``
    K5 and K4 kuka; K3 never runs for the fk stack."""
    import trajopt_tpu_torch as tt

    prob = problems.kuka_obstacles(dtype=torch.float32, device=cuda_device)
    counts = lambda: (riccati_sweep_cuda.launches_by["14x7"],  # noqa: E731
                      rollout_closed_loop_cuda.launches_by["kuka"],
                      fused_al_backward_cuda.launches_by["kuka"],
                      fused_al_forward_cuda.launches_by["kuka"])
    before = counts()
    res = tt.altro_solve(prob, tt.ALTROOptions(opts_al=tt.ALOptions(
        iterations=1, penalty_initial=0.01, penalty_scaling=50.0,
        opts_uncon=tt.iLQROptions(iterations=2, fused_al_fk=fk))))
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(counts(), before)]
    assert bool(torch.isfinite(res.X).all())
    assert moved[0] >= 2 and moved[2] == 0
    assert (moved[1] == 0) == fk and (moved[3] == 2) == fk


def test_unconstrained_fused_kuka_solve_raises_on_the_card(cuda_device):
    """K7a/K7b carry no chain step: an unconstrained ``fused=True`` kuka
    solve on a CUDA tensor raises NotImplementedError before any launch,
    as a model without a CUDA step does, and nothing runs in K7a's place."""
    import trajopt_tpu_torch as tt

    base = problems.kuka_obstacles(dtype=torch.float32, device=cuda_device)
    prob = tt.problem(base.model, base.obj, x0=base.x0.cpu(),
                      xf=base.xf.cpu(), N=base.N, dt=base.dt,
                      U0=base.U.cpu(), dtype=torch.float32,
                      device=cuda_device)
    before = fused_backward_cuda.launches
    with pytest.raises(NotImplementedError, match="K7a/K7b"):
        tt.al_solve(prob, tt.ALOptions(opts_uncon=tt.iLQROptions(
            iterations=2, fused=True)))
    assert fused_backward_cuda.launches == before
