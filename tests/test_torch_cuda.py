"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a GPU and
skips without one, so on a CPU-only machine the file collects and skips.
On a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Small shapes (B=16, N=21 for K1, K2, K5, K7a and K7b; B=16 on the N=101 maze
stack and on each other model's own stack for K3 and K4) in float32, at the
f32 tolerances of tests/test_pallas.py and of chip_smoke.py, which repeats
the comparisons at the main paths' shapes; and batches cut or tiled to other
sizes, where the kernels take other launch shapes, bitwise equal.
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
    fused_backward, fused_backward_cuda, fused_backward_shape, fused_forward,
    fused_forward_cuda,
)
from trajopt_tpu_torch.ops.cuda_models import rule_label
from trajopt_tpu_torch.ops.cuda_riccati import (
    riccati_sweep_cuda, riccati_sweep_shape,
)
from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
from trajopt_tpu_torch.ops.cuda_sqrt import (
    equilibrated_chol_upper, plain_chol_upper, sqrt_sweep, sqrt_sweep_cuda,
    sqrt_sweep_shape,
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


def _maze_sweep(maze, mu=None):
    """K3's arguments on the maze fixture (ρ = 1), ``mu`` in place of its
    penalties where given."""
    p = maze["prob"]
    return [p.model, maze["canon"], maze["X"], maze["U"], maze["lam"],
            maze["mu"] if mu is None else mu, p.dt_traj(), p.obj,
            torch.ones(B, device=maze["X"].device)]


@pytest.mark.parametrize("count", [1, 33, 129])
def test_fused_al_backward_kernel_ragged_batches(maze, count):
    """K3 on the maze problems cut or tiled to 1, 33 and 129: K, d, ΔV and
    the fail flags of every problem bitwise equal to the 16-problem
    launch's, whose block has producer warps."""
    args = _maze_sweep(maze)
    ref = fused_al_backward_cuda(*args)
    assert fused_al_backward_cuda.warps[1] > 0
    idx, cut = _tiled(args, (2, 3, 4, 5, 8), count)
    out = fused_al_backward_cuda(*cut)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert torch.equal(_bits(o), _bits(r[idx]))


def test_fused_al_backward_kernel_fails_with_the_pipeline_full(maze):
    """The fail branch's inputs (problem 7 indefinite at knot 40, in the
    middle of the sweep, the producers' ring full ahead of it) at 16
    problems and tiled to 129: exactly the copies of problem 7 fail, their
    gains at the failed stage are zero and the sweep goes on past it (the
    gains before it are the plain version's), bitwise equal between the
    two launches."""
    mu = maze["mu"].clone()
    r0, r1 = maze["prob"].constraints.row_slice("infeasible")
    mu[7, 40, r0:r1] = -1e3
    args = _maze_sweep(maze, mu)
    k = fused_al_backward_cuda(*args)
    Wc, Wp = fused_al_backward_cuda.warps
    slots = fused_al_backward_cuda.shape["slots"]
    assert Wp > 0 and slots >= Wp
    idx, cut = _tiled(args, (2, 3, 4, 5, 8), 129)
    big = fused_al_backward_cuda(*cut)
    torch.cuda.synchronize()
    p = fused_al_backward(*args)
    assert k[4].nonzero().flatten().tolist() == [7]
    assert torch.equal(k[4], p[4])
    assert big[4].nonzero().flatten().tolist() == (
        idx == 7).nonzero().flatten().tolist()
    assert not bool(k[0][7, 40].any()) and not bool(k[1][7, 40].any())
    assert bool(k[0][7, :40].any())
    assert (k[0][7, :40] - p[0][7, :40]).abs().max() < 1e-2 * p[0][7].abs(
        ).max()
    for o, r in zip(big, k):
        assert torch.equal(_bits(o), _bits(r[idx]))


def test_fused_al_backward_kernel_jacobians_from_the_producers(maze):
    """``return_jacobians``: A and B are written by the producer warps at 16
    problems and by the lone warp of each problem at 1,100 (tiled; more
    blocks than the card holds at any larger shape): bitwise equal, and
    within 1e-5 of ``jacobian_traj``."""
    args = _maze_sweep(maze)
    k = fused_al_backward_cuda(*args, return_jacobians=True)
    assert fused_al_backward_cuda.warps[1] > 0
    idx, cut = _tiled(args, (2, 3, 4, 5, 8), 1100)
    big = fused_al_backward_cuda(*cut, return_jacobians=True)
    assert fused_al_backward_cuda.warps == (1, 0)
    torch.cuda.synchronize()
    p = fused_al_backward(*args, return_jacobians=True)
    for o, r in zip(big, k):
        assert torch.equal(_bits(o), _bits(r[idx]))
    torch.testing.assert_close(k[5], p[5], rtol=0, atol=1e-5)
    torch.testing.assert_close(k[6], p[6], rtol=0, atol=1e-5)


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


def _bits(t):
    """A float32 tensor's bits (bool tensors as they are), so that equal
    NaNs compare equal."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _tiled(args, batched, count):
    """``args`` with their batch-first positions ``batched`` cut or tiled to
    ``count`` problems (problem b is problem b mod B)."""
    idx = torch.arange(count, device=args[min(batched)].device) % B
    return idx, [a[idx].contiguous() if i in batched else a
                 for i, a in enumerate(args)]


def _maze_search(maze, ls_opts=LS_OPTS):
    """K4's inputs on the maze fixture, as in
    test_fused_al_forward_kernel_matches_plain_version: problem 5's
    feedforward blown up, problem 11 with a cost no candidate beats."""
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
    return [p.model, maze["canon"], X[:, 0].contiguous(), X, U, K, d, dV1,
            dV2, J_prev, ones, ones, alpha0, lam, mu, dt, p.obj, ls_opts]


@pytest.mark.parametrize("count", [1, 33, 129])
def test_fused_al_forward_kernel_ragged_batches(maze, count):
    """K4 on the maze problems cut or tiled to 1, 33 and 129: every output
    of every problem bitwise equal to the 16-problem launch's."""
    args = _maze_search(maze)
    ref = fused_al_forward_cuda(*args)
    idx, cut = _tiled(args, range(2, 15), count)
    out = fused_al_forward_cuda(*cut)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert torch.equal(_bits(o), _bits(r[idx]))


def test_fused_al_forward_kernel_active_mask(maze):
    """Problems outside ``active`` get X, U and J_prev back with α = 0 and ρ,
    dρ unchanged; the others the result of the launch without a mask."""
    args = _maze_search(maze)
    ref = fused_al_forward_cuda(*args)
    active = torch.arange(B, device=maze["X"].device) % 3 != 1
    Xk, Uk, Jk, rk, drk, ak = fused_al_forward_cuda(*args, active=active)
    torch.cuda.synchronize()
    off = ~active
    assert torch.equal(Xk[off], args[3][off])
    assert torch.equal(Uk[off], args[4][off])
    assert torch.equal(Jk[off], args[9][off]) and not bool(ak[off].any())
    assert torch.equal(rk[off], args[10][off])
    assert torch.equal(drk[off], args[11][off])
    for o, r in zip((Xk, Uk, Jk, rk, drk, ak), ref):
        assert torch.equal(_bits(o[active]), _bits(r[active]))


def test_fused_al_forward_kernel_accepts_in_a_later_round(maze):
    """Problem 5 (the blown-up feedforward) accepts a candidate j past the
    launch's first round of W: its step, J and trajectory are the plain
    version's, as a serial search gives them."""
    args = _maze_search(maze)
    Xk, Uk, Jk, rk, drk, ak = fused_al_forward_cuda(*args)
    torch.cuda.synchronize()
    W = fused_al_forward_cuda.warps
    Xp, Up, Jp, rp, drp, ap = fused_al_forward(*args)
    alpha0 = args[12]
    j = int(torch.log2(alpha0[5] / ak[5]).round())
    assert float(ak[5]) > 0.0 and W > 1 and j >= W
    assert float(ak[5]) == float(ap[5]) and float(rk[5]) == float(rp[5])
    torch.testing.assert_close(Jk[5], Jp[5], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("count", [1, 33, 129])
def test_rollout_kernel_ragged_batches(linearization, count):
    """K2 (error state, one warp a problem) on the inputs of
    test_rollout_kernel_matches_twin cut or tiled to 1, 33 and 129 problems:
    every output of every problem bitwise equal to the 16-problem launch's,
    the 16-problem launch within the plain version's tolerance (K2 has no
    active mask: every problem rolls out)."""
    A, Bm, e, X, U, dt = linearization
    K, d, _, _, _ = sqrt_sweep_cuda(A, Bm, e.x, e.u, e.xx, e.uu, e.ux,
                                    torch.zeros(B, device=A.device))
    d = d.clone()
    d[5] *= 1e9
    alpha = torch.full((B,), 0.5, device=A.device)
    model = discretize(zoo.quadrotor, "rk3")
    args = [model, X[:, 0].contiguous(), X, U, K, d, alpha, dt]
    ref = rollout_closed_loop_cuda(*args, quat_slice=(3, 7))
    idx, cut = _tiled(args, range(1, 7), count)
    out = rollout_closed_loop_cuda(*cut, quat_slice=(3, 7))
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert torch.equal(_bits(o), _bits(r[idx]))
    Xt, Ut, okt = rollout_closed_loop(*args, quat_slice=(3, 7))
    assert torch.equal(ref[2], okt) and not bool(okt[5])
    torch.testing.assert_close(ref[0][okt], Xt[okt], rtol=0, atol=1e-4)


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
    ``cartpole``, ``pendulum`` (with slacks from a line seed), the maze
    without the transform, or a URDF rig's (``_rig_problem`` with a goal);
    float64 and float32 copies."""
    factory = dict(car=problems.car_escape, cartpole=problems.cartpole,
                   pendulum=problems.pendulum, quadrotor=quadrotor_maze).get(
        name, lambda **kw: _rig_problem(name, goal=True, **kw))
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
    _check_al_kernels(cuda_device, name, slack)


def _check_al_kernels(cuda_device, name, slack):
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
    return st, k, ak


def test_altro_solve_on_the_card(cuda_device):
    """``altro_solve`` on the line-seeded pendulum in float32 on the card:
    the AL stage on K3/K4 of the slack pendulum, the projection on K5 (2, 1)
    and K2, the re-solve on K3/K4 of the pendulum; the goal within 5e-3 and
    c_max < 1e-3. Then the float64 polish of that result by ``pn_solve`` on
    the card, which launches no kernel: violation below 1e-6. And the
    minimum-time transform of the same problem, cut to two outer
    iterations of five inner ones: phase-split on K5 (3, 4) and (3, 2) and
    K2's MinTime forms, no fused AL kernel launched."""
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
    fused = counts()[:4]
    mt = ("pendulum_slack_mintime", "pendulum_mintime")
    before = ([rollout_closed_loop_cuda.launches_by[k] for k in mt],
              [riccati_sweep_cuda.launches_by[k] for k in ("3x4", "3x2")])
    res = tt.altro_solve(prob, tt.ALTROOptions(opts_al=tt.ALOptions(
        iterations=2, opts_uncon=tt.iLQROptions(iterations=5))),
        minimum_time=True)
    after = ([rollout_closed_loop_cuda.launches_by[k] for k in mt],
             [riccati_sweep_cuda.launches_by[k] for k in ("3x4", "3x2")])
    assert all(b > a for x, y in zip(before, after) for a, b in zip(x, y))
    assert counts()[:4] == fused
    assert bool(torch.isfinite(res.X).all()) and res.dt_traj.shape == (30,)


# ------------------------------------------------------ K5, K7a, K7b, K2

def _rig_problem(rig, dtype, device, goal=False):
    """URDF rig ``rig`` on its zoo problem, its model replaced, as the JAX
    package solves it; with ``goal`` the double pendulum gets a goal
    constraint (the acrobot problem's), for the kernels that need a
    stack."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.ops.constraints import (
        ConstraintSetBuilder, goal_constraint)

    prob = problems.rig_problem(rig, dtype=dtype, device=device)
    if goal and prob.constraints.P == 0:
        cons = ConstraintSetBuilder(prob.N)
        cons.add(goal_constraint(prob.xf.cpu().numpy()))
        prob = tt.update_problem(prob, constraints=cons.stack(device=device))
    return prob


RIGS = ["acrobot_urdf", "doublependulum_urdf", "cartpole_urdf"]
MODEL_PROBLEMS = dict(quadrotor=lambda **kw: quadrotor_line(
    N=101, distance=5.0, **kw), cartpole=problems.cartpole,
    car=problems.parallel_park, pendulum=problems.pendulum,
    doubleintegrator=problems.doubleintegrator,
    **{rig: lambda r=rig, **kw: _rig_problem(r, **kw) for rig in RIGS})


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


def _k7b_search(name, device):
    """K7b's arguments on ``name``'s set-up, as in
    test_fused_forward_kernel_matches_plain_version: problem 5's
    feedforward blown up, problem 11 with a cost no candidate beats."""
    ms = _model_setup(name, device)
    one = torch.ones(B, device=device)
    K, d, v1, v2, fail = fused_backward_cuda(
        ms["model"], ms["X"], ms["U"], ms["dtt"], ms["obj"], one)
    assert not bool(fail.any())
    d = d.clone()
    d[5] *= 1e5
    J_prev = total_cost(ms["obj"], ms["X"], ms["U"], ms["dtt"]).contiguous()
    J_prev[11] = -1e30
    return [ms["model"], ms["X"][:, 0].contiguous(), ms["X"], ms["U"], K, d,
            v1, v2, J_prev, one, one.clone(), one.clone(), ms["dtt"],
            ms["obj"], LS_OPTS]


@pytest.mark.parametrize("count", [1, 33, 129])
def test_fused_forward_kernel_ragged_batches(cuda_device, count):
    """K7b on the quadrotor's searches cut or tiled to 1, 33 and 129: every
    output of every problem bitwise equal to the 16-problem launch's."""
    args = _k7b_search("quadrotor", cuda_device)
    ref = fused_forward_cuda(*args)
    idx, cut = _tiled(args, range(1, 12), count)
    out = fused_forward_cuda(*cut)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert torch.equal(_bits(o), _bits(r[idx]))


def test_fused_forward_kernel_active_mask(cuda_device):
    """Problems outside ``active`` get X, U and J_prev back with α = 0 and ρ,
    dρ unchanged; the others the result of the launch without a mask."""
    args = _k7b_search("quadrotor", cuda_device)
    ref = fused_forward_cuda(*args)
    active = torch.arange(B, device=cuda_device) % 3 != 1
    Xk, Uk, Jk, rk, drk, ak = fused_forward_cuda(*args, active=active)
    torch.cuda.synchronize()
    off = ~active
    assert torch.equal(Xk[off], args[2][off])
    assert torch.equal(Uk[off], args[3][off])
    assert torch.equal(Jk[off], args[8][off]) and not bool(ak[off].any())
    assert torch.equal(rk[off], args[9][off])
    assert torch.equal(drk[off], args[10][off])
    for o, r in zip((Xk, Uk, Jk, rk, drk, ak), ref):
        assert torch.equal(_bits(o[active]), _bits(r[active]))


def test_fused_forward_kernel_accepts_in_a_later_round(cuda_device):
    """Problem 5 (the blown-up feedforward) accepts a candidate j past the
    launch's first round of W: its step, ρ and J are the plain version's, as
    a serial search gives them."""
    args = _k7b_search("quadrotor", cuda_device)
    Xk, Uk, Jk, rk, drk, ak = fused_forward_cuda(*args)
    torch.cuda.synchronize()
    W = fused_forward_cuda.warps
    Xp, Up, Jp, rp, drp, ap = fused_forward(*args)
    j = int(torch.log2(1.0 / ak[5]).round())
    assert float(ak[5]) > 0.0 and W > 1 and j >= W
    assert float(ak[5]) == float(ap[5]) and float(rk[5]) == float(rp[5])
    torch.testing.assert_close(Jk[5], Jp[5], rtol=1e-4, atol=0)


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
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        riccati_sweep_cuda(z(2, 3, 6, 6), z(2, 3, 6, 2), z(2, 4, 6),
                           z(2, 3, 2), z(2, 4, 6, 6), z(2, 3, 2, 2),
                           z(2, 3, 2, 6), z(2))
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


def test_unconstrained_fused_kuka_solve_on_the_card(cuda_device):
    """K7a/K7b carry the chain step: an unconstrained ``fused=True`` kuka
    solve on a CUDA tensor runs on them alone (K5 and K2 never launch), from
    each start's own gravity hold, and its iterates stay finite."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.ops.constraints import empty_constraints
    from trajopt_tpu_torch.parallel.batch import solve_batch

    base = problems.kuka_obstacles(dtype=torch.float32, device=cuda_device)
    prob = tt.update_problem(base, constraints=empty_constraints(
        base.N, device=cuda_device))
    rng = np.random.default_rng(0)
    x0s = prob.x0[None] + torch.as_tensor(np.concatenate(
        [rng.normal(size=(4, 7)) * 0.05, np.zeros((4, 7))], axis=1),
        dtype=torch.float32, device=cuda_device)
    q = x0s[:, :7]
    U0s = prob.model.model.chain.bias_forces(q, torch.zeros_like(q))[
        :, None].expand(-1, prob.N - 1, -1).contiguous()
    counts = lambda: (fused_backward_cuda.launches_by["kuka"],  # noqa: E731
                      fused_forward_cuda.launches_by["kuka"],
                      riccati_sweep_cuda.launches,
                      rollout_closed_loop_cuda.launches)
    before = counts()
    res = solve_batch(prob, tt.ALOptions(opts_uncon=tt.iLQROptions(
        iterations=3, fused=True)), x0s, U0s)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(counts(), before)]
    assert moved[0] >= 3 and moved[1] >= 3 and moved[2:] == [0, 0]
    assert bool(torch.isfinite(res.X).all())


@pytest.mark.parametrize("rig", RIGS)
def test_rig_fused_kernels_match_plain_versions(cuda_device, rig):
    """The rigs' K7a, K7b, K2 (full state) and K5 (4, m) against their
    plain versions, B = 16, N = 21 at each zoo problem's dt: K7a at rho = 1
    (no failure, K and d at 1e-3 of scale, ΔV at 1e-4, or three times the
    float32 plain version's distance from float64; its Jacobians at 1e-5
    of scale); K7b on those gains with lane 11's search running out
    (steps, rho and drho equal everywhere, X at 1e-5 of scale or three
    times the float32 plain version's distance from float64); K2 at K7b's
    steps; K5 on the ``torch.func`` Jacobians."""
    ms = _model_setup(rig, cuda_device)
    one = torch.ones(B, device=cuda_device)
    before = fused_backward_cuda.launches_by[rig]
    k = fused_backward_cuda(ms["model"], ms["X"], ms["U"], ms["dtt"],
                            ms["obj"], one, return_jacobians=True)
    torch.cuda.synchronize()
    assert fused_backward_cuda.launches_by[rig] == before + 1
    p = fused_backward(ms["model"], ms["X"], ms["U"], ms["dtt"], ms["obj"],
                       one, return_jacobians=True)
    p64 = fused_backward(ms["model"], ms["X64"], ms["U64"], ms["dt64"],
                         ms["obj64"], one.double(), return_jacobians=True)
    assert torch.equal(k[4], p[4]) and not bool(k[4].any())
    for i, tol in ((0, 1e-3), (1, 1e-3), (2, 1e-4), (3, 1e-4)):
        _close(k[i], p[i], p64[i], tol)
    for i in (5, 6):
        _close(k[i], p[i], p64[i], 1e-5)

    K, d, v1, v2 = k[:4]
    x0 = ms["X"][:, 0].contiguous()
    J_prev = total_cost(ms["obj"], ms["X"], ms["U"], ms["dtt"]).contiguous()
    J_prev[11] = -1e30
    args = (ms["model"], x0, ms["X"], ms["U"], K, d, v1, v2, J_prev, one,
            one, None, ms["dtt"], ms["obj"], LS_OPTS)
    before = fused_forward_cuda.launches_by[rig]
    Xk, Uk, Jk, rk, drk, ak = fused_forward_cuda(*args)
    torch.cuda.synchronize()
    assert fused_forward_cuda.launches_by[rig] == before + 1
    Xp, Up, Jp, rp, drp, ap = fused_forward(*args)
    assert torch.equal(ak, ap) and torch.equal(rk, rp)
    assert torch.equal(drk, drp)
    assert float(ak[11]) == 0.0 and torch.equal(Xk[11], ms["X"][11])
    live = ak > 0
    assert int(live.sum()) >= B // 2
    X6 = rollout_closed_loop(ms["model"], x0.double(), ms["X64"], ms["U64"],
                             K.double(), d.double(), ak.double(),
                             ms["dt"])[0]
    _close(Xk[live], Xp[live], X6[live], 1e-5)
    torch.testing.assert_close(Jk[live], Jp[live], rtol=1e-4, atol=0)

    ins = (ms["model"], x0, ms["X"], ms["U"], K, d, ak.contiguous(),
           ms["dt"])
    before = rollout_closed_loop_cuda.launches_by[rig]
    Xr, Ur, okr = rollout_closed_loop_cuda(*ins)
    torch.cuda.synchronize()
    assert rollout_closed_loop_cuda.launches_by[rig] == before + 1
    Xs, Us, oks = rollout_closed_loop(*ins)
    assert torch.equal(okr, oks) and bool(okr.all())
    _close(Xr, Xs, X6, 1e-5)

    A, Bm = ms["model"].jacobian_traj(ms["X64"][:, :-1], ms["U64"],
                                      ms["dt64"])
    e = cost_expansion(ms["obj64"], ms["X64"], ms["U64"], ms["dt64"])
    ins64 = [A, Bm, e.x, e.u, e.xx, e.uu, e.ux]
    ins = [t.float().contiguous() for t in ins64]
    k5 = riccati_sweep_cuda(*ins, one)
    torch.cuda.synchronize()
    p5 = scan_sweep(ins[0], ins[1], Expansion(*ins[2:]), one)
    q5 = scan_sweep(A, Bm, e, one.double())
    assert torch.equal(k5[4], p5[4]) and not bool(k5[4].any())
    for i, tol in ((0, 1e-3), (1, 1e-3), (2, 1e-4), (3, 1e-4)):
        _close(k5[i], p5[i], q5[i], tol)


@pytest.mark.parametrize("rig,slack", [(r, s) for r in RIGS
                                       for s in (False, True)])
def test_rig_al_kernels_match_plain_versions(cuda_device, rig, slack):
    """The rigs' K3 and K4, with and without slacks, on each rig's zoo
    stack (the double pendulum's with a goal constraint), at the bars of
    ``test_fused_al_kernels_match_plain_versions_for_every_model``; then
    K2 at K4's steps and K5 (4, m) on the AL expansion of the same inputs
    (m = 5 or 6 with slacks)."""
    from trajopt_tpu_torch.solvers.al import al_cost_fns

    st, k, ak = _check_al_kernels(cuda_device, rig, slack)
    p32, p64 = st["p32"], st["p64"]
    X, U = st["data"][:2]
    label = rig + ("_slack" if slack else "")
    ones = torch.ones(B, device=cuda_device)
    ins = [X[:, 0].contiguous(), X, U, k[0], k[1], ak.contiguous()]
    before = rollout_closed_loop_cuda.launches_by[label]
    Xr, Ur, okr = rollout_closed_loop_cuda(p32.model, *ins, p32.dt)
    torch.cuda.synchronize()
    assert rollout_closed_loop_cuda.launches_by[label] == before + 1
    Xs, Us, oks = rollout_closed_loop(p32.model, *ins, p32.dt)
    X6, _, _ = rollout_closed_loop(p64.model, *(a.double() for a in ins),
                                   p32.dt)
    assert torch.equal(okr, oks) and int(okr.sum()) >= B // 2
    _close(Xr[okr], Xs[okr], X6[okr], 1e-5)

    X64, U64, lam64, mu64 = st["data64"]
    A, Bm = p64.model.jacobian_traj(X64[:, :-1], U64, p64.dt_traj())
    e = al_cost_fns(p64.obj, p64.constraints, p64.dt_traj(), lam64,
                    mu64)[1](X64, U64)
    ins64 = [A, Bm, e.x, e.u, e.xx, e.uu, e.ux]
    ins = [a.float().contiguous() for a in ins64]
    before = riccati_sweep_cuda.launches_by[f"4x{p32.m}"]
    k5 = riccati_sweep_cuda(*ins, ones)
    torch.cuda.synchronize()
    assert riccati_sweep_cuda.launches_by[f"4x{p32.m}"] == before + 1
    p5 = scan_sweep(ins[0], ins[1], Expansion(*ins[2:]), ones)
    q5 = scan_sweep(A, Bm, e, ones.double())
    assert torch.equal(k5[4], p5[4])
    for i in (0, 1):
        _close(k5[i], p5[i], q5[i], 1e-3)


def test_kuka_fused_kernels_match_plain_versions(cuda_device):
    """K7a and K7b ``kuka`` on the unconstrained arm, B = 16, N = 41: starts
    with q noise 0.05, each start's own hold torques, the open-loop
    rollouts (the held start where one leaves the finite numbers). K7a at
    rho = 1: K and d at 2e-3 of scale or three times the float32 plain
    version's distance from float64, its Jacobians at 1e-5 of their scale;
    K7b on those gains, lane 11's search running out: steps, rho and drho
    equal on at least 0.9 of the problems (the arm amplifies float32
    rounding, as on the kuka stack), X at 1e-4 of scale or three times the
    float32 plain version's distance from float64."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.ops.constraints import empty_constraints

    out = {}
    for dtype in (torch.float64, torch.float32):
        base = problems.kuka_obstacles(dtype=dtype, device=cuda_device)
        out[dtype] = tt.update_problem(base, constraints=empty_constraints(
            base.N, device=cuda_device))
    p64, p32 = out[torch.float64], out[torch.float32]
    rng = np.random.default_rng(5)
    x0s = p64.x0[None] + torch.as_tensor(np.concatenate(
        [rng.normal(size=(B, 7)) * 0.05, np.zeros((B, 7))], axis=1),
        device=cuda_device)
    q = x0s[:, :7]
    U64 = p64.model.model.chain.bias_forces(q, torch.zeros_like(q))[
        :, None].expand(-1, p64.N - 1, -1).contiguous()
    X64 = rollout(p64.model, x0s, U64, p64.dt_traj())
    blew = ~torch.isfinite(X64).flatten(1).all(-1)
    X64[blew] = x0s[blew][:, None]
    X, U = X64.float().contiguous(), U64.float().contiguous()
    one = torch.ones(B, device=cuda_device)
    dt = p32.dt_traj()
    before = fused_backward_cuda.launches_by["kuka"]
    k = fused_backward_cuda(p32.model, X, U, dt, p32.obj, one,
                            return_jacobians=True)
    torch.cuda.synchronize()
    assert fused_backward_cuda.launches_by["kuka"] == before + 1
    p = fused_backward(p32.model, X, U, dt, p32.obj, one,
                       return_jacobians=True)
    q64 = fused_backward(p64.model, X64, U64, p64.dt_traj(), p64.obj,
                         one.double(), return_jacobians=True)
    assert torch.equal(k[4], p[4]) and not bool(k[4].any())
    for i in (0, 1):
        _close(k[i], p[i], q64[i], 2e-3)
    for i in (5, 6):
        _close(k[i], p[i], q64[i], 1e-5)

    J_prev = total_cost(p32.obj, X, U, dt).contiguous()
    J_prev[11] = -1e30
    args = (p32.model, X[:, 0].contiguous(), X, U, k[0], k[1], k[2], k[3],
            J_prev, one, one, None, dt, p32.obj, LS_OPTS)
    before = fused_forward_cuda.launches_by["kuka"]
    Xk, Uk, Jk, rk, drk, ak = fused_forward_cuda(*args)
    torch.cuda.synchronize()
    assert fused_forward_cuda.launches_by["kuka"] == before + 1
    Xp, Up, Jp, rp, drp, ap = fused_forward(*args)
    same = ak == ap
    assert float(same.float().mean()) >= 0.9
    assert torch.equal(rk[same], rp[same]) and torch.equal(drk[same],
                                                           drp[same])
    assert float(ak[11]) == 0.0 and torch.equal(Xk[11], X[11])
    calm = same & (ak > 0)
    X6 = rollout_closed_loop(p64.model, x0s, X64, U64, k[0].double(),
                             k[1].double(), ak.double(), p32.dt)[0]
    if bool(calm.any()):
        _close(Xk[calm], Xp[calm], X6[calm], 1e-4)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _kuka_free(device, count=B):
    """The unconstrained kuka problem (float64, float32) and ``count``
    starts with q noise 0.05, each start's own hold torques and the
    open-loop rollouts in float64 (the held start where one leaves the
    finite numbers), as test_kuka_fused_kernels_match_plain_versions
    builds them."""
    import trajopt_tpu_torch as tt
    from trajopt_tpu_torch.ops.constraints import empty_constraints

    out = {}
    for dtype in (torch.float64, torch.float32):
        base = problems.kuka_obstacles(dtype=dtype, device=device)
        out[dtype] = tt.update_problem(base, constraints=empty_constraints(
            base.N, device=device))
    p64, p32 = out[torch.float64], out[torch.float32]
    rng = np.random.default_rng(5)
    x0s = p64.x0[None] + torch.as_tensor(np.concatenate(
        [rng.normal(size=(count, 7)) * 0.05, np.zeros((count, 7))], axis=1),
        device=device)
    q = x0s[:, :7]
    U64 = p64.model.model.chain.bias_forces(q, torch.zeros_like(q))[
        :, None].expand(-1, p64.N - 1, -1).contiguous()
    X64 = rollout(p64.model, x0s, U64, p64.dt_traj())
    blew = ~torch.isfinite(X64).flatten(1).all(-1)
    X64[blew] = x0s[blew][:, None]
    return dict(model=p32.model, model64=p64.model, obj=p32.obj,
                obj64=p64.obj, X64=X64, U64=U64, dt64=p64.dt_traj(),
                X=X64.float().contiguous(), U=U64.float().contiguous(),
                dtt=p32.dt_traj())


@pytest.mark.parametrize("count", [1, 33, 1024, 1152])
def test_riccati_kernel_ragged_and_large_batches(cuda_device, count):
    """K5 (13,4) on the B = 16 quadrotor set-up cut or tiled to ``count``
    problems, where the load pipeline takes another block shape: one
    launch counted, fail flags equal to the plain version's, K and d at
    1e-3 of scale and ΔV at 1e-4 (or three times the plain version's
    distance from float64), and every output of every problem bitwise equal
    to the B = 16 launch's."""
    ms = _model_setup("quadrotor", cuda_device)
    A, Bm = ms["model"].jacobian_traj(ms["X64"][:, :-1], ms["U64"],
                                      ms["dt64"])
    e = cost_expansion(ms["obj64"], ms["X64"], ms["U64"], ms["dt64"])
    ins64 = [A, Bm, e.x, e.u, e.xx, e.uu, e.ux]
    ins = [t.float().contiguous() for t in ins64]
    rho = torch.ones(B, device=cuda_device)
    ref = riccati_sweep_cuda(*ins, rho)
    idx = torch.arange(count, device=cuda_device) % B
    big = [t[idx].contiguous() for t in ins]
    before = riccati_sweep_cuda.launches
    k = riccati_sweep_cuda(*big, rho[idx])
    torch.cuda.synchronize()
    assert riccati_sweep_cuda.launches == before + 1
    assert riccati_sweep_shape(13, 4, count)["consumers"] >= 1
    p = scan_sweep(big[0], big[1], Expansion(*big[2:]), rho[idx])
    p64 = scan_sweep(A[idx], Bm[idx], Expansion(*(t[idx] for t in ins64[2:])),
                     rho[idx].double())
    assert torch.equal(k[4], p[4]) and not bool(k[4].any())
    for i, tol in ((0, 1e-3), (1, 1e-3), (2, 1e-4), (3, 1e-4)):
        _close(k[i], p[i], p64[i], tol)
    for a, r in zip(k, ref):
        assert torch.equal(_bits(a), _bits(r[idx]))


@pytest.mark.parametrize("name", ["quadrotor", "cartpole_urdf",
                                  "doublependulum_urdf", "kuka"])
@pytest.mark.parametrize("count", [1, 33, 1024, 1152])
def test_fused_backward_kernel_ragged_and_large_batches(cuda_device, name,
                                                        count):
    """K7a on the B = 16 set-up of ``name`` (kuka: the unconstrained arm,
    N = 41) cut or tiled to ``count`` problems, where the knot pipeline
    takes another block shape: one launch counted, fail flags equal to the
    plain version's (none), K and d at 1e-3 of scale (kuka 2e-3) and ΔV at
    1e-4 (kuka's not held, as in test_kuka_fused_kernels_match_plain_
    versions), or three times the plain version's distance from float64,
    the in-kernel Jacobians at 1e-5 of scale (JAC_TOL), and every output
    of every problem bitwise equal to the B = 16 launch's."""
    ms = _kuka_free(cuda_device) if name == "kuka" else \
        _model_setup(name, cuda_device)
    model64 = ms.get("model64", ms["model"])
    one = torch.ones(B, device=cuda_device)
    ref = fused_backward_cuda(ms["model"], ms["X"], ms["U"], ms["dtt"],
                              ms["obj"], one, return_jacobians=True)
    idx = torch.arange(count, device=cuda_device) % B
    X, U, rho = ms["X"][idx].contiguous(), ms["U"][idx].contiguous(), \
        one[idx]
    label = "kuka" if name == "kuka" else name
    before = fused_backward_cuda.launches_by[label]
    k = fused_backward_cuda(ms["model"], X, U, ms["dtt"], ms["obj"], rho,
                            return_jacobians=True)
    torch.cuda.synchronize()
    assert fused_backward_cuda.launches_by[label] == before + 1
    assert fused_backward_shape(ms["model"], count)["consumers"] >= 1
    p = fused_backward(ms["model"], X, U, ms["dtt"], ms["obj"], rho,
                       return_jacobians=True)
    p64 = fused_backward(model64, ms["X64"][idx], ms["U64"][idx],
                         ms["dt64"], ms["obj64"], rho.double(),
                         return_jacobians=True)
    assert torch.equal(k[4], p[4]) and not bool(k[4].any())
    for i, tol in ((0, 2e-3 if name == "kuka" else 1e-3),
                   (1, 2e-3 if name == "kuka" else 1e-3), (2, 1e-4),
                   (3, 1e-4)):
        if i < 2 or name != "kuka":
            _close(k[i], p[i], p64[i], tol)
    for i in (5, 6):
        _close(k[i], p[i], p64[i], 1e-5)
    for a, r in zip(k, ref):
        assert torch.equal(_bits(a), _bits(r[idx]))


def test_kuka_hold_trajectory_on_the_card(cuda_device):
    """``kuka_hold_trajectory`` builds on the card by default and follows a
    configuration that lies there; the hold agrees with the CPU's at 1e-12
    of scale."""
    from trajopt_tpu_torch.models import robots

    chain = robots.kuka_chain()
    q = np.array([0.0, np.pi / 2, np.pi / 2, np.pi / 2, 0.0, 0.0, 0.0])
    U = robots.kuka_hold_trajectory(chain, q, 41)
    assert U.device.type == "cuda" and U.shape == (40, 7)
    qd = torch.as_tensor(q, device=cuda_device)
    Ud = robots.kuka_hold_trajectory(chain, qd, 41)
    assert Ud.device == qd.device
    ref = robots.kuka_hold_trajectory(chain, q, 41, device="cpu")
    scale = float(ref.abs().max())
    assert float((Ud.cpu() - ref).abs().max()) <= 1e-12 * scale
    assert float((U.cpu() - ref).abs().max()) <= 1e-12 * scale


def _k1_branch_inputs(linearization):
    """K1's inputs of test_sqrt_kernel_branches_match_twin: at rho = 0 lane
    5 needs the equilibrated factor at knot 7, lane 9 fails at knot 12."""
    A, Bm, e, _, _, _ = linearization
    luu = e.uu.clone()
    _make_indefinite(luu, 5, 7, 1.0 + 2e-4)
    _make_indefinite(luu, 9, 12, 1.5)
    return [A, Bm, e.x, e.u, e.xx, luu, e.ux]


@pytest.mark.parametrize("count", [33, 600, 1152])
def test_sqrt_kernel_branches_at_every_launch_shape(linearization, count):
    """K1 at rho = 0 on the branch inputs tiled to 128 problems (slice 1's
    batch, one consumer and two producer warps a problem on the H100) and
    cut or tiled to ``count``: (1, 2) again at 33, the lone warp where
    (1, 2) no longer fits in one wave (600, a batch no multiple of 128,
    and 1152): one launch counted, exactly the failing lane's problems fail with zero gains at
    their stage, and every output of every problem bitwise equal to the
    B = 128 launch's."""
    ins = _k1_branch_inputs(linearization)
    dev = ins[0].device
    tile = torch.arange(128, device=dev) % B
    ref = sqrt_sweep_cuda(*(t[tile].contiguous() for t in ins),
                          torch.zeros(128, device=dev))
    idx = torch.arange(count, device=dev) % 128
    before = sqrt_sweep_cuda.launches
    k = sqrt_sweep_cuda(*(t[tile[idx]].contiguous() for t in ins),
                        torch.zeros(count, device=dev))
    torch.cuda.synchronize()
    assert sqrt_sweep_cuda.launches == before + 1
    assert sqrt_sweep_shape(12, 4, count)["consumers"] == 1
    failing = tile[idx] == 9
    assert torch.equal(k[4], failing) and bool(failing.any())
    assert not bool(k[0][failing][:, 12].any())
    assert not bool(k[1][failing][:, 12].any())
    for a, r in zip(k, ref):
        assert torch.equal(_bits(a), _bits(r[idx]))


@pytest.mark.parametrize("name", ["cartpole", "car"])
def test_sqrt_kernel_small_shapes_match_plain_version(cuda_device, name):
    """K1 at the cartpole's (4, 1) and the car's (3, 2) (bp_type='sqrt' is
    an option of any model; both run the instantiation with run-time
    sizes), rho = 0 and 1e-2: fail flags equal (none), K
    and d at 1e-3 of scale, ΔV at 1e-4 (or three times the plain version's
    distance from float64)."""
    ms = _model_setup(name, cuda_device)
    A, Bm = ms["model"].jacobian_traj(ms["X64"][:, :-1], ms["U64"],
                                      ms["dt64"])
    e = cost_expansion(ms["obj64"], ms["X64"], ms["U64"], ms["dt64"])
    ins = [t.float().contiguous() for t in (A, Bm, e.x, e.u, e.xx, e.uu,
                                            e.ux)]
    for rho_val in (0.0, 1e-2):
        rho = torch.full((B,), rho_val, device=cuda_device)
        k = sqrt_sweep_cuda(*ins, rho)
        torch.cuda.synchronize()
        p = sqrt_sweep(ins[0], ins[1], Expansion(*ins[2:]), rho)
        p64 = sqrt_sweep(A, Bm, e, rho.double())
        assert torch.equal(k[4], p[4]) and not bool(k[4].any())
        for i, tol in ((0, 1e-3), (1, 1e-3), (2, 1e-4), (3, 1e-4)):
            _close(k[i], p[i], p64[i], tol)


@pytest.mark.parametrize("n,m", [(5, 3), (13, 17)])
def test_sqrt_kernel_any_shape_matches_plain_version(cuda_device, n, m):
    """K1 at an (n, m) that no model gives (the kernel's instantiation with
    run-time sizes, as every shape but (12, 4); at (13, 17) one knot a
    producer step), on random data
    with positive definite stage Hessians, rho = 1e-2: as the small
    shapes."""
    rng = np.random.default_rng(11)
    r = lambda *s: torch.as_tensor(  # noqa: E731
        rng.normal(size=s), device=cuda_device)
    L = r(n, n) * 0.3
    Q = L @ L.T + 0.1 * torch.eye(n, device=cuda_device, dtype=L.dtype)
    A = torch.eye(n, device=cuda_device, dtype=L.dtype) + 0.1 * r(B, N - 1,
                                                                 n, n)
    e = Expansion(x=0.1 * r(B, N, n), u=0.1 * r(B, N - 1, m),
                  xx=Q.expand(B, N, n, n).contiguous(),
                  uu=torch.eye(m, device=cuda_device, dtype=L.dtype).expand(
                      B, N - 1, m, m).contiguous(),
                  ux=0.01 * r(B, N - 1, m, n))
    Bm = 0.1 * r(B, N - 1, n, m)
    ins = [t.float().contiguous() for t in (A, Bm, e.x, e.u, e.xx, e.uu,
                                            e.ux)]
    rho = torch.full((B,), 1e-2, device=cuda_device)
    k = sqrt_sweep_cuda(*ins, rho)
    torch.cuda.synchronize()
    p = sqrt_sweep(ins[0], ins[1], Expansion(*ins[2:]), rho)
    p64 = sqrt_sweep(A, Bm, e, rho.double())
    assert torch.equal(k[4], p[4]) and not bool(k[4].any())
    for i, tol in ((0, 1e-3), (1, 1e-3), (2, 1e-4), (3, 1e-4)):
        _close(k[i], p[i], p64[i], tol)


# ------------------------------------------------------------ slice 7

def _form_problem(name, slack, mintime, device, dtype, rule="rk3"):
    """A short problem (N = 21, dt = 0.05) of model ``name`` under the
    integrator ``rule`` near its equilibrium (the quadrotors at hover),
    line-seeded with slacks if ``slack``, then in minimum time if
    ``mintime`` (``altro_solve``'s order)."""
    from trajopt_tpu_torch.solvers.altro import minimum_time_problem
    from trajopt_tpu_torch.utils.interp import line_trajectory
    import trajopt_tpu_torch as tt

    model = discretize(zoo.MODELS[name], rule)
    n, m, Nk = model.n, model.m, N
    x0, xf = np.zeros(n), np.zeros(n)
    quad = name.startswith("quadrotor")
    if quad:
        x0[2] = xf[2] = 10.0
        x0[3] = xf[3] = 1.0 if name == "quadrotor" else 0.0
        xf[1] = 1.0
    else:
        x0[0] = 0.2
    u0 = 0.5 * 9.81 / 4.0 if quad else (9.81 if name == "ballonbeam" else 0.0)
    prob = tt.problem(model, tt.LQRObjective(
        np.eye(n), np.eye(m) * 0.1, np.eye(n) * 10.0, xf, Nk, dtype=dtype,
        device=device), x0=x0, xf=xf, N=Nk, dt=0.05,
        U0=np.full((Nk - 1, m), u0), dtype=dtype, device=device)
    if slack:
        prob = infeasible_problem(tt.initial_states(
            prob, line_trajectory(x0, xf, Nk)))
    if mintime:
        prob = minimum_time_problem(prob)
    return prob


SLICE7_FORMS = [(name, slack, True)
                for name in ("quadrotor", "cartpole", "car", "pendulum",
                             "doubleintegrator", "ballonbeam",
                             "quadrotor_euler") for slack in (False, True)] \
    + [(name, slack, False) for name in ("ballonbeam", "quadrotor_euler")
       for slack in (False, True)]


@pytest.mark.parametrize("name,slack,mintime", SLICE7_FORMS)
def test_slice7_rollout_kernel_matches_plain_version(cuda_device, name,
                                                     slack, mintime):
    """K2's slice-7 instantiations (every scalar model under MinTime, with
    and without slacks; ballonbeam and the Euler-angle quadrotor plain and
    with slacks): ``_check_form_rollout``."""
    _check_form_rollout(cuda_device, name, slack, mintime)


def _check_form_rollout(cuda_device, name, slack, mintime, rule="rk3"):
    """K2's instantiation of a form under the integrator ``rule`` on K5's
    gains at rho = 1: ok masks equal, X and U within 1e-5 of scale or three
    times the float32 plain version's distance from float64, the launch
    counted under the form's label."""
    p64 = _form_problem(name, slack, mintime, cuda_device, torch.float64,
                        rule)
    p32 = _form_problem(name, slack, mintime, cuda_device, torch.float32,
                        rule)
    rng = np.random.default_rng(5)
    n, m = p64.n, p64.m
    nb = n - 1 if mintime else n
    x0s = p64.x0 + torch.as_tensor(np.concatenate(
        [rng.normal(size=(B, nb)) * 0.02, np.zeros((B, n - nb))], axis=1),
        device=cuda_device)
    U = p64.U.expand(B, -1, -1).contiguous()
    X = rollout(p64.model, x0s, U, p64.dt_traj())
    A, Bm = p64.model.jacobian_traj(X[:, :-1], U, p64.dt_traj())
    e = p64.obj.expansion(X, U, p64.dt_traj())
    f32 = [t.float().contiguous() for t in (A, Bm, e.x, e.u, e.xx, e.uu,
                                            e.ux)]
    K, d, _, _, _ = riccati_sweep_cuda(*f32, torch.ones(B, device=cuda_device))
    alpha = (0.5 ** (torch.arange(B, device=cuda_device) % 4)).float()
    ins = (x0s.float().contiguous(), X.float().contiguous(),
           U.float().contiguous(), K, d, alpha)
    label = rule_label(name + ("_slack" if slack else "")
                       + ("_mintime" if mintime else ""), rule)
    before = rollout_closed_loop_cuda.launches_by[label]
    Xk, Uk, okk = rollout_closed_loop_cuda(p32.model, *ins, p32.dt)
    torch.cuda.synchronize()
    assert rollout_closed_loop_cuda.launches_by[label] == before + 1
    Xp, Up, okp = rollout_closed_loop(p32.model, *ins, p32.dt)
    X64, U64, _ = rollout_closed_loop(p64.model, *(t.double() for t in ins),
                                      p64.dt)
    assert torch.equal(okk, okp) and bool(okk.any())
    for a, b, c in ((Xk, Xp, X64), (Uk, Up, U64)):
        scale = max(1.0, float(c[okk].abs().max()))
        own = float((b.double() - c)[okk].abs().max()) / scale
        assert float((a - b)[okk].abs().max()) / scale <= max(1e-5, 3 * own)


@pytest.mark.parametrize("n,m", [(12, 16), (5, 2), (4, 3), (14, 5), (13, 5),
                                 (3, 4), (5, 6), (14, 18)])
def test_slice7_riccati_shapes_match_plain_version(cuda_device, n, m):
    """K5's slice-7 shapes: ``_check_riccati_shape``."""
    _check_riccati_shape(cuda_device, n, m)


def _check_riccati_shape(cuda_device, n, m):
    """K5 at (n, m) on well-conditioned random linearizations (B = 16,
    N = 21) at rho = 1: no failure, K within 2e-3 and d within 1e-1 of
    scale of ``scan_sweep``, ΔV at rtol 3e-2."""
    g = torch.Generator().manual_seed(100 * n + m)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)  # noqa
    L, Lu = r(B, N, n, n) * 0.3, r(B, N - 1, m, m) * 0.3
    ins = [t.float().contiguous().to(cuda_device) for t in (
        torch.eye(n) + 0.05 * r(B, N - 1, n, n), 0.1 * r(B, N - 1, n, m),
        r(B, N, n), r(B, N - 1, m), L @ L.transpose(-1, -2) + torch.eye(n),
        Lu @ Lu.transpose(-1, -2) + torch.eye(m), 0.05 * r(B, N - 1, m, n))]
    rho = torch.ones(B, device=cuda_device)
    before = riccati_sweep_cuda.launches_by[f"{n}x{m}"]
    K1, d1, v11, v21, f1 = riccati_sweep_cuda(*ins, rho)
    torch.cuda.synchronize()
    assert riccati_sweep_cuda.launches_by[f"{n}x{m}"] == before + 1
    K0, d0, v10, v20, f0 = scan_sweep(ins[0], ins[1], Expansion(*ins[2:]),
                                      rho)
    assert not bool(f1.any()) and not bool(f0.any())
    assert (K1 - K0).abs().max() < 2e-3 * K0.abs().max()
    assert (d1 - d0).abs().max() < 1e-1 * d0.abs().max()
    torch.testing.assert_close(v11, v10, rtol=3e-2, atol=1e-5)
    torch.testing.assert_close(v21, v20, rtol=3e-2, atol=1e-5)


# ------------------------------------------------------------ slice 8

# the chains (kuka and the three URDF rigs) under MinTime with and without
# slacks; the analytic double pendulum and acrobot in all four forms
SLICE8_FORMS = [(name, slack, True)
                for name in ("kuka", "acrobot_urdf", "doublependulum_urdf",
                             "cartpole_urdf", "doublependulum", "acrobot")
                for slack in (False, True)] \
    + [(name, slack, False) for name in ("doublependulum", "acrobot")
       for slack in (False, True)]


@pytest.mark.parametrize("name,slack,mintime", SLICE8_FORMS)
def test_slice8_rollout_kernel_matches_plain_version(cuda_device, name,
                                                     slack, mintime):
    """K2's slice-8 instantiations: ``_check_form_rollout``."""
    _check_form_rollout(cuda_device, name, slack, mintime)


@pytest.mark.parametrize("n,m", [(15, 8), (15, 22), (5, 3), (5, 7)])
def test_slice8_riccati_shapes_match_plain_version(cuda_device, n, m):
    """K5's slice-8 shapes (kuka's and the double pendulum's minimum-time
    forms, with and without slacks): ``_check_riccati_shape``."""
    _check_riccati_shape(cuda_device, n, m)


# ------------------------------------------------------------ slice 9

SLICE9_RULES = ("euler", "midpoint", "rk4", "midpoint_implicit",
                "rk3_implicit")
# a scalar model in all four forms, the quadrotors (the quaternion one also
# line-seeded in minimum time: gains on its slack and h rows), a rig with and without
# slacks in minimum time (kuka, whose implicit steps at these problems'
# dt = 0.05 fail to converge from some starts, in chip_smoke.py at 0.02)
SLICE9_FORMS = [("pendulum", False, False), ("pendulum", True, False),
                ("pendulum", False, True), ("pendulum", True, True),
                ("cartpole", False, False), ("quadrotor", False, False),
                ("quadrotor", True, True), ("quadrotor_euler", False, False),
                ("acrobot_urdf", False, True), ("acrobot_urdf", True, True)]


@pytest.mark.parametrize("rule", SLICE9_RULES)
@pytest.mark.parametrize("name,slack,mintime", SLICE9_FORMS)
def test_slice9_rollout_kernel_matches_plain_version(cuda_device, name,
                                                     slack, mintime, rule):
    """K2 under every integrator but RK3 (``csrc/rollout_<rule>.cu``):
    ``_check_form_rollout`` on the rule's own Jacobians (the implicit rules'
    by the implicit-function theorem) and K5's gains."""
    _check_form_rollout(cuda_device, name, slack, mintime, rule)


@pytest.mark.parametrize("rule", ("midpoint_implicit", "rk3_implicit"))
def test_slice9_nonconverging_step_is_poisoned(cuda_device, rule):
    """The pendulum's implicit step at dt = 2 from (3, 40) and (0, 100)
    does not converge in 1000 Newton trips: K2 returns NaN, its guard marks
    the problem dead and holds its start, as the plain version does; a
    benign start beside them steps as the plain version does."""
    x0 = torch.tensor([[3.0, 40.0], [0.0, 100.0], [0.1, 0.0]],
                      device=cuda_device)
    z = lambda *s: torch.zeros(s, device=cuda_device)  # noqa: E731
    ins = (x0, x0[:, None].expand(-1, 2, -1).contiguous(), z(3, 1, 1),
           z(3, 1, 1, 2), z(3, 1, 1), torch.ones(3, device=cuda_device))
    model = discretize(zoo.pendulum, rule)
    Xk, _, okk = rollout_closed_loop_cuda(model, *ins, 2.0)
    Xp, _, okp = rollout_closed_loop(model, *(t.cpu() for t in ins), 2.0)
    assert okk.tolist() == okp.tolist() == [False, False, True]
    assert torch.equal(Xk[:2], x0[:2, None].expand(-1, 2, -1))
    assert float((Xk[2].cpu() - Xp[2]).abs().max()) < 1e-4

