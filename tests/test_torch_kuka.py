"""kuka_obstacles' constraints and the plain versions of the kernels on the
7-DOF arm against the JAX package, on the CPU.

The fk_sphere rows (the arm's collision bubbles, K8 in the kernels) through
the port's canonical stack and through its ``ConstraintSet``, in float64 at
1e-10 of scale, with and without the slack controls of the infeasible-start
transform; the plain version of K2 on the kuka step against the Pallas
rollout kernel in interpret mode at tests/test_robust.py:323-358's shapes
and tolerance (N = 9, B = 128, float32, 5e-5 of scale); the plain versions
of K3 and K4 on the kuka stack against the JAX package's XLA reference of
tests/test_fused_al.py:172-236 (vmap of jacobian_traj, al_cost_fns'
expansion and the scan sweep; forward_pass under al_cost_fns' cost), in
float64 at 1e-8 of scale (K and d), rtol 1e-9 (ΔV, J) and 1e-9 of scale
(the rollouts); and the dispatch rule: no K3 for an fk stack, the hybrid
(K5 and K4) with ``fused_al_fk``. The CUDA kernels are held to these plain
versions on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.ops.canonical import canon_evaluate as jax_canon_evaluate
from trajopt_tpu.ops.canonical import canonical_stack as jax_canonical_stack
from trajopt_tpu.ops.pallas_rollout import rollout_closed_loop_pallas
from trajopt_tpu.problems import zoo as jzoo
from trajopt_tpu.solvers.al import al_cost_fns as jax_al_cost_fns
from trajopt_tpu.solvers.altro import infeasible_problem as jax_infeasible
from trajopt_tpu.solvers.ilqr import _backward_pass_impl
from trajopt_tpu.solvers.ilqr import forward_pass as jax_forward_pass
from trajopt_tpu.solvers.ilqr import iLQROptions as JaxILQROptions

import trajopt_tpu_torch as tt
from trajopt_tpu_torch.models import robots
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.ops.canonical import (
    canon_evaluate, canonical_stack, pad_terminal,
)
from trajopt_tpu_torch.ops.cuda_al_fused import (
    fused_al_backward_cuda, fused_al_forward_cuda,
)
from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
from trajopt_tpu_torch.problems.zoo import kuka_obstacles
from trajopt_tpu_torch.solvers import ilqr as port_ilqr
from trajopt_tpu_torch.solvers.altro import infeasible_problem
from trajopt_tpu_torch.solvers.ilqr import (
    ALFusedMeta, _canon_has_fk, _fused_al_eligible, iLQROptions,
)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

B = 4


def _problems(slack):
    pj = jzoo.kuka_obstacles(dtype=jnp.float64)
    pt = kuka_obstacles(device="cpu")
    if slack:
        pj, pt = jax_infeasible(pj, 1e-8), infeasible_problem(pt, 1e-8)
    return pj, pt


def _scaled_err(mine, ref):
    ref = np.asarray(ref)
    mine = mine.numpy() if torch.is_tensor(mine) else np.asarray(mine)
    return np.abs(mine - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("slack", [False, True])
def test_fk_stack_and_constraint_set_match_jax(slack):
    """On random states and controls: the canonical stack's values
    (canon_evaluate) against the JAX package's, and the ConstraintSet's
    evaluate, jacobian and al_expansion_terms (exercised g and Iμ) against
    the JAX ConstraintSet's, 1e-10 of scale; the row order is obstacle-major
    (spheres, then cylinders, five points each)."""
    pj, pt = _problems(slack)
    n, m, N = pt.n, pt.m, pt.N
    rng = np.random.default_rng(0)
    X = rng.uniform(-1.5, 1.5, size=(N, n))
    U = rng.normal(size=(N - 1, m)) * 2
    U_pad = np.concatenate([U, np.zeros((1, m))])
    jst = jax_canonical_stack(pj.constraints, n, m, dtype=jnp.float64)
    st = canonical_stack(pt.constraints, n, m, dtype=torch.float64)
    assert st.P == jst.P == pt.constraints.P == (72 if slack else 58)
    assert st.fk_joint.shape == (7, 36) and st.fk_point.shape == (5, 4)
    T = torch.as_tensor
    C_j = jax_canon_evaluate(jst, n, m, jnp.asarray(X), jnp.asarray(U_pad))
    assert _scaled_err(canon_evaluate(st, T(X), T(U_pad)), C_j) < 1e-10

    csj, cst = pj.constraints, pt.constraints
    assert [c.label for c in cst.cons] == [c.label for c in csj.cons]
    assert np.array_equal(cst.mask.numpy(), np.asarray(csj.mask))
    C = cst.evaluate(T(X), T(U))
    assert _scaled_err(C, csj.evaluate(jnp.asarray(X), jnp.asarray(U))) \
        < 1e-10
    # obstacle-major rows: row r0 + 5j + i is obstacle j at point i
    r0, r1 = cst.row_slice("obs")
    assert (r0, r1) == (14, 44)
    assert st.row_i[r0:r1, 1].tolist() == list(range(5)) * 6
    assert st.row_i[r0:r1, 2].tolist() == [7] * 15 + [3] * 15
    for (a, b) in zip(cst.jacobian(T(X), T(U)),
                      csj.jacobian(jnp.asarray(X), jnp.asarray(U))):
        assert _scaled_err(a, b) < 1e-10
    g = rng.normal(size=(N, cst.P)) * np.asarray(csj.mask)
    imu = rng.uniform(0.5, 20.0, size=(N, cst.P)) * np.asarray(csj.mask)
    mine = cst.al_expansion_terms(T(X), T(U), T(g), T(imu))
    ref = csj.al_expansion_terms(jnp.asarray(X), jnp.asarray(U),
                                 jnp.asarray(g), jnp.asarray(imu))
    ref = [ref[k] for k in ("x", "u", "xx", "uu", "ux")] \
        if isinstance(ref, dict) else ref
    for a, b in zip(mine, ref):
        assert _scaled_err(a, b) < 1e-10 or np.abs(np.asarray(b)).max() == 0


def test_rollout_plain_version_matches_pallas_interpret():
    """K2's plain version on the kuka step against the Pallas rollout kernel
    in interpret mode with the JAX lane step, at the shapes and tolerance of
    tests/test_robust.py:323-358: N = 9, B = 128, float32, X̄ and Ū within
    5e-5 of scale, every problem ok."""
    jd = jtt.discretize(jrobots.kuka_model(), "rk3")
    td = discretize(robots.kuka_model(), "rk3")
    n, m, N, Bk = 14, 7, 9, 128
    rng = np.random.default_rng(1)
    x0 = np.concatenate([rng.normal(size=(Bk, 7)) * 0.2,
                         np.zeros((Bk, 7))], axis=1)
    U = np.broadcast_to(np.asarray(jrobots.kuka_hold_trajectory(
        jd.model.chain, jnp.zeros(7), N)), (Bk, N - 1, m))
    X = np.zeros((Bk, N, n))
    K = rng.normal(size=(Bk, N - 1, m, n)) * 0.01
    d = rng.normal(size=(Bk, N - 1, m)) * 0.1
    f32 = [np.asarray(a, np.float32) for a in (x0, X, U, K, d)]
    alpha = np.ones(Bk, np.float32)
    Xp, Up, okp = rollout_closed_loop_pallas(
        jd.step_lanes, *(jnp.asarray(a) for a in f32), jnp.asarray(alpha),
        0.01, interpret=True)
    Xt, Ut, okt = rollout_closed_loop_cuda(
        td, *(torch.as_tensor(a).contiguous() for a in f32),
        torch.as_tensor(alpha), 0.01)
    assert bool(okt.all()) and bool(np.asarray(okp).all())
    Xp, Up = np.asarray(Xp), np.asarray(Up)
    assert np.abs(Xt.numpy() - Xp).max() < 5e-5 * (np.abs(Xp).max() + 1.0)
    assert np.abs(Ut.numpy() - Up).max() < 5e-5 * (np.abs(Up).max() + 1.0)


def _inputs(pj, pt, slack, seed=5):
    """B problems around the hold pose as chip_smoke.py's kuka_setup makes
    them (each start's own hold torques plus 0.05 noise, the start held on
    every knot; with slacks the knots 0.1 off and the slack controls the
    defects plus 0.02), exercised duals, as numpy."""
    rng = np.random.default_rng(seed)
    base = kuka_obstacles(device="cpu")
    x0s = base.x0.numpy()[None] + np.concatenate(
        [rng.normal(size=(B, 7)) * 0.05, np.zeros((B, 7))], axis=1)
    q = torch.as_tensor(x0s[:, :7])
    hold = base.model.model.chain.bias_forces(q, torch.zeros_like(q))
    U = hold.numpy()[:, None] + rng.normal(size=(B, 40, 7)) * 0.05
    X = np.repeat(x0s[:, None], 41, axis=1)
    if slack:
        X[:, 1:] += rng.normal(size=(B, 40, 14)) * 0.1
        defect = X[:, 1:] - base.model.step(
            torch.as_tensor(X[:, :-1]), torch.as_tensor(U), 0.125).numpy()
        U = np.concatenate([U, defect + rng.normal(size=(B, 40, 14)) * 0.02],
                           axis=-1)
    mask = np.asarray(pj.constraints.mask)
    P = mask.shape[1]
    return dict(X=X, U=U, lam=rng.uniform(0.0, 0.5, size=(B, 41, P)) * mask,
                mu=rng.uniform(0.5, 20.0, size=(B, 41, P)) * mask)


def _jax_backward(pj, data):
    dt_traj, cs = pj.dt_traj(), pj.constraints
    jopts = JaxILQROptions()

    def one(X, U, lam, mu):
        _, expansion_fn = jax_al_cost_fns(pj.obj, cs, dt_traj, lam, mu, 0.0)
        A, Bm = pj.model.jacobian_traj(X[:-1], U, dt_traj)
        return _backward_pass_impl(A, Bm, expansion_fn(X, U), jnp.ones(()),
                                   jnp.ones(()), jopts)

    return jax.vmap(one)(*(jnp.asarray(data[k])
                           for k in ("X", "U", "lam", "mu")))


@pytest.mark.parametrize("slack", [False, True])
def test_fused_al_plain_versions_match_jax(slack):
    """K3's plain version on the kuka stack (fk rows in it) against the XLA
    reference at ρ = 1 (one sweep, no failure): K and d at 1e-8 of scale, ΔV
    at rtol 1e-9. Then K4's plain version on those gains against vmap of
    forward_pass under al_cost_fns' cost, problem 2 given a cost no
    candidate can beat (its search runs out): α, ρ, dρ equal, J at rtol
    1e-9, X̄ and Ū at 1e-9 of scale."""
    pj, pt = _problems(slack)
    n, m = pt.n, pt.m
    data = _inputs(pj, pt, slack)
    Kj, dj, v1j, v2j, rhoj, _ = _jax_backward(pj, data)
    assert np.allclose(np.asarray(rhoj), 1.0 / 1.6)       # no retry
    canon = canonical_stack(pt.constraints, n, m, dtype=torch.float64)
    assert _canon_has_fk(canon)
    X, U, lam, mu = (torch.as_tensor(data[k])
                     for k in ("X", "U", "lam", "mu"))
    dt_traj, obj, one = pt.dt_traj(), pt.obj, torch.ones(B,
                                                         dtype=torch.float64)
    K, d, v1, v2, fail = fused_al_backward_cuda(
        pt.model, canon, X, U, lam, mu, dt_traj, obj, one)
    assert not bool(fail.any())
    assert _scaled_err(K, Kj) < 1e-8 and _scaled_err(d, dj) < 1e-8
    np.testing.assert_allclose(v1.numpy(), np.asarray(v1j), rtol=1e-9)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v2j), rtol=1e-9)

    jdt, cs = pj.dt_traj(), pj.constraints
    jin = {k: jnp.asarray(v) for k, v in data.items()}

    def cost_one(Xi, Ui, lam_i, mu_i):
        return jax_al_cost_fns(pj.obj, cs, jdt, lam_i, mu_i, 0.0)[0](Xi, Ui)

    J_prev = np.array(jax.vmap(cost_one)(jin["X"], jin["U"], jin["lam"],
                                         jin["mu"]))
    J_prev[2] = -1e30

    def fp_one(x0_, X_, U_, K_, d_, v1_, v2_, J_, lam_, mu_):
        cost_fn, _ = jax_al_cost_fns(pj.obj, cs, jdt, lam_, mu_, 0.0)
        return jax_forward_pass(pj.model, cost_fn, x0_, X_, U_, K_, d_, v1_,
                                v2_, J_, jnp.ones(()), jnp.ones(()), jdt,
                                JaxILQROptions())

    ref = jax.vmap(fp_one)(
        jin["X"][:, 0], jin["X"], jin["U"], jnp.asarray(K.numpy()),
        jnp.asarray(d.numpy()), jnp.asarray(v1.numpy()),
        jnp.asarray(v2.numpy()), jnp.asarray(J_prev), jin["lam"], jin["mu"])
    Xr, Ur, Jr, rhor, drhor, alphar = (np.asarray(a) for a in ref)
    opts = iLQROptions()
    opts_t = (opts.line_search_lower_bound, opts.line_search_upper_bound,
              opts.iterations_linesearch, opts.bp_reg_min,
              opts.bp_reg_increase_factor, opts.bp_reg_fp)
    Xn, Un, J, rho, drho, alpha = fused_al_forward_cuda(
        pt.model, canon, X[:, 0].contiguous(), X, U, K, d, v1, v2,
        torch.as_tensor(J_prev), one, one, None, lam, mu, dt_traj, obj,
        opts_t)
    assert alpha.tolist() == alphar.tolist()
    assert alphar[2] == 0.0 and (alphar > 0.0).any()
    assert rho.tolist() == rhor.tolist() and drho.tolist() == drhor.tolist()
    np.testing.assert_allclose(J.numpy(), Jr, rtol=1e-9)
    assert _scaled_err(Xn, Xr) < 1e-9 and _scaled_err(Un, Ur) < 1e-9


class _Count:
    """Counts the calls of a kernel wrapper (on the CPU: its plain
    version)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


def test_dispatch_never_sends_an_fk_stack_to_k3(monkeypatch):
    """The kuka stack is fused-AL eligible only with ``fused_al_fk``, and
    then runs the hybrid: the phase-split backward pass (K5) with the fused
    line search (K4), never K3; by default it is phase-split (K5 and K2).
    Two inner iterations of the first AL outer iteration, on the CPU."""
    prob = kuka_obstacles(device="cpu")
    canon = canonical_stack(prob.constraints, 14, 7, dtype=torch.float64)
    meta = ALFusedMeta(objective=prob.obj, cs=prob.constraints, canon=canon,
                       lam=None, mu=None, atol=0.0)
    assert _canon_has_fk(canon)
    assert not _fused_al_eligible(prob.model, iLQROptions(), meta)
    assert _fused_al_eligible(prob.model, iLQROptions(fused_al_fk=True), meta)
    for fk in (False, True):
        spies = {name: _Count(getattr(port_ilqr, name)) for name in (
            "fused_al_backward_cuda", "fused_al_forward_cuda",
            "riccati_sweep_cuda", "rollout_closed_loop_cuda")}
        for name, spy in spies.items():
            monkeypatch.setattr(port_ilqr, name, spy)
        opts = tt.ALTROOptions(opts_al=tt.ALOptions(
            iterations=1, penalty_initial=0.01, penalty_scaling=50.0,
            opts_uncon=tt.iLQROptions(iterations=2, fused_al_fk=fk)))
        res = tt.altro_solve(prob, opts)
        calls = {k: s.calls for k, s in spies.items()}
        assert int(res.iterations_total) == 2
        assert calls["fused_al_backward_cuda"] == 0
        assert calls["riccati_sweep_cuda"] >= 2
        if fk:
            assert calls["fused_al_forward_cuda"] == 2
            assert calls["rollout_closed_loop_cuda"] == 0
        else:
            assert calls["fused_al_forward_cuda"] == 0
            assert calls["rollout_closed_loop_cuda"] >= 2
