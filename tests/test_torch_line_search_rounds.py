"""The invariant that the parallel line searches of kernels K4 and K7b rest
on, on the CPU.

K4 (``trajopt_tpu_torch/csrc/fused_al_forward.cu``) and K7b
(``csrc/fused_forward.cu``), through ``csrc/line_search_rounds.cuh``,
evaluate the candidates α0·2⁻ʲ of one search W at a time, one warp each,
and take the
lowest accepted j of a round, or the next round, or the restore with the ρ
bump once j = ls_iters has been tried. That is the serial backtracking
search only if a candidate's result depends on nothing but its own α and
the inputs, and a diverged candidate never ends the search. Here each
candidate is evaluated on its own with the plain rollout and the cost,
the lowest accepted j is taken in rounds of W ∈ {1, 3, 8}, and the result
(X̄, Ū, J, ρ, δρ, α_used) must equal the serial search of
``ops/line_search.py::line_search`` bit for bit in float64, at 20 and at 5
line-search iterations, with the branch lanes of ``chip_smoke.py``: a
feedforward blown up (its early candidates diverge), a cost no candidate
can beat (the search runs out), and a lane accepted in its second round.
The searches: K4's (its plain version ``fused_al_forward``, the AL cost) on
the miniature maze of tests/test_torch_al_fused.py (N = 21), and K7b's (its
plain version ``fused_forward``, the objective's cost) on the unconstrained
quadrotor of tests/test_torch_fused.py (N = 21) and on the cartpole rig of
tests/test_torch_rigs.py (N = 11). One case of each kind is also held
against the JAX package's forward pass, the plain reference its own tests
hold the Pallas kernels to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_al_fused import _port_inputs, _setup
from test_torch_fused import _port
from test_torch_fused import _setup as _fused_setup
from test_torch_rigs import _setup as _rig_setup
from trajopt_tpu.solvers.al import al_cost_fns as jax_al_cost_fns
from trajopt_tpu.solvers.ilqr import forward_pass as jax_forward_pass
from trajopt_tpu.solvers.ilqr import iLQROptions as JaxILQROptions
from trajopt_tpu_torch.ops.canonical import canon_al_cost, pad_terminal
from trajopt_tpu_torch.ops.cost import total_cost
from trajopt_tpu_torch.ops.cuda_al_fused import (
    MAX_VALUE, fused_al_backward, fused_al_forward,
)
from trajopt_tpu_torch.ops.cuda_fused import fused_backward, fused_forward
from trajopt_tpu_torch.ops.line_search import reg_increase, where_rows
from trajopt_tpu_torch.ops.rollout import rollout_closed_loop

torch.set_num_threads(1)

B, N, R_INF = 8, 21, 1e-8
# K4's branch lanes (chip_smoke.py), and a lane whose feedforward is blown
# up so that it accepts its fourth candidate (j = 3): in the second round
# at W = 3
DIVERGE, EXHAUST, LATE = 1, 2, 3
# iLQROptions' line-search defaults, as the plain versions take them
LB, UB, REG_MIN, REG_FACTOR, REG_FP = 1e-8, 10.0, 1e-8, 1.6, 10.0
# the unconstrained searches: (model, N, seed of the set-up, the late lane's
# feedforward factor)
UNCONSTRAINED = dict(quadrotor=(21, 3, 10.0), cartpole_urdf=(11, 2, 100.0))


@pytest.fixture(scope="module")
def search():
    return _search_inputs()


@pytest.fixture(scope="module")
def searches(search):
    """Every search by name: the maze's AL search and the unconstrained
    ones, built once."""
    return dict(maze=search, **{name: _unconstrained_inputs(name)
                                for name in UNCONSTRAINED})


def _search_inputs():
    """The AL searches' inputs on the miniature maze: gains from K3's plain
    version at ρ = 1, steps α0 = 2^-(b mod 4), and the branch lanes."""
    pj, pt, data = _setup(B, N, R_INF, torch.float64)
    canon, (X, U, lam, mu) = _port_inputs(pt, data)
    dt, obj = pt.dt_traj(), pt.obj
    one = torch.ones(B, dtype=torch.float64)
    K, d, dV1, dV2, fail = fused_al_backward(pt.model, canon, X, U, lam, mu,
                                             dt, obj, one)
    assert not bool(fail.any())
    d = d.clone()
    d[DIVERGE] *= 1e6
    d[LATE] *= 30.0
    J_prev = total_cost(obj, X, U, dt) + canon_al_cost(
        canon, X, pad_terminal(U), lam, mu)
    J_prev[EXHAUST] = -1e30
    alpha0 = 0.5 ** (torch.arange(B) % 4).to(torch.float64)
    args = (pt.model, canon, X[:, 0], X, U, K, d, dV1, dV2, J_prev, one,
            one, alpha0, lam, mu, dt, obj)

    def cost(Xc, Uc):
        return total_cost(obj, Xc, Uc, dt) + canon_al_cost(
            canon, Xc, pad_terminal(Uc), lam, mu)

    return dict(pj=pj, data=data, args=args, cost=cost,
                serial=lambda opts: fused_al_forward(*args, opts))


def _unconstrained_inputs(name):
    """The unconstrained searches' inputs on ``name``'s set-up in float64
    (the JAX package's rollouts): gains from K7a's plain version at ρ = 1,
    steps α0 = 2^-(b mod 4), a feedforward blown up 1e5-fold, a cost no
    candidate can beat, a late lane."""
    Nk, seed, late = UNCONSTRAINED[name]
    if name == "quadrotor":
        jm, obj, x0j, Xj, Uj, dtj = _fused_setup(name, B, Nk, jnp.float64,
                                                 seed=seed)
        model, tobj = _port(name, obj)
    else:
        jm, model, obj, tobj, x0j, Xj, Uj, dtj = _rig_setup(
            name, B, Nk, jnp.float64, seed=seed)
    X, U, dt = (torch.as_tensor(np.array(a)) for a in (Xj, Uj, dtj))
    one = torch.ones(B, dtype=torch.float64)
    K, d, dV1, dV2, fail = fused_backward(model, X, U, dt, tobj, one)
    assert not bool(fail.any())
    d = d.clone()
    d[DIVERGE] *= 1e5
    d[LATE] *= late
    J_prev = total_cost(tobj, X, U, dt)
    J_prev[EXHAUST] = -1e30
    alpha0 = 0.5 ** (torch.arange(B) % 4).to(torch.float64)
    args = (model, X[:, 0], X, U, K, d, dV1, dV2, J_prev, one, one, alpha0,
            dt, tobj)
    return dict(jax=(jm, obj, x0j, Xj, Uj, dtj), args=args,
                cost=lambda Xc, Uc: total_cost(tobj, Xc, Uc, dt),
                serial=lambda opts: fused_forward(*args, opts))


def _common(s):
    """(model, x0, X, U, K, d, dV1, dV2, J_prev, ρ, δρ, α0, dt) of a
    search, whichever plain version it goes through."""
    a = s["args"]
    if len(a) == 17:      # fused_al_forward's: the stack, λ and μ too
        return a[:1] + a[2:13] + a[15:16]
    return a[:13]


def _rounds(s, ls_iters, W):
    """The search as K4 and K7b run it: candidates j = 0 … ls_iters, each
    on its own, W to a round; per problem the lowest accepted j of the
    first round that has one, else the restore and the ρ bump."""
    (model, x0, X, U, K, d, dV1, dV2, J_prev, rho, drho, alpha0,
     dt) = _common(s)
    Xo, Uo, J = X.clone(), U.clone(), J_prev.clone()
    alpha_used = torch.zeros_like(alpha0)
    done = torch.zeros(B, dtype=torch.bool)
    alphas = [alpha0]
    for _ in range(ls_iters):
        alphas.append(alphas[-1] * 0.5)
    for r in range(0, ls_iters + 1, W):
        for j in range(r, min(r + W, ls_iters + 1)):
            Xc, Uc, ok = rollout_closed_loop(
                model, x0, X, U, K, d, alphas[j], dt,
                max_state_value=MAX_VALUE, max_control_value=MAX_VALUE)
            Jc = s["cost"](Xc, Uc)
            expected = -alphas[j] * (dV1 + alphas[j] * dV2)
            z = torch.where(expected > 0.0, (J_prev - Jc) / expected,
                            -torch.ones_like(Jc))
            take = ok & ~(((z <= LB) | (z > UB)) & (Jc >= J_prev)) & ~done
            Xo, Uo = where_rows(take, Xc, Xo), where_rows(take, Uc, Uo)
            J = torch.where(take, Jc, J)
            alpha_used = torch.where(take, alphas[j] / 2.0 * 2.0, alpha_used)
            done = done | take      # a later j of the round never wins
    rho_o, drho_o = reg_increase(rho, drho, REG_FACTOR, REG_MIN)
    rho = torch.where(done, rho, rho_o + REG_FP)
    drho = torch.where(done, drho, drho_o)
    return Xo, Uo, J, rho, drho, alpha_used


def _serial(s, ls_iters):
    return s["serial"]((LB, UB, ls_iters, REG_MIN, REG_FACTOR, REG_FP))


# the maze's cases keep their ids of the AL search alone
CASES = [pytest.param(name, W, ls_iters, id=f"{W}-{ls_iters}"
                      if name == "maze" else f"{name}-{W}-{ls_iters}")
         for name in ("maze", *UNCONSTRAINED) for W in (1, 3, 8)
         for ls_iters in (20, 5)]


@pytest.mark.parametrize("name, W, ls_iters", CASES)
def test_rounds_equal_the_serial_search(searches, name, W, ls_iters):
    """(X̄, Ū, J, ρ, δρ, α_used) of the rounds bit for bit equal to the
    serial search's; the branch lanes take their branches (the blown-up
    lane's first candidate diverges and it accepts a later one or runs out,
    the other runs out and is restored), and one accepts its fourth
    candidate, past the first round of three."""
    s = searches[name]
    mine, ref = _rounds(s, ls_iters, W), _serial(s, ls_iters)
    for a, b in zip(mine, ref):
        assert torch.equal(a, b)
    model, x0, X, U, K, d, *_, alpha0, dt = _common(s)
    alpha = ref[5]
    ok0 = rollout_closed_loop(model, x0, X, U, K, d, alpha0, dt)[2]
    assert not bool(ok0[DIVERGE])
    assert float(alpha[DIVERGE]) < float(alpha0[DIVERGE])
    assert float(alpha[EXHAUST]) == 0.0 and float(ref[3][EXHAUST]) > 10.0
    assert torch.equal(ref[0][EXHAUST], X[EXHAUST])
    j = torch.log2(alpha0 / alpha.clamp(min=1e-300)).round()
    assert float(alpha[LATE]) > 0.0 and int(j[LATE]) == 3


def test_rounds_match_the_jax_forward_pass(search):
    """The rounds at W = 8 and 20 iterations (iLQROptions' default) against
    vmap of the JAX package's ``forward_pass`` under the AL cost of
    ``al_cost_fns`` on the same numpy inputs, float64: α, ρ and δρ equal,
    J at rtol 1e-10, X̄ and Ū at 1e-9 (tests/test_torch_al_fused.py's
    bars)."""
    pj, data, args = search["pj"], search["data"], search["args"]
    Xn, Un, J, rho, drho, alpha = _rounds(search, 20, 8)
    K, d, v1, v2, J_prev, alpha0 = (args[i].numpy()
                                    for i in (5, 6, 7, 8, 9, 12))
    jdt, cs = pj.dt_traj(), pj.constraints
    jin = {k: jnp.asarray(v) for k, v in data.items()}

    def fp_one(x0_, X_, U_, K_, d_, v1_, v2_, J_, a0_, lam_, mu_):
        cost_fn, _ = jax_al_cost_fns(pj.obj, cs, jdt, lam_, mu_, 0.0)
        return jax_forward_pass(pj.model, cost_fn, x0_, X_, U_, K_, d_, v1_,
                                v2_, J_, jnp.ones(()), jnp.ones(()), jdt,
                                JaxILQROptions(), alpha0=a0_)

    ref = jax.vmap(fp_one)(
        jin["X"][:, 0], jin["X"], jin["U"], jnp.asarray(K), jnp.asarray(d),
        jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(J_prev),
        jnp.asarray(alpha0), jin["lam"], jin["mu"])
    Xr, Ur, Jr, rhor, drhor, alphar = (np.asarray(a) for a in ref)
    assert alpha.tolist() == alphar.tolist()
    assert rho.tolist() == rhor.tolist() and drho.tolist() == drhor.tolist()
    assert alphar[EXHAUST] == 0.0
    np.testing.assert_allclose(J.numpy(), Jr, rtol=1e-10)
    np.testing.assert_allclose(Xn.numpy(), Xr, rtol=0, atol=1e-9)
    np.testing.assert_allclose(Un.numpy(), Ur, rtol=0, atol=1e-9)


def test_unconstrained_rounds_match_the_jax_forward_pass(searches):
    """The unconstrained quadrotor's rounds at W = 8 and 20 iterations
    against vmap of the JAX package's ``forward_pass`` under the
    objective's cost on the same numpy inputs, float64: α, ρ and δρ equal,
    J at rtol 1e-10, X̄ and Ū at 1e-9 (tests/test_torch_fused.py's bars)."""
    s = searches["quadrotor"]
    Xn, Un, J, rho, drho, alpha = _rounds(s, 20, 8)
    jm, obj, x0j, Xj, Uj, dtj = s["jax"]
    K, d, v1, v2, J_prev, alpha0 = (s["args"][i].numpy()
                                    for i in (4, 5, 6, 7, 8, 11))
    ref = jax.vmap(lambda x0_, X_, U_, K_, d_, a_, b_, J_, a0_:
                   jax_forward_pass(jm, lambda Xc, Uc: obj.total(Xc, Uc, dtj),
                                    x0_, X_, U_, K_, d_, a_, b_, J_,
                                    jnp.ones(()), jnp.ones(()), dtj,
                                    JaxILQROptions(), alpha0=a0_))(
        x0j, Xj, Uj, jnp.asarray(K), jnp.asarray(d), jnp.asarray(v1),
        jnp.asarray(v2), jnp.asarray(J_prev), jnp.asarray(alpha0))
    Xr, Ur, Jr, rhor, drhor, alphar = (np.asarray(a) for a in ref)
    assert alpha.tolist() == alphar.tolist()
    assert rho.tolist() == rhor.tolist() and drho.tolist() == drhor.tolist()
    assert alphar[EXHAUST] == 0.0 and alphar[DIVERGE] < 1.0
    np.testing.assert_allclose(J.numpy(), Jr, rtol=1e-10)
    np.testing.assert_allclose(Xn.numpy(), Xr, rtol=0, atol=1e-9)
    np.testing.assert_allclose(Un.numpy(), Ur, rtol=0, atol=1e-9)
