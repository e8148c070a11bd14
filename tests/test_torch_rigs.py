"""The two-link models and rigs against the JAX package, on the CPU.

- The analytic double pendulum and acrobot (``models/zoo.py``) against
  ``trajopt_tpu.models.zoo`` in float64 at 1e-12, and the URDF rigs of
  ``models/robots.py`` against them (``tests/test_robust.py:72-91`` holds
  the JAX package's rigs to its analytic models the same way);
- ``doublependulum_problem`` and ``acrobot_problem`` against the JAX
  problems carried over as arrays;
- the plain versions of the fused kernels K7a and K7b
  (``ops/cuda_fused.py``) on the rigs ``doublependulum_urdf`` (``Chain<2,2>``)
  and ``cartpole_urdf`` (``Chain<2,1>``, a prismatic slider) against the
  Pallas TPU kernels ``fused_backward_pallas`` and ``fused_forward_pallas``
  in interpret mode, float32, B = 128 (a lane tile), N = 11, each rig at its
  zoo problem's dt, at the bars of ``tests/test_torch_fused.py`` (K and d at
  1e-3 of scale, ΔV at 1e-4; α, ρ and dρ equal, X̄ at 1e-5 of scale, J at
  1e-4).

The CUDA kernels themselves are compared with the plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as tt_jax
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.ops.pallas_fused import (
    fused_backward_pallas, fused_forward_pallas,
)
from trajopt_tpu.ops.rollout import rollout as jax_rollout
from trajopt_tpu.problems import zoo as jproblems

from trajopt_tpu_torch import convert
from trajopt_tpu_torch.models import robots, zoo
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.ops.cost import Objective
from trajopt_tpu_torch.ops.cuda_fused import (
    fused_backward_cuda, fused_forward_cuda,
)
from trajopt_tpu_torch.ops.cuda_models import CHAIN_LABELS, cuda_model
from trajopt_tpu_torch.ops.rollout import rollout, rollout_closed_loop
from trajopt_tpu_torch.problems import zoo as problems
from trajopt_tpu_torch.solvers.ilqr import _line_search_opts, iLQROptions

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

OBJ_FIELDS = ("Q", "R", "H", "q", "r", "c")
LS_OPTS = _line_search_opts(iLQROptions())
# each rig's zoo problem: its goal, control weight, dt and control seed
RIGS = dict(
    doublependulum_urdf=(np.array([np.pi, 0.0, 0.0, 0.0]), 1e-2, 0.01, 1.0),
    acrobot_urdf=(np.array([np.pi, 0.0, 0.0, 0.0]), 1e-2, 0.01, 1.0),
    cartpole_urdf=(np.array([0.0, np.pi, 0.0, 0.0]), 1e-1, 0.05, 0.01))


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ------------------------------------------------------- models, problems

@pytest.mark.parametrize("name,rig", [("doublependulum",
                                       "doublependulum_urdf"),
                                      ("acrobot", "acrobot_urdf")])
def test_two_link_dynamics_match_jax_and_the_rigs(name, rig):
    """The analytic model against the JAX package's at 1e-12, float64 in
    and float32 in, float32 out; the URDF rig of the same mechanism (the
    acrobot's with the elbow actuated) against it at 1e-12 of scale, as
    the JAX package's rigs equal its analytic models. The JAX package
    gives the analytic models no lane step; K2 alone carries them here,
    under a ``k2_only`` entry that no fused kernel takes."""
    rng = np.random.default_rng(3)
    m = zoo.MODELS[name]
    x = rng.normal(size=(32, 4)) * 2.0
    u = rng.normal(size=(32, m.m)) * 5.0
    ref = np.stack([np.asarray(getattr(jzoo, name)(jnp.asarray(a),
                                                   jnp.asarray(b)))
                    for a, b in zip(x, u)])
    mine = m(_t(x), _t(u))
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=1e-12)
    f32 = m(_t(x, torch.float32), _t(u, torch.float32))
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), ref, rtol=1e-4, atol=1e-3)
    chain = zoo.MODELS[rig](_t(x), _t(u)).numpy()
    assert np.abs(chain - ref).max() < 1e-12 * np.abs(ref).max()
    # no lane step in the JAX package; K2's k2_only entry here
    assert getattr(tt_jax.discretize(getattr(jzoo, name), "rk3"),
                   "step_lanes", None) is None
    md = discretize(m, "rk3")
    assert md.cuda_step == f"{name}_rk3"
    cm = cuda_model(md, "test", k2_only_ok=True)
    assert cm.label == name and cm.k2_only and (cm.n, cm.m) == (4, m.m)


@pytest.mark.parametrize("rig", ["acrobot_urdf", "doublependulum_urdf",
                                 "cartpole_urdf"])
def test_rigs_carry_a_cuda_step(rig):
    """The three rigs are chains the kernels carry under RK3, as the JAX
    package attaches a lane step to every chain; the table they hand the
    kernels is the one of their model."""
    jm = tt_jax.discretize(getattr(jrobots, f"{rig}_model")(), "rk3")
    assert getattr(jm, "step_lanes", None) is not None
    md = discretize(zoo.MODELS[rig], "rk3")
    cm = cuda_model(md, "test", slack_ok=True)
    assert cm.label == rig and cm.label in CHAIN_LABELS
    assert (cm.n, cm.m) == (md.n, md.m) == (jm.n, jm.m)
    assert int(md.chain_table[-1]) == md.m and int(md.chain_table[-2]) == 2


@pytest.mark.parametrize("name", ["doublependulum", "acrobot"])
def test_two_link_problem_matches_jax(name):
    """The port's factory equals the JAX problem carried over as arrays:
    seeds, objective stacks, times, and the constraint set (mask and its
    values on a random trajectory at 1e-12)."""
    pj = jproblems.PROBLEMS[name](dtype=jnp.float64)
    carried = convert.problem_from_arrays(**convert.problem_arrays(pj),
                                          device="cpu")
    mine = convert.PROBLEMS[name](device="cpu")
    assert mine.model.name == carried.model.name == name
    assert (mine.N, mine.n, mine.m) == (carried.N, 4, pj.model.m)
    assert abs(mine.dt - carried.dt) < 1e-15
    for field in ("x0", "xf", "X", "U"):
        a, b = getattr(mine, field).numpy(), np.asarray(getattr(pj, field))
        assert np.array_equal(np.isnan(a), np.isnan(b)), field
        np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b))
        np.testing.assert_array_equal(
            np.nan_to_num(a), np.nan_to_num(getattr(carried, field).numpy()))
    for field in OBJ_FIELDS:
        np.testing.assert_array_equal(getattr(mine.obj, field).numpy(),
                                      np.asarray(getattr(pj.obj, field)))
    rng = np.random.default_rng(4)
    X = rng.normal(size=(mine.N, 4))
    U = rng.normal(size=(mine.N - 1, mine.m))
    cj = pj.constraints
    assert mine.constraints.P == cj.P
    assert np.array_equal(mine.constraints.mask.numpy(), np.asarray(cj.mask))
    if cj.P:
        np.testing.assert_allclose(
            mine.constraints.evaluate(_t(X), _t(U)).numpy(),
            np.asarray(cj.evaluate(jnp.asarray(X), jnp.asarray(U))),
            rtol=0, atol=1e-12)


@pytest.mark.parametrize("rig", ["acrobot_urdf", "doublependulum_urdf",
                                 "cartpole_urdf"])
def test_rig_problem_is_the_zoo_problem_with_the_rig(rig):
    """``problems.zoo.rig_problem`` is the rig's zoo problem with the model
    replaced, as the JAX package builds it (``update_problem(prob,
    model=discretize(rig, "rk3"))``): the same arrays, and a rollout of the
    seed from a perturbed start over the whole horizon at 1e-10 of scale
    (the two packages' rounding grows along the cartpole rig's 100 steps
    to 9e-12 of scale)."""
    factory = dict(acrobot_urdf="acrobot_problem",
                   doublependulum_urdf="doublependulum_problem",
                   cartpole_urdf="cartpole")[rig]
    jp = getattr(jproblems, factory)(dtype=jnp.float64)
    jp = tt_jax.update_problem(jp, model=tt_jax.discretize(
        getattr(jrobots, f"{rig}_model")(), "rk3"))
    mine = problems.rig_problem(rig, device="cpu")
    assert mine.model.name == rig and mine.model.cuda_step == f"{rig}_rk3"
    assert (mine.N, mine.n, mine.m) == (jp.N, jp.model.n, jp.model.m)
    assert mine.constraints.P == jp.constraints.P
    for field in ("x0", "xf", "U"):
        np.testing.assert_array_equal(getattr(mine, field).numpy(),
                                      np.asarray(getattr(jp, field)))
    x0 = np.asarray(jp.x0) + np.random.default_rng(2).normal(size=4) * 0.02
    dt = jnp.full((jp.N - 1,), jp.dt)
    ref = np.asarray(jax_rollout(jp.model, jnp.asarray(x0), jp.U, dt))
    X = rollout(mine.model, _t(x0)[None], mine.U[None], mine.dt_traj())[0]
    assert np.abs(X.numpy() - ref).max() < 1e-10 * np.abs(ref).max()


# ---------------------------------------- K7a and K7b's plain versions

def _setup(rig, batch, N, jdtype, seed=0):
    """The rig's zoo objective cut to N knots, starts with 0.02 noise on
    every state entry, the zoo control seed plus 0.1 noise and the open-loop
    rollouts, by the JAX package."""
    xf, R, dt, u0 = RIGS[rig]
    jm = tt_jax.discretize(getattr(jrobots, f"{rig}_model")(), "rk3")
    n, m = jm.n, jm.m
    obj = tt_jax.LQRObjective(np.eye(n) * 1e-2, np.eye(m) * R,
                              np.eye(n) * 100.0, xf, N)
    obj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype), obj)
    rng = np.random.default_rng(seed)
    x0j = jnp.asarray(rng.normal(size=(batch, n)) * 0.02, jdtype)
    U = jnp.asarray(rng.normal(size=(batch, N - 1, m)) * 0.1 + u0, jdtype)
    dt_traj = jnp.full((N - 1,), dt, jdtype)
    X = jax.vmap(lambda a, b: jax_rollout(jm, a, b, dt_traj))(x0j, U)
    md = discretize(zoo.MODELS[rig], "rk3")
    tobj = Objective(**{k: _t(getattr(obj, k)) for k in OBJ_FIELDS})
    return jm, md, obj, tobj, x0j, X, U, dt_traj


def _rel(mine, ref):
    ref = np.asarray(ref)
    return np.abs(mine.numpy() - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("rig", ["doublependulum_urdf", "cartpole_urdf"])
def test_fused_backward_on_a_rig_matches_pallas_interpret_f32(rig):
    """No failure on either side; K and d within 1e-3 of scale, ΔV within
    1e-4; the chain's Jacobians come from ``jax.linearize`` of its lane
    step in the Pallas kernel and from its structured linearization here."""
    Bz, N = 128, 11
    jm, md, obj, tobj, _, X, U, dt_traj = _setup(rig, Bz, N, jnp.float32)
    rho = jnp.ones((Bz,), jnp.float32)
    Kr, dr, v1r, v2r, failr = fused_backward_pallas(
        jm.step_lanes, X, U, dt_traj, obj, rho, interpret=True)
    K, d, v1, v2, fail = fused_backward_cuda(md, _t(X), _t(U), _t(dt_traj),
                                             tobj, _t(rho))
    assert K.dtype == torch.float32 and K.shape == (Bz, N - 1, md.m, md.n)
    assert not bool(np.asarray(failr).any()) and not bool(fail.any())
    assert _rel(K, Kr) < 1e-3 and _rel(d, dr) < 1e-3
    assert _rel(v1, v1r) < 1e-4 and _rel(v2, v2r) < 1e-4


@pytest.mark.parametrize("rig", ["doublependulum_urdf", "cartpole_urdf"])
def test_fused_forward_on_a_rig_matches_pallas_interpret_f32(rig):
    """Problem 1's feedforward blown up (its first candidates diverge),
    problem 2 given a cost no candidate can beat (its search runs out):
    α, ρ and dρ equal on every problem, X̄ within 1e-5 of scale and J
    within 1e-4 on the others."""
    Bz, N = 128, 11
    jm, md, obj, tobj, x0j, X, U, dt_traj = _setup(rig, Bz, N, jnp.float32,
                                                   seed=2)
    K, d, v1, v2, fail = fused_backward_cuda(
        md, _t(X), _t(U), _t(dt_traj), tobj, torch.ones(Bz))
    assert not bool(fail.any())
    d = d.clone()
    d[1] *= 1e5
    ok = rollout_closed_loop(md, _t(x0j), _t(X), _t(U), K, d,
                             torch.ones(Bz), float(dt_traj[0]))[2]
    assert not bool(ok[1]) and int(ok.sum()) == Bz - 1
    J_prev = np.array(jax.vmap(lambda a, b: obj.total(a, b, dt_traj))(X, U))
    J_prev[2] = -1e30
    one = jnp.ones((Bz,), jnp.float32)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    Xr, Ur, Jr, rhor, drhor, alphar = fused_forward_pallas(
        jm.step_lanes, None, x0j, X, U, j(K), j(d), j(v1), j(v2),
        jnp.asarray(J_prev), one, one, one, dt_traj, obj, LS_OPTS,
        interpret=True)
    Xn, Un, J, rho, drho, alpha = fused_forward_cuda(
        md, _t(x0j), _t(X), _t(U), K, d, v1, v2, _t(J_prev), _t(one),
        _t(one), None, _t(dt_traj), tobj, LS_OPTS)
    assert alpha.tolist() == np.asarray(alphar).tolist()
    assert rho.tolist() == np.asarray(rhor).tolist()
    assert drho.tolist() == np.asarray(drhor).tolist()
    assert 0.0 < float(alpha[1]) < 1.0
    assert float(alpha[2]) == 0.0 and float(rho[2]) > 10.0
    assert np.array_equal(Xn[2].numpy(), np.asarray(X)[2])
    calm = np.ones(Bz, bool)
    calm[1] = False      # follows a 1e5 x feedforward
    Xr, Jr = np.asarray(Xr), np.asarray(Jr)
    assert np.abs(Xn.numpy() - Xr)[calm].max() < 1e-5 * max(
        1.0, np.abs(Xr[calm]).max())
    assert np.abs(J.numpy() - Jr)[calm].max() < 1e-4 * np.abs(Jr[calm]).max()


def test_kuka_model_still_carries_its_table():
    """The rigs' ids come after kuka's: kuka keeps id 5, the slack offset
    moved past the rigs."""
    md = discretize(robots.kuka_model(), "rk3")
    assert cuda_model(md, "test").id == 5
    ids = sorted(cuda_model(discretize(zoo.MODELS[r], "rk3"), "test").id
                 for r in RIGS)
    assert ids == [6, 7, 8]
