"""The analytic double pendulum and acrobot on the card's path, on the CPU in
float64.

The JAX package gives the two models no lane step (``step_lanes``), so it
solves them unfused; the port's rollout kernel K2 carries their RK3 steps
(``csrc/models.cuh`` ``TwoLink``) under ``k2_only`` entries that no fused
kernel takes. Held here: the entries and the fused rules' no on either
package's side; the plain version of K2 (``rollout_closed_loop``) on both
models, with and without slacks, against the JAX package's rollout at
1e-12; and a phase-split ``al_solve`` of each zoo problem cut to N = 21 at
its dt of 0.01 against the JAX package's (J at rtol 1e-8, X within 1e-6),
with ``fused=True`` the same computation. The kernels themselves are held
to the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.ops.rollout import rollout_closed_loop as jax_rollout_cl
from trajopt_tpu.solvers import altro as jalt

import trajopt_tpu_torch as tt
from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.ops.cuda_models import cuda_model, find_cuda_model
from trajopt_tpu_torch.ops.rollout import rollout_closed_loop
from trajopt_tpu_torch.solvers import altro as alt
from trajopt_tpu_torch.solvers.ilqr import (
    _fused_al_eligible, _fused_eligible, iLQROptions,
)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

NAMES = ("doublependulum", "acrobot")
N_CUT = 21
# the acrobot's AL depth at N_CUT (42 inner iterations in both packages)
ACROBOT_OUTER = 5


def _problem(lib, name, N=N_CUT, **kw):
    """``problems.zoo``'s two-link swing-up (from hanging down to upright,
    dt = 0.01, U0 = 1, the acrobot with its goal constraint) at N knots,
    for either package."""
    zoo_ = zoo if lib is tt else jzoo
    model_d = lib.discretize(getattr(zoo_, name), "rk3")
    n, m = 4, model_d.m
    xf = np.array([np.pi, 0.0, 0.0, 0.0])
    obj = lib.LQRObjective(np.eye(n) * 1e-2, np.eye(m) * 1e-2,
                           np.eye(n) * 100.0, xf, N, **kw)
    cons = None
    if name == "acrobot":
        cons = lib.ConstraintSetBuilder(N)
        cons.add(lib.goal_constraint(xf))
    return lib.problem(model_d, obj, constraints=cons, x0=np.zeros(n),
                       xf=xf, N=N, dt=0.01, U0=np.ones((N - 1, m)), **kw)


@pytest.mark.parametrize("name", NAMES)
def test_two_link_models_have_k2_only_entries(name):
    """``discretize(.., "rk3")`` names the CUDA step; the entry and its
    slack and minimum-time forms are K2-only; the fused rules say no on
    either device's side, as the JAX package has no lane step for them."""
    jm = jtt.discretize(getattr(jzoo, name), "rk3")
    assert getattr(jm, "step_lanes", None) is None
    md = tt.discretize(zoo.MODELS[name], "rk3")
    assert md.cuda_step == f"{name}_rk3"
    cm = cuda_model(md, "test", slack_ok=True, k2_only_ok=True)
    assert cm.label == name and cm.k2_only and (cm.n, cm.m) == (4, md.m)
    assert find_cuda_model(md, slack_ok=True) is None
    with pytest.raises(NotImplementedError, match="no lane step"):
        cuda_model(md, "test", slack_ok=True)
    pt = _problem(tt, name, device="cpu")
    fused = iLQROptions(fused=True)
    assert not _fused_eligible(pt.model, fused, pt.obj)
    assert not _fused_eligible(pt.model, fused, pt.obj,
                               like=torch.zeros(1, dtype=torch.float32))
    assert not _fused_al_eligible(pt.model, fused, None)
    for slack in (False, True):
        p = alt.infeasible_problem(pt) if slack else pt
        pm = alt.minimum_time_problem(p)
        for q, label in ((p, name), (pm, name)):
            c = cuda_model(q.model, "test", slack_ok=True, k2_only_ok=True)
            want = label + ("_slack" if slack else "") \
                + ("_mintime" if q is pm else "")
            assert c.label == want and c.k2_only
            assert (c.n, c.m) == (q.model.n, q.model.m)


@pytest.mark.parametrize("slack", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_rollout_plain_version_matches_jax(name, slack):
    """K2's plain version on the model (with the infeasible-start slacks if
    ``slack``) for four starts with random gains, against the JAX package's
    rollout one problem at a time, at 1e-12 of scale."""
    pj, pt = _problem(jtt, name), _problem(tt, name, device="cpu")
    if slack:
        pj, pt = jalt.infeasible_problem(pj), alt.infeasible_problem(pt)
    n, m, N, Bz = pt.n, pt.m, pt.N, 4
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(Bz, n)) * 0.1
    # the problems have no state seed: X is NaN past x0, and the slack seed
    # with it; the slacks start at 0
    X = np.nan_to_num(np.asarray(pj.X))[None].repeat(Bz, 0) + rng.normal(
        size=(Bz, N, n)) * 0.01
    U0 = np.asarray(pj.U).copy()
    U0[:, zoo.MODELS[name].m:] = 0.0
    U = U0[None].repeat(Bz, 0) + rng.normal(size=(Bz, N - 1, m)) * 0.01
    K = rng.normal(size=(Bz, N - 1, m, n)) * 0.05
    d = rng.normal(size=(Bz, N - 1, m)) * 0.05
    alpha = np.array([1.0, 0.5, 0.25, 1.0])
    Xt, Ut, okt = rollout_closed_loop(
        pt.model, *(torch.tensor(a) for a in (x0, X, U, K, d, alpha)), pt.dt)
    for b in range(Bz):
        Xj, Uj, okj = jax_rollout_cl(
            pj.model, *(jnp.asarray(a[b]) for a in (x0, X, U, K, d)),
            float(alpha[b]), pj.dt)
        scale = max(1.0, float(np.abs(np.asarray(Xj)).max()))
        assert np.abs(Xt[b].numpy() - np.asarray(Xj)).max() <= 1e-12 * scale
        assert np.abs(Ut[b].numpy() - np.asarray(Uj)).max() <= 1e-12 * max(
            1.0, float(np.abs(np.asarray(Uj)).max()))
        assert bool(okt[b]) and bool(okj)


@pytest.mark.parametrize("name", NAMES)
def test_al_solve_phase_split_matches_jax(name):
    """``al_solve`` with ``ALOptions()`` on the zoo problem cut to N = 21
    (dt kept at 0.01): the port's phase-split solve (the plain versions of
    K5 and K2 here) against the JAX package's unfused one: the same outer
    and inner iteration counts, J at rtol 1e-8, X within 1e-6, c_max within
    1e-6; ``fused=True`` is the same computation (no fused kernel takes the
    model). The acrobot is cut to ACROBOT_OUTER outer iterations: in 0.2 s
    it cannot reach its goal, and the full depth climbs the penalty through
    30 outer iterations of up to 300 inner ones (minutes on a CPU core)."""
    pj, pt = _problem(jtt, name), _problem(tt, name, device="cpu")
    outer = ACROBOT_OUTER if name == "acrobot" else 30
    rj = jtt.al_solve(pj, jtt.ALOptions(iterations=outer))
    rt = tt.al_solve(pt, tt.ALOptions(iterations=outer))
    assert int(rt.iterations) == int(rj.iterations)
    assert int(rt.iterations_total) == int(rj.iterations_total)
    np.testing.assert_allclose(float(rt.J), float(rj.J), rtol=1e-8)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=1e-6)
    np.testing.assert_allclose(float(rt.c_max), float(rj.c_max), atol=1e-6)
    rf = tt.al_solve(pt, tt.ALOptions(iterations=outer,
                                      opts_uncon=iLQROptions(fused=True)))
    np.testing.assert_array_equal(rf.X.numpy(), rt.X.numpy())
