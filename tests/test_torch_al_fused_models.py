"""The plain versions of the fused AL kernels K3 and K4 for the models beside
the quadrotor, against the Pallas TPU kernels in interpret mode, on the CPU.

``ops/cuda_al_fused.py::fused_al_backward`` and ``fused_al_forward`` are
model-generic; the CUDA kernels they stand for are instantiated for every
model with a CUDA step, with and without the slack controls of the
infeasible-start transform. Here the plain versions run in float32 on small
constrained problems of the car (three circles, control box, goal), the
slack-augmented car, the cartpole and the pendulum (control box, goal)
against ``fused_al_backward_pallas`` / ``fused_al_forward_pallas`` run as
tests/test_fused_al.py:237-316 runs them: B = 128 (one lane tile), exercised
duals (λ in [0, 0.5], μ in [0.5, 20], masked). Tolerances are that file's:
K and d at 2e-3 of scale, ΔV1 at 1e-3; the accepted step α equal on at least
0.97 of the problems, and on those J at 1e-3 and X̄ at 1e-4 of scale. The
CUDA kernels themselves are held to the plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.ops.canonical import canonical_stack as jax_canonical_stack
from trajopt_tpu.ops.pallas_al_fused import (
    fused_al_backward_pallas, fused_al_forward_pallas,
)
from trajopt_tpu.solvers.al import al_cost_fns as jax_al_cost_fns
from trajopt_tpu.solvers.altro import infeasible_problem as jax_infeasible
from trajopt_tpu.utils.interp import line_trajectory

from trajopt_tpu_torch import convert
from trajopt_tpu_torch.ops.canonical import canonical_stack
from trajopt_tpu_torch.ops.cuda_al_fused import (
    cuda_model_supported, fused_al_backward_cuda, fused_al_forward_cuda,
)
from trajopt_tpu_torch.ops.cuda_models import CUDA_MODELS, cuda_model
from trajopt_tpu_torch.solvers.altro import infeasible_problem
from trajopt_tpu_torch.solvers.ilqr import iLQROptions

torch.set_num_threads(1)

B, N = 128, 9
LS_OPTS = (1e-8, 10.0, 20, 1e-8, 1.6, 10.0)     # iLQROptions' defaults
CASES = ("car", "car_slack", "cartpole", "pendulum")


def _jax_problem(case):
    """A small float32 problem of the JAX package: the car drives 1 m past
    three circles (R_inf = 1e-1 with slacks, as car_escape is solved), the
    cartpole and the pendulum swing up under a control box."""
    name = case.split("_")[0]
    dyn = dict(car=jzoo.car, cartpole=jzoo.cartpole,
               pendulum=jzoo.pendulum)[name]
    model_d = jtt.discretize(dyn, "rk3")
    n, m = model_d.n, model_d.m
    xf = dict(car=[1.0, 1.0, 0.0], cartpole=[0.0, np.pi, 0.0, 0.0],
              pendulum=[np.pi, 0.0])[name]
    xf = np.asarray(xf)
    obj = jtt.LQRObjective(np.eye(n) * 1e-2, np.eye(m) * 1e-1,
                           np.eye(n) * 10.0, xf, N)
    cons = jtt.ConstraintSetBuilder(N)
    cons.add(jtt.bound_constraint(n, m, u_min=-3.0, u_max=3.0))
    if name == "car":
        cons.add(jtt.obstacle_field_constraint(
            [(0.25, 0.25, 0.1), (0.5, 0.5, 0.1), (0.75, 0.75, 0.1)],
            label="obs"), knots=range(1, N - 1))
    cons.add(jtt.goal_constraint(xf))
    prob = jtt.problem(model_d, obj, constraints=cons, x0=np.zeros(n), xf=xf,
                       N=N, dt=0.1, U0=np.full((N - 1, m), 0.3),
                       dtype=jnp.float32)
    if case.endswith("_slack"):
        prob = jtt.initial_states(prob, line_trajectory(np.zeros(n), xf, N))
    return prob


def _setup(case, seed=11):
    """The problem in both packages (after the infeasible-start transform
    for a ``_slack`` case) and a batch of kernel inputs as numpy arrays."""
    base = _jax_problem(case)
    pt = convert.problem_from_arrays(**convert.problem_arrays(base),
                                     dtype=torch.float32, device="cpu")
    pj = base
    if case.endswith("_slack"):
        pj, pt = jax_infeasible(base, 1e-1), infeasible_problem(pt, 1e-1)
    n, m, P = pj.model.n, pj.model.m, pj.constraints.P
    rng = np.random.default_rng(seed)
    mask = np.asarray(pj.constraints.mask)
    x0s = np.asarray(pj.x0)[None] + rng.normal(size=(B, n)) * 0.05
    if case.endswith("_slack"):
        X = np.asarray(pj.X)[None] + rng.normal(size=(B, N, n)) * 0.05
    else:
        X = x0s[:, None, :] + rng.normal(size=(B, N, n)) * 0.1
    X[:, 0] = x0s
    data = dict(
        X=X, U=np.asarray(pj.U)[None] + rng.normal(size=(B, N - 1, m)) * 0.1,
        lam=rng.uniform(0.0, 0.5, size=(B, N, P)) * mask,
        mu=rng.uniform(0.5, 20.0, size=(B, N, P)) * mask)
    data = {k: v.astype(np.float32) for k, v in data.items()}
    return pj, pt, data


@pytest.fixture(scope="module", params=CASES)
def case(request):
    pj, pt, data = _setup(request.param)
    model = pj.model
    model_fns = (model.step_lanes, getattr(model, "base_step_lanes", None),
                 getattr(model, "slack_m", None))
    jcanon = jax_canonical_stack(pj.constraints, model.n, model.m,
                                 dtype=jnp.float32)
    jin = {k: jnp.asarray(v) for k, v in data.items()}
    # the Pallas backward kernel's gains feed both forward passes
    back = fused_al_backward_pallas(
        model_fns, jcanon, jin["X"], jin["U"], jin["lam"], jin["mu"],
        pj.dt_traj(), pj.obj, jnp.ones((B,), jnp.float32), interpret=True)
    canon = canonical_stack(pt.constraints, pt.model.n, pt.model.m,
                            dtype=torch.float32)
    tin = {k: torch.as_tensor(v) for k, v in data.items()}
    return dict(name=request.param, pj=pj, pt=pt, jcanon=jcanon, canon=canon,
                jin=jin, tin=tin, back=back)


def _assert_scaled(mine, ref, tol, floor=0.0):
    ref = np.asarray(ref)
    scale = max(floor, float(np.abs(ref).max()))
    assert np.abs(mine.numpy() - ref).max() <= tol * scale


def test_every_model_has_both_instantiations():
    """The kernels' table holds each of the six models (the five scalar
    ones and kuka) with and without slacks, with the widths the transform
    produces; the fused AL kernels take all twelve and refuse a model
    without a CUDA step."""
    assert len(CUDA_MODELS) == 12
    for (step, slack), cm in CUDA_MODELS.items():
        assert cm.m == cm.m_base + (cm.n if slack else 0)
        assert cm.label.endswith("_slack") == slack
    assert sorted(cm.id for cm in CUDA_MODELS.values()) == list(range(12))


def test_fused_al_eligibility_follows_the_table(case):
    """The transform's model (or the base model) is one the fused AL kernels
    carry, under the label the launch counts use."""
    model = case["pt"].model
    assert cuda_model_supported(model)
    cm = cuda_model(model, "test", slack_ok=True)
    assert cm.label == case["name"] and (cm.n, cm.m) == (model.n, model.m)


def test_fused_al_backward_matches_pallas_interpret_f32(case):
    """K3's plain version against the Pallas kernel in interpret mode,
    float32, ρ = 1: K at 2e-3 of scale, d at 2e-3 of max(1e-3, scale), ΔV1
    at 1e-3 of max(1e-6, scale) (tests/test_fused_al.py:261-267), no
    failure on either side."""
    pt, tin = case["pt"], case["tin"]
    Kr, dr, v1r, v2r, failr = case["back"]
    K, d, v1, v2, fail = fused_al_backward_cuda(
        pt.model, case["canon"], tin["X"], tin["U"], tin["lam"], tin["mu"],
        pt.dt_traj(), pt.obj, torch.ones(B))
    assert K.dtype == torch.float32
    assert K.shape == (B, N - 1, pt.model.m, pt.model.n)
    assert not bool(np.asarray(failr).any()) and not bool(fail.any())
    _assert_scaled(K, Kr, 2e-3)
    _assert_scaled(d, dr, 2e-3, floor=1e-3)
    _assert_scaled(v1, v1r, 1e-3, floor=1e-6)


def test_fused_al_forward_matches_pallas_interpret_f32(case):
    """K4's plain version against the Pallas kernel in interpret mode,
    float32, both fed the Pallas backward kernel's gains: the accepted step
    equal on more than 0.97 of the problems (float32 cost rounding can flip
    a borderline accept), and on those J at 1e-3 of max(1, |J|) and X̄ at
    1e-4 of max(1, |X|) (tests/test_fused_al.py:306-314)."""
    pj, pt, jin, tin = case["pj"], case["pt"], case["jin"], case["tin"]
    Kr, dr, v1r, v2r, _ = case["back"]
    jdt, cs = pj.dt_traj(), pj.constraints
    import jax

    def cost_one(Xi, Ui, lam_i, mu_i):
        return jax_al_cost_fns(pj.obj, cs, jdt, lam_i, mu_i, 0.0)[0](Xi, Ui)

    Jprev = jax.vmap(cost_one)(jin["X"], jin["U"], jin["lam"], jin["mu"])
    one = jnp.ones((B,), jnp.float32)
    Xf, Uf, Jf, rhof, drhof, alphaf = fused_al_forward_pallas(
        pj.model.step_lanes, case["jcanon"], jin["X"][:, 0], jin["X"],
        jin["U"], Kr, dr, v1r, v2r, Jprev, one, one, one, jin["lam"],
        jin["mu"], jdt, pj.obj, LS_OPTS, interpret=True)

    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    o = iLQROptions()
    assert LS_OPTS == (o.line_search_lower_bound, o.line_search_upper_bound,
                       o.iterations_linesearch, o.bp_reg_min,
                       o.bp_reg_increase_factor, o.bp_reg_fp)
    Xn, Un, J, rho, drho, alpha = fused_al_forward_cuda(
        pt.model, case["canon"], tin["X"][:, 0], tin["X"], tin["U"], t(Kr),
        t(dr), t(v1r), t(v2r), t(Jprev), torch.ones(B), torch.ones(B), None,
        tin["lam"], tin["mu"], pt.dt_traj(), pt.obj, LS_OPTS)
    same = alpha.numpy() == np.asarray(alphaf)
    assert same.mean() > 0.97
    Jr, Xr = np.asarray(Jf), np.asarray(Xf)
    assert np.abs(J.numpy() - Jr)[same].max() < 1e-3 * max(
        1.0, float(np.abs(Jr).max()))
    assert np.abs(Xn.numpy() - Xr)[same].max() < 1e-4 * max(
        1.0, float(np.abs(Xr).max()))
