"""Every integrator of the port against the JAX package, in float64, on the
scalar models: each rule's step (within 1e-12) and Jacobians A, B and
∂x⁺/∂dt (``tests/_torch_integrators.py``; the other scalar models in
``tests/test_torch_integrators_models.py`` and
``tests/test_torch_integrators_twolink.py``), the implicit Newton loop's
semantics (tests/test_core.py:431-468), a batch of problems against each
problem alone, and the pendulum's AL solve under rk3_implicit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.ops import integration as jint

import trajopt_tpu_torch as tt
from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.ops import integration as tint
from trajopt_tpu_torch.ops.cuda_models import (
    CUDA_MODELS, CUDA_STEPS, INTEGRATOR_IDS, cuda_model, find_cuda_model,
    with_integrator,
)

from _torch_integrators import (
    DT, RULES, central_differences, points, scale_close,
    steps_and_jacobians_match_jax,
)
from test_torch_integrators_solve import (
    al_solve_implicit_rule_meets_the_jax_outcome,
)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ("pendulum", "car", "doubleintegrator",
                                  "ballonbeam"))
def test_steps_and_jacobians_match_jax(name):
    steps_and_jacobians_match_jax(name)


def test_the_six_integrators():
    """``INTEGRATORS`` has the JAX package's six entries, exported from the
    package as the JAX package's are, and K2 carries each (an id each)."""
    assert set(tt.INTEGRATORS) == set(jtt.INTEGRATORS) == set(RULES)
    assert set(INTEGRATOR_IDS) == set(RULES)
    for rule in RULES:
        assert getattr(tt, rule) is tt.INTEGRATORS[rule]
    assert tint._IMPLICIT_MAX_ITERS == jint._IMPLICIT_MAX_ITERS == 1000


@pytest.mark.parametrize("rule", ("midpoint_implicit", "rk3_implicit"))
@pytest.mark.parametrize("name", ("pendulum", "cartpole", "quadrotor_euler",
                                  "acrobot"))
def test_implicit_jacobian_against_central_differences(name, rule):
    """The implicit-function-theorem Jacobian (x, u and dt columns) against
    central differences of the port's own converged step (h = 1e-6),
    within 1e-6 of scale."""
    x, u = (torch.as_tensor(a) for a in points(name, count=2, seed=2))
    md = tt.discretize(zoo.MODELS[name], rule)
    dt = torch.full((2,), DT, dtype=torch.float64)
    A, B, sdt = md._jac_dt(x, u, dt)
    FA, FB, Ft = central_differences(md.step, x, u, DT)
    for got, want in ((A, FA), (B, FB), (sdt, Ft)):
        scale_close(got.numpy(), want.numpy(), 1e-6)


def test_implicit_adaptive_tolerance():
    """tests/test_core.py:431-445: the heavily damped linear step
    y = x − 50·dt·(x + y)/2 converges to the dtype tolerance (more than the
    old fixed 20 trips' worth of stiffness), within 1e-10 of the exact
    y = x(1 − 25 dt)/(1 + 25 dt)."""
    f = lambda x, u: -50.0 * x  # noqa: E731
    y = tt.midpoint_implicit(f)(torch.tensor([1.0], dtype=torch.float64),
                                torch.zeros(1, dtype=torch.float64), 0.039)
    assert bool(torch.isfinite(y).all())
    exact = (1 - 25 * 0.039) / (1 + 25 * 0.039)
    assert abs(float(y[0]) - exact) < 1e-10


@pytest.mark.parametrize("rule", ("midpoint_implicit", "rk3_implicit"))
def test_implicit_nonconvergence_poisons(rule):
    """tests/test_core.py:448-468: the stiff arctan step from a far start
    does not converge and comes out NaN, as in the JAX package; a benign
    stiff step is left alone and is accurate. A batch holding both gives
    each its own outcome."""
    f = lambda x, u: -100.0 * torch.atan(x)  # noqa: E731
    jf = lambda x, u: -100.0 * jnp.arctan(x)  # noqa: E731
    u0 = torch.zeros(1, dtype=torch.float64)
    step = tt.INTEGRATORS[rule](f)
    y = step(torch.tensor([10.0], dtype=torch.float64), u0, 2.0)
    assert bool(torch.isnan(y).all())
    jy = jint.INTEGRATORS[rule](jf)(jnp.array([10.0]), jnp.zeros(1), 2.0)
    assert bool(jnp.all(jnp.isnan(jy)))
    g = lambda x, u: -x  # noqa: E731
    y_ok = tt.INTEGRATORS[rule](g)(torch.tensor([1.0], dtype=torch.float64),
                                   u0, 0.1)
    assert bool(torch.isfinite(y_ok).all())
    assert abs(float(y_ok[0]) - np.exp(-0.1)) < 1e-3
    both = step(torch.tensor([[10.0], [0.5]], dtype=torch.float64),
                torch.zeros(2, 1, dtype=torch.float64), 2.0)
    alone = step(torch.tensor([0.5], dtype=torch.float64), u0, 2.0)
    assert bool(torch.isnan(both[0]).all())
    assert torch.equal(both[1], alone)


def test_newton_loop_stops_at_the_abort_bound(monkeypatch):
    """A problem whose residual never meets its tolerance takes exactly
    ``_IMPLICIT_MAX_ITERS`` trips and is poisoned; a problem beside it
    that converges stops updating after its own few trips. The loop's
    passes and each problem's trips are counted from its residuals: a
    problem is active on a trip while its residual exceeds its tolerance
    (a stopped problem's residual is re-evaluated at the same y)."""
    inner = tint._newton_iterate
    actives = []

    def counted(x, residual_fn, newton_fn):
        tol = tint._implicit_tol(x)

        def residual(y):
            g = residual_fn(y)
            actives.append(torch.linalg.vector_norm(g, dim=-1) > tol)
            return g

        return inner(x, residual, newton_fn)

    monkeypatch.setattr(tint, "_newton_iterate", counted)
    x = torch.tensor([[10.0], [0.5]], dtype=torch.float64)
    y = tt.midpoint_implicit(lambda x, u: -100.0 * torch.atan(x))(
        x, torch.zeros(2, 1, dtype=torch.float64), 2.0)
    assert bool(torch.isnan(y[0]).all()) and bool(torch.isfinite(y[1]).all())
    # one residual before the loop and one a pass: 1000 passes
    assert len(actives) == tint._IMPLICIT_MAX_ITERS + 1
    trips = torch.stack(actives[:-1]).sum(0).tolist()
    assert trips[0] == tint._IMPLICIT_MAX_ITERS and 0 < trips[1] < 20


@pytest.mark.parametrize("rule", RULES)
def test_batch_is_each_problem_alone(rule):
    """A batch of problems gives each problem bit for bit what it gives
    alone: the Newton loop's tolerance, stop and solve are per problem."""
    x, u = (torch.as_tensor(a) for a in points("cartpole", count=5, seed=3))
    x[2] *= 8.0             # one far from the others: more Newton trips
    step = tt.discretize(zoo.cartpole, rule).step
    batch = step(x, u, DT)
    for i in range(5):
        assert torch.equal(batch[i], step(x[i], u[i], DT))
        assert torch.equal(batch[i], step(x[i:i + 1], u[i:i + 1], DT)[0])


@pytest.mark.parametrize("rule", RULES)
def test_every_rule_has_a_k2_entry(rule):
    """Every model under every rule finds its K2 entry (the RK3 entry's id
    and the rule's id), marked k2_only unless RK3, so the fused kernels and
    the fused paths' eligibility say no for it on either device; RK3's
    entries are the fused kernels' as before."""
    for name in zoo.MODELS:
        if zoo.MODELS[name].r:
            continue
        md = tt.discretize(zoo.MODELS[name], rule)
        cm = cuda_model(md, "test", slack_ok=True, k2_only_ok=True)
        rk3 = cuda_model(tt.discretize(zoo.MODELS[name], "rk3"), "test",
                         slack_ok=True, k2_only_ok=True)
        assert cm.id == rk3.id and cm.integrator == INTEGRATOR_IDS[rule]
        assert md.cuda_step == name
        if rule == "rk3":
            assert cm == rk3
        else:
            assert cm.k2_only and cm.label == f"{rk3.label}_under_{rule}"
            assert find_cuda_model(md, slack_ok=True) is None
            with pytest.raises(NotImplementedError, match="no lane step"):
                cuda_model(md, "test", slack_ok=True)


def test_every_form_under_every_rule_has_a_label_of_its_own():
    """The launch counts and the kernels' report are keyed by the label, so
    no two of K2's forms under any two rules share one: the quadrotor under
    Euler's rule is not the Euler-angle quadrotor under RK3."""
    labels = [with_integrator(cm, rule).label
              for cm in CUDA_MODELS.values() for rule in INTEGRATOR_IDS]
    assert len(set(labels)) == len(labels) == 52 * 6
    assert with_integrator(CUDA_STEPS["quadrotor"], "euler").label \
        == "quadrotor_under_euler" != CUDA_STEPS["quadrotor_euler"].label


def test_al_solve_rk3_implicit_meets_the_jax_outcome():
    """``tests/test_torch_integrators_solve.py``: the pendulum's whole AL
    solve under rk3_implicit, judged by outcome."""
    al_solve_implicit_rule_meets_the_jax_outcome("rk3_implicit")


@pytest.mark.parametrize("rule", RULES)
def test_convert_carries_every_integrator(rule):
    """``convert.problem_from_arrays`` carries a JAX problem under each rule
    across: the port's model is the same model under the same rule, and
    its step matches the JAX package's."""
    from trajopt_tpu_torch import convert

    pj = jtt.problem(jtt.discretize(jzoo.pendulum, rule), jtt.LQRObjective(
        np.eye(2), np.eye(1), np.eye(2), np.zeros(2), 5), x0=np.ones(2),
        N=5, dt=0.1)
    pt = convert.problem_from_arrays(**convert.problem_arrays(pj),
                                     device="cpu")
    assert (pt.model.name, pt.model.integrator) == ("pendulum", rule)
    x, u = points("pendulum", count=2)
    want = jax.vmap(pj.model.step, (0, 0, None))(jnp.asarray(x),
                                                 jnp.asarray(u), DT)
    scale_close(pt.model.step(torch.as_tensor(x), torch.as_tensor(u),
                              DT).numpy(), want, 1e-12)
