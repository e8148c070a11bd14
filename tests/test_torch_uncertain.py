"""The uncertain models of the port against the JAX package, on the CPU in
float64.

``pendulum_uncertain`` (an unknown mass) and ``cartpole_uncertain`` (an
unknown force on the cart), ``f(x, u, w)`` with r = 1, against
``trajopt_tpu.models.zoo`` at 1e-12 (the cart-pole's 2×2 solve is the
nominal model's explicit inverse here and ``spd_solve_vec`` there);
``discretize_uncertain`` under midpoint, rk3 and rk4 against the JAX
package's at 1e-12; the port of tests/test_core.py:207-223 (w = 0 gives the
nominal step, r = 0 raises ``ValueError``); and the models' place in
``MODELS`` and ``convert``. No kernel carries them: their steps run wherever
their tensors are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import base as jbase
from trajopt_tpu.models import zoo as jzoo

import trajopt_tpu_torch as tt
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.models.base import Model, discretize_uncertain
from trajopt_tpu_torch.ops.integration import UNCERTAIN_INTEGRATORS

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

NAMES = ("pendulum_uncertain", "cartpole_uncertain")


def _inputs(name, count=16, seed=0):
    """States, controls and disturbances of the model ``name``, from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    n = zoo.MODELS[name].n
    return (rng.normal(size=(count, n)), rng.normal(size=(count, 1)) * 3.0,
            rng.normal(size=(count, 1)) * 0.3)


def _jax_each(fn, *arrays):
    """``fn`` of the JAX package on each row, stacked."""
    return np.stack([np.asarray(fn(*(jnp.asarray(a[i]) for a in arrays)))
                     for i in range(len(arrays[0]))])


@pytest.mark.parametrize("name", NAMES)
def test_uncertain_dynamics_match_jax(name):
    """f(x, u, w) at 1e-12 of scale, batched over the leading dimension."""
    x, u, w = _inputs(name)
    ref = _jax_each(getattr(jzoo, name).dynamics, x, u, w)
    m = zoo.MODELS[name]
    assert (m.n, m.m, m.r) == (getattr(jzoo, name).n, 1, 1)
    mine = m.dynamics(*(torch.as_tensor(a) for a in (x, u, w))).numpy()
    assert np.abs(mine - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("integrator", sorted(UNCERTAIN_INTEGRATORS))
@pytest.mark.parametrize("name", NAMES)
def test_discretize_uncertain_matches_jax(name, integrator):
    """The discrete uncertain step F(x, u, w, dt) at 1e-12 of scale."""
    x, u, w = _inputs(name, seed=1)
    dt = 0.05
    jstep = jbase.discretize_uncertain(getattr(jzoo, name), integrator)
    ref = _jax_each(lambda a, b, c: jstep(a, b, c, dt), x, u, w)
    step = discretize_uncertain(zoo.MODELS[name], integrator)
    mine = step(*(torch.as_tensor(a) for a in (x, u, w)), dt).numpy()
    assert np.abs(mine - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("integrator", sorted(UNCERTAIN_INTEGRATORS))
def test_uncertain_integrators(integrator):
    """tests/test_core.py:207-223 on the port: at w = 0 the uncertain
    pendulum's step is the nominal pendulum's (1e-12), and a model without
    disturbance inputs raises ``ValueError``."""
    x = torch.tensor([0.2, -0.1], dtype=torch.float64)
    u = torch.tensor([0.4], dtype=torch.float64)
    w0 = torch.zeros(1, dtype=torch.float64)
    step_u = discretize_uncertain(zoo.pendulum_uncertain, integrator)
    nominal = tt.discretize(zoo.pendulum, integrator).step(x, u, 0.1)
    got = step_u(x, u, w0, 0.1)
    np.testing.assert_allclose(got.numpy(), nominal.numpy(), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError):
        discretize_uncertain(zoo.pendulum, integrator)


def test_uncertain_models_in_the_zoo_and_convert():
    """Both models are in ``MODELS`` as in the JAX package's, ``Model``
    carries ``r`` (0 by default), and carrying over a problem of one raises
    with a message that names DIRTREL, the solver that takes them."""
    for name in NAMES:
        assert convert.MODELS[name] is zoo.MODELS[name]
        assert name in jzoo.MODELS and zoo.MODELS[name].r == 1
    assert zoo.pendulum.r == 0 and Model(lambda x, u: x, 2, 1).r == 0
    assert "r=1" in repr(zoo.cartpole_uncertain)
    pj = jtt.problem(jtt.discretize(jzoo.pendulum, "rk3"),
                     jtt.LQRObjective(np.eye(2), np.eye(1), np.eye(2),
                                      np.zeros(2), 5),
                     x0=np.zeros(2), xf=np.zeros(2), N=5, dt=0.1,
                     U0=np.zeros((4, 1)))
    arrays = convert.problem_arrays(pj)
    arrays["model"] = "cartpole_uncertain"
    with pytest.raises(NotImplementedError, match="DIRTREL"):
        convert.problem_from_arrays(**arrays, device="cpu")
    arrays["model"] = "no_such_model"
    with pytest.raises(NotImplementedError, match="not a model"):
        convert.problem_from_arrays(**arrays, device="cpu")


def test_uncertain_step_takes_float32_and_jacfwd():
    """The steps keep float32 and differentiate under ``torch.func`` (the
    Jacobians DIRTREL takes), against central differences in float64."""
    step = discretize_uncertain(zoo.cartpole_uncertain, "rk3")
    x, u, w = (torch.as_tensor(a[0]) for a in _inputs("cartpole_uncertain"))
    f32 = step(x.float(), u.float(), w.float(), 0.05)
    assert f32.dtype == torch.float32
    Jw = torch.func.jacfwd(step, argnums=2)(x, u, w, 0.05)
    eps = 1e-6
    fd = (step(x, u, w + eps, 0.05) - step(x, u, w - eps, 0.05)) / (2 * eps)
    np.testing.assert_allclose(Jw[:, 0].numpy(), fd.numpy(), rtol=0,
                               atol=1e-8)
