"""Every integrator on the rigid-body chains, in float64: the acrobot
rig's steps under all six rules against the JAX package (within 1e-12; the
double-pendulum rig's in ``tests/test_torch_integrators_dprig.py``, the
cart-pole rig's in ``tests/test_torch_integrators_rigs.py``, kuka's in
``tests/test_torch_integrators_kuka.py``), and every chain's
Jacobians A, B and ∂x⁺/∂dt under every rule. Under the explicit rules they
are the stage-by-stage chain rule over the chain's structured
linearization (``models/base.py::explicit_jacobian``; RK3's own
``rk3_jacobian`` as before), held within 1e-10 of ``torch.func.jacfwd``
through the port's step (whose steps match the JAX package's); under the
implicit rules the implicit-function theorem over the same linearization,
held against central differences of the port's own converged step (and,
on the acrobot rig, against the JAX package's ``jacfwd`` through its Newton
loop: ``tests/test_torch_integrators_rigs.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import robots as jrobots

import trajopt_tpu_torch as tt
from trajopt_tpu_torch.models import zoo

from _torch_integrators import RULES, central_differences, scale_close

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

RIGS = ("acrobot_urdf", "doublependulum_urdf", "cartpole_urdf")
CHAINS = ("kuka",) + RIGS
DT = 0.05


def _points(name, count=3, seed=4):
    model = zoo.MODELS[name]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(count, model.n)) * 0.3,
            rng.normal(size=(count, model.m)) * 0.3)


def chain_steps_match_jax(name, rules=RULES, x=None, u=None):
    """Each rule's step of chain ``name`` at three states (dt = 0.05),
    batched, within 1e-12 of the JAX package's."""
    if x is None:
        x, u = _points(name)
    jm = getattr(jrobots, f"{name}_model")()
    for rule in rules:
        want = jax.jit(jax.vmap(jtt.discretize(jm, rule).step, (0, 0, None)))(
            jnp.asarray(x), jnp.asarray(u), DT)
        got = tt.discretize(zoo.MODELS[name], rule).step(
            torch.as_tensor(x), torch.as_tensor(u), DT)
        scale_close(got.numpy(), want, 1e-12)


@pytest.mark.parametrize("rig", ("acrobot_urdf",))
def test_rig_steps_match_jax(rig):
    chain_steps_match_jax(rig)


@pytest.mark.parametrize("rule", ("euler", "midpoint", "rk3", "rk4"))
@pytest.mark.parametrize("name", CHAINS)
def test_chain_explicit_jacobians_match_jacfwd(name, rule):
    """The structured Jacobians (``_jac``, ``_jac_dt``) against
    ``torch.func.jacfwd`` through the step, within 1e-10."""
    x, u = (torch.as_tensor(a) for a in _points(name, count=2))
    md = tt.discretize(zoo.MODELS[name], rule)
    dt = torch.full((2,), DT, dtype=torch.float64)
    A, B, sdt = md._jac_dt(x, u, dt)
    A2, B2 = md._jac(x, u, dt)
    assert torch.equal(A, A2) and torch.equal(B, B2)
    JA, JB, Jt = torch.func.vmap(torch.func.jacfwd(
        md.step, argnums=(0, 1, 2)))(x, u, dt)
    for got, want in ((A, JA), (B, JB), (sdt, Jt)):
        scale_close(got.numpy(), want.numpy(), 1e-10)


@pytest.mark.parametrize("rule", ("midpoint_implicit", "rk3_implicit"))
@pytest.mark.parametrize("name", CHAINS)
def test_chain_implicit_jacobians_against_central_differences(name, rule):
    """The implicit-function-theorem Jacobians of the chain's implicit step
    against central differences of the port's converged step (h = 1e-6),
    within 1e-6 of scale."""
    x, u = (torch.as_tensor(a) for a in _points(name, count=2, seed=5))
    md = tt.discretize(zoo.MODELS[name], rule)
    A, B, sdt = md._jac_dt(x, u, torch.full((2,), DT, dtype=torch.float64))
    FA, FB, Ft = central_differences(md.step, x, u, DT)
    for got, want in ((A, FA), (B, FB), (sdt, Ft)):
        scale_close(got.numpy(), want.numpy(), 1e-6)
