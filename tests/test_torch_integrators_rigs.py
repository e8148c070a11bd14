"""The cart-pole rig's steps under all six rules against the JAX package
(``tests/test_torch_integrators_chains.py``), and the acrobot rig's
implicit-midpoint Jacobians against the JAX package's ``jacfwd`` through its
Newton loop, within IMPLICIT_JAC_TOL (``tests/_torch_integrators.py``: the
two differ by about the Newton loop's last residual but one; measured at
most 1.8e-11 of scale on the cart-pole rig)."""
import jax
import jax.numpy as jnp
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import robots as jrobots

import trajopt_tpu_torch as tt
from trajopt_tpu_torch.models import zoo

from _torch_integrators import IMPLICIT_JAC_TOL, scale_close
from test_torch_integrators_chains import DT, _points, chain_steps_match_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("rules", (("euler", "midpoint", "rk3", "rk4"),
                                   ("midpoint_implicit",),
                                   ("rk3_implicit",)))
def test_cartpole_rig_steps_match_jax(rules):
    chain_steps_match_jax("cartpole_urdf", rules)


def test_acrobot_rig_implicit_jacobians_match_jax():
    x, u = _points("acrobot_urdf", count=2, seed=6)
    JA, JB, Jt = jax.jit(jax.vmap(jax.jacfwd(
        jtt.discretize(jrobots.acrobot_urdf_model(), "midpoint_implicit").step,
        argnums=(0, 1, 2)), (0, 0, None)))(jnp.asarray(x), jnp.asarray(u), DT)
    md = tt.discretize(zoo.MODELS["acrobot_urdf"], "midpoint_implicit")
    A, B, sdt = md._jac_dt(torch.as_tensor(x), torch.as_tensor(u),
                           torch.full((2,), DT, dtype=torch.float64))
    for got, want in ((A, JA), (B, JB), (sdt, Jt)):
        scale_close(got.numpy(), want, IMPLICIT_JAC_TOL)
