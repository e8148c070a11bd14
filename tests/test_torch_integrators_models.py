"""Every integrator's step and Jacobians on the cart-pole and the two
quadrotors against the JAX package, in float64 (``tests/_torch_integrators.py``;
the lighter models in ``tests/test_torch_integrators.py``, the two-link
models in ``tests/test_torch_integrators_twolink.py``). The Euler-angle
quadrotor's implicit Jacobians are held against central differences there
(the JAX package's ``jacfwd`` through its Newton loop over that model's
nested ``jvp`` compiles for about 40 s)."""
import pytest
import torch

from _torch_integrators import steps_and_jacobians_match_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ("cartpole", "quadrotor"))
def test_steps_and_jacobians_match_jax(name):
    steps_and_jacobians_match_jax(name)


def test_quadrotor_euler_steps_and_explicit_jacobians_match_jax():
    steps_and_jacobians_match_jax("quadrotor_euler", implicit_jac=False)
