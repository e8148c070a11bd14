"""Every integrator's step and Jacobians on the analytic two-link models
(the double pendulum and the acrobot) against the JAX package, in float64
(``tests/_torch_integrators.py``), the explicit rules together and each
implicit rule on its own (a JAX compile a rule)."""
import pytest
import torch

from _torch_integrators import steps_and_jacobians_match_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("rules", (("euler", "midpoint", "rk3", "rk4"),
                                   ("midpoint_implicit",),
                                   ("rk3_implicit",)))
@pytest.mark.parametrize("name", ("doublependulum", "acrobot"))
def test_two_link_steps_and_jacobians_match_jax(name, rules):
    steps_and_jacobians_match_jax(name, rules=rules)
