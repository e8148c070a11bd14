"""The double-pendulum URDF rig's steps under all six rules against the
JAX package, in float64, within 1e-12
(``tests/test_torch_integrators_chains.py``), the explicit rules together
and each implicit rule on its own (a JAX compile a rule)."""
import pytest
import torch

from test_torch_integrators_chains import chain_steps_match_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("rules", (("euler", "midpoint", "rk3", "rk4"),
                                   ("midpoint_implicit",),
                                   ("rk3_implicit",)))
def test_doublependulum_rig_steps_match_jax(rules):
    chain_steps_match_jax("doublependulum_urdf", rules)
