"""Minimum time for the kuka arm, on the CPU in float64: its minimum-time
model with and without the infeasible-start slacks, its step and
structured Jacobian against the JAX package's ``minimum_time_problem``
model step and ``jacfwd`` at 1e-10 of scale, as
``tests/test_torch_mintime_chains.py`` holds the three rigs' (a file of its
own: the JAX reference's compile through the 7-DOF chain takes most of a
minute).
"""
import pytest
import torch

from _torch_mintime_chains import check_step_and_jacobian

torch.set_num_threads(1)


@pytest.mark.parametrize("slack", [False, True])
def test_kuka_mintime_step_and_jacobian_match_jax(slack):
    check_step_and_jacobian("kuka", slack)
