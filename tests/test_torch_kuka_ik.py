"""``models/robots.py::kuka_ee_ik`` against the JAX package, on the CPU.

The restarts cannot be drawn bit-equal to ``jax.random`` (the port draws
them from a ``torch.Generator``), so the descent is held three ways: one
Jacobian-transpose step against ``jax.jacrev`` of the JAX package's FK point
at 1e-10; the whole descent (``ik_descend``) from the JAX package's own
restarts, 300 steps as ``tests/test_robust.py:123-132`` takes, against
``kuka_ee_ik`` of the JAX package; and the port's solve reaching that
test's goal within its tolerance from its own restarts. From these the
JAX package's 300 steps are not enough (its best of 8 ends at 0.029 > 1e-2
with the port's draws, 0.0066 with its own); the outcome is judged at the
port's default of 1000 steps, where every one of its 8 restarts reaches
the goal within 4e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.models import robots as jrobots

from trajopt_tpu_torch.models import robots

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

GOAL = (0.4, 0.3, 0.8)
EE = (0.0, 0.0, 0.045)


def test_one_jacobian_transpose_step_matches_jax():
    """q + α Jᵀ(p − FK(q)) at five random configurations: the port's step
    (``ik_descend`` with one iteration) against ``jax.jacrev`` of the JAX
    package's FK point, at 1e-10."""
    jchain = jrobots.kuka_model().chain
    q0 = np.random.default_rng(0).uniform(-np.pi, np.pi, size=(5, 7))
    point, ee = jnp.asarray(GOAL), jnp.asarray(EE)

    def fk(q):
        return jchain.forward_kinematics(q, point=ee)[1]

    def step(q):
        return q + 0.1 * (jax.jacrev(fk)(q).T @ (point - fk(q)))

    ref = np.stack([np.asarray(step(jnp.asarray(q))) for q in q0])
    q1, err = robots.ik_descend(robots.kuka_chain(), GOAL, EE,
                                torch.as_tensor(q0), 1, 0.1)
    np.testing.assert_allclose(q1.numpy(), ref, rtol=0, atol=1e-10)
    err_ref = [float(jnp.linalg.norm(point - fk(jnp.asarray(q))))
               for q in ref]
    np.testing.assert_allclose(err.numpy(), err_ref, rtol=0, atol=1e-10)


def test_descent_from_the_jax_restarts_matches_jax():
    """From the JAX package's restarts (``jax.random`` with its seed 0), the
    port's batched descent ends where the JAX package's ``kuka_ee_ik``
    does: its best configuration and error at 1e-8."""
    q_ref, err_ref = jrobots.kuka_ee_ik(
        jrobots.kuka_model().chain, jnp.asarray(GOAL), ee_point=EE,
        iterations=300, attempts=8, tol=1e-2)
    q0s = jax.random.uniform(jax.random.PRNGKey(0), (8, 7), jnp.float64,
                             -jnp.pi, jnp.pi)
    qs, errs = robots.ik_descend(robots.kuka_chain(), GOAL, EE,
                                 torch.as_tensor(np.asarray(q0s)), 300, 0.1)
    best = int(torch.argmin(errs))
    np.testing.assert_allclose(qs[best].numpy(), np.asarray(q_ref),
                               rtol=0, atol=1e-8)
    assert abs(float(errs[best]) - err_ref) < 1e-8


def test_kuka_ee_ik_reaches_goal():
    """The goal of tests/test_robust.py:123-132 within its tolerance: the
    error reported, and the FK of the configuration returned."""
    chain = robots.kuka_chain()
    q, err = robots.kuka_ee_ik(chain, GOAL, ee_point=EE, attempts=8,
                               tol=1e-2, device="cpu")
    assert q.shape == (7,) and err < 1e-2
    _, ee = chain.forward_kinematics(q, point=torch.tensor(EE,
                                                           dtype=q.dtype))
    assert float((ee - torch.tensor(GOAL, dtype=q.dtype)).norm()) < 1e-2
    with pytest.raises(RuntimeError, match="IK cannot get"):
        robots.kuka_ee_ik(chain, GOAL, ee_point=EE, iterations=2,
                          attempts=2, tol=1e-2, device="cpu")


def test_kuka_ee_ik_defaults_to_the_card(monkeypatch):
    """Like every entry point of the port, ``kuka_ee_ik`` runs on the
    current CUDA device unless the caller names one: with no card it
    raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        robots.kuka_ee_ik(robots.kuka_chain(), GOAL, ee_point=EE)
