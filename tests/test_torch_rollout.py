"""The closed-loop rollout twin of kernel K2 against the JAX package.

``rollout_closed_loop_cuda`` hands a tensor on the CPU to its plain twin
``ops/rollout.py::rollout_closed_loop``. In float64 the twin is held to
``jax.vmap(rollout_closed_loop)`` with the quaternion error state; in
float32 to the Pallas kernel it replaces, run in interpret mode at the size
``tests/test_pallas.py`` runs it. The CUDA kernel itself is compared with
the twin on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as tt_jax
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.ops.pallas_rollout import (
    quadrotor_state_diff_lanes, quadrotor_step_lanes,
    rollout_closed_loop_pallas,
)
from trajopt_tpu.ops.rollout import rollout_closed_loop as jax_rollout_cl

from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.models.base import Model, discretize
from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda

torch.set_num_threads(1)

QS = (3, 7)
DT = 0.05


def _inputs(B, N, seed, dtype, diverge=()):
    """The recipe of tests/test_pallas.py: hover seeds around perturbed
    starts, small error-state gains; ``diverge`` lanes get a 1e9 x
    feedforward that trips the guard."""
    n, m, ns = 13, 4, 12
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, n))
    x0[:, 3] = 1.0
    x0[:, 2] = 10.0
    x0[:, :3] += rng.normal(size=(B, 3)) * 0.1
    X = np.tile(x0[:, None, :], (1, N, 1))
    U = np.full((B, N - 1, m), 0.5 * 9.81 / 4)
    K = rng.normal(size=(B, N - 1, m, ns)) * 0.01
    d = rng.normal(size=(B, N - 1, m)) * 0.01
    for lane in diverge:
        d[lane] *= 1e9
    alpha = np.full((B,), 0.5)
    return tuple(a.astype(dtype) for a in (x0, X, U, K, d, alpha))


def _jax_ref(args):
    jm = tt_jax.discretize(jzoo.quadrotor, "rk3")
    return jax.vmap(lambda x0_, X_, U_, K_, d_, a_: jax_rollout_cl(
        jm, x0_, X_, U_, K_, d_, a_, DT, quat_slice=QS))(
        *map(jnp.asarray, args))


def test_twin_matches_jax_f64_with_divergence():
    args = _inputs(B=16, N=21, seed=0, dtype=np.float64, diverge=(3, 11))
    Xr, Ur, okr = (np.asarray(a) for a in _jax_ref(args))
    model = discretize(zoo.quadrotor, "rk3")
    X, U, ok = rollout_closed_loop_cuda(
        model, *(torch.as_tensor(a) for a in args), DT, quat_slice=QS)
    assert okr[0] and not okr[3] and not okr[11]    # the mask is exercised
    np.testing.assert_array_equal(ok.numpy(), okr)
    np.testing.assert_allclose(X.numpy(), Xr, rtol=0, atol=1e-10)
    np.testing.assert_allclose(U.numpy(), Ur, rtol=0, atol=1e-10)


def test_twin_matches_pallas_kernel_f32():
    """Against the TPU kernel K2 replaces (interpret mode), B=128, N=15."""
    args = _inputs(B=128, N=15, seed=1, dtype=np.float32, diverge=(77,))
    Xp, Up, okp = (np.asarray(a) for a in rollout_closed_loop_pallas(
        quadrotor_step_lanes, *map(jnp.asarray, args), DT, interpret=True,
        diff_lanes=quadrotor_state_diff_lanes))
    model = discretize(zoo.quadrotor, "rk3")
    X, U, ok = rollout_closed_loop_cuda(
        model, *(torch.as_tensor(a) for a in args), DT, quat_slice=QS)
    assert X.dtype == torch.float32
    assert not okp[77] and okp.sum() == 127
    np.testing.assert_array_equal(ok.numpy(), okp)
    np.testing.assert_allclose(X.numpy()[okp], Xp[okp], rtol=0, atol=1e-4)
    np.testing.assert_allclose(U.numpy()[okp], Up[okp], rtol=0, atol=1e-4)


@pytest.mark.parametrize("limit", ["state", "control"])
def test_twin_limits_are_arguments(limit):
    """A lower state or control limit kills lanes that the default 1e8
    keeps, exactly as the JAX rollout does with the same limits."""
    args = _inputs(B=8, N=11, seed=2, dtype=np.float64)
    kw = ({"max_state_value": 10.05} if limit == "state"
          else {"max_control_value": 1.2385})
    jm = tt_jax.discretize(jzoo.quadrotor, "rk3")
    ref = jax.vmap(lambda x0_, X_, U_, K_, d_, a_: jax_rollout_cl(
        jm, x0_, X_, U_, K_, d_, a_, DT, quat_slice=QS, **kw))(
        *map(jnp.asarray, args))
    model = discretize(zoo.quadrotor, "rk3")
    X, U, ok = rollout_closed_loop_cuda(
        model, *(torch.as_tensor(a) for a in args), DT, quat_slice=QS, **kw)
    okr = np.asarray(ref[2])
    assert 0 < okr.sum() < len(okr)                 # some lanes die
    np.testing.assert_array_equal(ok.numpy(), okr)
    np.testing.assert_allclose(X.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-10)


def test_wrapper_is_batch_first_with_one_launch_counter():
    """On the CPU the wrapper runs the twin and does not count a launch:
    the counter moves only where the CUDA kernel is launched."""
    args = _inputs(B=4, N=6, seed=3, dtype=np.float64)
    before = rollout_closed_loop_cuda.launches
    X, U, ok = rollout_closed_loop_cuda(
        discretize(zoo.quadrotor, "rk3"), *(torch.as_tensor(a) for a in args),
        DT, quat_slice=QS)
    assert rollout_closed_loop_cuda.launches == before
    assert X.shape == (4, 6, 13) and U.shape == (4, 5, 4) and ok.shape == (4,)
    # a model with no CUDA step still runs its twin on the CPU
    other = discretize(Model(zoo.quadrotor_dynamics, 13, 4, name="custom"),
                       "rk3")
    assert other.cuda_step is None
    X2, _, _ = rollout_closed_loop_cuda(
        other, *(torch.as_tensor(a) for a in args), DT, quat_slice=QS)
    torch.testing.assert_close(X2, X, rtol=0, atol=0)
