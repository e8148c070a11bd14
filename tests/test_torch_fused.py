"""The plain versions behind the fused kernels K7a and K7b against the JAX
package, on the CPU.

``ops/cuda_fused.py::fused_backward`` (K7a's plain version) and
``fused_forward`` (K7b's), reached through the wrappers ``fused_*_cuda`` (a
CPU tensor goes to the plain version):

- in float32 against the Pallas TPU kernels ``fused_backward_pallas`` and
  ``fused_forward_pallas`` in interpret mode, B = 128 (a lane tile), N = 11,
  for the quadrotor and the cartpole, at the tolerances of
  tests/test_fused.py (K and d at 1e-3 of scale, ΔV at 1e-4; α and ρ equal,
  X̄ at 1e-5 of scale, J at 1e-4);
- in float64 against ``vmap`` of the JAX scan backward pass and of
  ``forward_pass``, with a diverging problem and one whose search runs out.

The CUDA kernels themselves are compared with the plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as tt_jax
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.ops.pallas_fused import (
    fused_backward_pallas, fused_forward_pallas,
)
from trajopt_tpu.ops.rollout import rollout as jax_rollout
from trajopt_tpu.solvers.ilqr import _backward_pass_impl
from trajopt_tpu.solvers.ilqr import forward_pass as jax_forward_pass
from trajopt_tpu.solvers.ilqr import iLQROptions as JaxILQROptions

from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.ops.cost import Objective
from trajopt_tpu_torch.ops.cuda_fused import (
    fused_backward_cuda, fused_forward_cuda,
)
from trajopt_tpu_torch.ops.rollout import rollout_closed_loop
from trajopt_tpu_torch.solvers.ilqr import (
    _fused_eligible, _line_search_opts, iLQROptions,
)

torch.set_num_threads(1)

OBJ_FIELDS = ("Q", "R", "H", "q", "r", "c")
LS_OPTS = _line_search_opts(iLQROptions())


def _setup(name, batch, N, jdtype, seed=0):
    """The recipe of tests/test_fused.py::_setup for model ``name``: an LQR
    objective towards a goal, perturbed starts, noisy controls around a seed
    and their open-loop rollouts, by the JAX package."""
    jm = tt_jax.discretize(getattr(jzoo, name), "rk3")
    n, m = jm.n, jm.m
    x0, xf = np.zeros(n), np.zeros(n)
    if name == "quadrotor":
        x0[3] = xf[3] = 1.0
        xf[1] = 5.0
        u0, R = 1.22, 1e-4
    else:
        xf[0] = 1.0
        u0, R = 0.2, 1e-2
    obj = tt_jax.LQRObjective(np.eye(n) * 1e-3, np.eye(m) * R,
                              np.eye(n) * 100.0, xf, N)
    obj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype), obj)
    rng = np.random.default_rng(seed)
    x0s = np.tile(x0[None], (batch, 1))
    x0s[:, :min(n, 3)] += rng.normal(size=(batch, min(n, 3))) * 0.1
    dt_traj = jnp.full((N - 1,), 0.05, jdtype)
    U = jnp.asarray(rng.normal(size=(batch, N - 1, m)) * 0.1 + u0, jdtype)
    x0j = jnp.asarray(x0s, jdtype)
    X = jax.vmap(lambda a, b: jax_rollout(jm, a, b, dt_traj))(x0j, U)
    return jm, obj, x0j, X, U, dt_traj


def _t(a):
    return torch.as_tensor(np.array(a))


def _port(name, obj):
    md = discretize(getattr(zoo, name), "rk3")
    return md, Objective(**{k: _t(getattr(obj, k)) for k in OBJ_FIELDS})


def _rel(mine, ref):
    ref = np.asarray(ref)
    return np.abs(mine.numpy() - ref).max() / np.abs(ref).max()


# ------------------------------------------------------- K7a's plain version

@pytest.mark.parametrize("name", ["quadrotor", "cartpole"])
def test_fused_backward_matches_pallas_interpret_f32(name):
    """No failure on either side; K and d within 1e-3 of scale, ΔV within
    1e-4: the in-kernel Jacobians differ from ``jacobian_traj`` only in the
    float32 order of summation."""
    Bz, N = 128, 11
    jm, obj, _, X, U, dt_traj = _setup(name, Bz, N, jnp.float32)
    rho = jnp.ones((Bz,), jnp.float32)
    Kr, dr, v1r, v2r, failr = fused_backward_pallas(
        jm.step_lanes, X, U, dt_traj, obj, rho, interpret=True)
    md, tobj = _port(name, obj)
    K, d, v1, v2, fail = fused_backward_cuda(md, _t(X), _t(U), _t(dt_traj),
                                             tobj, _t(rho))
    assert K.dtype == torch.float32 and K.shape == (Bz, N - 1, md.m, md.n)
    assert not bool(np.asarray(failr).any()) and not bool(fail.any())
    assert _rel(K, Kr) < 1e-3 and _rel(d, dr) < 1e-3
    assert _rel(v1, v1r) < 1e-4 and _rel(v2, v2r) < 1e-4


@pytest.mark.parametrize("reg_type", ["control", "state"])
@pytest.mark.parametrize("name", ["quadrotor", "car"])
def test_fused_backward_matches_jax_scan_path_f64(name, reg_type):
    """Against what the JAX package's fused backward pass computes off the
    TPU (``_fused_bp_dispatch``'s ``_impl``: ``jacobian_traj`` + the LQR
    expansion + ``_backward_pass_impl``), float64, ρ = 1: K, d and ΔV at
    1e-10 of scale, and with ``return_jacobians`` A and B at 1e-12."""
    Bz, N = 4, 21
    jm, obj, _, X, U, dt_traj = _setup(name, Bz, N, jnp.float64, seed=1)
    jopts = JaxILQROptions(bp_reg_type=reg_type)

    def one(X_, U_):
        A, Bm = jm.jacobian_traj(X_[:-1], U_, dt_traj)
        out = _backward_pass_impl(A, Bm, obj.expansion(X_, U_, dt_traj),
                                  jnp.ones(()), jnp.ones(()), jopts)
        return out, A, Bm

    (Kj, dj, v1j, v2j, rhoj, _), Aj, Bj = jax.vmap(one)(X, U)
    assert np.allclose(np.asarray(rhoj), 1.0 / 1.6)     # one sweep, no retry
    md, tobj = _port(name, obj)
    K, d, v1, v2, fail, A, Bm = fused_backward_cuda(
        md, _t(X), _t(U), _t(dt_traj), tobj, _t(np.ones(Bz)),
        reg_state=reg_type == "state", return_jacobians=True)
    assert not bool(fail.any())
    for mine, ref in ((K, Kj), (d, dj), (v1, v1j), (v2, v2j)):
        assert _rel(mine, ref) < 1e-10
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Bm.numpy(), np.asarray(Bj), rtol=0, atol=1e-12)


# ------------------------------------------------------- K7b's plain version

def _search_inputs(name, Bz, N, jdtype, seed):
    """Gains from the port's backward pass at ρ = 1 and the cost of the
    seed; problem 1's feedforward is blown up so that its first candidates
    diverge, and problem 2 is given a cost no candidate can beat, so that
    its search runs out."""
    jm, obj, x0j, X, U, dt_traj = _setup(name, Bz, N, jdtype, seed=seed)
    md, tobj = _port(name, obj)
    K, d, v1, v2, fail = fused_backward_cuda(
        md, _t(X), _t(U), _t(dt_traj), tobj, torch.ones(Bz, dtype=_t(X).dtype))
    assert not bool(fail.any())
    d = d.clone()
    d[1] *= 1e5
    ok = rollout_closed_loop(md, _t(x0j), _t(X), _t(U), K, d,
                             torch.ones(Bz, dtype=d.dtype), 0.05)[2]
    assert not bool(ok[1]) and int(ok.sum()) == Bz - 1
    J_prev = np.array(jax.vmap(lambda a, b: obj.total(a, b, dt_traj))(X, U))
    J_prev[2] = -1e30
    return jm, md, obj, tobj, x0j, X, U, dt_traj, K, d, v1, v2, J_prev


def _check_branches(alpha, rho, Xn, X, J, J_prev):
    """Problem 1 halved its way out of divergence, problem 2 ran out:
    restored, α = 0, ρ bumped."""
    assert 0.0 < float(alpha[1]) < 1.0 and float(alpha[0]) > 0.0
    assert float(alpha[2]) == 0.0 and float(rho[2]) > 10.0
    assert np.array_equal(Xn[2].numpy(), np.asarray(X)[2])
    assert float(J[2]) == J_prev[2]


@pytest.mark.parametrize("name", ["quadrotor", "cartpole"])
def test_fused_forward_matches_pallas_interpret_f32(name):
    """α, ρ and dρ equal on every problem (the same accept decisions), X̄
    within 1e-5 of scale and J within 1e-4, as tests/test_fused.py:101-108
    holds the Pallas kernel to ``forward_pass``."""
    Bz, N = 128, 11
    (jm, md, obj, tobj, x0j, X, U, dt_traj, K, d, v1, v2,
     J_prev) = _search_inputs(name, Bz, N, jnp.float32, 2)
    one = jnp.ones((Bz,), jnp.float32)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    Xr, Ur, Jr, rhor, drhor, alphar = fused_forward_pallas(
        jm.step_lanes, None, x0j, X, U, j(K), j(d), j(v1), j(v2),
        jnp.asarray(J_prev), one, one, one, dt_traj, obj, LS_OPTS,
        interpret=True)
    Xn, Un, J, rho, drho, alpha = fused_forward_cuda(
        md, _t(x0j), _t(X), _t(U), K, d, v1, v2, _t(J_prev), _t(one),
        _t(one), None, _t(dt_traj), tobj, LS_OPTS)
    assert Xn.dtype == torch.float32
    assert alpha.tolist() == np.asarray(alphar).tolist()
    assert rho.tolist() == np.asarray(rhor).tolist()
    assert drho.tolist() == np.asarray(drhor).tolist()
    _check_branches(alpha, rho, Xn, X, J, J_prev)
    calm = np.ones(Bz, bool)
    calm[1] = False      # follows a 1e5 x feedforward at alpha ~ 1e-5
    Xr = np.asarray(Xr)
    assert np.abs(Xn.numpy() - Xr)[calm].max() < 1e-5 * max(
        1.0, np.abs(Xr[calm]).max())
    Jr = np.asarray(Jr)
    assert np.abs(J.numpy() - Jr)[calm].max() < 1e-4 * np.abs(Jr[calm]).max()


@pytest.mark.parametrize("name", ["quadrotor", "cartpole"])
def test_fused_forward_matches_jax_forward_pass_f64(name):
    """Against ``vmap(forward_pass)`` under the objective's cost, float64:
    α, ρ and dρ equal on every problem, J at rtol 1e-10, X̄ and Ū at 1e-9."""
    Bz, N = 4, 21
    (jm, md, obj, tobj, x0j, X, U, dt_traj, K, d, v1, v2,
     J_prev) = _search_inputs(name, Bz, N, jnp.float64, 3)
    jopts = JaxILQROptions()
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    ref = jax.vmap(lambda x0_, X_, U_, K_, d_, a_, b_, J_: jax_forward_pass(
        jm, lambda Xc, Uc: obj.total(Xc, Uc, dt_traj), x0_, X_, U_, K_, d_,
        a_, b_, J_, jnp.ones(()), jnp.ones(()), dt_traj, jopts))(
        x0j, X, U, j(K), j(d), j(v1), j(v2), jnp.asarray(J_prev))
    Xr, Ur, Jr, rhor, drhor, alphar = (np.asarray(a) for a in ref)
    one = _t(np.ones(Bz))
    Xn, Un, J, rho, drho, alpha = fused_forward_cuda(
        md, _t(x0j), _t(X), _t(U), K, d, v1, v2, _t(J_prev), one, one, None,
        _t(dt_traj), tobj, LS_OPTS)
    assert alpha.tolist() == alphar.tolist()
    assert rho.tolist() == rhor.tolist() and drho.tolist() == drhor.tolist()
    _check_branches(alpha, rho, Xn, X, J, J_prev)
    np.testing.assert_allclose(J.numpy(), Jr, rtol=1e-10)
    np.testing.assert_allclose(Xn.numpy(), Xr, rtol=0, atol=1e-9)
    np.testing.assert_allclose(Un.numpy(), Ur, rtol=0, atol=1e-9)


# ---------------------------------------------------------- eligibility

def test_fused_eligibility_follows_the_jax_rules():
    """``fused`` on, a plain ``Objective``, a model whose step the kernels
    carry, the scan backward pass on the full state, default limits."""
    md, tobj = _port("cartpole", _setup("cartpole", 1, 3, jnp.float64)[1])
    on = iLQROptions(fused=True)
    assert _fused_eligible(md, on, tobj)
    assert not _fused_eligible(md, iLQROptions(), tobj)
    assert not _fused_eligible(md, on, None)
    assert not _fused_eligible(discretize(zoo.cartpole, "rk4"), on, tobj)
    for off in (dict(bp_type="sqrt"), dict(square_root=True),
                dict(error_state=True), dict(max_state_value=1e6),
                dict(max_control_value=1e6)):
        assert not _fused_eligible(md, iLQROptions(fused=True, **off), tobj)
