"""The plain versions behind the fused AL kernels K3 and K4 against the JAX
package, on the CPU.

``ops/linalg.py::posdef_solve``, the scan backward pass with its ρ retry,
``ops/cuda_al_fused.py::fused_al_backward`` (K3's plain version) and
``fused_al_forward`` (K4's) run on the miniature maze of
tests/test_torch_constraints.py (infeasible-start quadrotor, N = 21, three
cylinders, n = 13, m = 17) with exercised duals, in float64 against the JAX
closure path, and K3's once in float32 against the Pallas kernel in interpret
mode. The wrappers ``fused_al_*_cuda`` hand a CPU tensor to the plain
versions, so the tests go through them; the CUDA kernels themselves are
compared with the plain versions on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.ops.canonical import canonical_stack as jax_canonical_stack
from trajopt_tpu.ops.linalg import posdef_solve as jax_posdef_solve
from trajopt_tpu.ops.pallas_al_fused import fused_al_backward_pallas
from trajopt_tpu.solvers.al import al_cost_fns as jax_al_cost_fns
from trajopt_tpu.solvers.altro import infeasible_problem as jax_infeasible
from trajopt_tpu.solvers.ilqr import ALFusedMeta as JaxALFusedMeta
from trajopt_tpu.solvers.ilqr import _backward_pass_impl
from trajopt_tpu.solvers.ilqr import _make_fused_al_dispatches
from trajopt_tpu.solvers.ilqr import forward_pass as jax_forward_pass
from trajopt_tpu.solvers.ilqr import iLQROptions as JaxILQROptions
from trajopt_tpu.solvers.ilqr import reg_noise_scale as jax_reg_noise_scale

from test_torch_constraints import small_maze_jax
from trajopt_tpu_torch import convert
from trajopt_tpu_torch.ops.canonical import canonical_stack
from trajopt_tpu_torch.ops.cost import Expansion
from trajopt_tpu_torch.ops.cuda_al_fused import (
    fused_al_backward_cuda, fused_al_forward_cuda,
)
from trajopt_tpu_torch.ops.linalg import posdef_solve
from trajopt_tpu_torch.solvers.altro import infeasible_problem
from trajopt_tpu_torch.solvers.ilqr import (
    backward_pass, iLQROptions, reg_noise_scale,
)

torch.set_num_threads(1)

B, N, R_INF = 4, 21, 1e-8
FIELDS = ("x", "u", "xx", "uu", "ux")


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _setup(batch, n_knots, r_inf, dtype, seed=3):
    """The miniature maze in both packages after the infeasible-start
    transform, and a batch of states, controls and exercised duals
    (λ in [0, 0.5], μ in [0.5, 20], masked, as tests/test_fused_al.py:77-82)
    around the transform's seed, as numpy."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    base = small_maze_jax(N=n_knots, dtype=jdt)
    pj = jax_infeasible(base, r_inf)
    pt = infeasible_problem(convert.problem_from_arrays(
        **convert.problem_arrays(base), dtype=dtype, device="cpu"), r_inf)
    rng = np.random.default_rng(seed)
    P = pj.constraints.P
    mask = np.asarray(pj.constraints.mask)
    data = dict(
        X=np.asarray(pj.X)[None] + rng.normal(size=(batch, n_knots, 13)) * .02,
        U=np.asarray(pj.U)[None]
        + rng.normal(size=(batch, n_knots - 1, 17)) * .02,
        lam=rng.uniform(0.0, 0.5, size=(batch, n_knots, P)) * mask,
        mu=rng.uniform(0.5, 20.0, size=(batch, n_knots, P)) * mask)
    return pj, pt, data


@pytest.fixture(scope="module")
def small():
    return _setup(B, N, R_INF, torch.float64)


def _assert_scaled(mine, ref, tol, floor=0.0):
    ref = np.asarray(ref)
    scale = max(floor, float(np.abs(ref).max()))
    assert np.abs(mine.numpy() - ref).max() <= tol * scale


# ------------------------------------------------------------ posdef_solve

def test_posdef_solve_matches_jax_f64():
    """Random SPD systems of K3's shape (m = 17 with 14 right-hand sides),
    one made indefinite: solutions at 1e-10 of scale, flags equal."""
    rng = np.random.default_rng(0)
    M = rng.normal(size=(5, 17, 17))
    S = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(17)
    # rows and columns scaled across 12 decades, as penalty rows against
    # R_inf slack rows are: what the equilibration is for
    sc = 10.0 ** rng.uniform(-6, 6, size=(5, 17))
    S = S * sc[:, :, None] * sc[:, None, :]
    S[3] -= 2.0 * np.diag(np.diag(S[3]))            # problem 3: indefinite
    rhs = rng.normal(size=(5, 17, 14))
    Xj, fj = jax.vmap(jax_posdef_solve)(jnp.asarray(S), jnp.asarray(rhs))
    X, f = posdef_solve(_t(S), _t(rhs))
    assert f.tolist() == np.asarray(fj).tolist() == [False] * 3 + [True, False]
    ok = ~f
    _assert_scaled(X[ok], np.asarray(Xj)[ok.numpy()], 1e-10)


def test_posdef_solve_f32_pivot_policy_matches_jax():
    """float32: a singular system whose second scaled pivot is exactly 0
    is solved on the pivot floor 1e-7 without failing; an indefinite one
    (scaled pivot −3) fails. Flags equal the JAX package's."""
    S = np.array([[[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 2.0]],
                  [[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 2.0]]],
                 np.float32)
    rhs = np.array([[[1.0], [1.0], [4.0]], [[1.0], [0.0], [4.0]]], np.float32)
    Xj, fj = jax.vmap(jax_posdef_solve)(jnp.asarray(S), jnp.asarray(rhs))
    X, f = posdef_solve(torch.as_tensor(S), torch.as_tensor(rhs))
    assert X.dtype == torch.float32
    assert f.tolist() == np.asarray(fj).tolist() == [False, True]
    np.testing.assert_allclose(X[0].numpy(), np.asarray(Xj)[0], rtol=1e-5)
    # strict in float64: the singular system fails there
    assert posdef_solve(_t(S), _t(rhs))[1].tolist() == [True, True]


# ------------------------------------------------- scan backward pass

def _jax_expansion(pj, data, atol=0.0):
    """Jacobians and AL-decorated expansion of every problem, by the JAX
    package (vmap of jacobian_traj and of al_cost_fns' expansion)."""
    dt_traj = pj.dt_traj()
    cs = pj.constraints

    def one(X, U, lam, mu):
        _, expansion_fn = jax_al_cost_fns(pj.obj, cs, dt_traj, lam, mu, atol)
        A, Bm = pj.model.jacobian_traj(X[:-1], U, dt_traj)
        return A, Bm, expansion_fn(X, U)

    return jax.vmap(one)(*(jnp.asarray(data[k])
                           for k in ("X", "U", "lam", "mu")))


@pytest.mark.parametrize("reg_type", ["control", "state"])
def test_scan_backward_pass_rho_retry_matches_jax(small, reg_type):
    """``backward_pass`` with ``bp_type='scan'`` against vmap of
    ``_backward_pass_impl``, float64. Problems 1 and 3 get an indefinite
    slack-control Hessian at one knot (the block where BᵀB = I, so either
    regularization repairs it), so the ρ retry runs (the others are
    re-swept at their own ρ): K and d at 1e-8 of scale, ρ and dρ at rtol
    1e-12."""
    pj, pt, data = small
    A, Bm, exp = _jax_expansion(pj, data)
    e = {k: np.array(getattr(exp, k)) for k in FIELDS}
    e["uu"][1, 7, 4:, 4:] -= 3.0 * np.eye(13)
    e["uu"][3, 12, 4:, 4:] -= 3.0 * np.eye(13)
    jexp = type(exp)(**{k: jnp.asarray(v) for k, v in e.items()})
    jopts = JaxILQROptions(bp_reg_type=reg_type)
    scale = jax.vmap(lambda m: jax_reg_noise_scale(m, jnp.float64))(
        jnp.asarray(data["mu"]))
    rho0, drho0 = jnp.full((B,), 1e-3), jnp.ones((B,))
    Kj, dj, v1j, v2j, rhoj, drhoj = jax.vmap(
        lambda a, b, ex, r, dr, s: _backward_pass_impl(
            a, b, ex, r, dr, jopts, reg_scale=s))(A, Bm, jexp, rho0, drho0,
                                                  scale)
    mu = _t(data["mu"])
    K, d, v1, v2, rho, drho = backward_pass(
        _t(A), _t(Bm), Expansion(**{k: _t(v) for k, v in e.items()}),
        _t(rho0), _t(drho0), iLQROptions(bp_reg_type=reg_type),
        reg_scale=reg_noise_scale(mu, torch.float64))
    assert min(float(rho[1]), float(rho[3])) > 0.1 > float(rho[0])  # retried
    np.testing.assert_allclose(rho.numpy(), np.asarray(rhoj), rtol=1e-12)
    np.testing.assert_allclose(drho.numpy(), np.asarray(drhoj), rtol=1e-12)
    _assert_scaled(K, Kj, 1e-8)
    _assert_scaled(d, dj, 1e-8)
    np.testing.assert_allclose(v1.numpy(), np.asarray(v1j), rtol=1e-8)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v2j), rtol=1e-8)


# ------------------------------------------------- K3's plain version

def _port_inputs(pt, data, dtype=torch.float64):
    canon = canonical_stack(pt.constraints, 13, 17, dtype=dtype)
    return canon, tuple(_t(data[k], dtype) for k in ("X", "U", "lam", "mu"))


def test_fused_al_backward_matches_jax_closure_path(small):
    """K3's plain version against the JAX package's closure path for the
    fused AL backward pass (``_bp_single`` behind the ``custom_vmap`` of
    ``_make_fused_al_dispatches``: jacobian_traj + al_cost_fns' expansion +
    the scan sweep), float64, ρ = 1: K and d at 1e-8 of scale, ΔV at rtol
    1e-9, no failure."""
    pj, pt, data = small
    cs = pj.constraints
    jcanon = jax_canonical_stack(cs, 13, 17, dtype=jnp.float64)
    jopts = JaxILQROptions(fused=True)
    meta = JaxALFusedMeta(objective=pj.obj, cs=cs, canon=jcanon, lam=None,
                          mu=None, atol=0.0)
    fbp, _ = _make_fused_al_dispatches(pj.model, jopts, meta)
    Kj, dj, v1j, v2j, rhoj, _ = jax.vmap(
        fbp, in_axes=(0, 0, None, None, None, 0, 0, 0, 0))(
        jnp.asarray(data["X"]), jnp.asarray(data["U"]), pj.dt_traj(), pj.obj,
        cs, jnp.asarray(data["lam"]), jnp.asarray(data["mu"]),
        jnp.ones((B,)), jnp.ones((B,)))
    assert np.allclose(np.asarray(rhoj), 1.0 / 1.6)     # one sweep, no retry

    canon, (X, U, lam, mu) = _port_inputs(pt, data)
    K, d, v1, v2, fail = fused_al_backward_cuda(
        pt.model, canon, X, U, lam, mu, pt.dt_traj(), pt.obj, _t(np.ones(B)))
    assert K.shape == (B, N - 1, 17, 13) and not bool(fail.any())
    _assert_scaled(K, Kj, 1e-8)
    _assert_scaled(d, dj, 1e-8)
    np.testing.assert_allclose(v1.numpy(), np.asarray(v1j), rtol=1e-9)
    np.testing.assert_allclose(v2.numpy(), np.asarray(v2j), rtol=1e-9)


def test_fused_al_backward_matches_pallas_interpret_f32():
    """K3's plain version against the Pallas TPU kernel in interpret mode,
    float32, B = 128 (a lane tile) at N = 6, R_inf = 1e-4, at the
    tolerances of tests/test_fused_al.py:261-267: K at 2e-3 of scale, d at
    2e-3 of max(1e-3, scale), ΔV1 at 1e-3, no failure on either side."""
    Bk, Nk = 128, 6
    pj, pt, data = _setup(Bk, Nk, 1e-4, torch.float32)
    f32 = lambda k: jnp.asarray(data[k], jnp.float32)  # noqa: E731
    jcanon = jax_canonical_stack(pj.constraints, 13, 17, dtype=jnp.float32)
    model = pj.model
    Kr, dr, v1r, v2r, failr = fused_al_backward_pallas(
        (model.step_lanes, model.base_step_lanes, model.slack_m), jcanon,
        f32("X"), f32("U"), f32("lam"), f32("mu"), pj.dt_traj(), pj.obj,
        jnp.ones((Bk,), jnp.float32), interpret=True)
    canon, (X, U, lam, mu) = _port_inputs(pt, data, torch.float32)
    K, d, v1, v2, fail = fused_al_backward_cuda(
        pt.model, canon, X, U, lam, mu, pt.dt_traj(), pt.obj, torch.ones(Bk))
    assert K.dtype == torch.float32
    assert not bool(np.asarray(failr).any()) and not bool(fail.any())
    _assert_scaled(K, Kr, 2e-3)
    _assert_scaled(d, dr, 2e-3, floor=1e-3)
    _assert_scaled(v1, v1r, 1e-3, floor=1e-6)


# ------------------------------------------------- K4's plain version

def test_fused_al_forward_matches_jax_forward_pass(small):
    """K4's plain version against vmap of ``forward_pass`` under the AL cost
    of ``al_cost_fns``, float64, gains from the backward pass at ρ = 1.
    Problem 1's feedforward is blown up so its first candidates diverge,
    and problem 2 is given a cost no candidate can beat, so its search runs
    out (restore and ρ bump): α, ρ, dρ equal on every problem, J at rtol
    1e-10, X̄ and Ū at 1e-9."""
    pj, pt, data = small
    canon, (X, U, lam, mu) = _port_inputs(pt, data)
    dt_traj, obj = pt.dt_traj(), pt.obj
    K, d, v1, v2, _ = fused_al_backward_cuda(
        pt.model, canon, X, U, lam, mu, dt_traj, obj, _t(np.ones(B)))
    d = d.clone()
    d[1] *= 3e3

    jdt, cs = pj.dt_traj(), pj.constraints
    jopts = JaxILQROptions()

    def cost_one(Xi, Ui, lam_i, mu_i):
        return jax_al_cost_fns(pj.obj, cs, jdt, lam_i, mu_i, 0.0)[0](Xi, Ui)

    jin = {k: jnp.asarray(v) for k, v in data.items()}
    J_prev = np.array(jax.vmap(cost_one)(jin["X"], jin["U"], jin["lam"],
                                         jin["mu"]))
    J_prev[2] = -1e30

    def fp_one(x0_, X_, U_, K_, d_, v1_, v2_, J_, lam_, mu_):
        cost_fn, _ = jax_al_cost_fns(pj.obj, cs, jdt, lam_, mu_, 0.0)
        return jax_forward_pass(pj.model, cost_fn, x0_, X_, U_, K_, d_, v1_,
                                v2_, J_, jnp.ones(()), jnp.ones(()), jdt,
                                jopts)

    ref = jax.vmap(fp_one)(
        jin["X"][:, 0], jin["X"], jin["U"], jnp.asarray(K.numpy()),
        jnp.asarray(d.numpy()), jnp.asarray(v1.numpy()),
        jnp.asarray(v2.numpy()), jnp.asarray(J_prev), jin["lam"], jin["mu"])
    Xr, Ur, Jr, rhor, drhor, alphar = (np.asarray(a) for a in ref)

    opts = iLQROptions()
    opts_t = (opts.line_search_lower_bound, opts.line_search_upper_bound,
              opts.iterations_linesearch, opts.bp_reg_min,
              opts.bp_reg_increase_factor, opts.bp_reg_fp)
    Xn, Un, J, rho, drho, alpha = fused_al_forward_cuda(
        pt.model, canon, X[:, 0], X, U, K, d, v1, v2, _t(J_prev),
        _t(np.ones(B)), _t(np.ones(B)), None, lam, mu, dt_traj, obj, opts_t)
    assert alpha.tolist() == alphar.tolist()
    assert alphar[2] == 0.0 and 0.0 < alphar[1] < 1.0 and alphar[0] > 0.0
    assert np.array_equal(Xn[2].numpy(), data["X"][2])      # restored
    assert rho.tolist() == rhor.tolist() and rhor[2] > 10.0
    assert drho.tolist() == drhor.tolist()
    np.testing.assert_allclose(J.numpy(), Jr, rtol=1e-10)
    np.testing.assert_allclose(Xn.numpy(), Xr, rtol=0, atol=1e-9)
    np.testing.assert_allclose(Un.numpy(), Ur, rtol=0, atol=1e-9)
