"""Custom constraints and generic costs of the port against the JAX package,
on the CPU in float64.

``custom_constraint`` (its ``torch.func`` Jacobian against an analytic one
at 1e-12, as tests/test_constraints.py:26-55 holds the JAX one; its stack's
values, Jacobians and AL terms against the JAX package's at 1e-12),
``lift_constraint`` of a constraint without a canonical descriptor against
the JAX package's at 1e-12, ``planar_obstacle_constraint`` and
``sphere_constraint_fn``, ``stage_cost``, ``GenericObjective`` (total and
expansion by AD, with all four hooks and with a partial set, at 1e-12),
the port of tests/test_core.py:180-204 (a full iLQR solve through a
``GenericObjective``: the same bar, and X within 1e-6 of the JAX solve),
and ``quadrotor_line(constrained=True)`` at N = 21: its stack against the
JAX package's at 1e-12, no canonical stack (so it runs phase-split), and
three outer iterations of its AL solve count for count with X within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import zoo as jzoo
from trajopt_tpu.ops import constraints as jcons
from trajopt_tpu.ops import cost as jcost
from trajopt_tpu.problems import zoo as jprobs
from trajopt_tpu.solvers import altro as jalt

import trajopt_tpu_torch as tt
from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.ops import cost as tcost
from trajopt_tpu_torch.ops.canonical import canonical_stack
from trajopt_tpu_torch.problems import zoo as probs
from trajopt_tpu_torch.solvers import altro as alt

torch.set_num_threads(1)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, float(np.abs(b).max()))


def _stack(lib, N, *entries):
    b = lib.ConstraintSetBuilder(N)
    for con, knots in entries:
        b.add(con, knots=knots)
    if lib is tt:
        return b.stack(device="cpu")
    return b.stack()


# the custom equality of tests/test_constraints.py:26-55 in both packages
def _fn_jax(x, u):
    return jnp.stack([x[0] ** 2 + u[0] - 1.0, x[1] * u[1]])


def _jac_jax(x, u):
    cx = jnp.array([[2 * x[0], 0.0, 0.0], [0.0, u[1], 0.0]])
    cu = jnp.array([[1.0, 0.0], [0.0, x[1]]])
    return cx, cu


def _fn(x, u):
    return torch.stack([x[0] ** 2 + u[0] - 1.0, x[1] * u[1]])


def _jac(x, u):
    z = torch.zeros_like(x[0])
    cx = torch.stack([torch.stack([2 * x[0], z, z]),
                      torch.stack([z, u[1], z])])
    cu = torch.stack([torch.stack([z + 1.0, z]), torch.stack([z, x[1]])])
    return cx, cu


# ------------------------------------------------------ custom constraints

def test_custom_constraint_ad_jacobian_matches_analytic():
    """The ``torch.func.jacfwd`` Jacobian of a custom constraint against
    its analytic one at 1e-12 (reference constraint_tests.jl), over the
    knots of a stack and over a batch of two trajectories."""
    n, m, N = 3, 2, 4
    cs_ad = _stack(tt, N, (tt.custom_constraint(_fn, 2, equality=True), None))
    cs_an = _stack(tt, N, (tt.custom_constraint(_fn, 2, equality=True,
                                                jac_fn=_jac), None))
    X, U = torch.tensor(_rand((2, N, n), 7)), torch.tensor(_rand((2, N - 1, m),
                                                                 8))
    for a, b in zip(cs_ad.jacobian(X, U), cs_an.jacobian(X, U)):
        _close(a, b)
    assert canonical_stack(cs_ad, n, m, dtype=torch.float64) is None


def test_custom_constraint_stack_matches_jax():
    """A stack of a custom equality (terminal), a custom inequality (stage,
    AD Jacobian) and a bound: values, Jacobians, the AL expansion terms and
    the violation at random (X, U), λ, μ against the JAX package's."""
    n, m, N = 3, 2, 6

    def ineq_j(x, u):
        return jnp.stack([jnp.sin(x[2]) * u[0] - 0.3])

    def ineq(x, u):
        return torch.stack([torch.sin(x[2]) * u[0] - 0.3])

    entries = lambda lib, f, j, fi: (  # noqa: E731
        (lib.custom_constraint(f, 2, label="c_eq", equality=True,
                               applies="terminal", jac_fn=j), None),
        (lib.custom_constraint(fi, 1, label="c_in"), range(1, N - 1)),
        (lib.bound_constraint(n, m, u_min=-1.0, u_max=1.0), None))
    cs = _stack(tt, N, *entries(tt, _fn, _jac, ineq))
    csj = _stack(jtt, N, *entries(jtt, _fn_jax, _jac_jax, ineq_j))
    assert cs.labels() == csj.labels()
    np.testing.assert_array_equal(cs.mask.numpy(), np.asarray(csj.mask))
    X, U = _rand((N, n), 1), _rand((N - 1, m), 2)
    Xt, Ut = torch.tensor(X), torch.tensor(U)
    C = cs.evaluate(Xt, Ut)
    Cj = csj.evaluate(jnp.asarray(X), jnp.asarray(U))
    _close(C, Cj)
    for a, b in zip(cs.jacobian(Xt, Ut),
                    csj.jacobian(jnp.asarray(X), jnp.asarray(U))):
        _close(a, b)
    lam = _rand((N, cs.P), 3) * cs.mask.numpy()
    mu = np.abs(_rand((N, cs.P), 4)) * cs.mask.numpy()
    g = lam + mu * C.numpy()
    out = cs.al_expansion_terms(Xt, Ut, torch.tensor(g), torch.tensor(mu))
    outj = csj.al_expansion_terms(jnp.asarray(X), jnp.asarray(U),
                                  jnp.asarray(g), jnp.asarray(mu))
    for a, b in zip(out, outj):
        _close(a, b)
    _close(cs.max_violation(C), csj.max_violation(Cj))
    _close(tt.max_violation(cs, C), csj.max_violation(Cj))


def test_lifted_custom_constraint_matches_jax():
    """``lift_constraint`` of a constraint without a canonical descriptor
    onto (n + 2, m + 3): its value, its zero-padded Jacobian and its
    zero-padded AL terms against the JAX package's lift; a canonical
    constraint lifts to itself."""
    n, m, nb, mb = 3, 2, 5, 5
    con = tt.custom_constraint(_fn, 2, jac_fn=_jac)
    conj = jtt.custom_constraint(_fn_jax, 2, jac_fn=_jac_jax)

    def hook_t(X, U, g, imu):
        return {"x": g[..., :1].expand(X.shape) * X,
                "uu": imu[..., 0, None, None] * torch.ones(U.shape + (m,),
                                                           dtype=X.dtype)}

    def hook_j(X, U, g, imu):
        return {"x": g[:, :1] * X,
                "uu": imu[:, 0, None, None] * jnp.ones(U.shape + (m,))}

    con.al_terms, conj.al_terms = hook_t, hook_j
    lt, lj = alt.lift_constraint(con, n, m), jalt.lift_constraint(conj, n, m)
    assert lt is not con and lt.canon is None
    X, U = _rand((4, nb), 5), _rand((4, mb), 6)
    Xt, Ut = torch.tensor(X), torch.tensor(U)
    _close(lt.fn(Xt, Ut), jax.vmap(lj.fn)(jnp.asarray(X), jnp.asarray(U)))
    for a, b in zip(lt.jac_fn(Xt, Ut),
                    jax.vmap(lj.jac_fn)(jnp.asarray(X), jnp.asarray(U))):
        _close(a, b)
    g, imu = _rand((4, 2), 7), np.abs(_rand((4, 2), 8))
    t = lt.al_terms(Xt, Ut, torch.tensor(g), torch.tensor(imu))
    tj = lj.al_terms(jnp.asarray(X), jnp.asarray(U), jnp.asarray(g),
                     jnp.asarray(imu))
    assert set(t) == set(tj)
    for k in t:
        _close(t[k], tj[k])
    bnd = tt.bound_constraint(n, m, u_min=-1.0)
    assert alt.lift_constraint(bnd, n, m) is bnd


def test_planar_obstacle_and_sphere_fn_match_jax():
    """``planar_obstacle_constraint`` (one circle at every knot, AD
    Jacobian, no canonical descriptor) and ``sphere_constraint_fn`` against
    the JAX package's."""
    n, m, N = 3, 2, 5
    con = tt.planar_obstacle_constraint(n, m, (0.5, -0.2), 0.3)
    conj = jcons.planar_obstacle_constraint(n, m, (0.5, -0.2), 0.3)
    assert con.applies == conj.applies == "all" and con.canon is None
    cs = _stack(tt, N, (con, None))
    csj = _stack(jtt, N, (conj, None))
    X, U = _rand((N, n), 9), _rand((N - 1, m), 10)
    _close(cs.evaluate(torch.tensor(X), torch.tensor(U)),
           csj.evaluate(jnp.asarray(X), jnp.asarray(U)))
    for a, b in zip(cs.jacobian(torch.tensor(X), torch.tensor(U)),
                    csj.jacobian(jnp.asarray(X), jnp.asarray(U))):
        _close(a, b)
    x = _rand((3,), 11)
    _close(tt.sphere_constraint_fn(torch.tensor(x), 0.1, 0.2, 0.3, 0.5),
           jcons.sphere_constraint_fn(jnp.asarray(x), 0.1, 0.2, 0.3, 0.5))
    _close(tt.circle_constraint_fn(torch.tensor(x), 0.1, 0.2, 0.5),
           jcons.circle_constraint_fn(jnp.asarray(x), 0.1, 0.2, 0.5))


# ------------------------------------------------------------- generic costs

def test_stage_cost_matches_jax():
    """``stage_cost`` of a quadratic objective at knot 3 against the JAX
    package's, for a batch of three (x, u)."""
    N, n, m = 6, 3, 2
    xf = _rand((n,), 12)
    A = _rand((n, n), 13)
    obj = tt.LQRObjective(A @ A.T, np.eye(m) * 0.3, np.eye(n), xf, N,
                          device="cpu")
    objj = jtt.LQRObjective(A @ A.T, np.eye(m) * 0.3, np.eye(n), xf, N)
    x, u = _rand((3, n), 14), _rand((3, m), 15)
    got = tt.stage_cost(obj, 3, torch.tensor(x), torch.tensor(u), 0.1)
    for b in range(3):
        _close(got[b], jcost.stage_cost(objj, 3, jnp.asarray(x[b]),
                                        jnp.asarray(u[b]), 0.1))


def _generic_pair(hooks):
    """The same nonquadratic cost in both packages; ``hooks``: 'none',
    'all' (the four analytic hooks) or 'grad' (grad and gradf only: the
    Hessians by AD)."""
    xf = np.array([0.4, -0.2])

    def ell_t(x, u):
        dx = x - torch.as_tensor(xf, dtype=x.dtype)
        return 1e-3 * (dx @ dx) + 1e-3 * (u @ u) + 1e-4 * dx[1] ** 4 \
            + 0.1 * torch.sin(x[0]) * u[0]

    def ell_j(x, u):
        dx = x - jnp.asarray(xf)
        return 1e-3 * (dx @ dx) + 1e-3 * (u @ u) + 1e-4 * dx[1] ** 4 \
            + 0.1 * jnp.sin(x[0]) * u[0]

    def ellf_t(x):
        dx = x - torch.as_tensor(xf, dtype=x.dtype)
        return 0.5 * dx @ dx + dx[0] ** 4

    def ellf_j(x):
        dx = x - jnp.asarray(xf)
        return 0.5 * dx @ dx + dx[0] ** 4

    def parts(lib, ell, ellf):
        if hooks == "none":
            return dict(ell=ell, ellf=ellf, N=7)

        def grad(x, u):
            g = (jax.grad if lib is jtt else torch.func.grad)(
                ell, argnums=(0, 1))
            return g(x, u)

        def gradf(x):
            return (jax.grad if lib is jtt else torch.func.grad)(ellf)(x)

        out = dict(ell=ell, ellf=ellf, N=7, grad=grad, gradf=gradf)
        if hooks == "all":
            H = jax.hessian if lib is jtt else torch.func.hessian

            def hess(x, u):
                z = (jnp.concatenate if lib is jtt else torch.cat)([x, u])
                Hz = H(lambda z: ell(z[:2], z[2:]))(z)
                return Hz[:2, :2], Hz[2:, 2:], Hz[2:, :2]

            out.update(hess=hess, hessf=H(ellf))
        return out

    return (tcost.GenericObjective(**parts(tt, ell_t, ellf_t)),
            jcost.GenericObjective(**parts(jtt, ell_j, ellf_j)))


@pytest.mark.parametrize("hooks", ["none", "all", "grad"])
def test_generic_objective_matches_jax(hooks):
    """Total and expansion of a ``GenericObjective`` against the JAX
    package's at 1e-12, per-interval dt, for a batch of two trajectories;
    with the hooks the expansion equals the AD one."""
    obj, objj = _generic_pair(hooks)
    N = obj.N
    X, U = _rand((2, N, 2), 16), _rand((2, N - 1, 1), 17)
    dt = np.abs(_rand((N - 1,), 18)) * 0.1
    Xt, Ut, dtt = torch.tensor(X), torch.tensor(U), torch.tensor(dt)
    J = obj.total(Xt, Ut, dtt)
    e = obj.expansion(Xt, Ut, dtt)
    e_ad = tcost.GenericObjective(obj.ell, obj.ellf, N).expansion(Xt, Ut, dtt)
    for b in range(2):
        _close(J[b], objj.total(jnp.asarray(X[b]), jnp.asarray(U[b]),
                                jnp.asarray(dt)))
        ej = objj.expansion(jnp.asarray(X[b]), jnp.asarray(U[b]),
                            jnp.asarray(dt))
        for k in ("x", "u", "xx", "uu", "ux"):
            _close(getattr(e, k)[b], getattr(ej, k))
            _close(getattr(e, k)[b], getattr(e_ad, k)[b])
    assert obj.to(dtype=torch.float32) is obj


def test_generic_objective_solves():
    """tests/test_core.py:180-204: a full iLQR solve through a
    ``GenericObjective`` (a quartic velocity penalty) on the pendulum
    reaches the goal within 0.2, as the JAX package's does, and lands
    within 1e-6 of it with the same iteration count."""
    N = 31
    xf = np.array([np.pi, 0.0])

    def ell_t(x, u):
        dx = x - torch.as_tensor(xf, dtype=x.dtype)
        return 1e-3 * (dx @ dx) + 1e-3 * (u @ u) + 1e-4 * dx[1] ** 4

    def ellf_t(x):
        dx = x - torch.as_tensor(xf, dtype=x.dtype)
        return 0.5 * dx @ dx

    def ell_j(x, u):
        dx = x - jnp.asarray(xf)
        return 1e-3 * (dx @ dx) + 1e-3 * (u @ u) + 1e-4 * dx[1] ** 4

    def ellf_j(x):
        dx = x - jnp.asarray(xf)
        return 0.5 * dx @ dx

    pt = tt.problem(tt.discretize(zoo.pendulum, "rk3"),
                    tt.GenericObjective(ell=ell_t, ellf=ellf_t, N=N),
                    x0=np.zeros(2), xf=xf, N=N, dt=0.15,
                    U0=np.ones((N - 1, 1)), device="cpu")
    pj = jtt.problem(jtt.discretize(jzoo.pendulum, "rk3"),
                     jcost.GenericObjective(ell=ell_j, ellf=ellf_j, N=N),
                     x0=np.zeros(2), xf=xf, N=N, dt=0.15,
                     U0=np.ones((N - 1, 1)))
    rt = tt.al_solve(pt, tt.ALOptions())
    rj = jtt.al_solve(pj, jtt.ALOptions())
    assert float((rt.X[-1] - pt.xf).norm()) < 0.2
    assert int(rt.iterations_total) == int(rj.iterations_total)
    np.testing.assert_allclose(rt.X.numpy(), np.asarray(rj.X), atol=1e-6)


# ------------------------------------------- quadrotor_line(constrained=True)

def test_quadrotor_line_constrained_matches_jax():
    """``quadrotor_line(N=21, constrained=True)``: the u ≥ 0 bound and the
    position + velocity goal row (a custom constraint) against the JAX
    package's problem at 1e-12 (values and Jacobians at random (X, U)); no
    canonical stack, so it runs phase-split. Its AL solve with the default
    options is judged by outcome, as the full-state quadrotor's must be (the
    packages part ways within three iterations even in float64, ROADMAP
    "Gotchas"): c_max < 1e-3 in both, the goal position within 1e-3, and the
    final cost within 10% of the JAX package's."""
    pt = probs.quadrotor_line(N=21, constrained=True, device="cpu")
    pj = jprobs.quadrotor_line(N=21, constrained=True)
    cs, csj = pt.constraints, pj.constraints
    assert cs.labels() == csj.labels() == ("bnd_u", "goal_pv")
    np.testing.assert_array_equal(cs.mask.numpy(), np.asarray(csj.mask))
    np.testing.assert_array_equal(cs.is_eq.numpy(), np.asarray(csj.is_eq))
    X, U = _rand((21, 13), 19), _rand((20, 4), 20)
    Xt, Ut = torch.tensor(X), torch.tensor(U)
    _close(cs.evaluate(Xt, Ut), csj.evaluate(jnp.asarray(X), jnp.asarray(U)))
    for a, b in zip(cs.jacobian(Xt, Ut),
                    csj.jacobian(jnp.asarray(X), jnp.asarray(U))):
        _close(a, b)
    assert canonical_stack(cs, 13, 4, dtype=torch.float64) is None
    for k in ("x0", "xf", "U"):
        np.testing.assert_allclose(getattr(pt, k).numpy(),
                                   np.asarray(getattr(pj, k)), atol=1e-15)
    rt = tt.al_solve(pt, tt.ALOptions())
    rj = jtt.al_solve(pj, jtt.ALOptions())
    for r, X_, xf in ((rt, rt.X.numpy(), pt.xf.numpy()),
                      (rj, np.asarray(rj.X), np.asarray(pj.xf))):
        assert float(r.c_max) < 1e-3
        assert np.linalg.norm(X_[-1, :3] - xf[:3]) < 1e-3
    assert abs(float(rt.J) - float(rj.J)) < 0.1 * abs(float(rj.J))
