"""The chain minimum-time models of both packages at a few points, for
``tests/test_torch_mintime_chains.py`` and ``tests/test_torch_mintime_kuka.py``:
each chain's JAX reference (its minimum-time step with slacks and that
step's ``jacfwd``) is compiled once, at points with slacks and at the same
points with zero slacks, where the step without slacks is that step and
its Jacobian those columns.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.solvers import altro as jalt

import trajopt_tpu_torch as tt
from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.solvers import altro as alt

jax.config.update("jax_enable_x64", True)

N_SMALL = 5


def problem(lib, rig, slack):
    """The chain's minimum-time problem in package ``lib`` (a small LQR
    problem at dt = 0.01, through the infeasible-start transform first if
    ``slack``)."""
    if lib is jtt:
        model = jtt.discretize(getattr(jrobots, f"{rig}_model")(), "rk3")
        kw, mt = {}, jalt
    else:
        model = tt.discretize(zoo.MODELS[rig], "rk3")
        kw, mt = {"device": "cpu"}, alt
    n, m, N = model.n, model.m, N_SMALL
    p = lib.problem(model, lib.LQRObjective(
        np.eye(n), np.eye(m), np.eye(n), np.zeros(n), N, **kw),
        x0=np.zeros(n), xf=np.zeros(n), N=N, dt=0.01,
        U0=np.zeros((N - 1, m)), **kw)
    return mt.minimum_time_problem(mt.infeasible_problem(p) if slack else p)


def _points(rig, count=4, seed=0):
    """States and controls of the chain's minimum-time model with slacks,
    h in [0.08, 0.15]: ``count`` points with slacks, then the same points
    with the slacks zero."""
    model = zoo.MODELS[rig]
    n = model.n + 1
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(count, n)) * 0.5
    u = rng.normal(size=(count, model.m + n)) * 0.5
    u[:, -1] = rng.uniform(0.08, 0.15, size=count)
    u0 = u.copy()
    u0[:, model.m:-1] = 0.0
    return np.concatenate([x, x]), np.concatenate([u, u0])


@functools.lru_cache(maxsize=None)
def _jax_reference(rig):
    """The JAX package's minimum-time step with slacks and its ``jacfwd``
    at ``_points(rig)``, in one compile a chain: at the points whose slacks
    are zero, the step without slacks is this step and its Jacobian these
    columns."""
    mj = problem(jtt, rig, True).model
    x, u = _points(rig)

    def step(a, b):
        out = mj.step(a, b, 0.01)
        return out, out

    (A, B), out = jax.jit(jax.vmap(jax.jacfwd(
        step, argnums=(0, 1), has_aux=True)))(jnp.asarray(x),
                                               jnp.asarray(u))
    return np.asarray(out), np.asarray(A), np.asarray(B)


def _err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def check_step_and_jacobian(rig, slack):
    """The port's minimum-time model of ``rig`` (with slacks if ``slack``):
    its step and structured Jacobian at 1e-10 of scale against the JAX
    package's step and ``jacfwd``, and against ``jacfwd`` of its own step;
    the model keeps the chain's table."""
    mt = problem(tt, rig, slack).model
    m, n = zoo.MODELS[rig].m, zoo.MODELS[rig].n
    assert (mt.n, mt.m) == (n + 1, m + n * slack + 1)
    assert mt.mintime and mt.chain_table is not None
    x, u = _points(rig)
    step_j, Aj, Bj = _jax_reference(rig)
    half = slice(0, len(x) // 2) if slack else slice(len(x) // 2, None)
    cols = np.arange(u.shape[1]) if slack else np.r_[0:m, u.shape[1] - 1]
    x, u = x[half], u[half][:, cols]
    step_j, Aj, Bj = step_j[half], Aj[half], Bj[half][:, :, cols]
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    assert _err(mt.step(xt, ut, 0.01).numpy(), step_j) < 1e-10
    A, B = mt.jacobian_traj(xt, ut, 0.01)
    assert _err(A.numpy(), Aj) < 1e-10
    assert _err(B.numpy(), Bj) < 1e-10
    Aad, Bad = torch.func.vmap(torch.func.jacfwd(mt.step, argnums=(0, 1)))(
        xt, ut, torch.full((len(x),), 0.01, dtype=torch.float64))
    assert _err(A.numpy(), Aad.numpy()) < 1e-10
    assert _err(B.numpy(), Bad.numpy()) < 1e-10
