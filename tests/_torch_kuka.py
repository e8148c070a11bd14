"""Kuka inputs shared by the CPU tests of K7a's and K7b's plain versions
(``tests/test_torch_kuka_fused_kernels.py``,
``tests/test_torch_kuka_fused_forward.py``), made by the JAX package in
float64."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.ops.rollout import rollout as jax_rollout
from trajopt_tpu.problems import zoo as jzoo

from trajopt_tpu_torch import convert
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.ops.cost import Objective


def t(a):
    """A JAX or numpy array as a torch tensor on the CPU."""
    return torch.as_tensor(np.array(a))


def kuka_setup(Bz, N, seed=0):
    """The kuka objective cut to N knots at its dt (0.125 s), starts around
    the hold pose (q noise 0.05), each start's hold torques plus 1e-3 noise
    and the open-loop rollouts, by the JAX package in float64. (With 0.05
    noise on the torques the undamped arm reaches |x| ~ 1e6 within 8 steps,
    where the gains of any two orders of elimination part at 1e-4.)
    Returns the JAX model, the port's model, the JAX and the port's
    objective, and x0s, X, U and dt_traj as JAX arrays."""
    pj = jzoo.kuka_obstacles(dtype=jnp.float64)
    jm = pj.model
    obj = jtt.LQRObjective(np.asarray(pj.obj.Q[0]), np.asarray(pj.obj.R[0]),
                           np.asarray(pj.obj.Q[-1]), np.asarray(pj.xf), N)
    rng = np.random.default_rng(seed)
    q0 = np.asarray(pj.x0)[None, :7] + rng.normal(size=(Bz, 7)) * 0.05
    x0s = jnp.asarray(np.concatenate([q0, np.zeros((Bz, 7))], axis=1))
    hold = np.stack([np.asarray(jrobots.kuka_hold_trajectory(
        jm.model.chain, q, N)) for q in q0])
    U = jnp.asarray(hold + rng.normal(size=hold.shape) * 1e-3)
    dt_traj = jnp.full((N - 1,), 0.125)
    X = jax.vmap(lambda a, b: jax_rollout(jm, a, b, dt_traj))(x0s, U)
    assert float(jnp.abs(X).max()) < 10.0
    md = discretize(convert.MODELS["kuka"], "rk3")
    tobj = Objective(**{k: t(getattr(obj, k))
                        for k in ("Q", "R", "H", "q", "r", "c")})
    return jm, md, obj, tobj, x0s, X, U, dt_traj
