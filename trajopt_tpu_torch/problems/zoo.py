"""Problem zoo.

Counterpart of ``trajopt_tpu/problems/zoo.py``: the unconstrained
``quadrotor_line`` and ``quadrotor_maze`` are ported (ROADMAP Queue 1: the
rest of the zoo comes after). Every factory builds on ``device``; None is
the current CUDA device, and the CPU is asked for with ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.models import zoo as dynamics
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.ops.constraints import (
    ConstraintSetBuilder, bound_constraint, obstacle_field_constraint,
)
from trajopt_tpu_torch.ops.cost import LQRObjective
from trajopt_tpu_torch.problem import initial_states, problem
from trajopt_tpu_torch.utils.device import resolve_device
from trajopt_tpu_torch.utils.interp import interp_rows


def quadrotor_line(N=101, dtype=torch.float64, device=None,
                   constrained=False, distance=60.0):
    """Flagship benchmark problem: quadrotor ``distance``-meter translation
    (reference problems/quadrotor.jl spec, tf=5, minus bounds)."""
    if constrained:
        raise NotImplementedError(
            "quadrotor_line(constrained=True) needs custom_constraint "
            "(ROADMAP Queue 1)")
    device = resolve_device(device)
    model_d = discretize(dynamics.quadrotor, "rk3")
    n, m = 13, 4
    x0 = np.zeros(n)
    x0[0:3] = [0.0, 0.0, 10.0]
    x0[3] = 1.0
    xf = np.zeros(n)
    xf[0:3] = [0.0, distance, 10.0]
    xf[3] = 1.0
    Q = np.eye(n) * 1e-3
    Q[3:7, 3:7] = np.eye(4) * 1e-2
    obj = LQRObjective(Q, np.eye(m) * 1e-4, np.eye(n) * 1000.0, xf, N,
                       dtype=dtype, device=device)
    return problem(model_d, obj, x0=x0, xf=xf, N=N, dt=5.0 / (N - 1),
                   U0=np.full((N - 1, m), 0.5 * 9.81 / 4.0), dtype=dtype,
                   device=device)


def _maze_cylinders():
    """(reference problems/quadrotor_maze.jl:27-62): 44 cylinders."""
    r = 2.0
    cylinders = []
    l1, l3, l4 = 5, 4, 10
    for i in np.linspace(-25, -10, l1):
        cylinders.append((i, 10.0, r))
    for i in np.linspace(10, 25, l1):
        cylinders.append((i, 10.0, r))
    for i in np.linspace(-5, 5, l3):
        cylinders.append((i, 30.0, r))
    for i in np.linspace(-25, -10, l1):
        cylinders.append((i, 50.0, r))
    for i in np.linspace(10, 25, l1):
        cylinders.append((i, 50.0, r))
    for i in np.linspace(10 + 2 * r, 50 - 2 * r, l4):
        cylinders.append((-25.0, i, r))
    for i in np.linspace(10 + 2 * r, 50 - 2 * r, l4):
        cylinders.append((25.0, i, r))
    return cylinders


def quadrotor_maze(dtype=torch.float64, device=None):
    """(reference problems/quadrotor_maze.jl): ALTRO flagship: 44 cylinder
    obstacles, state box, terminal velocity box, infeasible-start
    waypoints."""
    device = resolve_device(device)
    model_d = discretize(dynamics.quadrotor, "rk3")
    n, m, N = 13, 4, 101
    tf = 5.0
    q0 = [1.0, 0.0, 0.0, 0.0]
    x0 = np.zeros(n)
    x0[0:3] = [0.0, 0.0, 10.0]
    x0[3:7] = q0
    xf = np.zeros(n)
    xf[0:3] = [0.0, 60.0, 10.0]
    xf[3:7] = q0
    Q = np.eye(n) * 1e-3
    Q[3:7, 3:7] = np.eye(4) * 1e-2
    obj = LQRObjective(Q, np.eye(m) * 1e-4, np.eye(n) * 1000.0, xf, N,
                       dtype=dtype, device=device)

    u_min, u_max = 0.0, 50.0
    x_max = np.full(n, np.inf)
    x_min = np.full(n, -np.inf)
    x_max[0:3] = [25.0, np.inf, 20.0]
    x_min[0:3] = [-25.0, -np.inf, 0.0]
    bnd1 = bound_constraint(n, m, u_min=u_min, u_max=u_max, label="bnd1")
    bnd2 = bound_constraint(n, m, u_min=u_min, u_max=u_max, x_min=x_min,
                            x_max=x_max, label="bnd2")
    xf_U = xf.copy()
    xf_L = xf.copy()
    xf_U[3:7] = np.inf
    xf_L[3:7] = -np.inf
    xf_U[7:10] = 0.0
    xf_L[7:10] = 0.0
    xf_U[10:] = np.inf
    xf_L[10:] = -np.inf
    bnd_xf = bound_constraint(n, m, x_min=xf_L, x_max=xf_U, label="bnd_xf")
    maze = obstacle_field_constraint(_maze_cylinders(), label="maze",
                                     inflate=2.0)  # + r_quad

    cons = ConstraintSetBuilder(N)
    cons.add(bnd1, knots=[0])
    cons.add(bnd2, knots=range(1, N - 1))
    cons.add(maze, knots=range(1, N - 1))
    cons.add(bnd_xf, knots=[N - 1])
    prob = problem(model_d, obj, constraints=cons, x0=x0, xf=xf, N=N, tf=tf,
                   U0=np.full((N - 1, m), 0.5 * 9.81 / 4.0), dtype=dtype,
                   device=device)

    # infeasible waypoint seed (quadrotor_maze.jl:107-114)
    X_guess = np.zeros((n, 7))
    X_guess[:, 0] = x0
    X_guess[:, 6] = xf
    X_guess[0:3, 1:6] = np.array([
        [0, -12.5, -20, -12.5, 0],
        [15, 20, 30, 40, 45],
        [10, 10, 10, 10, 10],
    ])
    X_guess[3:7, :] = np.array(q0)[:, None]
    return initial_states(prob, interp_rows(N, tf, X_guess))
