"""Problem zoo.

Counterpart of ``trajopt_tpu/problems/zoo.py``: ``doubleintegrator``,
``pendulum``, ``cartpole``, ``parallel_park``, ``car_3obs``, ``car_escape``,
the unconstrained ``quadrotor_line`` and ``quadrotor_maze`` are ported
(ROADMAP Queue 1: the rest of the zoo comes after). Every factory builds on
``device``; None is the current CUDA device, and the CPU is asked for with
``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.models import zoo as dynamics
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.ops.canonical import fk_sphere_canon
from trajopt_tpu_torch.ops.constraints import (
    ConstraintSetBuilder, bound_constraint, fk_sphere_constraint,
    goal_constraint, obstacle_field_constraint,
)
from trajopt_tpu_torch.ops.cost import LQRObjective
from trajopt_tpu_torch.problem import initial_states, problem
from trajopt_tpu_torch.utils.device import resolve_device
from trajopt_tpu_torch.utils.interp import interp_rows


def _bounded_goal_problem(model, Q, R, Qf, xf, N, u_bnd, U0, dtype, device,
                          **time):
    """LQR objective, a control box and a goal constraint: the shape of
    the doubleintegrator, pendulum and cartpole problems."""
    device = resolve_device(device)
    model_d = discretize(model, "rk3")
    n, m = model.n, model.m
    obj = LQRObjective(np.eye(n) * Q, np.eye(m) * R, np.eye(n) * Qf, xf, N,
                       dtype=dtype, device=device)
    cons = ConstraintSetBuilder(N)
    cons.add(bound_constraint(n, m, u_min=-u_bnd, u_max=u_bnd))
    cons.add(goal_constraint(xf))
    return problem(model_d, obj, constraints=cons, x0=np.zeros(n), xf=xf,
                   N=N, U0=U0, dtype=dtype, device=device, **time)


def doubleintegrator(dtype=torch.float64, device=None):
    """(reference problems/doubleintegrator.jl): N=21, dt=0.1, u∈[−1.5,1.5]."""
    N = 21
    U0 = 0.001 * np.random.default_rng(0).random((N - 1, 1))
    return _bounded_goal_problem(
        dynamics.doubleintegrator, 1.0, 1e-1, 1.0, np.array([1.0, 0.0]), N,
        1.5, U0, dtype, device, dt=0.1)


def pendulum(dtype=torch.float64, device=None):
    """(reference problems/pendulum.jl): N=31, dt=0.15, swing-up, u∈[−3,3]."""
    N = 31
    return _bounded_goal_problem(
        dynamics.pendulum, 1e-3, 1e-3, 1e-3, np.array([np.pi, 0.0]), N, 3.0,
        np.ones((N - 1, 1)), dtype, device, dt=0.15)


def cartpole(dtype=torch.float64, device=None):
    """(reference problems/cartpole.jl): N=101, tf=5, swing-up, u∈[−3,3]."""
    N = 101
    return _bounded_goal_problem(
        dynamics.cartpole, 1e-2, 1e-1, 100.0,
        np.array([0.0, np.pi, 0.0, 0.0]), N, 3.0, np.full((N - 1, 1), 0.01),
        dtype, device, tf=5.0)


def parallel_park(dtype=torch.float64, device=None):
    """(reference problems/parallel_park.jl): car, N=51, state box + goal."""
    device = resolve_device(device)
    model_d = discretize(dynamics.car, "rk3")
    n, m, N = 3, 2, 51
    xf = np.array([0.0, 1.0, 0.0])
    obj = LQRObjective(np.eye(n) * 1e-2, np.eye(m) * 1e-2, np.eye(n) * 100.0,
                       xf, N, dtype=dtype, device=device)
    u_bnd = 2.0
    bnd1 = bound_constraint(n, m, u_min=-u_bnd, u_max=u_bnd, label="bnd1")
    bnd2 = bound_constraint(n, m, x_min=[-0.25, -0.001, -np.inf],
                            x_max=[0.25, 1.001, np.inf],
                            u_min=-u_bnd, u_max=u_bnd, label="bnd2")
    cons = ConstraintSetBuilder(N)
    cons.add(bnd1, knots=[0])
    cons.add(bnd2, knots=range(1, N - 1))
    cons.add(goal_constraint(xf))
    return problem(model_d, obj, constraints=cons, x0=np.zeros(n), xf=xf,
                   N=N, dt=0.06, U0=np.ones((N - 1, m)), dtype=dtype,
                   device=device)


# (reference problems/car_3obs.jl:12-20)
CAR_3OBS_CIRCLES = [(0.25, 0.25, 0.1), (0.5, 0.5, 0.1), (0.75, 0.75, 0.1)]


def car_3obs(dtype=torch.float64, device=None):
    """(reference problems/car_3obs.jl): 3 circular obstacles on the
    diagonal."""
    device = resolve_device(device)
    model_d = discretize(dynamics.car, "rk3")
    n, m, N = 3, 2, 101
    xf = np.array([1.0, 1.0, 0.0])
    obj = LQRObjective(np.eye(n), np.eye(m) * 1e-1, np.eye(n) * 100.0, xf, N,
                       dtype=dtype, device=device)
    cons = ConstraintSetBuilder(N)
    cons.add(obstacle_field_constraint(CAR_3OBS_CIRCLES, label="obs"),
             knots=range(1, N - 1))
    cons.add(goal_constraint(xf))
    return problem(model_d, obj, constraints=cons, x0=np.zeros(n), xf=xf,
                   N=N, dt=0.05, U0=np.full((N - 1, m), 0.01), dtype=dtype,
                   device=device)


def _escape_circles():
    """(reference problems/car_escape.jl:20-46): 170 obstacle circles
    (3·30 + 50 + 2·15)."""
    r = 0.5
    s1, s2, s3 = 30, 50, 15
    circles = []
    for xc in (0.0, 5.0, 10.0):
        for i in np.linspace(0, 5, s1):
            circles.append((xc, i, r))
    for i in np.linspace(0, 10, s2):
        circles.append((i, 0.0, r))
    for i in np.linspace(0, 3, s3):
        circles.append((i, 5.0, r))
    for i in np.linspace(5, 8, s3):
        circles.append((i, 5.0, r))
    return circles


def car_escape(dtype=torch.float64, device=None):
    """(reference problems/car_escape.jl): the car leaves a walled room of
    170 circles through its one gap; control box, goal, and an
    infeasible-start state seed through five waypoints (N=101, tf=3;
    P = 177, and 180 with the slack rows of the infeasible-start
    transform)."""
    device = resolve_device(device)
    model_d = discretize(dynamics.car, "rk3")
    n, m, N = 3, 2, 101
    tf = 3.0
    x0 = np.array([2.5, 2.5, 0.0])
    xf = np.array([7.5, 2.5, 0.0])
    obj = LQRObjective(np.eye(n) * 1e-3, np.eye(m) * 1e-2, np.eye(n) * 100.0,
                       xf, N, dtype=dtype, device=device)
    cons = ConstraintSetBuilder(N)
    cons.add(bound_constraint(n, m, u_min=-5.0, u_max=5.0))
    cons.add(obstacle_field_constraint(_escape_circles(), label="trap"),
             knots=range(1, N - 1))
    cons.add(goal_constraint(xf))
    prob = problem(model_d, obj, constraints=cons, x0=x0, xf=xf, N=N, tf=tf,
                   U0=np.ones((N - 1, m)), dtype=dtype, device=device)
    # infeasible-start seed (car_escape.jl:68-71)
    X_guess = np.array([
        [2.5, 2.5, 0.0], [4.0, 5.0, 0.785], [5.0, 6.25, 0.0],
        [7.5, 6.25, -0.261], [9.0, 5.0, -1.57], [7.5, 2.5, 0.0],
    ]).T
    return initial_states(prob, interp_rows(N, tf, X_guess))


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


def kuka_obstacles(dtype=torch.float64, device=None):
    """(reference problems/kuka_obstacles.jl): the 7-DOF arm, collision
    bubbles at links 3-6 and the end effector against 3 spheres and 3
    cylinders, torque bounds, the goal constraint, the gravity-compensation
    hold as the control seed. n = 14, m = 7, N = 41, tf = 5; no state seed
    (a feasible start)."""
    from trajopt_tpu_torch.models import robots

    device = resolve_device(device)
    model = dynamics.MODELS["kuka"]
    chain = model.chain
    model_d = discretize(model, "rk3")
    n, m, N = 14, 7, 41
    x0 = np.zeros(n)
    x0[1:4] = np.pi / 2
    xf = np.zeros(n)
    xf[0] = np.pi / 2
    xf[3] = np.pi / 2
    obj = LQRObjective(np.diag(np.concatenate([np.ones(7), np.ones(7) * 100.0])),
                       1e-2 * np.eye(m), 10.0 * np.eye(n), xf, N, dtype=dtype,
                       device=device)

    # collision bubbles (kuka_obstacles.jl:14-36): the frames of links 3-6
    # (moving joints 2..5) and a point 4.5 cm along the last link; rows
    # obstacle-major, the spheres' then the cylinders' (x, y only)
    body_idx = [2, 3, 4, 5]
    radii = np.array([0.1, 0.12, 0.09, 0.09, 0.05])
    d = 0.25
    spheres = np.array([[d, 0.0, 1.2, 0.2], [0.0, -d, 0.4, 0.15],
                        [0.0, -d, 1.2, 0.15]])
    cylinders = np.array([[d, -d, 0.08], [d, d, 0.08], [-d, -d, 0.08]])
    points = [(b, None) for b in body_idx] + \
        [(chain.ndof - 1, (0.0, 0.0, 0.045))]
    rows = [(i, sp[:3], float((radii[i] + sp[3]) ** 2), (0, 1, 2))
            for sp in spheres for i in range(5)]
    rows += [(i, (cy[0], cy[1], 0.0), float((radii[i] + cy[2]) ** 2), (0, 1))
             for cy in cylinders for i in range(5)]
    obs = fk_sphere_constraint(fk_sphere_canon(chain, points, rows), "obs")

    cons = ConstraintSetBuilder(N)
    cons.add(bound_constraint(n, m, u_min=-80.0, u_max=80.0),
             knots=range(0, N - 1))
    cons.add(obs, knots=range(1, N - 1))
    cons.add(goal_constraint(xf))
    U0 = robots.kuka_hold_trajectory(chain, x0[:7], N).numpy()
    return problem(model_d, obj, constraints=cons, x0=x0, xf=xf, N=N, tf=5.0,
                   U0=U0, dtype=dtype, device=device)
