"""Analytic dynamics models.

Counterpart of ``trajopt_tpu/models/zoo.py``: the quaternion quadrotor and
the four models whose scalar lane step the JAX package ships (pendulum,
double integrator, car, cartpole); the rest of the zoo is ROADMAP Queue 1.
``MODELS`` names them with the four rigid-body rigs of ``models/robots.py``
(kuka and the URDF acrobot, double pendulum and cartpole). Every function
takes states with any leading batch dimensions and works under
``torch.func.vmap``/``jacfwd``.

Every component is taken as a width-1 slice, never a 0-d index: under
``torch.func.jacfwd`` a Python float times a 0-d element is promoted to
float64, which breaks float32 solves. Each function keeps the order of
operations of its CUDA counterpart in ``csrc/models.cuh``.
"""
from __future__ import annotations

import torch

from trajopt_tpu_torch.models.base import Model

# ---------------------------------------------------------------- pendulum
# reference dynamics/pendulum.jl:3-14


def pendulum_dynamics(x, u):
    m, b, lc, I_, g = 1.0, 0.1, 0.5, 0.25, 9.81
    th, w = x[..., 0:1], x[..., 1:2]
    return torch.cat(
        [w, (u[..., 0:1] - m * g * lc * torch.sin(th) - b * w) / I_], dim=-1)


pendulum = Model(pendulum_dynamics, 2, 1, name="pendulum")

# ------------------------------------------------------- double integrator
# reference dynamics/double_integrator.jl:1-9


def double_integrator_dynamics(x, u):
    return torch.cat([x[..., 1:2], u[..., 0:1]], dim=-1)


doubleintegrator = Model(double_integrator_dynamics, 2, 1,
                         name="doubleintegrator")

# --------------------------------------------------------------------- car
# reference dynamics/car.jl:3-11 (Dubins/unicycle kinematics)


def car_dynamics(x, u):
    th, v = x[..., 2:3], u[..., 0:1]
    return torch.cat([v * torch.cos(th), v * torch.sin(th), u[..., 1:2]],
                     dim=-1)


car = Model(car_dynamics, 3, 2, name="car")

# ---------------------------------------------------------------- cartpole
# reference dynamics/cartpole.jl:9-40 (manipulator equations). The 2x2
# mass-matrix solve is written as an explicit inverse, as the JAX package's
# lane step does (ops/pallas_rollout.py::cartpole_dynamics_lanes).


def cartpole_dynamics(x, u):
    mc, mp, l, g = 1.0, 0.2, 0.5, 9.81
    th, v, w = x[..., 1:2], x[..., 2:3], x[..., 3:4]
    s, c = torch.sin(th), torch.cos(th)
    # H = [[mc+mp, mp l c], [mp l c, mp l^2]]
    h11 = mc + mp
    h12 = mp * l * c
    h22 = mp * l * l
    det = h11 * h22 - h12 * h12
    # rhs = B u - C qd - G  with C qd = [-mp w l s * w, 0], G = [0, mp g l s]
    r1 = u[..., 0:1] + mp * w * l * s * w
    r2 = -mp * g * l * s
    vd = (h22 * r1 - h12 * r2) / det
    wd = (h11 * r2 - h12 * r1) / det
    return torch.cat([v, w, vd, wd], dim=-1)


cartpole = Model(cartpole_dynamics, 4, 1, name="cartpole")

# -------------------------------------------------- quadrotor (quaternion)
# reference dynamics/quadrotor.jl:1-73 + dynamics/quaternions.jl.
# State (13): pos(3), quaternion [w,x,y,z](4), vel(3), omega(3).

QUAD_PARAMS = dict(
    m=0.5,
    J=(0.0023, 0.0023, 0.004),      # diagonal inertia
    gravity=(0.0, 0.0, -9.81),
    motor_dist=0.1750,
    kf=1.0,
    km=0.0245,
)


def quat_mul(q1, q2):
    """Hamilton product q1 ⊗ q2, scalar-first [w, x, y, z]."""
    w1, v1 = q1[..., :1], q1[..., 1:]
    w2, v2 = q2[..., :1], q2[..., 1:]
    w = w1 * w2 - (v1 * v2).sum(-1, keepdim=True)
    v = w1 * v2 + w2 * v1 + torch.linalg.cross(v1, v2, dim=-1)
    return torch.cat([w, v], dim=-1)


def quat_rotate(q, r):
    """Rotate vector r by unit quaternion q (reference
    dynamics/quaternions.jl:31-37)."""
    w, v = q[..., :1], q[..., 1:]
    return r + 2.0 * torch.linalg.cross(
        v, torch.linalg.cross(v, r, dim=-1) + w * r, dim=-1)


def quadrotor_dynamics(x, u, params=None):
    p = QUAD_PARAMS if params is None else params
    q = x[..., 3:7]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    v = x[..., 7:10]
    omega = x[..., 10:13]

    kf, km, L = p["kf"], p["km"], p["motor_dist"]
    F_rotors = kf * u
    F = [F_rotors[..., i:i + 1] for i in range(4)]
    F_body = torch.cat([torch.zeros_like(v[..., :2]),
                        F_rotors.sum(-1, keepdim=True)], dim=-1)
    M = [km * u[..., i:i + 1] for i in range(4)]
    tau = torch.cat([L * (F[1] - F[3]), L * (F[2] - F[0]),
                     M[0] - M[1] + M[2] - M[3]], dim=-1)

    qdot = 0.5 * quat_mul(q, torch.cat([torch.zeros_like(q[..., :1]), omega],
                                       dim=-1))
    # gravity and the diagonal inertia stay Python floats: a tensor made
    # from them per call would be a host-to-device copy on every step
    acc = quat_rotate(q, F_body) / p["m"]
    vdot = torch.cat([g + acc[..., i:i + 1]
                      for i, g in enumerate(p["gravity"])], dim=-1)
    J = p["J"]
    Jw = torch.cat([J[i] * omega[..., i:i + 1] for i in range(3)], dim=-1)
    rhs = tau - torch.linalg.cross(omega, Jw, dim=-1)
    omegadot = torch.cat([(1.0 / J[i]) * rhs[..., i:i + 1] for i in range(3)],
                         dim=-1)

    return torch.cat([v, qdot, vdot, omegadot], dim=-1)


quadrotor = Model(quadrotor_dynamics, 13, 4, name="quadrotor")
quadrotor.quat_slice = (3, 7)  # unit quaternion at x[3:7]


def _robot_models():
    """The URDF-rig models (``models/robots.py``), by name."""
    from trajopt_tpu_torch.models import robots

    return {"kuka": robots.kuka_model(),
            "doublependulum_urdf": robots.doublependulum_urdf_model(),
            "acrobot_urdf": robots.acrobot_urdf_model(),
            "cartpole_urdf": robots.cartpole_urdf_model()}


MODELS = {"pendulum": pendulum, "doubleintegrator": doubleintegrator,
          "car": car, "cartpole": cartpole, "quadrotor": quadrotor,
          **_robot_models()}
