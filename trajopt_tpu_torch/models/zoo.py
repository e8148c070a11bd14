"""Analytic dynamics models.

Counterpart of ``trajopt_tpu/models/zoo.py``: the quaternion quadrotor, the
four models whose scalar lane step the JAX package ships (pendulum, double
integrator, car, cartpole), ballonbeam, the Euler-angle quadrotor, the
analytic two-link double pendulum and acrobot, and the uncertain pendulum and
cart-pole (``f(x, u, w)``, r = 1, which ``discretize_uncertain`` steps; no
kernel carries them, they run wherever their tensors are). The JAX package
registers no lane step for ballonbeam, the Euler-angle quadrotor and the
two-link models, so they never run fused; the rollout kernel K2 carries
them (``ops/cuda_models.py``), so their phase-split solves run on the card.
``MODELS`` names the models here with the four rigid-body rigs (kuka and
the URDF acrobot, double pendulum and cartpole). Every function
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


def pendulum_dynamics_uncertain(x, u, w):
    # reference dynamics/pendulum.jl:18-29 (unknown mass)
    m = 1.0 + w[..., 0:1]
    b, lc, g = 0.1, 0.5, 9.81
    th, om = x[..., 0:1], x[..., 1:2]
    return torch.cat([om, u[..., 0:1] / (m * lc * lc)
                      - g * torch.sin(th) / lc - b * om / (m * lc * lc)],
                     dim=-1)


pendulum_uncertain = Model(pendulum_dynamics_uncertain, 2, 1, r=1,
                           name="pendulum_uncertain")

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


def cartpole_dynamics_uncertain(x, u, w):
    """reference dynamics/cartpole.jl:44-72 (an unknown force disturbance w
    on the cart): q̈ = −H⁻¹(C q̇ + G − B u − B w), which is the nominal
    cart-pole's dynamics with the force u + w, its 2×2 solve the same
    explicit inverse (the JAX package's is ``spd_solve_vec``; the two agree
    to rounding, held at 1e-12 in float64)."""
    return cartpole_dynamics(x, u[..., 0:1] + w[..., 0:1])


cartpole_uncertain = Model(cartpole_dynamics_uncertain, 4, 1, r=1,
                           name="cartpole_uncertain")

# ------------------------------------------------------------ ball on beam
# reference dynamics/ballonbeam.jl:3-24


def ballonbeam_dynamics(x, u):
    g, m1, m2, l = 9.81, 0.35, 2.0, 0.5
    z, th, zd, thd = x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]
    c = torch.cos(th)
    zdd = z * (thd * thd) - g * torch.sin(th)
    thdd = (u[..., 0:1] * l * c - (2.0 * m1) * z * zd * thd
            - (m1 * g) * z * c - ((m2 * g * l) * c) / 2.0) \
        / (m2 * l**2 / 3.0 + m1 * (z * z))
    return torch.cat([zd, thd, zdd, thdd], dim=-1)


ballonbeam = Model(ballonbeam_dynamics, 4, 1, name="ballonbeam")

# ---------------------------------------------------- double pendulum family
# reference dynamics/doublependulum.jl and acrobot.jl, built there from
# dynamics/urdf/doublependulum.urdf: the same two-link mechanism (m1 = m2 = 1,
# link 1 joint to joint 1 m, COM at 0.5 m, iyy1 = 0.083; link 2 COM at 1 m,
# iyy2 = 0.33) by the planar manipulator equations. No damping: the
# reference's RigidBodyDynamics.jl ignores the URDF's <dynamics damping>.
# The 2x2 mass-matrix solve is written as an explicit inverse, as the
# cart-pole's (the JAX package solves it by ``spd_solve_vec``; the two agree
# to rounding, held at 1e-12 in float64), in the order of K2's step
# (csrc/models.cuh TwoLink).

_DP = dict(m1=1.0, m2=1.0, l1=1.0, lc1=0.5, lc2=1.0, I1=0.083, I2=0.33,
           b1=0.0, b2=0.0, g=9.81)


def _two_link_dynamics(x, tau1, tau2):
    p = _DP
    q1, q2 = x[..., 0:1], x[..., 1:2]
    qd1, qd2 = x[..., 2:3], x[..., 3:4]
    c2, s2 = torch.cos(q2), torch.sin(q2)

    # mass matrix of the 2R manipulator (Spong eq. 7.87)
    a = p["I1"] + p["I2"] + p["m1"] * p["lc1"] ** 2 \
        + p["m2"] * (p["l1"] ** 2 + p["lc2"] ** 2)
    b = p["m2"] * p["l1"] * p["lc2"]
    d = p["I2"] + p["m2"] * p["lc2"] ** 2
    H11 = a + 2.0 * b * c2
    H12 = d + b * c2
    # Coriolis and centrifugal terms
    C1 = -b * s2 * qd2 * (2.0 * qd1 + qd2)
    C2 = b * s2 * qd1 * qd1
    # gravity, q measured from hanging straight down
    s12 = torch.sin(q1 + q2)
    G1 = (p["m1"] * p["lc1"] + p["m2"] * p["l1"]) * p["g"] * torch.sin(q1) \
        + p["m2"] * p["lc2"] * p["g"] * s12
    G2 = p["m2"] * p["lc2"] * p["g"] * s12
    r1 = tau1 - C1 - G1 - p["b1"] * qd1
    r2 = tau2 - C2 - G2 - p["b2"] * qd2
    # H = [[H11, H12], [H12, d]]
    det = H11 * d - H12 * H12
    qdd1 = (d * r1 - H12 * r2) / det
    qdd2 = (H11 * r2 - H12 * r1) / det
    return torch.cat([qd1, qd2, qdd1, qdd2], dim=-1)


def doublependulum_dynamics(x, u):
    return _two_link_dynamics(x, u[..., 0:1], u[..., 1:2])


def acrobot_dynamics(x, u):
    # elbow-only actuation (reference dynamics/acrobot.jl:6, B = [0; 1])
    return _two_link_dynamics(x, torch.zeros_like(u[..., 0:1]), u[..., 0:1])


doublependulum = Model(doublependulum_dynamics, 4, 2, name="doublependulum")
acrobot = Model(acrobot_dynamics, 4, 1, name="acrobot")

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


# ------------------------------------------------------- quadrotor (Euler)
# reference dynamics/quadrotor_euler.jl. State (12): pos(3), rpy(3),
# vel(3), rpy rates(3).


def _rows(*rows):
    """A (…, 3, 3) matrix from three rows of three (…, 1) entries."""
    return torch.stack([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _rpy2rotmat(rpy):
    cr, sr = torch.cos(rpy[..., 0:1]), torch.sin(rpy[..., 0:1])
    cp, sp = torch.cos(rpy[..., 1:2]), torch.sin(rpy[..., 1:2])
    cy, sy = torch.cos(rpy[..., 2:3]), torch.sin(rpy[..., 2:3])
    return _rows([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                 [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                 [-sp, cp * sr, cp * cr])


def _rpydot2angularvel_matrix(rpy):
    cp, sp = torch.cos(rpy[..., 1:2]), torch.sin(rpy[..., 1:2])
    cy, sy = torch.cos(rpy[..., 2:3]), torch.sin(rpy[..., 2:3])
    z, o = torch.zeros_like(cp), torch.ones_like(cp)
    return _rows([cp * cy, -sy, z], [cp * sy, cy, z], [-sp, z, o])


def _angularvel2rpydot_matrix(rpy):
    sp, cp = torch.sin(rpy[..., 1:2]), torch.cos(rpy[..., 1:2])
    sy, cy = torch.sin(rpy[..., 2:3]), torch.cos(rpy[..., 2:3])
    tp = sp / cp
    z, o = torch.zeros_like(cp), torch.ones_like(cp)
    return _rows([cy / cp, sy / cp, z], [-sy, cy, z], [cy * tp, tp * sy, o])


def _rpy_g(rpy):
    """G(rpy) = A(rpy)·R(rpy) = _angularvel2rpydot_matrix ·
    _rpy2rotmat, the map from body rates to rpy rates, in its closed form
    [[1, sr·tp, cr·tp], [0, cr, −sr], [0, sr/cp, cr/cp]] (the product with
    cos² + sin² = 1 taken out; the yaw drops out), which ``torch.func.jvp``
    differentiates in a fraction of the product's tensor operations."""
    sr, cr = torch.sin(rpy[..., 0:1]), torch.cos(rpy[..., 0:1])
    sp, cp = torch.sin(rpy[..., 1:2]), torch.cos(rpy[..., 1:2])
    tp = sp / cp
    z, o = torch.zeros_like(cp), torch.ones_like(cp)
    return _rows([o, sr * tp, cr * tp], [z, cr, -sr], [z, sr / cp, cr / cp])


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def quadrotor_euler_dynamics(x, u):
    m, g, L, kf, km = 0.5, 9.81, 0.1750, 1.0, 0.0245
    J = (0.0023, 0.0023, 0.004)
    rpy, rpyd = x[..., 3:6], x[..., 9:12]
    R = _rpy2rotmat(rpy)
    F = [kf * u[..., i:i + 1] for i in range(4)]
    Mo = [km * u[..., i:i + 1] for i in range(4)]
    sumF = ((F[0] + F[1]) + F[2]) + F[3]
    acc = R[..., :, 2] * sumF
    xyz_ddot = torch.cat([acc[..., 0:1], acc[..., 1:2],
                          -m * g + acc[..., 2:3]], dim=-1) / m
    # body angular velocity from the rpy rates (world → body by Rᵀ, as in
    # the reference)
    pqr = _mv(R.transpose(-1, -2), _mv(_rpydot2angularvel_matrix(rpy), rpyd))
    tau = torch.cat([L * (F[1] - F[3]), L * (F[2] - F[0]),
                     Mo[0] - Mo[1] + Mo[2] - Mo[3]], dim=-1)
    Jp = torch.cat([J[i] * pqr[..., i:i + 1] for i in range(3)], dim=-1)
    rhs = tau - torch.linalg.cross(pqr, Jp, dim=-1)
    pqr_dot = torch.cat([(1.0 / J[i]) * rhs[..., i:i + 1] for i in range(3)],
                        dim=-1)
    # rpy accelerations: the product rule on rpẏ = G(rpy)·pqr, with
    # Ġ = jvp(G)(rpy; rpẏ) (the JAX package's form)
    G, G_dot = torch.func.jvp(_rpy_g, (rpy,), (rpyd,))
    rpy_ddot = _mv(G, pqr_dot) + _mv(G_dot, pqr)
    return torch.cat([x[..., 6:12], xyz_ddot, rpy_ddot], dim=-1)


quadrotor_euler = Model(quadrotor_euler_dynamics, 12, 4,
                        name="quadrotor_euler")


def _robot_models():
    """The URDF-rig models (``models/robots.py``), by name."""
    from trajopt_tpu_torch.models import robots

    return {"kuka": robots.kuka_model(),
            "doublependulum_urdf": robots.doublependulum_urdf_model(),
            "acrobot_urdf": robots.acrobot_urdf_model(),
            "cartpole_urdf": robots.cartpole_urdf_model()}


MODELS = {"pendulum": pendulum, "pendulum_uncertain": pendulum_uncertain,
          "doubleintegrator": doubleintegrator, "car": car,
          "cartpole": cartpole, "cartpole_uncertain": cartpole_uncertain,
          "ballonbeam": ballonbeam,
          "quadrotor": quadrotor, "quadrotor_euler": quadrotor_euler,
          "doublependulum": doublependulum, "acrobot": acrobot,
          **_robot_models()}
