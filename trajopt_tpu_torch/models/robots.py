"""Robot descriptions.

Counterpart of ``trajopt_tpu/models/robots.py``. The reference ships URDF
files (reference dynamics/urdf/*); here the same public parameters (KUKA
iiwa 14 from the kuka_iiwa_description package; the cartpole, double
pendulum and acrobot rigs) are Python structures built into
:class:`RigidBodyChain` models, with no file I/O. ``model_from_urdf``
(``models/rigidbody.py``) still reads a user's file. ``kuka_ee_ik`` is not
ported (ROADMAP Queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.models.base import Model
from trajopt_tpu_torch.models.rigidbody import (
    RigidBodyChain, UrdfJoint, UrdfLink, chain_model,
)

_PI = float(np.pi)
_HP = _PI / 2.0


def _link(name, mass=0.0, com=(0, 0, 0), I_diag=(0, 0, 0), iyz=0.0):
    inertia = np.diag(np.asarray(I_diag, dtype=np.float64))
    inertia[1, 2] = inertia[2, 1] = iyz
    return UrdfLink(name=name, mass=mass,
                    com=np.asarray(com, dtype=np.float64), inertia=inertia)


def _joint(name, jtype, parent, child, xyz=(0, 0, 0), rpy=(0, 0, 0),
           axis=(0, 0, 1), damping=0.0):
    return UrdfJoint(name=name, jtype=jtype, parent=parent, child=child,
                     origin_xyz=np.asarray(xyz, dtype=np.float64),
                     origin_rpy=np.asarray(rpy, dtype=np.float64),
                     axis=np.asarray(axis, dtype=np.float64), damping=damping)


def _chain(links, joints):
    return RigidBodyChain(links={lk.name: lk for lk in links}, joints=joints)


# ------------------------------------------------------- KUKA iiwa 14 (7R)
# kinematics and inertials of the public kuka_iiwa_description URDF
# (reference dynamics/urdf/kuka_iiwa.urdf)

def kuka_chain() -> RigidBodyChain:
    links = [
        _link("base"),
        _link("l0", 5.0, (-0.1, 0, 0.07), (0.05, 0.06, 0.03)),
        _link("l1", 5.76, (0, -0.03, 0.12), (0.033, 0.0333, 0.0123),
              iyz=0.004887),
        _link("l2", 6.35, (0.0003, 0.059, 0.042), (0.0305, 0.0304, 0.011),
              iyz=0.004887),
        _link("l3", 3.5, (0, 0.03, 0.13), (0.025, 0.0238, 0.0076),
              iyz=0.00487),
        _link("l4", 3.5, (0, 0.067, 0.034), (0.017, 0.0164, 0.006),
              iyz=0.00284),
        _link("l5", 3.5, (0.0001, 0.021, 0.076), (0.01, 0.0087, 0.00449),
              iyz=0.00309),
        _link("l6", 1.8, (0, 0.0006, 0.0004), (0.0049, 0.0047, 0.0036),
              iyz=0.000246),
        _link("l7", 1.2, (0, 0, 0.02), (0.0002, 0.0002, 0.0003)),
        _link("ee"),
    ]
    d = 0.5
    joints = [
        _joint("j0", "fixed", "base", "l0"),
        _joint("j1", "revolute", "l0", "l1", xyz=(0, 0, 0.1575), damping=d),
        _joint("j2", "revolute", "l1", "l2", xyz=(0, 0, 0.2025),
               rpy=(_HP, 0, _PI), damping=d),
        _joint("j3", "revolute", "l2", "l3", xyz=(0, 0.2045, 0),
               rpy=(_HP, 0, _PI), damping=d),
        _joint("j4", "revolute", "l3", "l4", xyz=(0, 0, 0.2155),
               rpy=(_HP, 0, 0), damping=d),
        _joint("j5", "revolute", "l4", "l5", xyz=(0, 0.1845, 0),
               rpy=(-_HP, _PI, 0), damping=d),
        _joint("j6", "revolute", "l5", "l6", xyz=(0, 0, 0.2155),
               rpy=(_HP, 0, 0), damping=d),
        _joint("j7", "revolute", "l6", "l7", xyz=(0, 0.081, 0),
               rpy=(-_HP, _PI, 0), damping=d),
        _joint("jee", "fixed", "l7", "ee", xyz=(0, 0, 0.045)),
    ]
    return _chain(links, joints)


# --------------------------------------------- two-link pendulum mechanism
# (reference dynamics/urdf/doublependulum.urdf and acrobot.urdf: one rig)

def doublependulum_chain() -> RigidBodyChain:
    links = [
        _link("base"),
        _link("upper", 1.0, (0, 0, -0.5), (1.0, 0.083, 1.0)),
        _link("lower", 1.0, (0, 0, -1.0), (1.0, 0.33, 1.0)),
    ]
    joints = [
        _joint("shoulder", "continuous", "base", "upper", xyz=(0, 0.15, 0),
               axis=(0, 1, 0), damping=0.1),
        _joint("elbow", "continuous", "upper", "lower", xyz=(0, 0.1, -1),
               axis=(0, 1, 0), damping=0.1),
    ]
    return _chain(links, joints)


# ------------------------------------------------------------ cartpole rig
# (reference dynamics/urdf/cartpole.urdf: 1 kg cart, 10 kg pole at 0.5 m)

def cartpole_chain() -> RigidBodyChain:
    links = [
        _link("bar"),
        _link("cart", 1.0, (0, 0, 0), (1.0, 1.0, 1.0)),
        _link("pole", 10.0, (0, 0, 0.5), (1.0, 1.0, 1.0)),
    ]
    joints = [
        _joint("slide", "prismatic", "bar", "cart", axis=(1, 0, 0)),
        _joint("hinge", "continuous", "cart", "pole", axis=(0, 1, 0)),
    ]
    return _chain(links, joints)


def _model_from_chain(chain: RigidBodyChain, actuated=None, name="robot",
                      gravity=9.81) -> Model:
    # use_damping=False matches the reference: RigidBodyDynamics.jl does
    # not parse URDF <dynamics damping> (reference model.jl:411-415)
    return chain_model(chain, actuated, name=name, gravity=gravity,
                       use_damping=False)


def kuka_model() -> Model:
    """(reference dynamics/kuka.jl): n=14, m=7."""
    return _model_from_chain(kuka_chain(), name="kuka")


def doublependulum_urdf_model() -> Model:
    """(reference dynamics/doublependulum.jl)."""
    return _model_from_chain(doublependulum_chain(),
                             name="doublependulum_urdf")


def acrobot_urdf_model() -> Model:
    """(reference dynamics/acrobot.jl): elbow-only actuation."""
    return _model_from_chain(doublependulum_chain(), actuated=[0.0, 1.0],
                             name="acrobot_urdf")


def cartpole_urdf_model() -> Model:
    """(reference dynamics/cartpole.jl cartpole_urdf): slider-only
    actuation."""
    return _model_from_chain(cartpole_chain(), actuated=[1.0, 0.0],
                             name="cartpole_urdf")


def kuka_hold_trajectory(chain: RigidBodyChain, q, N: int,
                         dtype=torch.float64, device="cpu"):
    """Gravity-compensation controls (N-1, nd) holding configuration q
    (reference hold_trajectory, dynamics/kuka.jl:129-145)."""
    q = torch.as_tensor(np.asarray(q), dtype=dtype, device=device)
    tau = chain.bias_forces(q, torch.zeros_like(q))
    return tau.expand(N - 1, q.shape[0])
