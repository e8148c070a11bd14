"""The port's rigid-body chains against the JAX package, on the CPU.

``models/rigidbody.py`` (CRBA, RNEA, forward kinematics, the dynamics and
the structured Jacobians), ``models/robots.py`` (the four rigs and the
gravity-compensation hold) and ``models/rigidbody_lanes.py`` (the tables of
the kernels' ``Chain`` trait and its plain version) in float64, on the same
numpy-seeded inputs as the JAX package: the chain quantities at 1e-12 of
their scale, the trajectory Jacobians at 1e-10 (their sums run in another
order), the plain version of the lane step at 1e-9 (the tolerance of
tests/test_robust.py:295-320 for the JAX lane step), and the chain tables
exactly. The id tables of ``csrc/models.cuh`` and ``ops/cuda_models.py``
must agree.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trajopt_tpu as jtt
from trajopt_tpu.models import robots as jrobots
from trajopt_tpu.models.rigidbody import model_from_urdf as jax_from_urdf
from trajopt_tpu.models.rigidbody_lanes import (
    _joint_affine_coeffs as jax_joint_coeffs,
    make_chain_dynamics_lanes as jax_lanes,
    make_chain_step_lanes as jax_step_lanes,
)
from trajopt_tpu.ops.canonical import _fk_affine_coeffs as jax_fk_coeffs

from trajopt_tpu_torch.models import robots
from trajopt_tpu_torch.models.base import discretize
from trajopt_tpu_torch.models.rigidbody import model_from_urdf
from trajopt_tpu_torch.models.rigidbody_lanes import (
    CHAIN_MAX_DOF, _joint_affine_coeffs, chain_table,
    make_chain_dynamics_lanes, make_chain_step_lanes,
)
from trajopt_tpu_torch.ops.canonical import _fk_affine_coeffs
from trajopt_tpu_torch.ops.cuda_models import CUDA_STEPS, SLACK_ID

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "trajopt_tpu_torch" / "csrc"
# (rig, actuation of the JAX lane test, tests/test_robust.py:304-309)
RIGS = {"kuka": None, "acrobot_urdf": np.array([[0.0], [1.0]]),
        "doublependulum_urdf": None,
        "cartpole_urdf": np.array([[1.0], [0.0]])}


def _models(name):
    return (getattr(jrobots, f"{name}_model")(),
            getattr(robots, f"{name}_model")())


def _scaled_err(mine, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(mine) - ref).max() / (np.abs(ref).max() + 1.0)


@pytest.mark.parametrize("name", list(RIGS))
def test_chain_matches_jax(name):
    """mass_matrix, bias_forces, inverse_dynamics, forward_kinematics (with
    a point and the axes) and dynamics on 5 random states: 1e-12 of
    scale."""
    jm, tm = _models(name)
    nd = jm.n // 2
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, jm.n)) * 0.5
    u = rng.normal(size=(5, jm.m))
    qdd = rng.normal(size=(5, nd))
    q, qd = x[:, :nd], x[:, nd:]
    jc, tc = jm.chain, tm.chain
    T = torch.as_tensor
    pt = np.array([0.0, 0.0, 0.045])

    def jfk(qi):
        return jc.forward_kinematics(qi, point=jnp.asarray(pt),
                                     return_axes=True)

    pairs = [
        (jax.vmap(jc.mass_matrix)(jnp.asarray(q)), tc.mass_matrix(T(q))),
        (jax.vmap(jc.bias_forces)(jnp.asarray(q), jnp.asarray(qd)),
         tc.bias_forces(T(q), T(qd))),
        (jax.vmap(jc.inverse_dynamics)(jnp.asarray(q), jnp.asarray(qd),
                                       jnp.asarray(qdd)),
         tc.inverse_dynamics(T(q), T(qd), T(qdd))),
        (jax.vmap(jm.dynamics)(jnp.asarray(x), jnp.asarray(u)),
         tm.dynamics(T(x), T(u))),
    ] + list(zip(jax.vmap(jfk)(jnp.asarray(q)),
                 tc.forward_kinematics(T(q), point=pt, return_axes=True)))
    for ref, mine in pairs:
        assert mine.shape == ref.shape
        assert _scaled_err(mine.numpy(), ref) < 1e-12


@pytest.mark.parametrize("name", list(RIGS))
def test_structured_jacobians_match_jax(name):
    """``jacobian_traj`` of the RK3 step (the structured linearization
    chained through the stages) against the JAX package's (jacfwd through
    its custom JVP), 12 random knots: 1e-10 of scale."""
    jm, tm = _models(name)
    jd, td = jtt.discretize(jm, "rk3"), discretize(tm, "rk3")
    rng = np.random.default_rng(1)
    X = rng.normal(size=(12, jm.n)) * 0.5
    U = rng.normal(size=(12, jm.m))
    dt = np.full(12, 0.125)
    A, Bm = jd.jacobian_traj(jnp.asarray(X), jnp.asarray(U), jnp.asarray(dt))
    At, Bt = td.jacobian_traj(torch.as_tensor(X), torch.as_tensor(U),
                              torch.as_tensor(dt))
    assert _scaled_err(At.numpy(), A) < 1e-10
    assert _scaled_err(Bt.numpy(), Bm) < 1e-10


def test_kuka_hold_trajectory_matches_jax():
    """The gravity-compensation hold of the kuka start (the seed of
    kuka_obstacles) and of a random pose: 1e-12 of scale."""
    jc, tc = jrobots.kuka_chain(), robots.kuka_chain()
    for q in (np.array([0.0, np.pi / 2, np.pi / 2, np.pi / 2, 0, 0, 0]),
              np.random.default_rng(2).normal(size=7)):
        ref = jrobots.kuka_hold_trajectory(jc, jnp.asarray(q), 41)
        mine = robots.kuka_hold_trajectory(tc, q, 41)
        assert mine.shape == (40, 7)
        assert _scaled_err(mine.numpy(), ref) < 1e-12


@pytest.mark.parametrize("name", list(RIGS))
def test_lane_step_plain_version_matches_jax(name):
    """The plain version of the kernels' Chain trait against the JAX lane
    dynamics and lane RK3 step (batch on the last axis there), 8 random
    states: 1e-9 of scale (tests/test_robust.py:295-320)."""
    jm, tm = _models(name)
    Bsel = RIGS[name]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(jm.n, 8)) * 0.5
    u = rng.normal(size=(jm.m, 8))
    f_j = jax_lanes(jm.chain, B=Bsel, use_damping=False)
    f_t = make_chain_dynamics_lanes(tm.chain, B=Bsel, use_damping=False)
    X, Uu = torch.as_tensor(x.T), torch.as_tensor(u.T)
    assert _scaled_err(f_t(X, Uu).numpy().T,
                       f_j(jnp.asarray(x), jnp.asarray(u))) < 1e-9
    s_j = jax_step_lanes(jm.chain, B=Bsel, use_damping=False)
    s_t = make_chain_step_lanes(tm.chain, B=Bsel, use_damping=False)
    assert _scaled_err(s_t(X, Uu, 0.125).numpy().T,
                       s_j(jnp.asarray(x), jnp.asarray(u), 0.125)) < 1e-9


@pytest.mark.parametrize("name", list(RIGS))
def test_chain_tables_equal_jax(name):
    """The affine joint coefficients, parents and folded inertias, and for
    the revolute chains the FK coefficients, are the JAX package's bit for
    bit; the kernels' table holds them with every |c| < 1e-12 zeroed, in
    the field order of csrc/models.cuh."""
    jm, tm = _models(name)
    jc, jp, jI = jax_joint_coeffs(jm.chain)
    tc, tp, tI = _joint_affine_coeffs(tm.chain)
    assert jp == tp and len(jc) == len(tc)
    for a, b in zip(jc, tc):
        assert a[0] == b[0]
        for u, v in zip(a[1:], b[1:]):
            assert np.array_equal(u, v)
    for u, v in zip(jI, tI):
        assert np.array_equal(u, v)
    if name != "cartpole_urdf":
        (fa, fpa), (fb, fpb) = jax_fk_coeffs(jm.chain), \
            _fk_affine_coeffs(tm.chain)
        assert fpa == fpb
        for a, b in zip(fa, fb):
            for u, v in zip(a, b):
                assert np.array_equal(u, v)
    D = CHAIN_MAX_DOF
    tab = chain_table(tm.chain, B=RIGS[name], use_damping=False,
                      dtype=np.float64)
    C = tab[:D * 108].reshape(D, 3, 36)
    for k, (_, C0, Cs, Cc, _) in enumerate(tc):
        for i, M in enumerate((C0, Cs, Cc)):
            want = np.where(np.abs(M) < 1e-12, 0.0, M).reshape(36)
            assert np.array_equal(C[k, i], want)
    nd = tm.chain.ndof
    assert tab[-3:].tolist() == [9.81, nd, tm.m]
    assert tab.dtype == np.float64
    assert chain_table(tm.chain, B=RIGS[name]).dtype == np.float32


def test_model_ids_and_table_size_agree_with_models_cuh():
    """csrc/models.cuh's ModelId enum against ops/cuda_models.py (the base
    ids, and kModelSlack against SLACK_ID), and the size of its ChainTable
    against chain_table's length."""
    src = (CSRC / "models.cuh").read_text()
    enum = dict((name, int(v)) for name, v in re.findall(
        r"kModel(\w+) = (\d+)", src))
    names = {"Quadrotor": "quadrotor", "Cartpole": "cartpole", "Car": "car",
             "Pendulum": "pendulum", "DoubleIntegrator": "doubleintegrator",
             "Kuka": "kuka"}
    assert enum.pop("Slack") == SLACK_ID
    assert {names[k]: v for k, v in enum.items()} == {
        cm.label: cm.id for cm in CUDA_STEPS.values()}
    assert len(set(enum.values())) == len(enum) and max(enum.values()) \
        < SLACK_ID
    D = int(re.search(r"kChainMaxDof = (\d+)", src).group(1))
    assert D == CHAIN_MAX_DOF
    fields = re.search(r"struct ChainTable \{(.*?)\};", src, re.S).group(1)
    size = 0
    for dims in re.findall(r"float ([^;]+);", fields):
        for item in dims.split(","):
            shape = re.findall(r"\[(\w+)\]", item)
            size += int(np.prod([D if s == "kChainMaxDof" else int(s)
                                 for s in shape])) if shape else 1
    assert size == len(chain_table(robots.kuka_chain()))


URDF = """<robot name="two_link">
  <link name="base"/>
  <link name="upper">
    <inertial><mass value="1.0"/><origin xyz="0 0 -0.5"/>
      <inertia ixx="1.0" iyy="0.083" izz="1.0" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <link name="lower">
    <inertial><mass value="1.0"/><origin xyz="0 0 -1.0"/>
      <inertia ixx="1.0" iyy="0.33" izz="1.0" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="shoulder" type="continuous">
    <parent link="base"/><child link="upper"/>
    <origin xyz="0 0.15 0"/><axis xyz="0 1 0"/><dynamics damping="0.1"/>
  </joint>
  <joint name="elbow" type="continuous">
    <parent link="upper"/><child link="lower"/>
    <origin xyz="0 0.1 -1"/><axis xyz="0 1 0"/><dynamics damping="0.1"/>
  </joint>
</robot>
"""


def test_model_from_urdf_matches_jax(tmp_path):
    """A user's URDF file (the double pendulum rig, damping parsed and
    used, the elbow actuated) read by both packages: dynamics and RK3
    Jacobians at 1e-12 and 1e-10 of scale."""
    path = tmp_path / "two_link.urdf"
    path.write_text(URDF)
    jm = jax_from_urdf(str(path), actuated=[0.0, 1.0])
    tm = model_from_urdf(str(path), actuated=[0.0, 1.0])
    assert (tm.n, tm.m) == (jm.n, jm.m) == (4, 1)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 4))
    u = rng.normal(size=(6, 1))
    ref = jax.vmap(jm.dynamics)(jnp.asarray(x), jnp.asarray(u))
    assert _scaled_err(tm.dynamics(torch.as_tensor(x),
                                   torch.as_tensor(u)).numpy(), ref) < 1e-12
    A, Bm = jtt.discretize(jm, "rk3").jacobian_traj(
        jnp.asarray(x), jnp.asarray(u), jnp.full(6, 0.05))
    At, Bt = discretize(tm, "rk3").jacobian_traj(
        torch.as_tensor(x), torch.as_tensor(u), torch.full((6,), 0.05,
                                                           dtype=torch.float64))
    assert _scaled_err(At.numpy(), A) < 1e-10
    assert _scaled_err(Bt.numpy(), Bm) < 1e-10
