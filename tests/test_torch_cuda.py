"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a GPU and
skips without one, so on a CPU-only machine the file collects and skips.
On a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Small shapes (B=16, N=21) in float32, at the f32 tolerances of
tests/test_pallas.py; chip_smoke.py repeats the comparison at the main
path's shapes.
"""
import numpy as np
import pytest
import torch

from trajopt_tpu_torch.models import zoo
from trajopt_tpu_torch.models.base import Model, discretize
from trajopt_tpu_torch.models.quaternions import project_error_state
from trajopt_tpu_torch.ops.cost import Expansion, cost_expansion
from trajopt_tpu_torch.ops.cuda_rollout import rollout_closed_loop_cuda
from trajopt_tpu_torch.ops.cuda_sqrt import (
    equilibrated_chol_upper, plain_chol_upper, sqrt_sweep, sqrt_sweep_cuda,
)
from trajopt_tpu_torch.ops.rollout import rollout, rollout_closed_loop
from trajopt_tpu_torch.problems.zoo import quadrotor_line

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

B, N = 16, 21


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def linearization(cuda_device):
    prob = quadrotor_line(N=N, dtype=torch.float64, device=cuda_device,
                          distance=20.0)
    rng = np.random.default_rng(3)
    x0s = torch.as_tensor(prob.x0.cpu().numpy()[None]
                          + rng.normal(size=(B, 13)) * 0.02,
                          device=cuda_device)
    U = prob.U.expand(B, -1, -1)
    dt = prob.dt_traj()
    X = rollout(prob.model, x0s, U, dt)
    A, Bm = prob.model.jacobian_traj(X[:, :-1], U, dt)
    A, Bm, e = project_error_state(X, A, Bm, cost_expansion(prob.obj, X, U,
                                                             dt), (3, 7))
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    return (f32(A), f32(Bm), Expansion(*(f32(getattr(e, k)) for k in
                                         ("x", "u", "xx", "uu", "ux"))),
            f32(X), f32(U), prob.dt)


@pytest.mark.parametrize("rho_val", [0.0, 1e-2])
def test_sqrt_kernel_matches_twin(linearization, rho_val):
    A, Bm, e, _, _, _ = linearization
    rho = torch.full((B,), rho_val, device=A.device)
    before = sqrt_sweep_cuda.launches
    K1, d1, v11, v21, f1 = sqrt_sweep_cuda(A, Bm, e.x, e.u, e.xx, e.uu, e.ux,
                                           rho)
    torch.cuda.synchronize()
    assert sqrt_sweep_cuda.launches == before + 1
    K0, d0, v10, v20, f0 = sqrt_sweep(A, Bm, e, rho)
    assert torch.equal(f1, f0)
    assert (K1 - K0).abs().max() < 2e-3 * K0.abs().max()
    assert (d1 - d0).abs().max() < 1e-1 * (d0.abs().max() + 1e-12)
    torch.testing.assert_close(v11, v10, rtol=3e-2, atol=1e-5)
    torch.testing.assert_close(v21, v20, rtol=3e-2, atol=1e-5)


def _make_indefinite(luu, lane, knot, off):
    """Replace one stage's control Hessian by c·[[1, off], [off, 1]] ⊕ c·I
    (tests/test_torch_sqrt.py): indefinite for off > 1."""
    c = luu[lane, knot, 0, 0]
    M = c * torch.eye(4, dtype=luu.dtype, device=luu.device)
    M[0, 1] = M[1, 0] = c * off
    luu[lane, knot] = M


def test_sqrt_kernel_branches_match_twin(linearization):
    """At rho = 0, lane 5 has a mildly indefinite stage: the plain float32
    factor breaks down and the equilibrated one succeeds on its pivot
    floor. Lane 9 has a strongly indefinite stage: both factors break down,
    the lane fails and its gains at that stage are zero."""
    A, Bm, e, _, _, _ = linearization
    luu = e.uu.clone()
    _make_indefinite(luu, 5, 7, 1.0 + 2e-4)
    _make_indefinite(luu, 9, 12, 1.5)
    joint = torch.cat([torch.cat([luu[5, 7], e.ux[5, 7]], -1),
                       torch.cat([e.ux[5, 7].T, e.xx[5, 7]], -1)], -2)
    assert bool(plain_chol_upper(joint)[1])
    assert not bool(equilibrated_chol_upper(joint)[1])
    rho = torch.zeros(B, device=A.device)
    K1, d1, v11, v21, f1 = sqrt_sweep_cuda(A, Bm, e.x, e.u, e.xx, luu, e.ux,
                                           rho)
    torch.cuda.synchronize()
    e_indef = Expansion(x=e.x, u=e.u, xx=e.xx, uu=luu, ux=e.ux)
    K0, d0, v10, v20, f0 = sqrt_sweep(A, Bm, e_indef, rho)
    assert f1.nonzero().flatten().tolist() == [9]
    assert torch.equal(f1, f0)
    assert not bool(K1[9, 12].any()) and not bool(d1[9, 12].any())
    assert (K1 - K0).abs().max() < 2e-3 * K0.abs().max()
    assert (d1 - d0).abs().max() < 1e-1 * (d0.abs().max() + 1e-12)
    torch.testing.assert_close(v11, v10, rtol=3e-2, atol=1e-5)
    torch.testing.assert_close(v21, v20, rtol=3e-2, atol=1e-5)


def test_rollout_kernel_matches_twin(linearization):
    A, Bm, e, X, U, dt = linearization
    K, d, _, _, _ = sqrt_sweep_cuda(A, Bm, e.x, e.u, e.xx, e.uu, e.ux,
                                    torch.zeros(B, device=A.device))
    d = d.clone()
    d[5] *= 1e9
    alpha = torch.full((B,), 0.5, device=A.device)
    model = discretize(zoo.quadrotor, "rk3")
    x0 = X[:, 0].contiguous()
    Xk, Uk, okk = rollout_closed_loop_cuda(model, x0, X, U, K, d, alpha, dt,
                                           quat_slice=(3, 7))
    torch.cuda.synchronize()
    Xt, Ut, okt = rollout_closed_loop(model, x0, X, U, K, d, alpha, dt,
                                      quat_slice=(3, 7))
    assert torch.equal(okk, okt) and not bool(okk[5])
    torch.testing.assert_close(Xk[okk], Xt[okt], rtol=0, atol=1e-4)
    torch.testing.assert_close(Uk[okk], Ut[okt], rtol=0, atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    z = lambda *s, dt=torch.float64: torch.zeros(  # noqa: E731
        s, dtype=dt, device=cuda_device)
    with pytest.raises(ValueError):
        sqrt_sweep_cuda(z(2, 3, 12, 12), z(2, 3, 12, 4), z(2, 4, 12),
                        z(2, 3, 4), z(2, 4, 12, 12), z(2, 3, 4, 4),
                        z(2, 3, 4, 12), z(2))
    quad = discretize(zoo.quadrotor, "rk3")
    with pytest.raises(ValueError):
        rollout_closed_loop_cuda(quad, z(2, 13), z(2, 4, 13), z(2, 3, 4),
                                 z(2, 3, 4, 12), z(2, 3, 4), z(2), 0.05,
                                 quat_slice=(3, 7))
    f = torch.float32
    with pytest.raises(ValueError):  # the kernel runs the error state only
        rollout_closed_loop_cuda(quad, z(2, 13, dt=f), z(2, 4, 13, dt=f),
                                 z(2, 3, 4, dt=f), z(2, 3, 4, 13, dt=f),
                                 z(2, 3, 4, dt=f), z(2, dt=f), 0.05,
                                 quat_slice=None)
    other = discretize(Model(zoo.quadrotor_dynamics, 13, 4, name="custom"),
                       "rk3")
    with pytest.raises(NotImplementedError):
        rollout_closed_loop_cuda(other, z(2, 13, dt=f), z(2, 4, 13, dt=f),
                                 z(2, 3, 4, dt=f), z(2, 3, 4, 12, dt=f),
                                 z(2, 3, 4, dt=f), z(2, dt=f), 0.05,
                                 quat_slice=(3, 7))
