"""The standard Riccati sweep on the CUDA kernel K5.

``riccati_sweep_cuda`` wraps ``csrc/riccati_sweep.cu``, the counterpart of
``trajopt_tpu/ops/pallas_riccati.py::riccati_sweep_pallas``: the backward
pass of the default ``bp_type='scan'``, a load pipeline (producer warps
copy the knots into shared memory ahead of the consumer warps that run the
Riccati step; ``riccati_sweep_shape`` tells the block it takes). Its plain version is
``ops/riccati.py::scan_sweep``. A tensor on the CPU goes to the plain
version; a CUDA tensor goes to the kernel, and anything the kernel does not
take raises.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from trajopt_tpu_torch.kernels import _build
from trajopt_tpu_torch.ops.cost import Expansion
from trajopt_tpu_torch.ops.riccati import scan_sweep

# the (n, m) pairs csrc/riccati_sweep.cu instantiates: the quadrotor (full
# and error state), cartpole (and the acrobots and the cartpole rig), car,
# pendulum, double integrator, kuka, the double pendulums, ballonbeam and
# the Euler-angle quadrotor, each with the n infeasible-start slacks
# (n, m + n), and every model's minimum-time forms (n + 1, m + 1) with and
# without the slacks; several models share a pair
SHAPES = ((13, 4), (12, 4), (13, 17), (4, 1), (3, 2), (2, 1), (4, 5), (3, 5),
          (2, 3), (14, 7), (14, 21), (4, 2), (4, 6), (12, 16), (5, 2), (4, 3),
          (14, 5), (13, 5), (3, 4), (5, 6), (14, 18), (15, 8), (15, 22),
          (5, 3), (5, 7))


def riccati_sweep_cuda(A, B, lx, lu, lxx, luu, lux, rho,
                       reg_state: bool = False):
    """Batched Riccati sweep on kernel K5. Batch-first inputs as
    ``riccati_sweep_pallas``: A (B, N-1, n, n), B (B, N-1, n, m),
    lx (B, N, n), lu (B, N-1, m), lxx (B, N, n, n), luu (B, N-1, m, m),
    lux (B, N-1, m, n), rho (B,). Returns (K, d, dV1, dV2, fail). CPU
    tensors run the plain version; CUDA tensors must be contiguous float32
    with (n, m) one of ``SHAPES``, or this raises."""
    if A.device.type == "cpu":
        return scan_sweep(A, B, Expansion(x=lx, u=lu, xx=lxx, uu=luu, ux=lux),
                          rho, reg_state=reg_state)
    fn = "riccati_sweep_cuda"
    Bz, Nm1, n, m = B.shape
    N = Nm1 + 1
    if (n, m) not in SHAPES:
        raise NotImplementedError(
            f"{fn}: no kernel instantiation for n={n}, m={m} (there are "
            f"{SHAPES}: the shapes of the models the kernels carry; another "
            "model's are ROADMAP Queue 1 work)")
    for name, t, shape in (
            ("A", A, (Bz, Nm1, n, n)), ("B", B, (Bz, Nm1, n, m)),
            ("lx", lx, (Bz, N, n)), ("lu", lu, (Bz, Nm1, m)),
            ("lxx", lxx, (Bz, N, n, n)), ("luu", luu, (Bz, Nm1, m, m)),
            ("lux", lux, (Bz, Nm1, m, n)), ("rho", rho, (Bz,))):
        _build.check_input(fn, name, t, shape, A.device)

    lib = _build.load()
    K = torch.empty((Bz, Nm1, m, n), dtype=A.dtype, device=A.device)
    d = torch.empty((Bz, Nm1, m), dtype=A.dtype, device=A.device)
    dV = torch.empty((2, Bz), dtype=A.dtype, device=A.device)
    fail = torch.empty((Bz,), dtype=torch.bool, device=A.device)
    err = lib.trajopt_riccati_sweep_f32(
        A.data_ptr(), B.data_ptr(), lx.data_ptr(), lu.data_ptr(),
        lxx.data_ptr(), luu.data_ptr(), lux.data_ptr(), rho.data_ptr(),
        K.data_ptr(), d.data_ptr(), dV.data_ptr(), fail.data_ptr(),
        Bz, N, n, m, int(bool(reg_state)), _build.stream(A.device))
    _build.check(err, "trajopt_riccati_sweep_f32")
    riccati_sweep_cuda.launches += 1
    riccati_sweep_cuda.launches_by[f"{n}x{m}"] += 1
    return K, d, dV[0], dV[1], fail


# launches in all, and by the kernel's instantiation
riccati_sweep_cuda.launches = 0
riccati_sweep_cuda.launches_by = collections.Counter()


def riccati_sweep_shape(n: int, m: int, batch: int) -> dict:
    """The block K5 launches for (n, m) at ``batch`` problems on the current
    CUDA device (``csrc/knot_pipeline.cuh``): its consumer and producer
    warps, the slots of its ring and its shared-memory bytes."""
    if (n, m) not in SHAPES:
        raise NotImplementedError(
            f"riccati_sweep_shape: no kernel instantiation for n={n}, m={m}")
    out = (ctypes.c_int * 4)()
    _build.check(_build.load().trajopt_riccati_sweep_shape(
        n, m, batch, ctypes.addressof(out)), "trajopt_riccati_sweep_shape")
    return dict(consumers=out[0], producers=out[1], slots=out[2],
                smem_bytes=out[3])
