"""The standard Riccati sweep on the CUDA kernel K5.

``riccati_sweep_cuda`` wraps ``csrc/riccati_sweep.cu``, the counterpart of
``trajopt_tpu/ops/pallas_riccati.py::riccati_sweep_pallas``: the backward
pass of the default ``bp_type='scan'``. Its plain version is
``ops/riccati.py::scan_sweep``. A tensor on the CPU goes to the plain
version; a CUDA tensor goes to the kernel, and anything the kernel does not
take raises.
"""
from __future__ import annotations

import collections

import torch

from trajopt_tpu_torch.kernels import _build
from trajopt_tpu_torch.ops.cost import Expansion
from trajopt_tpu_torch.ops.riccati import scan_sweep

# the (n, m) pairs csrc/riccati_sweep.cu instantiates: the quadrotor (full
# and error state), cartpole, car, pendulum, double integrator and kuka, and
# each with the n infeasible-start slacks (n, m + n)
SHAPES = ((13, 4), (12, 4), (13, 17), (4, 1), (3, 2), (2, 1), (4, 5), (3, 5),
          (2, 3), (14, 7), (14, 21))


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
            f"{SHAPES}; the rest of the zoo: ROADMAP Queue 2, K6)")
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
