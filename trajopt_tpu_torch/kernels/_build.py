"""Build and load the port's CUDA kernels.

Every ``trajopt_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` into a
shared library of its own with a plain C interface, at first use, for the
Hopper target ``sm_90a``; the compilers of all sources run side by side:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v \\
         -o build/lib<source>_<hash>.so csrc/<source>.cu

The libraries land in ``build/`` at the root of the checkout, named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited kernel is rebuilt and an unchanged one is reused. nvcc's output, with
ptxas's registers, shared memory and spills of every kernel, is kept beside
each as ``lib<source>_<hash>.log``. The libraries are loaded with
``ctypes``; every pointer and the stream are ``c_void_p`` arguments. Nothing
here runs at import time: this module imports on machines without ``nvcc``
or a card, and only :func:`load` needs them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import types
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points by source file, and their argument types (see csrc/*.cu)
SIGNATURES = {
    "sqrt_sweep": {
        # A, B, lx, lu, lxx, luu, lux, rho, K, d, dV, fail, batch, N, n, m,
        # stream
        "trajopt_sqrt_sweep_f32": (_P,) * 12 + (_I,) * 4 + (_P,)},
    "rollout": {
        # x0, X, U, K, d, alpha, Xout, Uout, ok, chain, batch, N, model,
        # error_state, dt, max_state, max_control, stream
        "trajopt_rollout_f32": (_P,) * 10 + (_I,) * 4 + (_F,) * 3 + (_P,)},
    "riccati_sweep": {
        # A, B, lx, lu, lxx, luu, lux, rho, K, d, dV, fail, batch, N, n, m,
        # reg_state, stream
        "trajopt_riccati_sweep_f32": (_P,) * 12 + (_I,) * 5 + (_P,)},
    "fused_backward": {
        # X, U, dt, Q, R, H, q, r, rho, K, d, dV, fail, Aout, Bout, batch, N,
        # model, reg_state, stream
        "trajopt_fused_backward_f32": (_P,) * 15 + (_I,) * 4 + (_P,)},
    "fused_forward": {
        # x0, X, U, K, d, dV1, dV2, Jprev, rho, drho, alpha0, dt, Q, R, H, q,
        # r, c, active, Xout, Uout, scal, batch, N, model, ls_iters, ls_lb,
        # ls_ub, reg_min, reg_factor, reg_fp, stream
        "trajopt_fused_forward_f32": (_P,) * 22 + (_I,) * 4 + (_F,) * 5
        + (_P,)},
    "fused_al_backward": {
        # X, U, lam, mu, dt, Q, R, H, q, r, rho, row_i, row_f, groups,
        # col_ptr, col_rows, fk_joint, fk_point, chain, K, d, dV, fail, Aout,
        # Bout, batch, N, P, G, J, npts, model, reg_state, atol, stream
        "trajopt_fused_al_backward_f32": (_P,) * 25 + (_I,) * 8 + (_F, _P)},
    "fused_al_forward": {
        # x0, X, U, K, d, dV1, dV2, Jprev, rho, drho, alpha0, lam, mu, dt, Q,
        # R, H, q, r, c, row_i, row_f, fk_joint, fk_point, active, chain,
        # Xout, Uout, scal, batch, N, P, J, npts, model, ls_iters, ls_lb,
        # ls_ub, reg_min, reg_factor, reg_fp, atol, stream
        "trajopt_fused_al_forward_f32": (_P,) * 29 + (_I,) * 7 + (_F,) * 6
        + (_P,)},
}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def build() -> dict:
    """Compile every source whose library does not exist yet, all at once
    (one nvcc process per source), and keep nvcc's report beside each
    library (``.log``). Returns {source stem: library path}; raises
    RuntimeError with nvcc's output if a compile fails."""
    libs = {src.stem: library_path(src) for src in _sources()}
    todo = [src for src in _sources() if not libs[src.stem].exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        jobs.append((src, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
            continue
        libs[src.stem].with_suffix(".log").write_text(out)
        os.replace(tmp, libs[src.stem])
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


@functools.lru_cache(maxsize=1)
def load() -> types.SimpleNamespace:
    """Build if needed, load the libraries once per process and return
    their entry points, argument types declared, as one namespace."""
    libs = build()
    fns = {}
    for stem, entries in SIGNATURES.items():
        lib = ctypes.CDLL(str(libs[stem]))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            fns[name] = fn
    return types.SimpleNamespace(**fns)


def stream(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the C entry points
    take it."""
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def check(err: int, name: str):
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_input(fn: str, name: str, t, shape, device):
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on the
    CUDA ``device``: the kernels take nothing else."""
    if not (t.is_cuda and t.device == device and t.dtype == torch.float32
            and t.is_contiguous()):
        raise ValueError(
            f"{fn}: {name} must be a contiguous float32 tensor on {device}, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
