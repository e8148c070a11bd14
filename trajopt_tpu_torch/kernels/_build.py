"""Build and load the port's CUDA kernels.

Every ``trajopt_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` into one
shared library with a plain C interface, at first use, for the Hopper
target ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v \\
         -o build/libtrajopt_kernels_<hash>.so csrc/*.cu

The library lands in ``build/`` at the root of the checkout, named by a hash
of the sources and flags, so an edited kernel is rebuilt and an unchanged one
is reused. nvcc's output, with ptxas's registers, shared memory and spills
of every kernel, is kept beside it as ``libtrajopt_kernels_<hash>.log``.
The library is loaded with ``ctypes``; every pointer and the stream are
``c_void_p`` arguments. Nothing here runs at import time: this module imports
on machines without ``nvcc`` or a card, and only :func:`load` needs them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (see the csrc/*.cu sources)
SIGNATURES = {
    # A, B, lx, lu, lxx, luu, lux, rho, K, d, dV, fail, batch, N, n, m, stream
    "trajopt_sqrt_sweep_f32": (_P,) * 12 + (_I,) * 4 + (_P,),
    # x0, X, U, K, d, alpha, Xout, Uout, ok, batch, N, dt, max_state,
    # max_control, stream
    "trajopt_rollout_quadrotor_f32": (_P,) * 9 + (_I,) * 2 + (_F,) * 3
    + (_P,),
}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtrajopt_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def build() -> Path:
    """Compile the kernels unless the library for these sources exists,
    and keep nvcc's report beside it (``.log``). Returns the library's
    path; raises RuntimeError with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build if needed, load the library once per process and declare the
    argument types of every entry point."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


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
