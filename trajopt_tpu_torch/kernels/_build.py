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
or a card, and only :func:`load` needs them. :func:`load` starts the
compilers and returns at once; each library is waited for and loaded when
one of its entry points is first used, so a kernel whose source has
compiled runs while the others still compile (``fused_al_backward.cu``
takes several times the others' seconds).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points by source file, and their argument types (see csrc/*.cu)
SIGNATURES = {
    "sqrt_sweep": {
        # n, m, batch, shape (5 ints of host memory) -> the launch's Wc, Wp,
        # S, shared bytes and knots a producer step at that batch
        "trajopt_sqrt_sweep_shape": (_I, _I, _I, _P),
        # A, B, lx, lu, lxx, luu, lux, rho, K, d, dV, fail, batch, N, n, m,
        # stream
        "trajopt_sqrt_sweep_f32": (_P,) * 12 + (_I,) * 4 + (_P,)},
    "rollout": {
        # x0, X, U, K, d, alpha, Xout, Uout, ok, chain, batch, N, model,
        # error_state, dt, max_state, max_control, stream
        "trajopt_rollout_f32": (_P,) * 10 + (_I,) * 4 + (_F,) * 3 + (_P,)},
    "riccati_sweep": {
        # n, m, batch, shape (4 ints of host memory) -> the launch's Wc, Wp,
        # S and shared bytes at that batch
        "trajopt_riccati_sweep_shape": (_I, _I, _I, _P),
        # A, B, lx, lu, lxx, luu, lux, rho, K, d, dV, fail, batch, N, n, m,
        # reg_state, stream
        "trajopt_riccati_sweep_f32": (_P,) * 12 + (_I,) * 5 + (_P,)},
    "fused_backward": {
        # model, batch, shape (5 ints of host memory) -> the launch's Wc,
        # Wp, S, shared bytes and knots a producer step at that batch
        "trajopt_fused_backward_shape": (_I, _I, _P),
        # X, U, dt, Q, R, H, q, r, rho, chain, K, d, dV, fail, Aout, Bout,
        # batch, N, model, reg_state, stream
        "trajopt_fused_backward_f32": (_P,) * 16 + (_I,) * 4 + (_P,)},
    "fused_forward": {
        # model, batch -> the warps a block takes (W)
        "trajopt_fused_forward_warps": (_I, _I),
        # x0, X, U, K, d, dV1, dV2, Jprev, rho, drho, alpha0, dt, Q, R, H, q,
        # r, c, active, chain, ws, ws_floats, Xout, Uout, scal, batch, N,
        # model, ls_iters, ls_lb, ls_ub, reg_min, reg_factor, reg_fp, stream
        "trajopt_fused_forward_f32": (_P,) * 21 + (_L,) + (_P,) * 3
        + (_I,) * 4 + (_F,) * 5 + (_P,)},
    "fused_al_backward": {
        # X, U, lam, mu, dt, Q, R, H, q, r, rho, row_i, row_f, groups,
        # col_ptr, col_rows, fk_joint, fk_point, chain, K, d, dV, fail, Aout,
        # Bout, batch, N, P, G, J, npts, model, reg_state, atol, shape (4
        # ints of host memory: the launch's Wc, Wp, S, shared bytes), stream
        "trajopt_fused_al_backward_f32": (_P,) * 25 + (_I,) * 8
        + (_F, _P, _P)},
    "fused_al_forward": {
        # model, batch -> the warps a block takes (W)
        "trajopt_fused_al_forward_warps": (_I, _I),
        # x0, X, U, K, d, dV1, dV2, Jprev, rho, drho, alpha0, lam, mu, dt, Q,
        # R, H, q, r, c, row_i, row_f, fk_joint, fk_point, active, chain, ws,
        # ws_floats, Xout, Uout, scal, batch, N, P, J, npts, model, ls_iters,
        # ls_lb, ls_ub, reg_min, reg_factor, reg_fp, atol, stream
        "trajopt_fused_al_forward_f32": (_P,) * 27 + (_L,) + (_P,) * 3
        + (_I,) * 7 + (_F,) * 6 + (_P,)},
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


# source stem -> its running compile: the thread that waits for nvcc, and
# what it leaves (the command, the temporary library, the output)
_JOBS = {}


def start_build() -> dict:
    """Start nvcc, one process per source, for every source whose library
    does not exist yet and is not being compiled, and return at once:
    {source stem: library path}. A thread per compile records its seconds
    from the start of this batch in ``build.seconds`` when nvcc ends."""
    libs = {src.stem: library_path(src) for src in _sources()}
    todo = [src for src in _sources()
            if not libs[src.stem].exists() and src.stem not in _JOBS]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    build.seconds.clear()
    t0 = time.perf_counter()
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        job = dict(cmd=cmd, tmp=tmp, proc=proc)

        def finish(job=job, stem=src.stem):
            job["out"], _ = job["proc"].communicate()
            build.seconds[stem] = time.perf_counter() - t0

        job["thread"] = threading.Thread(target=finish, daemon=True)
        job["thread"].start()
        _JOBS[src.stem] = job
    return libs


def _wait(stem: str) -> Path:
    """The library of source ``stem``: its compile waited for and the
    library put in place (its nvcc output beside it), started first if
    need be; RuntimeError with nvcc's output if the compile failed."""
    path = start_build()[stem]
    job = _JOBS.pop(stem, None)
    if job is None:
        return path
    job["thread"].join()
    if job["proc"].returncode != 0:
        os.unlink(job["tmp"])
        raise RuntimeError(f"nvcc failed ({job['proc'].returncode}):\n"
                           f"{' '.join(job['cmd'])}\n{job['out']}")
    path.with_suffix(".log").write_text(job["out"])
    os.replace(job["tmp"], path)
    return path


def build() -> dict:
    """Compile every source whose library does not exist yet, all at once
    (one nvcc process per source), and wait for all of them; keep nvcc's
    report beside each library (``.log``). Returns {source stem: library
    path}; raises RuntimeError with nvcc's output if a compile fails.
    ``build.seconds`` keeps each compiled source's seconds."""
    libs = start_build()
    errors = []
    for stem in list(_JOBS):
        try:
            _wait(stem)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


# seconds from the start of the build to each compiled source's end (the
# last build of this process; empty when every library was built already)
build.seconds = {}

# entry point -> the source stem whose library holds it
_STEM_OF = {name: stem for stem, entries in SIGNATURES.items()
            for name in entries}


class _EntryPoints:
    """The C entry points as attributes, argument types declared. A
    library is waited for and loaded when one of its entry points is first
    asked for."""

    def __getattr__(self, name):
        stem = _STEM_OF.get(name)
        if stem is None:
            raise AttributeError(name)
        lib = ctypes.CDLL(str(_wait(stem)))
        for entry, argtypes in SIGNATURES[stem].items():
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            setattr(self, entry, fn)
        return self.__dict__[name]


@functools.lru_cache(maxsize=1)
def load() -> _EntryPoints:
    """Start the build if needed and return the entry points, once per
    process; each library is waited for and loaded at its first use."""
    start_build()
    return _EntryPoints()


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
