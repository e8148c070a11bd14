#!/usr/bin/env python3
"""Time kernel K2 (``trajopt_tpu_torch/csrc/rollout.cu``) at 1, 2 and 4
problems (warps) per block, on one GPU.

    python3 tools/rollout_block_shape.py

Builds a copy of ``rollout.cu`` for each block shape (``kWarpsPerBlock``
replaced; the same nvcc flags as ``kernels/_build.py``, the builds side by
side) under ``build/block_shape/``, and times each with CUDA events on
equilibrium inputs (zero gains, each problem held at its start): the
7-DOF arm (B = 128, N = 41), the cartpole rig (B = 128, N = 101), the
quadrotor's error state (B = 128, N = 101) and its full state at B = 1024.
Prints the card's ``nvidia-smi`` line and one line per instantiation.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = (1, 2, 4)


def build(shapes):
    from trajopt_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "block_shape"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "rollout.cu").read_text()
    jobs = {}
    for w in shapes:
        cu = out / f"rollout_w{w}.cu"
        cu.write_text(re.sub(r"kWarpsPerBlock = \d+;",
                             f"kWarpsPerBlock = {w};", src))
        lib = out / f"librollout_w{w}.so"
        jobs[w] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for w, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(log)
        fn = ctypes.CDLL(str(lib)).trajopt_rollout_f32
        fn.argtypes = list(
            _build.SIGNATURES["rollout"]["trajopt_rollout_f32"])
        fn.restype = ctypes.c_int
        libs[w] = fn
    return libs


def inputs(label, batch):
    """Equilibrium inputs: (model, x0, X, U, K, d, alpha, dt, error
    state)."""
    import torch
    from trajopt_tpu_torch.problems import zoo

    dev, f32 = torch.device("cuda", 0), torch.float32
    if label == "kuka":
        prob = zoo.kuka_obstacles(dtype=f32, device=dev)
    elif label == "cartpole_urdf":
        prob = zoo.rig_problem("cartpole_urdf", dtype=f32, device=dev)
    else:
        prob = zoo.quadrotor_line(N=101, dtype=f32, device=dev)
    es = label == "quadrotor_error_state"
    n, m, N = prob.n, prob.m, prob.N
    ns = n - 1 if es else n
    x0 = prob.x0[None].expand(batch, n).contiguous()
    X = prob.x0[None, None].expand(batch, N, n).contiguous()
    U = prob.U[None].expand(batch, N - 1, m).contiguous()
    K = torch.zeros(batch, N - 1, m, ns, device=dev)
    d = torch.zeros(batch, N - 1, m, device=dev)
    alpha = torch.ones(batch, device=dev)
    return prob.model, x0, X, U, K, d, alpha, float(prob.dt_traj()[0]), es


def time_ms(fn, model, x0, X, U, K, d, alpha, dt, es, reps=20):
    import torch
    from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model

    cm = cuda_model(model, "rollout_block_shape")
    Xo, Uo = torch.empty_like(X), torch.empty_like(U)
    ok = torch.empty(X.shape[0], dtype=torch.bool, device=X.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(x0.data_ptr(), X.data_ptr(), U.data_ptr(), K.data_ptr(),
                 d.data_ptr(), alpha.data_ptr(), Xo.data_ptr(),
                 Uo.data_ptr(), ok.data_ptr(),
                 chain_table_ptr(model, cm, X.device), X.shape[0],
                 X.shape[1], cm.id, int(es), dt, 1e8, 1e8, stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")

    for _ in range(reps):   # warm-up: the card's clocks ramp up under load
        call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, bool(ok.all())


def main():
    import torch

    if not torch.cuda.is_available():
        print("rollout_block_shape: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = build(SHAPES)
    for label, batch in (("kuka", 128), ("cartpole_urdf", 128),
                         ("quadrotor_error_state", 128),
                         ("quadrotor", 1024)):
        ins = inputs(label, batch)
        times = {w: time_ms(fn, *ins) for w, fn in libs.items()}
        print(f"K2 {label} B={batch}: " + ", ".join(
            f"{w} warps a block {t:.4f} ms (all ok: {ok})"
            for w, (t, ok) in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
