#!/usr/bin/env python3
"""Time kernel K3 (``trajopt_tpu_torch/csrc/fused_al_backward.cu``) at every
block shape (Wc consumer warps, Wp producer warps), on one GPU.

    python3 tools/k3_launch_shape.py

Builds ``fused_al_backward.cu`` with one more entry point that launches at
a shape given by the caller (the kernel itself takes its shape from the
batch and the occupancy), with the flags of ``kernels/_build.py``, under
``build/k3_launch_shape/``, and times every shape with Wc in {1, 2, 4},
Wp in {1 … 8 − Wc} (a block holds at most 8 warps) and the lone warp
(Wc, Wp) = (1, 0), by CUDA events, on the inputs of ``chip_smoke.py``'s K3
checks at B = 128 (the maze's slack quadrotor, the slack car, the cartpole
rig with and without slacks, kuka with the fk rows, the cartpole), and
the lone warp against (1, 1), (2, 2) and (4, 4) at B = 1024 (the first
three and the cartpole tiled 8 times). Each shape's K, d, ΔV and fail
flags must be bitwise equal to the lone warp's. Prints the card's
``nvidia-smi`` line and one line per instantiation and batch.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

SOURCE = r"""
#include "fused_al_backward.cu"

// f: X, U, lam, mu, dt, Q, R, H, q, r, rho (device pointers)
extern "C" int k3_at_shape_f32(const float* const* f, const int* row_i,
    const float* row_f, const int* groups, const int* col_ptr,
    const int* col_rows, const float* fk_joint, const float* fk_point,
    const float* chain, float* K, float* d, float* dV, unsigned char* fail,
    int batch, int N, int P, int G, int J, int npts, int model, int Wc,
    int Wp) {
  const Args a{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9],
               f[10], (const ChainTable*)chain, K, d, dV, fail, nullptr,
               nullptr, batch, N, 0, 0.0f};
  const CanonTables tab{(const int4*)row_i, (const float4*)row_f, groups,
                        col_ptr, col_rows, P, G, fk_joint,
                        (const float4*)fk_point, J, npts};
  return dispatch(model, [&](auto inst) {
    using I = decltype(inst);
    return launch_shape<typename I::M, I::kSlack>(a, tab, Shape{Wc, Wp},
                                                  nullptr, 0);
  }, (int)cudaErrorInvalidValue);
}
"""


def build():
    from trajopt_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "k3_launch_shape"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "k3_launch_shape.cu", out / "libk3_launch_shape.so"
    cu.write_text(SOURCE)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
         str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(lib)).k3_at_shape_f32
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P_] * 13 + [I_] * 9
    fn.restype = ctypes.c_int
    return fn


def shapes():
    out = [(1, 0)]
    for wc in (1, 2, 4):
        out += [(wc, wp) for wp in range(1, 9 - wc)]
    return out


def run(fn, label, model, canon, X, U, lam, mu, dt, obj, shape_list,
        reps=10):
    import torch
    from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model

    cm = cuda_model(model, "k3_launch_shape", slack_ok=True)
    Bz, N, n = X.shape
    dev = X.device
    rho = torch.ones(Bz, device=dev)
    ptrs = (ctypes.c_void_p * 11)(*(t.data_ptr() for t in (
        X, U, lam, mu, dt, obj.Q, obj.R, obj.H, obj.q, obj.r, rho)))

    def outs():
        return (torch.empty(Bz, N - 1, cm.m, n, device=dev),
                torch.empty(Bz, N - 1, cm.m, device=dev),
                torch.empty(2, Bz, device=dev),
                torch.empty(Bz, dtype=torch.uint8, device=dev))

    def call(o, wc, wp):
        err = fn(ptrs, canon.row_i.data_ptr(), canon.row_f.data_ptr(),
                 canon.groups.data_ptr(), canon.col_ptr.data_ptr(),
                 canon.col_rows.data_ptr(), canon.fk_joint.data_ptr(),
                 canon.fk_point.data_ptr(), chain_table_ptr(model, cm, dev),
                 *(t.data_ptr() for t in o), Bz, N, canon.P,
                 canon.groups.shape[0], canon.fk_joint.shape[0],
                 canon.fk_point.shape[0], cm.id, wc, wp)
        if err:
            raise RuntimeError(f"{label} at ({wc}, {wp}): launch failed "
                               f"({err})")

    ref = outs()
    call(ref, 1, 0)
    torch.cuda.synchronize()
    times, same = {}, {}
    for wc, wp in shape_list:
        o = outs()
        for _ in range(3):
            call(o, wc, wp)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            call(o, wc, wp)
        end.record()
        torch.cuda.synchronize()
        times[wc, wp] = start.elapsed_time(end) / reps
        same[wc, wp] = all(torch.equal(a.view(torch.uint8), b.view(
            torch.uint8)) for a, b in zip(o, ref))
    best = min(times, key=times.get)
    print(f"K3 {label} (n={n}, m={cm.m}, P={canon.P}, N={N}, B={Bz}): "
          + ", ".join(f"({wc},{wp}) {t:.4f}" for (wc, wp), t in
                      times.items())
          + f" ms; fastest {best}; bitwise equal to (1,0): "
          f"{all(same.values())}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"{label}: shapes differ bitwise: "
                             f"{[s for s, ok in same.items() if not ok]}")


def main():
    import torch
    import chip_smoke as cs
    from k3_knot_split import cases

    if not torch.cuda.is_available():
        print("k3_launch_shape: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    fn = build()
    big = []
    for case in cases():
        run(fn, *case, shapes())
        big.append(case)
    for st in (cs.kuka_setup(False), cs.al_setup("cartpole", False)):
        p = st["p32"]
        case = (st["label"], p.model, st["canon"], *st["data"], p.dt_traj(),
                p.obj)
        run(fn, *case, shapes())
        big.append(case)
    # B = 1024 (slice 3 arm (c) runs the cartpole's K3 there)
    for label, model, canon, X, U, lam, mu, dt, obj in (big[0], big[1],
                                                        big[2], big[-1]):
        idx = torch.arange(X.shape[0], device=X.device).repeat(8)
        run(fn, label, model, canon, X[idx].contiguous(), U[idx].contiguous(),
            lam[idx].contiguous(), mu[idx].contiguous(), dt, obj,
            [(1, 0), (1, 1), (2, 2), (4, 4)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
