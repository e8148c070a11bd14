#!/usr/bin/env python3
"""Time kernel K1 (``trajopt_tpu_torch/csrc/sqrt_sweep.cu``) at every block
shape (Wc consumer warps, Wp producer warps of the knot pipeline,
``csrc/knot_pipeline.cuh``), on one GPU.

    python3 tools/k1_launch_shape.py

Builds the source with one more entry point that launches at a shape given
by the caller (the kernel takes its shape from the batch and the
occupancy), with the flags of ``kernels/_build.py``, under
``build/k1_launch_shape/``, and times by CUDA events:

- on ``chip_smoke.py``'s K1 inputs (``k1_inputs``: slice 1's error state,
  (n, m) = (12, 4), N = 101, ρ = 0), at B = 128 (slice 1's batch) the
  lone warp (1, 0) and one consumer warp with Wp in {1, 2, 3, 4, 6}
  producers (the kernel has one consumer warp), at B = 1024 (the 128
  problems tiled 8 times) a short list;
- on the cartpole's (4, 1) and the car's (3, 2) sweeps at B = 128 a short
  list (the kernel's instantiation with run-time sizes).

Every shape's K, d, ΔV and fail flags must be bitwise equal to the lone
warp's. Then prints the shape the production entry point picks at B = 33,
64, 128, 1024 and 1152 for (12, 4), (13, 4), (4, 1) and (3, 2), ptxas's
registers, stack and spills for the kernel, and first the card's
``nvidia-smi`` line.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

ENTRY = r"""
#include "sqrt_sweep.cu"

// f: A, B, lx, lu, lxx, luu, lux, rho (device pointers)
extern "C" int k1_at_shape_f32(const float* const* f, float* K, float* d,
    float* dV, unsigned char* fail, int batch, int N, int n, int m, int Wc,
    int Wp) {
  const Args a{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], K, d, dV,
               fail, batch, N, n, m};
  return dispatch(n, m, [&](auto f) {
    using S = decltype(f);
    return launch_shape<S::nx, S::nu>(a, Shape{Wc, Wp}, 0);
  });
}
"""


def build():
    from trajopt_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "k1_launch_shape"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "k1.cu", out / "libk1.so"
    cu.write_text(ENTRY)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
         str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(lib)).k1_at_shape_f32
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P_] * 5 + [I_] * 6
    fn.restype = I_
    return fn, proc.stdout + proc.stderr


def shapes():
    """The lone warp, and one consumer warp with 1, 2, 3, 4 or 6
    producers."""
    return [(1, 0)] + [(1, wp) for wp in (1, 2, 3, 4, 6)]


def k1_run(fn, label, ins, shape_list):
    import torch
    from k7a_k5_launch_shape import sweep

    Bz, N1, n, m = ins[1].shape
    dev = ins[0].device
    rho = torch.zeros(Bz, device=dev)
    ptrs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in (*ins, rho)))

    def outs():
        return (torch.empty(Bz, N1, m, n, device=dev),
                torch.empty(Bz, N1, m, device=dev),
                torch.empty(Bz, 2, device=dev),
                torch.empty(Bz, dtype=torch.uint8, device=dev))

    def launch(o, wc, wp):
        err = fn(ptrs, *(t.data_ptr() for t in o), Bz, N1 + 1, n, m, wc, wp)
        if err:
            raise RuntimeError(f"K1 {label} at ({wc}, {wp}): launch failed "
                               f"({err})")

    sweep(f"K1 {label} ({n},{m}) N={N1 + 1} B={Bz}; (Wc, Wp)", launch, outs,
          list(shape_list))


def main():
    import torch
    import chip_smoke as cs
    from trajopt_tpu_torch.ops.cuda_sqrt import sqrt_sweep_shape

    if not torch.cuda.is_available():
        print("k1_launch_shape: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    fn, log = build()
    dev = torch.device("cuda", 0)
    ins, _ = cs.k1_inputs()
    big = torch.arange(cs.B, device=dev).repeat(8)
    short = [(1, 0), (1, 1), (1, 2), (1, 4)]
    k1_run(fn, "quadrotor error state", ins, shapes())
    k1_run(fn, "quadrotor error state", [t[big].contiguous() for t in ins],
           short)
    for name in ("cartpole", "car"):
        k1_run(fn, name, cs.sweep_inputs(cs.model_setup(name), torch.float32),
               short)
    for n, m in ((12, 4), (13, 4), (4, 1), (3, 2)):
        picks = {b: sqrt_sweep_shape(n, m, b)
                 for b in (33, 64, 128, 1024, 1152)}
        print(f"K1 ({n},{m}) picks (Wc, Wp, S, G; shared bytes): " + ", ".join(
            f"B={b} ({p['consumers']}, {p['producers']}, {p['slots']}, "
            f"{p['knots_a_step']}; {p['smem_bytes']})"
            for b, p in picks.items()), flush=True)
    for kname, regs, stack, spill in cs.ptxas_report(log):
        print(f"ptxas sqrt_sweep: {kname}: {regs} registers, {stack} B "
              f"stack, {spill} B spilled", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
