#!/usr/bin/env python3
"""Hold the warp chain step of kernels K2/K4 against the one-thread chain
step of K3/K7a/K7b, bit for bit, on one GPU.

    python3 tools/chain_step_bitwise.py [count]

For each rigid-body chain of ``csrc/models.cuh`` (kuka and the three URDF
rigs), ``count`` random states and controls (default 2048; seed 0): one
block of one warp a state runs ``Chain::step<float>`` (the one-thread RK3
step) on lane 0 and ``Chain::step_warp`` (the step over the warp, its
table in shared memory) on all 32 lanes, at the problem's dt. Prints, per
chain, the states whose step is bitwise equal on every lane, and the
card's ``nvidia-smi`` line. The probe kernel is built here by nvcc, with
the flags of ``kernels/_build.py``, under ``build/chain_step_bitwise/``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include "models.cuh"
using namespace trajopt;

template <class C>
__global__ void probe(const ChainTable* table, const float* xs,
                      const float* us, float dt, float* one, float* warp) {
  constexpr int NX = C::NX, NU = C::NU;
  extern __shared__ float smem[];
  const ChainTable* tab = stage_chain_table<C>(table, smem);
  const int lane = threadIdx.x, b = blockIdx.x;
  float x[NX], u[NU], out[NX];
  for (int i = 0; i < NX; ++i) x[i] = xs[b * NX + i];
  for (int j = 0; j < NU; ++j) u[j] = us[b * NU + j];
  if (lane == 0) {
    C::template step<float>(x, u, dt, out, table);
    for (int i = 0; i < NX; ++i) one[b * NX + i] = out[i];
  }
  __syncwarp();
  C::step_warp(x, u, dt, out, tab, smem + kChainTableFloats, lane);
  for (int i = 0; i < NX; ++i) warp[(b * 32 + lane) * NX + i] = out[i];
}

template <class C>
int run(const float* t, const float* xs, const float* us, float dt,
        float* one, float* warp, int count) {
  const size_t bytes = sizeof(float) * (kChainTableFloats + C::kWarpScratch);
  probe<C><<<count, 32, bytes>>>((const ChainTable*)t, xs, us, dt, one,
                                 warp);
  return (int)cudaDeviceSynchronize();
}

extern "C" int chain_step_probe(const float* t, int ndof, int nu,
                                const float* xs, const float* us, float dt,
                                float* one, float* warp, int count) {
  if (ndof == 7) return run<Kuka>(t, xs, us, dt, one, warp, count);
  if (nu == 1) return run<AcrobotUrdf>(t, xs, us, dt, one, warp, count);
  return run<DoublependulumUrdf>(t, xs, us, dt, one, warp, count);
}
"""


def build():
    from trajopt_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "chain_step_bitwise"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "probe.cu", out / "libprobe.so"
    cu.write_text(SOURCE)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           f"-I{_build.CSRC}", "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(lib)).chain_step_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def main(count=2048):
    import torch
    from trajopt_tpu_torch.problems import zoo

    if not torch.cuda.is_available():
        print("chain_step_bitwise: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    fn = build()
    dev, f32 = torch.device("cuda", 0), torch.float32
    gen = torch.Generator().manual_seed(0)
    equal_everywhere = True
    for name in ("kuka", "acrobot_urdf", "doublependulum_urdf",
                 "cartpole_urdf"):
        prob = zoo.kuka_obstacles(dtype=f32, device=dev) if name == "kuka" \
            else zoo.rig_problem(name, dtype=f32, device=dev)
        table = torch.as_tensor(prob.model.chain_table, device=dev)
        nd, nu = int(table[-2]), int(table[-1])
        xs = torch.cat([torch.randn(count, nd, generator=gen),
                        2 * torch.randn(count, nd, generator=gen)], 1)
        us = 5 * torch.randn(count, nu, generator=gen)
        xs, us = xs.to(dev).contiguous(), us.to(dev).contiguous()
        one = torch.empty(count, 2 * nd, device=dev)
        warp = torch.empty(count, 32, 2 * nd, device=dev)
        err = fn(table.data_ptr(), nd, nu, xs.data_ptr(), us.data_ptr(),
                 float(prob.dt_traj()[0]), one.data_ptr(), warp.data_ptr(),
                 count)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        same = (warp.view(torch.int32)
                == one[:, None].view(torch.int32)).all(-1).all(-1)
        equal_everywhere &= bool(same.all())
        print(f"{name}: the warp step bitwise equal to the one-thread step "
              f"on every lane for {int(same.sum())}/{count} states; max "
              f"|difference| {float((warp - one[:, None]).abs().max()):.3e}",
              flush=True)
    return 0 if equal_everywhere else 1


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
