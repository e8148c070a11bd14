#!/usr/bin/env python3
"""Split the knot time of kernel K7a's one-warp design into its parts, and
time the forms the Jacobians' chain step could take, on one GPU, with
``clock64()`` stamps.

    python3 tools/k7a_knot_split.py

K7a (``trajopt_tpu_torch/csrc/fused_backward.cu``) ran one warp a problem
until its pipelined redesign, every part of a knot on that warp in turn:
the Dual Jacobians (one tangent a lane on n + m lanes, each lane the whole
RK3 step in ``Dual``), the stage expansion and the Riccati step. This
script carries a copy of that design (``SOURCE`` below, with the team step
of ``csrc/riccati_step.cuh`` over the one warp), with lane 0 stamping the
SM clock between the parts, and after each knot three probes of the step
on the same knot's state:

- the float RK3 step over the warp (``step_warp``: for a chain
  ``chain_dynamics_warp``, the table staged in shared memory), the floor
  of a warp form of the Dual step that carries one tangent a call (design
  (a) costs n + m of these, each in Dual) and the primal part of one that
  computes the primal chain quantities once over the warp into shared
  memory (design (b));
- the float step on one thread (what a lane of the Dual step spends on the
  primal: design (b) saves about this much a tangent lane);
- the Dual step on all 32 lanes, lane l pushing tangent l mod (n + m):
  G = ⌊32 / (n + m)⌋ knots' Jacobians at once, the packed form the
  redesign takes.

Builds it by nvcc with the flags of ``kernels/_build.py`` under
``build/k7a_knot_split/``, runs it on the inputs of ``chip_smoke.py``'s
K7a checks at B = 128 (the quadrotor, the scalar cartpole, the cartpole
and acrobot rigs, kuka on path (a)'s inputs), and prints per model the
mean cycles a knot spends in each part and probe, the parts' shares, the
launch's time by CUDA events without the probes, and the card's
``nvidia-smi`` line.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PARTS = ("Dual Jacobians", "stage expansion", "Riccati step")
PROBES = ("float step over the warp", "float step on one thread",
          "Dual step on 32 lanes")

SOURCE = r"""
#include <cuda_runtime.h>
#include "models.cuh"
#include "riccati_step.cuh"
using namespace trajopt;

namespace {
constexpr int kSlots = 6;   // the parts, then the probes

template <class M>
struct Work {
  KnotInputs<M::NX, M::NU> in;
  RiccatiState<M::NX, M::NU> st;
  float z[M::NX + M::NU];
};

template <class M>
__global__ void __launch_bounds__(32) split_kernel(
    const float* X, const float* U, const float* dt, const float* Q,
    const float* R, const float* H, const float* q, const float* r,
    const float* rho_in, const ChainTable* chain, float* K, float* d,
    long long* cycles, float* sink, int N, int probes) {
  constexpr int NX = M::NX, NU = M::NU, W = NX + NU;
  __shared__ Work<M> s;
  __shared__ float tab_s[M::kChain ? kChainTableFloats : 1];
  __shared__ float scr[M::kWarpScratch > 0 ? M::kWarpScratch : 1];
  const int b = blockIdx.x, lane = threadIdx.x;
  const ChainTable* tab = stage_chain_table<M>(chain, tab_s);
  const NamedSync sync{1, 32};
  const float rho = rho_in[b];
  RiccatiState<NX, NU>& w = s.st;
  const float* xN = X + ((size_t)b * N + (N - 1)) * NX;
  const float* QN = Q + (size_t)(N - 1) * NX * NX;
  if (lane < NX) {
    float acc = QN[lane * NX] * xN[0];
    for (int j = 1; j < NX; ++j) acc = acc + QN[lane * NX + j] * xN[j];
    w.Sx[lane] = acc + q[(size_t)(N - 1) * NX + lane];
  }
  for (int e = lane; e < NX * NX; e += 32) w.Sxx[e] = QN[e];
  __syncwarp();

  long long acc[kSlots] = {0, 0, 0, 0, 0, 0};
  float keep = 0.0f, dV1 = 0.0f, dV2 = 0.0f;
  for (int k = N - 2; k >= 0; --k) {
    const size_t bk = (size_t)b * (N - 1) + k;
    const float* xk = X + ((size_t)b * N + k) * NX;
    const float* uk = U + bk * NU;
    const float dtv = dt[k];
    if (lane < W) s.z[lane] = lane < NX ? xk[lane] : uk[lane - NX];
    __syncwarp();
    const long long t0 = clock64();
    if (lane < W) {
      Dual xd[NX], ud[NU], out[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xd[i] = Dual(s.z[i], lane == i ? 1.f : 0.f);
#pragma unroll
      for (int i = 0; i < NU; ++i)
        ud[i] = Dual(s.z[NX + i], lane == NX + i ? 1.f : 0.f);
      M::template step<Dual>(xd, ud, dtv, out, chain);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (lane < NX) s.in.A[i * NX + lane] = out[i].d;
        else s.in.B[i * NU + lane - NX] = out[i].d;
      }
    }
    __syncwarp();
    const long long t1 = clock64();
    const float* Qk = Q + (size_t)k * NX * NX;
    const float* Rk = R + (size_t)k * NU * NU;
    const float* Hk = H + (size_t)k * NU * NX;
    const float* x = s.z;
    const float* u = s.z + NX;
    if (lane < NX) {
      float a = Qk[lane * NX] * x[0];
      for (int j = 1; j < NX; ++j) a = a + Qk[lane * NX + j] * x[j];
      float h = Hk[lane] * u[0];
      for (int j = 1; j < NU; ++j) h = h + Hk[j * NX + lane] * u[j];
      s.in.lx[lane] = (a + q[(size_t)k * NX + lane] + h) * dtv;
    }
    if (lane < NU) {
      float a = Rk[lane * NU] * u[0];
      for (int j = 1; j < NU; ++j) a = a + Rk[lane * NU + j] * u[j];
      float h = Hk[lane * NX] * x[0];
      for (int j = 1; j < NX; ++j) h = h + Hk[lane * NX + j] * x[j];
      s.in.lu[lane] = (a + r[(size_t)k * NU + lane] + h) * dtv;
    }
    for (int e = lane; e < NX * NX; e += 32) s.in.lxx[e] = Qk[e] * dtv;
    for (int e = lane; e < NU * NU; e += 32) s.in.luu[e] = Rk[e] * dtv;
    for (int e = lane; e < NU * NX; e += 32) s.in.lux[e] = Hk[e] * dtv;
    __syncwarp();
    const long long t2 = clock64();
    riccati_step<NX, NU>(s.in, w, rho, false, K + bk * NU * NX, d + bk * NU,
                         dV1, dV2, lane, 32, sync);
    const long long t3 = clock64();
    acc[0] += t1 - t0;
    acc[1] += t2 - t1;
    acc[2] += t3 - t2;
    if (probes) {
      float xs[NX], us[NU], out[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xs[i] = s.z[i];
#pragma unroll
      for (int i = 0; i < NU; ++i) us[i] = s.z[NX + i];
      __syncwarp();
      const long long p0 = clock64();
      M::step_warp(xs, us, dtv, out, tab, scr, lane);
      __syncwarp();
      const long long p1 = clock64();
#pragma unroll
      for (int i = 0; i < NX; ++i) keep += out[i];
      if (lane == 0) {
        M::template step<float>(xs, us, dtv, out, chain);
#pragma unroll
        for (int i = 0; i < NX; ++i) keep += out[i];
      }
      __syncwarp();
      const long long p2 = clock64();
      {
        const int t = lane % W;
        Dual xd[NX], ud[NU], dout[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) xd[i] = Dual(xs[i], t == i ? 1.f : 0.f);
#pragma unroll
        for (int i = 0; i < NU; ++i)
          ud[i] = Dual(us[i], t == NX + i ? 1.f : 0.f);
        M::template step<Dual>(xd, ud, dtv, dout, chain);
#pragma unroll
        for (int i = 0; i < NX; ++i) keep += dout[i].d;
      }
      __syncwarp();
      const long long p3 = clock64();
      acc[3] += p1 - p0;
      acc[4] += p2 - p1;
      acc[5] += p3 - p2;
    }
  }
  if (lane == 0)
    for (int i = 0; i < kSlots; ++i) cycles[(size_t)b * kSlots + i] = acc[i];
  sink[(size_t)b * 32 + lane] = keep + dV1 + dV2;
}

template <class M>
int run(const float* const* f, const float* chain, float* K, float* d,
        long long* cycles, float* sink, int batch, int N, int probes) {
  split_kernel<M><<<batch, 32>>>(f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                                 f[7], f[8], (const ChainTable*)chain, K, d,
                                 cycles, sink, N, probes);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int k7a_split_f32(const float* const* f, const float* chain,
                             float* K, float* d, long long* cycles,
                             float* sink, int batch, int N, int model,
                             int probes) {
#define CASE(M) \
  return run<M>(f, chain, K, d, cycles, sink, batch, N, probes)
  switch (model) {
    case kModelQuadrotor: CASE(Quadrotor);
    case kModelCartpole: CASE(Cartpole);
    case kModelKuka: CASE(Kuka);
    case kModelAcrobotUrdf: CASE(AcrobotUrdf);
    case kModelCartpoleUrdf: CASE(CartpoleUrdf);
  }
#undef CASE
  return (int)cudaErrorInvalidValue;
}
"""


def build():
    from trajopt_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "k7a_knot_split"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "k7a_knot_split.cu", out / "libk7a_knot_split.so"
    cu.write_text(SOURCE)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
         str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(lib)).k7a_split_f32
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P_] * 6 + [I_] * 4
    fn.restype = ctypes.c_int
    return fn


def split(fn, st):
    import torch
    from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model

    model, obj, dt, X, U = (st[k] for k in ("model", "obj", "dt_traj", "X",
                                             "U"))
    cm = cuda_model(model, "k7a_knot_split")
    Bz, N, n = X.shape
    dev = X.device
    rho = torch.ones(Bz, device=dev)
    keep = (X, U, dt, obj.Q, obj.R, obj.H, obj.q, obj.r, rho)
    ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() for t in keep))
    K = torch.empty(Bz, N - 1, cm.m, n, device=dev)
    d = torch.empty(Bz, N - 1, cm.m, device=dev)
    cyc = torch.zeros(Bz, 6, dtype=torch.int64, device=dev)
    sink = torch.empty(Bz, 32, device=dev)
    chain = chain_table_ptr(model, cm, dev)

    def call(probes):
        err = fn(ptrs, chain, K.data_ptr(), d.data_ptr(), cyc.data_ptr(),
                 sink.data_ptr(), Bz, N, cm.id, probes)
        if err:
            raise RuntimeError(f"{st['name']}: launch failed ({err})")

    call(1)
    torch.cuda.synchronize()
    mean = (cyc.double().mean(0) / (N - 1)).tolist()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    call(0)
    start.record()
    for _ in range(5):
        call(0)
    end.record()
    torch.cuda.synchronize()
    knot = sum(mean[:3])
    W = n + cm.m
    G = 32 // W
    print(f"K7a {st['name']} (n={n}, m={cm.m}, N={N}, B={Bz}): a knot "
          f"{knot:.0f} cycles: " + ", ".join(
              f"{p} {c:.0f} ({100 * c / knot:.1f}%)"
              for p, c in zip(PARTS, mean[:3]))
          + "; probes: " + ", ".join(
              f"{p} {c:.0f}" for p, c in zip(PROBES, mean[3:]))
          + f"; per knot's Jacobians: one-thread Dual {mean[0]:.0f}, design"
          f" (a) >= {W * mean[3]:.0f} ({W} float warp steps), design (b) >="
          f" {mean[3] + mean[0] - mean[4]:.0f}, packed {mean[5] / G:.0f} "
          f"(G = {G}); launch without probes "
          f"{start.elapsed_time(end) / 5:.4f} ms", flush=True)


def main():
    import torch
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("k7a_knot_split: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    fn = build()
    for name in ("quadrotor", "cartpole", "cartpole_urdf", "acrobot_urdf"):
        split(fn, cs.model_setup(name))
    split(fn, cs.kuka_free_setup())
    return 0


if __name__ == "__main__":
    sys.exit(main())
