#!/usr/bin/env python3
"""Time kernels K7a (``trajopt_tpu_torch/csrc/fused_backward.cu``) and K5
(``csrc/riccati_sweep.cu``) at every block shape (Wc consumer warps, Wp
producer warps of the knot pipeline, ``csrc/knot_pipeline.cuh``), on one
GPU.

    python3 tools/k7a_k5_launch_shape.py

Builds both sources with one more entry point each that launches at a
shape given by the caller (the kernels take theirs from the batch and the
occupancy), and two variants the kernels do not carry: K7a with one knot a
producer step (``fused_backward.cu`` with ``knots_per_warp()`` returning 1,
substituted at build time) and K5 with several problems a block (a copy of
the sweep in ``K5_ENTRY`` below); with the flags of ``kernels/_build.py``,
under ``build/k7a_k5_launch_shape/``, side by side, and times by CUDA
events:

- K7a on the inputs of ``chip_smoke.py``'s K7a checks (``model_setup``;
  kuka on path (a)'s, ``kuka_free_setup``) at B = 128 for the quadrotor,
  the scalar cartpole, the cartpole rig, the acrobot rig and kuka, every
  shape with Wc in {1, 2, 4}, Wp in {1, 2, 3, 4, 6} (at most 8 warps a
  block) and the lone warp (1, 0); where a producer warp takes G > 1 knots
  a step, the same shapes again with one knot a step (G = 1: what the
  packing gains); a short list for the car, the pendulum, the double
  integrator and the double pendulum rig; at B = 1024 (the 128 problems
  tiled 8 times) a short list for the quadrotor (slice 3 arm (a)), the
  cartpole, its rig and kuka;
- K5 on ``sweep_inputs`` of the same set-ups: (13,4), (4,1), (3,2),
  (2,1) and (14,7) at B = 128, (13,4) at B = 1024 (arm (b)) and (14,7) at
  B = 64 (the kuka pool); for (4,1), (3,2) and (2,1) at B = 128 and 1024
  also 1, 2, 4 and 8 problems a block, one warp each or (1, 1) each.

Every shape's K, d, ΔV and fail flags must be bitwise equal to the lone
warp's. Then prints the shape each production entry point picks at
B = 33, 64, 128, 1024 and 1152, and the registers, stack and spills ptxas
gives each K7a and K5 instantiation and the several-problems-a-block
kernels. Prints the card's ``nvidia-smi`` line first.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

K7A_ENTRY = r"""
// f: X, U, dt, Q, R, H, q, r, rho (device pointers)
extern "C" int k7a_at_shape_f32(const float* const* f, const float* chain,
    float* K, float* d, float* dV, unsigned char* fail, int batch, int N,
    int model, int Wc, int Wp) {
  const Args a{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8],
               (const ChainTable*)chain, K, d, dV, fail, nullptr, nullptr,
               batch, N, 0};
  return dispatch(model, [&](auto of) {
    using M = typename decltype(of)::M;
    return launch_shape<M>(a, Shape{Wc, Wp}, 0);
  }, (int)cudaErrorInvalidValue);
}
"""

# K7a with one knot a producer step: fused_backward.cu with its
# knots_per_warp() returning 1 (what the packing of G knots gains)
ONE_KNOT = ("return 32 / (M::NX + M::NU) > 0 ? 32 / (M::NX + M::NU) : 1;",
            "return 1;")

# K5 with PB problems a block: a team of 32·Wc (Wp = 0) or 32·(Wc + Wp)
# threads a problem, each with its own ring and its consumers on their own
# named barrier 1 + team. The barrier id is a compile-time constant (an id
# computed at run time makes ptxas reserve every barrier, which halved the
# blocks an SM holds); the knot loop is knot_pipeline()'s with one knot a
# producer step, offset to the team's first thread t0.
K5_ENTRY = r"""
namespace {

template <int NX, int NU, int BAR>
__device__ __forceinline__ void team_sweep(const Args& a,
                                           const RiccatiRing<NX, NU>& r, int Wc,
                                           int Wp, int b, int t0) {
  const int S = r.L.S, N = a.N, t = threadIdx.x - t0, warp = t >> 5;
  const int lane = threadIdx.x & 31, nt = 32 * Wc;
  const bool solo = Wp == 0, cons = warp < Wc, prod = solo || !cons;
  const NamedSync sync{BAR, nt};
  if (cons) {
    // terminal knot: Sx = lx_N, Sxx = lxx_N
    RiccatiState<NX, NU>& w = r.state();
    const size_t bN = (size_t)b * N + (N - 1);
    for (int e = t; e < NX; e += nt) w.Sx[e] = a.lx[bN * NX + e];
    for (int e = t; e < NX * NX; e += nt)
      w.Sxx[e] = a.lxx[bN * NX * NX + e];
    sync();
  }
  const float rho = a.rho[b];
  const bool reg_state = a.reg_state != 0;
  const size_t b0 = (size_t)b * (N - 1);
  float* K_b = a.K + b0 * NU * NX;
  float* d_b = a.d + b0 * NU;
  float dV1 = 0.0f, dV2 = 0.0f;
  bool fail = false;
  const int first = solo || cons ? 0 : warp - Wc;
  const int stride = solo || cons ? 1 : Wp;
  for (int i = first; i < N - 1; i += stride) {
    const int s = i % S, k = N - 2 - i;
    if (prod) {
      if (!solo && i >= S) mbar_wait(r.empty(s), ((i / S) - 1) & 1);
      load_knot<NX, NU>(a, b, k, r.slot(s), lane);
      if (!solo) mbar_arrive(r.full(s));
    }
    if (cons) {
      if (!solo) mbar_wait(r.full(s), (i / S) & 1);
      const bool fail_k = riccati_step<NX, NU>(
          r.slot(s), r.state(), rho, reg_state, K_b + (size_t)k * NU * NX,
          d_b + (size_t)k * NU, dV1, dV2, t, nt, sync);
      fail = fail || fail_k;
      if (!solo) mbar_arrive(r.empty(s));
    }
  }
  if (t == 0) {
    a.dV[b] = dV1;
    a.dV[a.batch + b] = dV2;
    a.fail[b] = fail ? 1 : 0;
  }
}

// team `team`'s sweep, with the barrier 1 + team
template <int NX, int NU, int PB>
__device__ __forceinline__ void team_of(const Args& a,
                                        const RiccatiRing<NX, NU>& r,
                                        int Wc, int Wp, int b, int t0,
                                        int team) {
  if (team == PB - 1)
    team_sweep<NX, NU, PB>(a, r, Wc, Wp, b, t0);
  else if constexpr (PB > 1)
    team_of<NX, NU, PB - 1>(a, r, Wc, Wp, b, t0, team);
}

template <int NX, int NU, int PB>
__global__ void __launch_bounds__(32 * kMaxWarps) teams_kernel(Args a,
                                                               int Wc,
                                                               int Wp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RingLayout L = layout<NX, NU>(Wp);
  const int team = threadIdx.x / (32 * (Wc + Wp));
  const int t0 = team * 32 * (Wc + Wp);
  const RiccatiRing<NX, NU> r{smem + team * L.bytes(), L};
  const int b = blockIdx.x * PB + team;
  if (threadIdx.x == t0 && Wp > 0) {
    for (int s = 0; s < L.S; ++s) {
      mbar_init(r.full(s), 32);
      mbar_init(r.empty(s), 32 * Wc);
    }
  }
  __syncthreads();
  if (b >= a.batch) return;
  team_of<NX, NU, PB>(a, r, Wc, Wp, b, t0, team);
}

template <int NX, int NU, int PB>
int launch_teams(const Args& a, Shape sh) {
  static LaunchCache cache;
  return launch_ring(teams_kernel<NX, NU, PB>, (a.batch + PB - 1) / PB,
                     PB * 32 * (sh.Wc + sh.Wp),
                     PB * layout<NX, NU>(sh.Wp).bytes(), cache, 0, a, sh.Wc,
                     sh.Wp);
}

}  // namespace

// f: A, B, lx, lu, lxx, luu, lux, rho (device pointers); per_block
// problems a block (1: the kernel's own launch)
extern "C" int k5_at_shape_f32(const float* const* f, float* K, float* d,
    float* dV, unsigned char* fail, int batch, int N, int n, int m, int Wc,
    int Wp, int per_block) {
  const Args a{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], K, d, dV,
               fail, batch, N, 0};
  return dispatch(n, m, [&](auto dims) {
    using D = decltype(dims);
    const Shape sh{Wc, Wp};
    switch (per_block) {
      case 1: return launch_shape<D::NX, D::NU>(a, sh, 0);
      case 2: return launch_teams<D::NX, D::NU, 2>(a, sh);
      case 4: return launch_teams<D::NX, D::NU, 4>(a, sh);
      case 8: return launch_teams<D::NX, D::NU, 8>(a, sh);
    }
    return (int)cudaErrorInvalidValue;
  }, (int)cudaErrorInvalidValue);
}
"""


def sources():
    """The three libraries' sources: K7a as it is, K7a with one knot a
    producer step, K5 with the several-problems-a-block launch."""
    from trajopt_tpu_torch.kernels import _build

    k7a = (_build.CSRC / "fused_backward.cu").read_text()
    if k7a.count(ONE_KNOT[0]) != 1:
        raise RuntimeError("fused_backward.cu: knots_per_warp() not found")
    return {
        "k7a": '#include "fused_backward.cu"\n' + K7A_ENTRY,
        "k7a_one_knot": k7a.replace(*ONE_KNOT) + K7A_ENTRY,
        "k5": '#include "riccati_sweep.cu"\n' + K5_ENTRY,
    }


def build():
    from trajopt_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "k7a_k5_launch_shape"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem, src in sources().items():
        cu, lib = out / f"{stem}.cu", out / f"lib{stem}.so"
        cu.write_text(src)
        jobs[stem] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for stem, (lib, proc) in jobs.items():
        logs[stem], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(logs[stem])
        libs[stem] = ctypes.CDLL(str(lib))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    k7a = []
    for stem in ("k7a", "k7a_one_knot"):
        fn = libs[stem].k7a_at_shape_f32
        fn.argtypes = [P_] * 6 + [I_] * 5
        fn.restype = I_
        k7a.append(fn)
    k5 = libs["k5"].k5_at_shape_f32
    k5.argtypes = [P_] * 5 + [I_] * 7
    k5.restype = I_
    return k7a, k5, logs


def shapes():
    out = [(1, 0)]
    for wc in (1, 2, 4):
        out += [(wc, wp) for wp in (1, 2, 3, 4, 6) if wc + wp <= 8]
    return out


def timed(call, reps=10):
    import torch

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep(label, launch, outs, shape_list):
    """Each (shape, variant) of ``shape_list`` timed; every output bitwise
    equal to the first entry's."""
    import torch

    ref = outs()
    launch(ref, *shape_list[0])
    torch.cuda.synchronize()
    times, same = {}, {}
    for key in shape_list:
        o = outs()
        times[key] = timed(lambda: launch(o, *key))
        same[key] = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                        for a, b in zip(o, ref))
    best = min(times, key=times.get)
    print(f"{label}: " + ", ".join(f"{k} {t:.4f}" for k, t in times.items())
          + f" ms; fastest {best}; bitwise equal to {shape_list[0]}: "
          f"{all(same.values())}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"{label}: shapes differ bitwise: "
                             f"{[s for s, ok in same.items() if not ok]}")


def k7a_run(fn, st, batch_tile, shape_list):
    import torch
    from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model

    model, obj, dt = st["model"], st["obj"], st["dt_traj"]
    X, U = st["X"][batch_tile].contiguous(), st["U"][batch_tile].contiguous()
    cm = cuda_model(model, "k7a_k5_launch_shape")
    Bz, N, n = X.shape
    dev = X.device
    rho = torch.ones(Bz, device=dev)
    keep = (X, U, dt, obj.Q, obj.R, obj.H, obj.q, obj.r, rho)
    ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() for t in keep))
    chain = chain_table_ptr(model, cm, dev)

    def outs():
        return (torch.empty(Bz, N - 1, cm.m, n, device=dev),
                torch.empty(Bz, N - 1, cm.m, device=dev),
                torch.empty(2, Bz, device=dev),
                torch.empty(Bz, dtype=torch.uint8, device=dev))

    def launch(o, wc, wp, one_knot=0):
        err = fn[one_knot](ptrs, chain, *(t.data_ptr() for t in o), Bz, N,
                           cm.id, wc, wp)
        if err:
            raise RuntimeError(f"K7a {st['name']} at ({wc}, {wp}): launch "
                               f"failed ({err})")

    G = 32 // (n + cm.m)
    keys = [(wc, wp, 0) for wc, wp in shape_list]
    if G > 1:
        keys += [(wc, wp, 1) for wc, wp in shape_list]
    sweep(f"K7a {st['name']} (n={n}, m={cm.m}, G={G}, N={N}, B={Bz}; "
          "(Wc, Wp, 1 where G = 1))", launch, outs, keys)


def k5_run(fn, label, ins, shape_list):
    import torch

    Bz, N1, n, m = ins[1].shape
    dev = ins[0].device
    rho = torch.ones(Bz, device=dev)
    ptrs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in (*ins, rho)))

    def outs():
        return (torch.empty(Bz, N1, m, n, device=dev),
                torch.empty(Bz, N1, m, device=dev),
                torch.empty(2, Bz, device=dev),
                torch.empty(Bz, dtype=torch.uint8, device=dev))

    def launch(o, wc, wp, per_block=1):
        err = fn(ptrs, *(t.data_ptr() for t in o), Bz, N1 + 1, n, m, wc, wp,
                 per_block)
        if err:
            raise RuntimeError(f"K5 {label} at ({wc}, {wp}) x {per_block}: "
                               f"launch failed ({err})")

    sweep(f"K5 {label} ({n},{m}) N={N1 + 1} B={Bz}; (Wc, Wp[, problems a "
          "block])", launch, outs, list(shape_list))


def main():
    import torch
    import chip_smoke as cs
    from trajopt_tpu_torch.kernels import _build
    from trajopt_tpu_torch.ops.cuda_fused import fused_backward_shape
    from trajopt_tpu_torch.ops.cuda_riccati import riccati_sweep_shape

    if not torch.cuda.is_available():
        print("k7a_k5_launch_shape: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    k7a, k5, logs = build()
    dev = torch.device("cuda", 0)
    base = torch.arange(cs.B, device=dev)
    big = base.repeat(8)
    short = [(1, 0), (1, 1), (1, 2), (2, 1), (2, 2), (4, 4)]
    setups = {name: cs.model_setup(name) for name in (
        "quadrotor", "cartpole", "cartpole_urdf", "acrobot_urdf", "car",
        "pendulum", "doubleintegrator", "doublependulum_urdf")}
    setups["kuka"] = cs.kuka_free_setup()
    for name in ("quadrotor", "cartpole", "cartpole_urdf", "acrobot_urdf",
                 "kuka"):
        k7a_run(k7a, setups[name], base, shapes())
    for name in ("car", "pendulum", "doubleintegrator",
                 "doublependulum_urdf"):
        k7a_run(k7a, setups[name], base, short + [(1, 3)])
    for name in ("quadrotor", "cartpole", "cartpole_urdf", "kuka"):
        k7a_run(k7a, setups[name], big, short)

    ins = {name: cs.sweep_inputs(setups[name], torch.float32) for name in (
        "quadrotor", "cartpole", "car", "pendulum", "kuka")}
    for name, i in ins.items():
        k5_run(k5, name, i, shapes())
    k5_run(k5, "quadrotor", [t[big].contiguous() for t in ins["quadrotor"]],
           short)
    k5_run(k5, "kuka", [t[:64].contiguous() for t in ins["kuka"]], shapes())
    # several problems a block for the small shapes, against one with
    # Wc = 1
    packs = [(1, 0, 1), (1, 0, 2), (1, 0, 4), (1, 0, 8), (1, 1, 1),
             (1, 1, 2), (1, 1, 4), (2, 1, 1), (4, 1, 1)]
    for name in ("cartpole", "car", "pendulum"):
        k5_run(k5, name, ins[name], packs)
        k5_run(k5, name, [t[big].contiguous() for t in ins[name]], packs)

    for name, st in setups.items():
        picks = {b: fused_backward_shape(st["model"], b)
                 for b in (33, 64, 128, 1024, 1152)}
        print(f"K7a {name} picks (Wc, Wp, S, G; shared bytes): " + ", ".join(
            f"B={b} ({p['consumers']}, {p['producers']}, {p['slots']}, "
            f"{p['knots_a_step']}; {p['smem_bytes']})"
            for b, p in picks.items()), flush=True)
    for n, m in ((13, 4), (14, 7), (4, 1), (3, 2), (2, 1), (13, 17),
                 (14, 21)):
        picks = {b: riccati_sweep_shape(n, m, b)
                 for b in (33, 64, 128, 1024, 1152)}
        print(f"K5 ({n},{m}) picks (Wc, Wp, S; shared bytes): " + ", ".join(
            f"B={b} ({p['consumers']}, {p['producers']}, {p['slots']}; "
            f"{p['smem_bytes']})" for b, p in picks.items()), flush=True)
    libs = _build.build()
    reports = {stem: libs[stem].with_suffix(".log").read_text()
               for stem in ("fused_backward", "riccati_sweep")}
    reports["k5 several problems a block"] = logs["k5"]
    for stem, log in reports.items():
        for kname, regs, stack, spill in cs.ptxas_report(log):
            if "several" in stem and "teams_kernel" not in kname:
                continue
            print(f"ptxas {stem}: {kname}: {regs} registers, {stack} B "
                  f"stack, {spill} B spilled", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
