#!/usr/bin/env python3
"""Split the knot time of kernel K1's one-warp design into its parts, on one
GPU, with ``clock64()`` stamps, and measure what its dense rows' bank
conflicts cost.

    python3 tools/k1_knot_split.py

K1 (``trajopt_tpu_torch/csrc/sqrt_sweep.cu``) ran one warp a problem until
its pipelined redesign, every part of a knot on that warp in turn, its
dense rows stored column by column (``D[j][r]``, 32 floats apart, so the
16 lanes of a p = 16 stage hit one bank on every access). This script
carries a copy of that design (``SOURCE`` below), with lane 0 stamping the
SM clock between the parts of each knot: the loads; the stage factor's
plain Cholesky and, where it runs, its equilibrated one; the dense rows
Ssqrt·[B A]; the Householder triangularization; the fail rules with Qu, d
and the value terms; the per-column K and Sx; the carry. The same copy is
built a second time with the dense rows padded to ``D[32][33]`` (the probe
without the conflicts; its outputs must equal the first's bit for bit) and
a third time without the stamps (the design as it ran).

Then the pipelined design of ``csrc/sqrt_sweep.cu`` itself, built with its
hooks ``K1_PART`` and ``K1_PRODUCER_PART`` defined to stamp the clock
(``PIPELINE_SOURCE``), at the shapes (Wc, Wp) of ``PIPELINE_SHAPES``: the
consumers' knot (waiting for the slot, the dense rows, the Householder
columns, the gains with the carry) and the last producer warp's step (its
waits with the copies, the stage factors).

Builds them by nvcc with the flags of ``kernels/_build.py`` under
``build/k1_knot_split/``, runs them on ``chip_smoke.py``'s K1 inputs
(``k1_inputs``, B = 128, N = 101, (n, m) = (12, 4), ρ = 0: the
equilibrated fallback runs at one stage), and prints the mean cycles a knot
spends in each part for both layouts, their shares, how many knots ran the
equilibrated factor, each launch's time by CUDA events, and the card's
``nvidia-smi`` line.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PARTS = ("loads", "plain factor", "equilibrated factor", "dense rows",
         "Householder", "fail rules, Qu, d, value terms", "K and Sx columns",
         "carry")

SOURCE = r"""
#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1e-30f;
constexpr float kNegTol = 1e-3f;
constexpr float kFloor = 1e-7f;
constexpr int kParts = 8;

template <int LDD>
struct Smem {
  float M[kMaxP][kMaxP];
  float R[kMaxP][kMaxP];
  float D[kMaxP][LDD];      // dense rows transposed: D[j][r]
  float S[kMaxP][kMaxP];
  float BA[kMaxP][kMaxP];
  float Sx[kMaxP];
};

template <class Sm>
__device__ bool chol_plain(Sm& sm, float (*U)[kMaxP], int dim, int lane) {
  bool fail = false;
  for (int i = 0; i < dim; ++i) {
    float s = 0.f;
    if (lane < dim) {
      s = sm.M[i][lane];
      for (int k = 0; k < i; ++k) s = s - U[k][i] * U[k][lane];
    }
    const float piv2 = __shfl_sync(kFull, s, i) + 1e-14f;
    fail = fail || (piv2 <= 0.f) || !isfinite(piv2);
    const float piv = sqrtf(fmaxf(piv2, kTiny));
    __syncwarp();
    if (lane < dim) U[i][lane] = lane == i ? piv : (lane < i ? 0.f : s / piv);
    __syncwarp();
  }
  return fail;
}

template <class Sm>
__device__ bool chol_equilibrated(Sm& sm, float (*U)[kMaxP], int dim,
                                  int lane) {
  const float dinv =
      lane < dim ? 1.f / sqrtf(fmaxf(sm.M[lane][lane], 1e-30f)) : 1.f;
  bool fail = false;
  for (int i = 0; i < dim; ++i) {
    const float dinv_i = __shfl_sync(kFull, dinv, i);
    float s = 0.f;
    if (lane < dim) {
      s = sm.M[i][lane] * dinv_i * dinv;
      for (int k = 0; k < i; ++k) s = s - U[k][i] * U[k][lane];
    }
    const float piv2 = __shfl_sync(kFull, s, i);
    fail = fail || (piv2 < -kNegTol) || !isfinite(piv2);
    const float piv = sqrtf(fmaxf(piv2, kFloor));
    __syncwarp();
    if (lane < dim) U[i][lane] = lane == i ? piv : (lane < i ? 0.f : s / piv);
    __syncwarp();
  }
  if (lane < dim)
    for (int i = 0; i < dim; ++i) U[i][lane] = U[i][lane] / dinv;
  __syncwarp();
  return fail;
}

// lane 0 adds the cycles since `last` to part q
#define STAMP(q)                              \
  if (STAMPS) {                               \
    __syncwarp();                             \
    const long long now = clock64();          \
    acc[q] += now - last;                     \
    last = now;                               \
  }

template <int LDD, bool STAMPS>
__global__ void __launch_bounds__(32)
split_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
             const float* __restrict__ lx, const float* __restrict__ lu,
             const float* __restrict__ lxx, const float* __restrict__ luu,
             const float* __restrict__ lux, const float* __restrict__ rho,
             float* __restrict__ K, float* __restrict__ d,
             float* __restrict__ dV, unsigned char* __restrict__ fail_out,
             long long* __restrict__ cycles, int N, int n, int m) {
  __shared__ Smem<LDD> sm;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int p = m + n;
  const int Nm1 = N - 1;
  const float rho_b = rho[b];
  long long acc[kParts + 1] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long last = 0;

  const float* lxxN = lxx + ((size_t)b * N + Nm1) * n * n;
  if (lane < n)
    for (int r = 0; r < n; ++r) sm.M[r][lane] = lxxN[r * n + lane];
  __syncwarp();
  bool fail = chol_plain(sm, sm.S, n, lane);
  if (fail) fail = chol_equilibrated(sm, sm.S, n, lane);
  if (lane < n) sm.Sx[lane] = lx[((size_t)b * N + Nm1) * n + lane];
  __syncwarp();
  float dV1 = 0.f, dV2 = 0.f;

  for (int k = Nm1 - 1; k >= 0; --k) {
    if (STAMPS) {
      __syncwarp();
      last = clock64();
    }
    const size_t bk = (size_t)b * Nm1 + k;
    const float* Ak = A + bk * n * n;
    const float* Bk = Bm + bk * n * m;
    const float* luuk = luu + bk * m * m;
    const float* luxk = lux + bk * m * n;
    const float* lxxk = lxx + ((size_t)b * N + k) * n * n;

    if (lane < p) {
      for (int r = 0; r < m; ++r)
        sm.M[r][lane] = lane < m
            ? luuk[r * m + lane] + (r == lane ? rho_b : 0.f)
            : luxk[r * n + (lane - m)];
      for (int r = 0; r < n; ++r)
        sm.M[m + r][lane] = lane < m ? luxk[lane * n + r]
                                     : lxxk[r * n + (lane - m)];
      for (int r = 0; r < n; ++r)
        sm.BA[r][lane] = lane < m ? Bk[r * m + lane] : Ak[r * n + (lane - m)];
    }
    STAMP(0)
    bool fail_k = chol_plain(sm, sm.R, p, lane);
    STAMP(1)
    if (fail_k) {
      fail_k = chol_equilibrated(sm, sm.R, p, lane);
      if (STAMPS) acc[kParts] += 1;
    }
    STAMP(2)

    if (lane < p) {
      for (int r = 0; r < n; ++r) {
        float acc2 = sm.S[r][0] * sm.BA[0][lane];
        for (int c = 1; c < n; ++c) acc2 = acc2 + sm.S[r][c] * sm.BA[c][lane];
        sm.D[lane][r] = acc2;
      }
    }
    __syncwarp();
    STAMP(3)

    for (int j = 0; j < p; ++j) {
      const float a0 = sm.R[j][j];
      float sigma = sm.D[j][0] * sm.D[j][0];
      for (int r = 1; r < n; ++r) sigma = sigma + sm.D[j][r] * sm.D[j][r];
      const float nrm = sqrtf(a0 * a0 + sigma);
      const float alpha = a0 >= 0.f ? -nrm : nrm;
      const float v0 = a0 - alpha;
      const float denom = nrm * (nrm + fabsf(a0));
      const float beta = denom > kTiny ? 1.f / fmaxf(denom, kTiny) : 0.f;
      float t = 0.f;
      if (lane > j && lane < p) {
        float acc2 = sm.D[lane][0] * sm.D[j][0];
        for (int r = 1; r < n; ++r) acc2 = acc2 + sm.D[lane][r] * sm.D[j][r];
        t = beta * (v0 * sm.R[j][lane] + acc2);
      }
      __syncwarp();
      if (lane > j && lane < p) {
        sm.R[j][lane] = sm.R[j][lane] - t * v0;
        for (int r = 0; r < n; ++r)
          sm.D[lane][r] = sm.D[lane][r] - t * sm.D[j][r];
      }
      if (lane == j) sm.R[j][j] = alpha;
      __syncwarp();
    }
    STAMP(4)

    {
      float dmin = fabsf(sm.R[0][0]), dmax = dmin;
      for (int j = 1; j < m; ++j) {
        const float dd = fabsf(sm.R[j][j]);
        dmin = fminf(dmin, dd);
        dmax = fmaxf(dmax, dd);
      }
      fail_k = fail_k || (dmin / fmaxf(dmax, kTiny) < 1e-8f);
      for (int j = 0; j < m; ++j) {
        float rs = fabsf(sm.R[j][0]);
        for (int c = 1; c < p; ++c) rs = rs + fabsf(sm.R[j][c]);
        fail_k = fail_k || !isfinite(rs);
      }
    }
    float Qu[kMaxP], y[kMaxP], dk[kMaxP], Rd[kMaxP], Quu_d[kMaxP];
    const float* luk = lu + bk * m;
    for (int i = 0; i < m; ++i) {
      float acc2 = sm.BA[0][i] * sm.Sx[0];
      for (int r = 1; r < n; ++r) acc2 = acc2 + sm.BA[r][i] * sm.Sx[r];
      Qu[i] = luk[i] + acc2;
    }
    for (int j = 0; j < m; ++j) {
      float s = Qu[j];
      for (int kk = 0; kk < j; ++kk) s = s - sm.R[kk][j] * y[kk];
      y[j] = s / sm.R[j][j];
    }
    for (int j = m - 1; j >= 0; --j) {
      float s = y[j];
      for (int kk = j + 1; kk < m; ++kk) s = s - sm.R[j][kk] * dk[kk];
      dk[j] = s / sm.R[j][j];
    }
    for (int j = 0; j < m; ++j) dk[j] = fail_k ? 0.f : -dk[j];
    for (int j = 0; j < m; ++j) {
      float s = sm.R[j][j] * dk[j];
      for (int kk = j + 1; kk < m; ++kk) s = s + sm.R[j][kk] * dk[kk];
      Rd[j] = s;
    }
    for (int j = 0; j < m; ++j) {
      float s = sm.R[0][j] * Rd[0];
      for (int kk = 1; kk <= j; ++kk) s = s + sm.R[kk][j] * Rd[kk];
      Quu_d[j] = s;
    }
    STAMP(5)

    float sx_new = 0.f;
    if (lane < n) {
      const int c = lane;
      float Kc[kMaxP];
      for (int j = m - 1; j >= 0; --j) {
        float r = sm.R[j][m + c];
        for (int kk = j + 1; kk < m; ++kk) r = r - sm.R[j][kk] * Kc[kk];
        Kc[j] = r / sm.R[j][j];
      }
      for (int j = 0; j < m; ++j) Kc[j] = fail_k ? 0.f : -Kc[j];
      float* Kout = K + (bk * m) * n;
      for (int j = 0; j < m; ++j) Kout[j * n + c] = Kc[j];
      float acc2 = sm.BA[0][m + c] * sm.Sx[0];
      for (int r = 1; r < n; ++r) acc2 = acc2 + sm.BA[r][m + c] * sm.Sx[r];
      const float Qx = lx[((size_t)b * N + k) * n + c] + acc2;
      float s1 = Kc[0] * Quu_d[0];
      for (int i = 1; i < m; ++i) s1 = s1 + Kc[i] * Quu_d[i];
      float s2 = Kc[0] * Qu[0];
      for (int i = 1; i < m; ++i) s2 = s2 + Kc[i] * Qu[i];
      float s3 = 0.f;
      for (int i = 0; i < m; ++i) {
        float q = sm.R[0][i] * sm.R[0][m + c];
        for (int j2 = 1; j2 <= i; ++j2) q = q + sm.R[j2][i] * sm.R[j2][m + c];
        s3 = i == 0 ? q * dk[0] : s3 + q * dk[i];
      }
      sx_new = Qx + s1 + s2 + s3;
    }
    if (lane < m) d[bk * m + lane] = dk[lane];
    {
      float a1 = dk[0] * Qu[0], a2 = Rd[0] * Rd[0];
      for (int j = 1; j < m; ++j) {
        a1 = a1 + dk[j] * Qu[j];
        a2 = a2 + Rd[j] * Rd[j];
      }
      dV1 = dV1 + a1;
      dV2 = dV2 + 0.5f * a2;
    }
    fail = fail || fail_k;
    STAMP(6)
    __syncwarp();
    if (lane < n) {
      sm.Sx[lane] = sx_new;
      for (int r = 0; r < n; ++r) sm.S[r][lane] = sm.R[m + r][m + lane];
    }
    __syncwarp();
    STAMP(7)
  }
  if (lane == 0) {
    dV[2 * b] = dV1;
    dV[2 * b + 1] = dV2;
    fail_out[b] = fail ? 1 : 0;
    if (STAMPS)
      for (int q = 0; q <= kParts; ++q)
        cycles[(size_t)b * (kParts + 1) + q] = acc[q];
  }
}

}  // namespace

// f: A, B, lx, lu, lxx, luu, lux, rho (device pointers); variant 0: the
// design with stamps, 1: its dense rows padded to D[32][33], with stamps,
// 2: the design without stamps
extern "C" int k1_split_f32(const float* const* f, float* K, float* d,
                            float* dV, unsigned char* fail,
                            long long* cycles, int batch, int N, int n,
                            int m, int variant) {
  if (n + m > kMaxP) return (int)cudaErrorInvalidValue;
#define ARGS f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], K, d, dV, fail, \
             cycles, N, n, m
  switch (variant) {
    case 0: split_kernel<kMaxP, true><<<batch, 32>>>(ARGS); break;
    case 1: split_kernel<kMaxP + 1, true><<<batch, 32>>>(ARGS); break;
    case 2: split_kernel<kMaxP, false><<<batch, 32>>>(ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
  return (int)cudaGetLastError();
}
"""

VARIANTS = ("the design, D[32][32]", "D padded to [32][33]",
            "the design without stamps")

CONSUMER_PARTS = ("waiting for the slot", "dense rows", "Householder",
                  "gains and carry")
PRODUCER_PARTS = ("waits and copies", "stage factors")
PIPELINE_SHAPES = ((1, 0), (1, 1), (1, 2), (1, 4))

PIPELINE_SOURCE = r"""
#include <cuda_runtime.h>

__device__ unsigned long long k1_cycles[16];

// the clock since the thread's last stamp into part q of `base` (0: the
// consumers, 8: the producer)
__device__ __forceinline__ void k1_stamp(int q, bool me, int base) {
  __shared__ long long last[2];
  if (me) {
    const long long now = clock64();
    if (q >= 0)
      atomicAdd(&k1_cycles[base + q], (unsigned long long)(now - last[base / 8]));
    last[base / 8] = now;
  }
}
#define K1_PART(q) k1_stamp(q, threadIdx.x == 0, 0)
#define K1_PRODUCER_PART(q) k1_stamp(q, threadIdx.x == blockDim.x - 32, 8)
#include "sqrt_sweep.cu"

// f: A, B, lx, lu, lxx, luu, lux, rho (device pointers); cycles (16, host)
extern "C" int k1_pipeline_split_f32(const float* const* f, float* K,
    float* d, float* dV, unsigned char* fail, int batch, int N, int n, int m,
    int Wc, int Wp, unsigned long long* cycles) {
  unsigned long long zero[16] = {};
  cudaMemcpyToSymbol(k1_cycles, zero, sizeof(zero));
  const Args a{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], K, d, dV,
               fail, batch, N, n, m};
  const int err = dispatch(n, m, [&](auto f) {
    using S = decltype(f);
    return launch_shape<S::nx, S::nu>(a, Shape{Wc, Wp}, 0);
  });
  if (err) return err;
  return (int)cudaMemcpyFromSymbol(cycles, k1_cycles, sizeof(zero));
}
"""


def build():
    """Both libraries, side by side: the one-warp copy's entry point and the
    pipelined kernel's, and nvcc's report of the first."""
    from trajopt_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "k1_knot_split"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for stem, src in (("one_warp", SOURCE), ("pipeline", PIPELINE_SOURCE)):
        cu, lib = out / f"{stem}.cu", out / f"lib{stem}.so"
        cu.write_text(src)
        jobs.append((lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs, logs = [], []
    for lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(log)
        libs.append(ctypes.CDLL(str(lib)))
        logs.append(log)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn = libs[0].k1_split_f32
    fn.argtypes = [P_] * 6 + [I_] * 5
    fn.restype = I_
    pipe = libs[1].k1_pipeline_split_f32
    pipe.argtypes = [P_] * 5 + [I_] * 6 + [P_]
    pipe.restype = I_
    return fn, pipe, logs[0]


def pipeline_split(pipe, ins, shape):
    """The pipelined kernel at ``shape`` on ``ins`` (ρ = 0): mean cycles a
    knot by consumer part, and a producer step by part."""
    import torch

    Bz, N1, n, m = ins[1].shape
    dev = ins[0].device
    rho = torch.zeros(Bz, device=dev)
    ptrs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in (*ins, rho)))
    o = (torch.empty(Bz, N1, m, n, device=dev),
         torch.empty(Bz, N1, m, device=dev), torch.empty(Bz, 2, device=dev),
         torch.empty(Bz, dtype=torch.uint8, device=dev))
    cyc = (ctypes.c_ulonglong * 16)()
    err = pipe(ptrs, *(t.data_ptr() for t in o), Bz, N1 + 1, n, m, *shape,
               cyc)
    if err:
        raise RuntimeError(f"pipelined K1 at {shape}: launch failed ({err})")
    G = max(32 // (n + m), 1)
    wp = max(shape[1], 1)
    groups = -(-N1 // G)
    steps = Bz * -(-groups // wp)       # about the last producer's steps
    cons = [cyc[q] / (Bz * N1) for q in range(len(CONSUMER_PARTS))]
    prod = [cyc[8 + q] / steps for q in range(len(PRODUCER_PARTS))]
    knot = sum(cons)
    print(f"K1 pipelined {shape} (n={n}, m={m}, B={Bz}): a consumer knot "
          f"{knot:.0f} cycles: " + ", ".join(
              f"{p} {c:.0f} ({100 * c / knot:.1f}%)"
              for p, c in zip(CONSUMER_PARTS, cons))
          + f"; a producer step of G = {G} knots: " + ", ".join(
              f"{p} {c:.0f}" for p, c in zip(PRODUCER_PARTS, prod)),
          flush=True)


def main():
    import torch
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("k1_knot_split: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    fn, pipe, log = build()
    for kname, regs, stack, spill in cs.ptxas_report(log):
        print(f"ptxas: {kname}: {regs} registers, {stack} B stack, {spill} "
              "B spilled", flush=True)
    ins, _ = cs.k1_inputs()
    Bz, N1, n, m = ins[1].shape
    dev = ins[0].device
    rho = torch.zeros(Bz, device=dev)
    ptrs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in (*ins, rho)))
    outs, means = [], []
    for variant, label in enumerate(VARIANTS):
        o = (torch.empty(Bz, N1, m, n, device=dev),
             torch.empty(Bz, N1, m, device=dev),
             torch.empty(Bz, 2, device=dev),
             torch.empty(Bz, dtype=torch.uint8, device=dev))
        cyc = torch.zeros(Bz, len(PARTS) + 1, dtype=torch.int64, device=dev)

        def call():
            err = fn(ptrs, *(t.data_ptr() for t in o), cyc.data_ptr(), Bz,
                     N1 + 1, n, m, variant)
            if err:
                raise RuntimeError(f"{label}: launch failed ({err})")

        call()
        torch.cuda.synchronize()
        outs.append(o)
        ms = cs.cuda_time_ms(call, reps=10)
        if variant == 2:
            print(f"K1 one-warp {label}: {ms:.4f} ms a launch", flush=True)
            continue
        mean = (cyc[:, :len(PARTS)].double().sum(0) / (Bz * N1)).tolist()
        means.append(mean)
        knot = sum(mean)
        print(f"K1 one-warp {label} (n={n}, m={m}, N={N1 + 1}, B={Bz}): a "
              f"knot {knot:.0f} cycles: " + ", ".join(
                  f"{p} {c:.0f} ({100 * c / knot:.1f}%)"
                  for p, c in zip(PARTS, mean))
              + f"; the equilibrated factor ran at "
              f"{int(cyc[:, len(PARTS)].sum())} knots; {ms:.4f} ms a launch "
              "with the stamps", flush=True)
    same = all(torch.equal(a.view(torch.uint8) if a.dtype != torch.uint8
                           else a, b.view(torch.uint8) if b.dtype !=
                           torch.uint8 else b)
               for o in outs[1:] for a, b in zip(o, outs[0]))
    print("the conflicts' share of a knot: "
          + ", ".join(f"{p} {c0 - c1:.0f} cycles"
                      for p, c0, c1 in zip(PARTS, *means) if c0 - c1 > 0)
          + f"; in all {sum(means[0]) - sum(means[1]):.0f} of "
          f"{sum(means[0]):.0f} ({100 * (1 - sum(means[1]) / sum(means[0])):.1f}"
          f"%); every variant's outputs bitwise equal: {same}", flush=True)
    for shape in PIPELINE_SHAPES:
        pipeline_split(pipe, ins, shape)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
