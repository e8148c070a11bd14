#!/usr/bin/env python3
"""Split the knot time of kernel K3's one-warp design into its parts, on one
GPU, with ``clock64()`` stamps.

    python3 tools/k3_knot_split.py

K3 (``trajopt_tpu_torch/csrc/fused_al_backward.cu``) ran one warp a problem
until its pipelined redesign, every phase of a knot on that warp in turn.
This script carries a copy of that design (``SOURCE`` below: the kernel,
its Riccati step and its PD solve as they stood, one lane stamping the
SM clock between the parts), builds it by nvcc with the flags of
``kernels/_build.py`` under ``build/k3_knot_split/``, and runs it on the
inputs of ``chip_smoke.py``'s K3 checks at B = 128: the maze's slack
quadrotor (P = 89), the slack car of ``car_escape`` (P = 180), the cartpole
rig with and without slacks. Per instantiation it prints the mean cycles a
knot spends in each part (the Dual Jacobians; the stage expansion; the AL
expansion with the fk rows; the Riccati step before the PD solve, the PD
solve, the rest of the step), their shares, the launch's time by CUDA
events with and without the stamps, and the card's ``nvidia-smi`` line.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PARTS = ("jacobians", "stage expansion", "AL expansion",
         "Riccati before the solve", "PD solve", "Riccati after the solve")

SOURCE = r"""
#include <cuda_runtime.h>
#include "canon.cuh"
#include "models.cuh"
using namespace trajopt;

namespace {
constexpr int kParts = 6;

template <int P, int Q, int R>
__device__ __forceinline__ void split_mm(float* C, int ldc, const float* A,
    int sai, int sar, const float* B, int sbr, int sbj, const float* add,
    int ldadd, float scale, int lane) {
  for (int e = lane; e < P * Q; e += 32) {
    const int i = e / Q, j = e % Q;
    float acc = A[i * sai] * B[j * sbj];
#pragma unroll
    for (int r = 1; r < R; ++r)
      acc = acc + A[i * sai + r * sar] * B[r * sbr + j * sbj];
    acc = scale * acc;
    C[i * ldc + j] = add ? add[i * ldadd + j] + acc : acc;
  }
  __syncwarp();
}

template <int M, int K, int LD>
__device__ __forceinline__ bool split_solve(float* aug, float* dscale,
                                            float* piv, int lane) {
  if (lane < M) dscale[lane] = 1.0f / sqrtf(fmaxf(aug[lane * LD + lane], 1e-30f));
  __syncwarp();
  for (int e = lane; e < M * (M + K); e += 32) {
    const int i = e / (M + K), c = e % (M + K);
    float v = aug[i * LD + c] * dscale[i];
    if (c < M) v = v * dscale[c];
    aug[i * LD + c] = v;
  }
  __syncwarp();
  bool fail = false;
  for (int i = 0; i < M; ++i) {
    float p = aug[i * LD + i];
    fail = fail || (p < -1e-3f) || !isfinite(p);
    p = fmaxf(p, 1e-7f);
    if (lane == 0) piv[i] = p;
    const float inv = 1.0f / p;
    const int ncols = M + K - 1 - i;
    const int count = (M - 1 - i) * ncols;
    for (int e = lane; e < count; e += 32) {
      const int j = i + 1 + e / ncols, c = i + 1 + e % ncols;
      const float f = aug[j * LD + i] * inv;
      aug[j * LD + c] = aug[j * LD + c] - f * aug[i * LD + c];
    }
    __syncwarp();
  }
  if (lane < K) {
    float* x = aug + M + lane;
    for (int i = M - 1; i >= 0; --i) {
      float r = x[i * LD];
      for (int j = i + 1; j < M; ++j) r = r - aug[i * LD + j] * x[j * LD];
      x[i * LD] = r / piv[i];
    }
    for (int i = 0; i < M; ++i) x[i * LD] = x[i * LD] * dscale[i];
  }
  __syncwarp();
  return fail;
}

template <int NX, int NU>
struct Work {
  static constexpr int LD = NU + NX + 1;
  float Sx[NX], Sxx[NX * NX];
  float A[NX * NX], B[NX * NU];
  float lx[NX], lu[NU], lxx[NX * NX], luu[NU * NU], lux[NU * NX];
  float SxxA[NX * NX], SxxB[NX * NU];
  float Qx[NX], Qu[NU], Qxx[NX * NX], Quu[NU * NU], Qux[NU * NX];
  float aug[NU * LD], dscale[NU], piv[NU];
  float K[NU * NX], d[NU], Quud[NU], QuuK[NU * NX];
};

__device__ __forceinline__ void stamp(long long* acc, int part,
                                      long long& t, int lane) {
  if (acc == nullptr) return;
  __syncwarp();
  const long long now = clock64();
  if (lane == 0) acc[part] += now - t;
  t = now;
}

template <int NX, int NU>
__device__ __forceinline__ bool split_step(Work<NX, NU>& w, float rho,
    bool reg_state, float* K_out, float* d_out, float& dV1, float& dV2,
    int lane, long long* acc, long long& t) {
  constexpr int LD = Work<NX, NU>::LD;
  const float* none = nullptr;
  split_mm<NX, NX, NX>(w.SxxA, NX, w.Sxx, NX, 1, w.A, NX, 1, none, 0, 1.f, lane);
  split_mm<NX, NU, NX>(w.SxxB, NU, w.Sxx, NX, 1, w.B, NU, 1, none, 0, 1.f, lane);
  split_mm<NX, 1, NX>(w.Qx, 1, w.A, 1, NX, w.Sx, 1, 1, w.lx, 1, 1.f, lane);
  split_mm<NU, 1, NX>(w.Qu, 1, w.B, 1, NU, w.Sx, 1, 1, w.lu, 1, 1.f, lane);
  split_mm<NX, NX, NX>(w.Qxx, NX, w.A, 1, NX, w.SxxA, NX, 1, w.lxx, NX, 1.f, lane);
  split_mm<NU, NU, NX>(w.Quu, NU, w.B, 1, NU, w.SxxB, NU, 1, w.luu, NU, 1.f, lane);
  split_mm<NU, NX, NX>(w.Qux, NX, w.B, 1, NU, w.SxxA, NX, 1, w.lux, NX, 1.f, lane);
  if (reg_state) {
    split_mm<NU, NU, NX>(w.aug, LD, w.B, 1, NU, w.B, NU, 1, w.Quu, NU, rho, lane);
    split_mm<NU, NX, NX>(w.aug + NU, LD, w.B, 1, NU, w.A, NX, 1, w.Qux, NX,
                         rho, lane);
  } else {
    for (int e = lane; e < NU * NU; e += 32) {
      const int i = e / NU, j = e % NU;
      w.aug[i * LD + j] = w.Quu[e] + (i == j ? rho : 0.0f);
    }
    for (int e = lane; e < NU * NX; e += 32)
      w.aug[(e / NX) * LD + NU + e % NX] = w.Qux[e];
  }
  if (lane < NU) w.aug[lane * LD + NU + NX] = w.Qu[lane];
  stamp(acc, 3, t, lane);
  const bool fail = split_solve<NU, NX + 1, LD>(w.aug, w.dscale, w.piv, lane);
  stamp(acc, 4, t, lane);
  for (int e = lane; e < NU * NX; e += 32) {
    const float v = fail ? 0.0f : -w.aug[(e / NX) * LD + NU + e % NX];
    w.K[e] = v;
    K_out[e] = v;
  }
  if (lane < NU) {
    const float v = fail ? 0.0f : -w.aug[lane * LD + NU + NX];
    w.d[lane] = v;
    d_out[lane] = v;
  }
  __syncwarp();
  split_mm<NU, 1, NU>(w.Quud, 1, w.Quu, NU, 1, w.d, 1, 1, none, 0, 1.f, lane);
  split_mm<NU, NX, NU>(w.QuuK, NX, w.Quu, NU, 1, w.K, NX, 1, none, 0, 1.f, lane);
  split_mm<NX, 1, NU>(w.Sx, 1, w.K, 1, NX, w.Quud, 1, 1, w.Qx, 1, 1.f, lane);
  split_mm<NX, 1, NU>(w.Sx, 1, w.K, 1, NX, w.Qu, 1, 1, w.Sx, 1, 1.f, lane);
  split_mm<NX, 1, NU>(w.Sx, 1, w.Qux, 1, NX, w.d, 1, 1, w.Sx, 1, 1.f, lane);
  split_mm<NX, NX, NU>(w.SxxA, NX, w.K, 1, NX, w.QuuK, NX, 1, w.Qxx, NX, 1.f, lane);
  split_mm<NX, NX, NU>(w.SxxA, NX, w.Qux, 1, NX, w.K, NX, 1, w.SxxA, NX, 1.f, lane);
  split_mm<NX, NX, NU>(w.SxxA, NX, w.K, 1, NX, w.Qux, NX, 1, w.SxxA, NX, 1.f, lane);
  for (int e = lane; e < NX * NX; e += 32) {
    const int i = e / NX, j = e % NX;
    w.Sxx[e] = 0.5f * (w.SxxA[e] + w.SxxA[j * NX + i]);
  }
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = 0; i < NU; ++i) {
    s1 = s1 + w.d[i] * w.Qu[i];
    s2 = s2 + w.d[i] * w.Quud[i];
  }
  dV1 = dV1 + s1;
  dV2 = dV2 + 0.5f * s2;
  stamp(acc, 5, t, lane);
  return fail;
}

template <int NX, int NU>
struct Shared {
  Work<NX, NU> w;
  FkWork fk;
  float z[NX + NU];
  float alx[NX], alu[NU], alxx[NX * NX], aluu_d[NU];
};

template <class M, bool Slack>
__global__ void __launch_bounds__(32) split_kernel(
    const float* __restrict__ X, const float* __restrict__ U,
    const float* __restrict__ lam, const float* __restrict__ mu,
    const float* __restrict__ dt, const float* __restrict__ Q,
    const float* __restrict__ R, const float* __restrict__ H,
    const float* __restrict__ q, const float* __restrict__ r,
    const float* __restrict__ rho_in, CanonTables tab,
    const ChainTable* __restrict__ chain, float* __restrict__ K,
    float* __restrict__ d, float* __restrict__ dV,
    unsigned char* __restrict__ fail_out, int batch, int N, float atol,
    long long* __restrict__ prof, int stamps) {
  constexpr int NX = M::NX, MB = M::NU, NU = Slack ? MB + NX : MB;
  __shared__ Shared<NX, NU> s;
  extern __shared__ float dyn[];
  float* g_s = dyn;
  float* imu_s = dyn + tab.P;
  const int b = blockIdx.x, lane = threadIdx.x, P = tab.P;
  const float rho = rho_in[b];
  Work<NX, NU>& w = s.w;
  long long acc_[kParts] = {0, 0, 0, 0, 0, 0};
  long long* acc = stamps ? acc_ : nullptr;

  const float* xN = X + ((size_t)b * N + (N - 1)) * NX;
  for (int e = lane; e < NX + NU; e += 32) s.z[e] = e < NX ? xN[e] : 0.0f;
  __syncwarp();
  fk_knot_warp(tab, s.z, s.fk, lane);
  canon_al_expansion_warp<NX, NU>(
      tab, s.z, s.fk, lam + ((size_t)b * N + (N - 1)) * P,
      mu + ((size_t)b * N + (N - 1)) * P, atol, g_s, imu_s, s.alx, s.alu,
      s.alxx, s.aluu_d, lane);
  const float* QN = Q + (size_t)(N - 1) * NX * NX;
  if (lane < NX) {
    float a = QN[lane * NX] * s.z[0];
    for (int j = 1; j < NX; ++j) a = a + QN[lane * NX + j] * s.z[j];
    w.Sx[lane] = a + q[(size_t)(N - 1) * NX + lane] + s.alx[lane];
  }
  for (int e = lane; e < NX * NX; e += 32) w.Sxx[e] = QN[e] + s.alxx[e];
  if constexpr (Slack) {
    for (int e = lane; e < NX * NX; e += 32)
      w.B[(e / NX) * NU + MB + e % NX] = (e / NX == e % NX) ? 1.0f : 0.0f;
  }
  __syncwarp();

  float dV1 = 0.0f, dV2 = 0.0f;
  bool fail = false;
  long long t = clock64();
  for (int k = N - 2; k >= 0; --k) {
    const size_t bk = (size_t)b * (N - 1) + k;
    const float* xk = X + ((size_t)b * N + k) * NX;
    const float* uk = U + bk * NU;
    const float dtv = dt[k];
    for (int e = lane; e < NX + NU; e += 32)
      s.z[e] = e < NX ? xk[e] : uk[e - NX];
    __syncwarp();
    if (lane < NX + MB) {
      Dual xd[NX], ud[MB], out[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xd[i] = Dual(s.z[i], lane == i ? 1.f : 0.f);
#pragma unroll
      for (int i = 0; i < MB; ++i)
        ud[i] = Dual(s.z[NX + i], lane == NX + i ? 1.f : 0.f);
      M::template step<Dual>(xd, ud, dtv, out, chain);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (lane < NX) w.A[i * NX + lane] = out[i].d;
        else w.B[i * NU + lane - NX] = out[i].d;
      }
    }
    stamp(acc, 0, t, lane);
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
      w.lx[lane] = (a + q[(size_t)k * NX + lane] + h) * dtv;
    }
    if (lane < NU) {
      float a = Rk[lane * NU] * u[0];
      for (int j = 1; j < NU; ++j) a = a + Rk[lane * NU + j] * u[j];
      float h = Hk[lane * NX] * x[0];
      for (int j = 1; j < NX; ++j) h = h + Hk[lane * NX + j] * x[j];
      w.lu[lane] = (a + r[(size_t)k * NU + lane] + h) * dtv;
    }
    for (int e = lane; e < NX * NX; e += 32) w.lxx[e] = Qk[e] * dtv;
    for (int e = lane; e < NU * NU; e += 32) w.luu[e] = Rk[e] * dtv;
    for (int e = lane; e < NU * NX; e += 32) w.lux[e] = Hk[e] * dtv;
    __syncwarp();
    stamp(acc, 1, t, lane);
    fk_knot_warp(tab, s.z, s.fk, lane);
    canon_al_expansion_warp<NX, NU>(tab, s.z, s.fk,
                                    lam + ((size_t)b * N + k) * P,
                                    mu + ((size_t)b * N + k) * P, atol, g_s,
                                    imu_s, s.alx, s.alu, s.alxx, s.aluu_d,
                                    lane);
    if (lane < NX) w.lx[lane] = w.lx[lane] + s.alx[lane];
    if (lane < NU) {
      w.lu[lane] = w.lu[lane] + s.alu[lane];
      w.luu[lane * NU + lane] = w.luu[lane * NU + lane] + s.aluu_d[lane];
    }
    for (int e = lane; e < NX * NX; e += 32) w.lxx[e] = w.lxx[e] + s.alxx[e];
    __syncwarp();
    stamp(acc, 2, t, lane);
    const bool fail_k = split_step<NX, NU>(w, rho, false, K + bk * NU * NX,
                                           d + bk * NU, dV1, dV2, lane,
                                           acc, t);
    fail = fail || fail_k;
  }
  if (lane == 0) {
    dV[b] = dV1;
    dV[batch + b] = dV2;
    fail_out[b] = fail ? 1 : 0;
    if (stamps)
      for (int i = 0; i < kParts; ++i) prof[b * kParts + i] = acc[i];
  }
}

template <class M, bool Slack>
int launch(const float* const* f, const CanonTables& tab,
           const ChainTable* chain, float* K, float* d, float* dV,
           unsigned char* fail, int batch, int N, float atol,
           long long* prof, int stamps) {
  split_kernel<M, Slack><<<batch, 32, 2 * (size_t)tab.P * sizeof(float)>>>(
      f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], tab,
      chain, K, d, dV, fail, batch, N, atol, prof, stamps);
  return (int)cudaGetLastError();
}
}  // namespace

// f: X, U, lam, mu, dt, Q, R, H, q, r, rho (device pointers)
extern "C" int k3_split_f32(const float* const* f, const int* row_i,
    const float* row_f, const int* groups, const int* col_ptr,
    const int* col_rows, const float* fk_joint, const float* fk_point,
    const float* chain, float* K, float* d, float* dV, unsigned char* fail,
    int batch, int N, int P, int G, int J, int npts, int model, float atol,
    long long* prof, int stamps) {
  CanonTables tab{(const int4*)row_i, (const float4*)row_f, groups, col_ptr,
                  col_rows, P, G, fk_joint, (const float4*)fk_point, J, npts};
  const ChainTable* ct = (const ChainTable*)chain;
  switch (model) {
    case kModelSlack + kModelQuadrotor:
      return launch<Quadrotor, true>(f, tab, ct, K, d, dV, fail, batch, N,
                                     atol, prof, stamps);
    case kModelSlack + kModelCar:
      return launch<Car, true>(f, tab, ct, K, d, dV, fail, batch, N, atol,
                               prof, stamps);
    case kModelCartpoleUrdf:
      return launch<CartpoleUrdf, false>(f, tab, ct, K, d, dV, fail, batch,
                                         N, atol, prof, stamps);
    case kModelSlack + kModelCartpoleUrdf:
      return launch<CartpoleUrdf, true>(f, tab, ct, K, d, dV, fail, batch,
                                        N, atol, prof, stamps);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def build():
    from trajopt_tpu_torch.kernels import _build

    out = _build.BUILD_DIR / "k3_knot_split"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "k3_knot_split.cu", out / "libk3_knot_split.so"
    cu.write_text(SOURCE)
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
         str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(lib)).k3_split_f32
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P_] * 13 + [I_] * 7 + [F_, P_, I_]
    fn.restype = ctypes.c_int
    return fn


def cases():
    """(label, model, canon, X, U, lam, mu, dt, obj) of the K3 checks."""
    import torch
    import chip_smoke as cs

    ms = cs.maze_setup(torch.float32, cs.B)
    yield ("quadrotor_slack", ms["prob"].model, ms["canon"], ms["X"],
           ms["U"], ms["lam"], ms["mu"], ms["dt"], ms["prob"].obj)
    for name, slack in (("car", True), ("cartpole_urdf", False),
                        ("cartpole_urdf", True)):
        st = cs.al_setup(name, slack)
        p = st["p32"]
        yield (st["label"], p.model, st["canon"], *st["data"], p.dt_traj(),
               p.obj)


def run(fn, label, model, canon, X, U, lam, mu, dt, obj, reps=10):
    import torch
    from trajopt_tpu_torch.ops.cuda_models import chain_table_ptr, cuda_model

    cm = cuda_model(model, "k3_knot_split", slack_ok=True)
    Bz, N, n = X.shape
    dev = X.device
    rho = torch.ones(Bz, device=dev)
    K = torch.empty(Bz, N - 1, cm.m, n, device=dev)
    d = torch.empty(Bz, N - 1, cm.m, device=dev)
    dV = torch.empty(2, Bz, device=dev)
    fail = torch.empty(Bz, dtype=torch.uint8, device=dev)
    prof = torch.zeros(Bz, len(PARTS), dtype=torch.int64, device=dev)
    ptrs = (ctypes.c_void_p * 11)(*(t.data_ptr() for t in (
        X, U, lam, mu, dt, obj.Q, obj.R, obj.H, obj.q, obj.r, rho)))

    def call(stamps):
        err = fn(ptrs, canon.row_i.data_ptr(), canon.row_f.data_ptr(),
                 canon.groups.data_ptr(), canon.col_ptr.data_ptr(),
                 canon.col_rows.data_ptr(), canon.fk_joint.data_ptr(),
                 canon.fk_point.data_ptr(), chain_table_ptr(model, cm, dev),
                 K.data_ptr(), d.data_ptr(), dV.data_ptr(), fail.data_ptr(),
                 Bz, N, canon.P, canon.groups.shape[0],
                 canon.fk_joint.shape[0], canon.fk_point.shape[0], cm.id,
                 0.0, prof.data_ptr(), int(stamps))
        if err:
            raise RuntimeError(f"{label}: launch failed ({err})")

    times = {}
    for stamps in (False, True):
        for _ in range(3):
            call(stamps)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            call(stamps)
        end.record()
        torch.cuda.synchronize()
        times[stamps] = start.elapsed_time(end) / reps
    prof.zero_()
    call(True)
    torch.cuda.synchronize()
    cyc = prof.double().mean(0) / (N - 1)       # cycles a knot, per part
    total = float(cyc.sum())
    print(f"K3 {label} (n={n}, m={cm.m}, P={canon.P}, N={N}, B={Bz}): "
          f"{times[False]:.4f} ms a launch ({times[True]:.4f} with the "
          f"stamps); a knot {total:.0f} cycles: " + "; ".join(
              f"{p} {float(c):.0f} ({100 * float(c) / total:.1f}%)"
              for p, c in zip(PARTS, cyc)) +
          f"; fails {int(fail.sum())}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("k3_knot_split: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    fn = build()
    for case in cases():
        run(fn, *case)
    return 0


if __name__ == "__main__":
    sys.exit(main())
