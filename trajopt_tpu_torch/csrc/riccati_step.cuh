// One knot of the Riccati sweep by one warp, on matrices in shared memory.
//
// Counterpart of the loop body of _fused_al_backward_kernel
// (trajopt_tpu/ops/pallas_al_fused.py:464-500) and of _riccati_kernel
// (ops/pallas_riccati.py); the plain version is ops/riccati.py::scan_sweep.
// Used by the fused AL backward kernel (fused_al_backward.cu), the fused
// backward kernel (fused_backward.cu) and the plain Riccati kernel
// (riccati_sweep.cu), which takes A, B and the expansion from memory.
//
//   Qx = lx + AᵀSx        Qxx = lxx + AᵀSxxA     Qux = lux + BᵀSxxA
//   Qu = lu + BᵀSx        Quu = luu + BᵀSxxB
//   Quu_reg = Quu + ρI            (control regularization), or
//   Quu_reg = Quu + ρBᵀB, Qux_reg = Qux + ρBᵀA   (state regularization)
//   [K | d] = −Quu_reg⁻¹ [Qux_reg | Qu]     (zero on a failed stage)
//   Sx  ← Qx + KᵀQuu d + KᵀQu + Quxᵀd        (unregularized Quu, Qux)
//   Sxx ← sym(Qxx + KᵀQuuK + QuxᵀK + KᵀQux)
//   ΔV1 += dᵀQu,  ΔV2 += ½ dᵀQuu d
#pragma once
#include <cuda_runtime.h>

#include "posdef_solve.cuh"
#include "warp_linalg.cuh"

namespace trajopt {

// Shared-memory state and scratch of the sweep for one problem.
template <int NX, int NU>
struct RiccatiWork {
  static constexpr int LD = NU + NX + 1;  // [Quu_reg | Qux_reg | Qu]
  // the sweep's carry
  float Sx[NX], Sxx[NX * NX];
  // this knot's inputs, filled by the caller
  float A[NX * NX], B[NX * NU];
  float lx[NX], lu[NU], lxx[NX * NX], luu[NU * NU], lux[NU * NX];
  // scratch
  float SxxA[NX * NX], SxxB[NX * NU];
  float Qx[NX], Qu[NU], Qxx[NX * NX], Quu[NU * NU], Qux[NU * NX];
  float aug[NU * LD], dscale[NU], piv[NU];
  float K[NU * NX], d[NU], Quud[NU], QuuK[NU * NX];
};

// Runs the step on w (inputs A, B, lx..lux and the carry Sx, Sxx), writes
// K (NU×NX) and d (NU) to K_out and d_out, updates the carry and the ΔV
// sums. Returns whether the stage failed (the same on every lane).
template <int NX, int NU>
__device__ __forceinline__ bool riccati_step_warp(RiccatiWork<NX, NU>& w,
                                                  float rho, bool reg_state,
                                                  float* K_out, float* d_out,
                                                  float& dV1, float& dV2,
                                                  int lane) {
  constexpr int LD = RiccatiWork<NX, NU>::LD;
  const float* none = nullptr;
  // SxxA = Sxx·A, SxxB = Sxx·B
  warp_mm<NX, NX, NX>(w.SxxA, NX, w.Sxx, NX, 1, w.A, NX, 1, none, 0, 1.f, lane);
  warp_mm<NX, NU, NX>(w.SxxB, NU, w.Sxx, NX, 1, w.B, NU, 1, none, 0, 1.f, lane);
  // Qx = lx + AᵀSx, Qu = lu + BᵀSx
  warp_mm<NX, 1, NX>(w.Qx, 1, w.A, 1, NX, w.Sx, 1, 1, w.lx, 1, 1.f, lane);
  warp_mm<NU, 1, NX>(w.Qu, 1, w.B, 1, NU, w.Sx, 1, 1, w.lu, 1, 1.f, lane);
  // Qxx = lxx + AᵀSxxA, Quu = luu + BᵀSxxB, Qux = lux + BᵀSxxA
  warp_mm<NX, NX, NX>(w.Qxx, NX, w.A, 1, NX, w.SxxA, NX, 1, w.lxx, NX, 1.f, lane);
  warp_mm<NU, NU, NX>(w.Quu, NU, w.B, 1, NU, w.SxxB, NU, 1, w.luu, NU, 1.f, lane);
  warp_mm<NU, NX, NX>(w.Qux, NX, w.B, 1, NU, w.SxxA, NX, 1, w.lux, NX, 1.f, lane);

  // aug = [Quu_reg | Qux_reg | Qu]
  if (reg_state) {
    warp_mm<NU, NU, NX>(w.aug, LD, w.B, 1, NU, w.B, NU, 1, w.Quu, NU, rho, lane);
    warp_mm<NU, NX, NX>(w.aug + NU, LD, w.B, 1, NU, w.A, NX, 1, w.Qux, NX, rho,
                        lane);
  } else {
    for (int e = lane; e < NU * NU; e += 32) {
      const int i = e / NU, j = e % NU;
      w.aug[i * LD + j] = w.Quu[e] + (i == j ? rho : 0.0f);
    }
    for (int e = lane; e < NU * NX; e += 32)
      w.aug[(e / NX) * LD + NU + e % NX] = w.Qux[e];
  }
  if (lane < NU) w.aug[lane * LD + NU + NX] = w.Qu[lane];
  __syncwarp();

  const bool fail =
      posdef_solve_warp<NU, NX + 1, LD>(w.aug, w.dscale, w.piv, lane);
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

  // cost-to-go with the UNregularized Quu, Qux (backward_pass.jl:66-72)
  warp_mm<NU, 1, NU>(w.Quud, 1, w.Quu, NU, 1, w.d, 1, 1, none, 0, 1.f, lane);
  warp_mm<NU, NX, NU>(w.QuuK, NX, w.Quu, NU, 1, w.K, NX, 1, none, 0, 1.f, lane);
  // Sx = ((Qx + KᵀQuud) + KᵀQu) + Quxᵀd
  warp_mm<NX, 1, NU>(w.Sx, 1, w.K, 1, NX, w.Quud, 1, 1, w.Qx, 1, 1.f, lane);
  warp_mm<NX, 1, NU>(w.Sx, 1, w.K, 1, NX, w.Qu, 1, 1, w.Sx, 1, 1.f, lane);
  warp_mm<NX, 1, NU>(w.Sx, 1, w.Qux, 1, NX, w.d, 1, 1, w.Sx, 1, 1.f, lane);
  // T = ((Qxx + KᵀQuuK) + QuxᵀK) + KᵀQux, in SxxA; Sxx = ½(T + Tᵀ)
  warp_mm<NX, NX, NU>(w.SxxA, NX, w.K, 1, NX, w.QuuK, NX, 1, w.Qxx, NX, 1.f, lane);
  warp_mm<NX, NX, NU>(w.SxxA, NX, w.Qux, 1, NX, w.K, NX, 1, w.SxxA, NX, 1.f, lane);
  warp_mm<NX, NX, NU>(w.SxxA, NX, w.K, 1, NX, w.Qux, NX, 1, w.SxxA, NX, 1.f, lane);
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
  __syncwarp();
  return fail;
}

}  // namespace trajopt
