// One knot of the Riccati sweep by a team of threads, on matrices in shared
// memory: the Wc consumer warps of a knot pipeline (knot_pipeline.cuh), or
// its lone warp.
//
// Counterpart of the loop body of _fused_al_backward_kernel
// (trajopt_tpu/ops/pallas_al_fused.py:464-500) and of _riccati_kernel
// (ops/pallas_riccati.py); the plain version is ops/riccati.py::scan_sweep.
// Used by the fused AL backward kernel (fused_al_backward.cu), the fused
// backward kernel (fused_backward.cu) and the plain Riccati kernel
// (riccati_sweep.cu), which takes A, B and the expansion from memory, each
// over Wc warps.
//
//   Qx = lx + AᵀSx        Qxx = lxx + AᵀSxxA     Qux = lux + BᵀSxxA
//   Qu = lu + BᵀSx        Quu = luu + BᵀSxxB
//   Quu_reg = Quu + ρI            (control regularization), or
//   Quu_reg = Quu + ρBᵀB, Qux_reg = Qux + ρBᵀA   (state regularization)
//   [K | d] = −Quu_reg⁻¹ [Qux_reg | Qu]     (zero on a failed stage)
//   Sx  ← Qx + KᵀQuu d + KᵀQu + Quxᵀd        (unregularized Quu, Qux)
//   Sxx ← sym(Qxx + KᵀQuuK + QuxᵀK + KᵀQux)
//   ΔV1 += dᵀQu,  ΔV2 += ½ dᵀQuu d
//
// Six dependent phases and the solve's NU + 3, each ended by the team's
// barrier; the products of one phase that do not depend on each other share
// a pass over their entries (SxxA, SxxB, Qx, Qu; then Qxx, Quu, Qux with
// the augmented matrix), and so do the three sums that update each entry of
// Sx and of Sxx. Every entry is one thread's dot product in a fixed order,
// with the rounding of each operation written out (warp_linalg.cuh
// dot_entry, add_dot), so K, d, ΔV and the fail flag are the same float32
// arithmetic whatever the team's size, and the same as the one-warp step's
// plain loops compiled to.
#pragma once
#include <cuda_runtime.h>

#include "posdef_solve.cuh"
#include "warp_linalg.cuh"

namespace trajopt {

// A knot's inputs: the Jacobians and the cost expansion.
template <int NX, int NU>
struct KnotInputs {
  float A[NX * NX], B[NX * NU];
  float lx[NX], lu[NU], lxx[NX * NX], luu[NU * NU], lux[NU * NX];
};

// The sweep's carry and the step's scratch.
template <int NX, int NU>
struct RiccatiState {
  static constexpr int LD = NU + NX + 1;  // [Quu_reg | Qux_reg | Qu]
  float Sx[NX], Sxx[NX * NX];
  float SxxA[NX * NX], SxxB[NX * NU];
  float Qx[NX], Qu[NU], Qxx[NX * NX], Quu[NU * NU], Qux[NU * NX];
  float aug[NU * LD], dscale[NU], piv[NU];
  float K[NU * NX], d[NU], Quud[NU], QuuK[NU * NX];
};

// Runs the step on the inputs `in` and the carry Sx, Sxx of `w` by thread t
// of a team of nt threads (a multiple of 32) whose barrier is `sync`:
// writes K (NU×NX) and d (NU) to K_out and d_out, updates the carry and the
// ΔV sums (the same on every thread). Returns whether the stage failed (the
// same on every thread).
template <int NX, int NU, class Sync>
__device__ __forceinline__ bool riccati_step(const KnotInputs<NX, NU>& in,
                                             RiccatiState<NX, NU>& w,
                                             float rho, bool reg_state,
                                             float* K_out, float* d_out,
                                             float& dV1, float& dV2, int t,
                                             int nt, Sync sync) {
  constexpr int LD = RiccatiState<NX, NU>::LD;
  const float *A = in.A, *B = in.B;
  // SxxA = Sxx·A, SxxB = Sxx·B; Qx = lx + AᵀSx, Qu = lu + BᵀSx
  constexpr int e1 = NX * NX, e2 = e1 + NX * NU, e3 = e2 + NX, e4 = e3 + NU;
  for (int e = t; e < e4; e += nt) {
    if (e < e1) {
      const int i = e / NX, j = e % NX;
      w.SxxA[e] = dot_entry<NX>(w.Sxx + i * NX, 1, A + j, NX);
    } else if (e < e2) {
      const int i = (e - e1) / NU, j = (e - e1) % NU;
      w.SxxB[e - e1] = dot_entry<NX>(w.Sxx + i * NX, 1, B + j, NU);
    } else if (e < e3) {
      const int i = e - e2;
      w.Qx[i] = add_dot<NX>(in.lx[i], A + i, NX, w.Sx, 1);
    } else {
      const int i = e - e3;
      w.Qu[i] = add_dot<NX>(in.lu[i], B + i, NU, w.Sx, 1);
    }
  }
  sync();

  // Qxx = lxx + AᵀSxxA, Quu = luu + BᵀSxxB, Qux = lux + BᵀSxxA, and
  // aug = [Quu_reg | Qux_reg | Qu]
  constexpr int f1 = NX * NX, f2 = f1 + NU * NU, f3 = f2 + NU * NX,
                f4 = f3 + NU;
  for (int e = t; e < f4; e += nt) {
    if (e < f1) {
      const int i = e / NX, j = e % NX;
      w.Qxx[e] = add_dot<NX>(in.lxx[e], A + i, NX, w.SxxA + j, NX);
    } else if (e < f2) {
      const int i = (e - f1) / NU, j = (e - f1) % NU;
      const float v = add_dot<NX>(in.luu[e - f1], B + i, NU, w.SxxB + j, NU);
      w.Quu[e - f1] = v;
      w.aug[i * LD + j] =
          reg_state
              ? __fmaf_rn(rho, dot_entry<NX>(B + i, NU, B + j, NU), v)
              : __fadd_rn(v, i == j ? rho : 0.0f);
    } else if (e < f3) {
      const int i = (e - f2) / NX, j = (e - f2) % NX;
      const float v = add_dot<NX>(in.lux[e - f2], B + i, NU, w.SxxA + j, NX);
      w.Qux[e - f2] = v;
      w.aug[i * LD + NU + j] =
          reg_state
              ? __fmaf_rn(rho, dot_entry<NX>(B + i, NU, A + j, NX), v)
              : v;
    } else {
      const int i = e - f3;
      w.aug[i * LD + NU + NX] = w.Qu[i];
    }
  }
  sync();

  const bool fail =
      posdef_solve<NU, NX + 1, LD>(w.aug, w.dscale, w.piv, t, nt, sync);
  for (int e = t; e < NU * NX + NU; e += nt) {
    if (e < NU * NX) {
      const float v = fail ? 0.0f : -w.aug[(e / NX) * LD + NU + e % NX];
      w.K[e] = v;
      K_out[e] = v;
    } else {
      const int i = e - NU * NX;
      const float v = fail ? 0.0f : -w.aug[i * LD + NU + NX];
      w.d[i] = v;
      d_out[i] = v;
    }
  }
  sync();

  // cost-to-go with the UNregularized Quu, Qux (backward_pass.jl:66-72):
  // Quud = Quu·d, QuuK = Quu·K
  for (int e = t; e < NU + NU * NX; e += nt) {
    if (e < NU) {
      w.Quud[e] = dot_entry<NU>(w.Quu + e * NU, 1, w.d, 1);
    } else {
      const int i = (e - NU) / NX, j = (e - NU) % NX;
      w.QuuK[e - NU] = dot_entry<NU>(w.Quu + i * NU, 1, w.K + j, NX);
    }
  }
  sync();
  // Sx = ((Qx + KᵀQuud) + KᵀQu) + Quxᵀd (the last two sums rounded before
  // they are added, even where NU = 1, as nvcc compiled the plain loops);
  // T = ((Qxx + KᵀQuuK) + QuxᵀK) + KᵀQux, in SxxA
  for (int e = t; e < NX + NX * NX; e += nt) {
    if (e < NX) {
      float v = add_dot<NU>(w.Qx[e], w.K + e, NX, w.Quud, 1);
      v = __fadd_rn(v, dot_entry<NU>(w.K + e, NX, w.Qu, 1));
      w.Sx[e] = __fadd_rn(v, dot_entry<NU>(w.Qux + e, NX, w.d, 1));
    } else {
      const int i = (e - NX) / NX, j = (e - NX) % NX;
      float v = add_dot<NU>(w.Qxx[e - NX], w.K + i, NX, w.QuuK + j, NX);
      v = add_dot<NU>(v, w.Qux + i, NX, w.K + j, NX);
      w.SxxA[e - NX] = add_dot<NU>(v, w.K + i, NX, w.Qux + j, NX);
    }
  }
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = 0; i < NU; ++i) {
    s1 = __fmaf_rn(w.d[i], w.Qu[i], s1);
    s2 = __fmaf_rn(w.d[i], w.Quud[i], s2);
  }
  dV1 = __fadd_rn(dV1, s1);
  dV2 = __fmaf_rn(0.5f, s2, dV2);
  sync();
  // Sxx = ½(T + Tᵀ)
  for (int e = t; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    w.Sxx[e] = __fmul_rn(0.5f, __fadd_rn(w.SxxA[e], w.SxxA[j * NX + i]));
  }
  sync();
  return fail;
}

}  // namespace trajopt
