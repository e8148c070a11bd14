// The canonical constraint stack inside a kernel: sphere rows and
// single-entry linear rows evaluated from flat tables, the active-set
// rule, the AL cost and its Gauss-Newton expansion.
//
// Counterpart of _group_c_g_imu, _al_cost_lanes and
// _al_expansion_accumulate in trajopt_tpu/ops/pallas_al_fused.py; the
// tables are built by trajopt_tpu_torch/ops/canonical.py::canonical_stack
// (see CanonStack for their layout). One warp works on one knot of one
// problem; z = [x; u] lies in shared memory.
//
//   sphere row: c = b − Σ_d (z[coord_d] − ctr_d)²   act = (c ≥ atol) | (λ > 0)
//   linear row: c = sign·z[col] + off               act = eq | (c ≥ atol) | (λ > 0)
//   Iμ = act ? μ : 0,  g = Iμ·c + λ
//
// λ and μ arrive zero on rows that are not valid at the knot, so those rows
// add nothing: the knot masks are not part of the tables.
#pragma once
#include <cuda_runtime.h>

#include "warp_linalg.cuh"

namespace trajopt {

struct CanonTables {
  const int4* row_i;     // (P) kind, c0, c1, c2
  const float4* row_f;   // (P) sign, off, eq, 0  |  ctr0, ctr1, ctr2, b
  const int* groups;     // (G, 6) r0, r1, D, c0, c1, c2 of the sphere groups
  const int* col_ptr;    // (n + m + 1) linear rows by z-column
  const int* col_rows;
  int P, G;
};

constexpr int kKindLinear = 0;

// c, g and Iμ of row r at this knot
__device__ __forceinline__ void canon_row(const CanonTables& t, int r,
                                          const float* z, float lam,
                                          float mu, float atol, float& c,
                                          float& g, float& imu) {
  const int4 ri = t.row_i[r];
  const float4 rf = t.row_f[r];
  bool act;
  if (ri.x == kKindLinear) {
    c = rf.x * z[ri.y] + rf.y;
    act = rf.z > 0.5f;
  } else {
    c = rf.w;
    float v = z[ri.y] - rf.x;
    c = c - v * v;
    if (ri.z >= 0) {
      v = z[ri.z] - rf.y;
      c = c - v * v;
    }
    if (ri.w >= 0) {
      v = z[ri.w] - rf.z;
      c = c - v * v;
    }
    act = false;
  }
  act = act || (c >= atol) || (lam > 0.0f);
  imu = act ? mu : 0.0f;
  g = imu * c + lam;
}

// This lane's share of Σ_p λ c + ½ c Iμ c at one knot (sum over the warp to
// get the knot's AL cost).
__device__ __forceinline__ float canon_al_cost_lane(const CanonTables& t,
                                                    const float* z,
                                                    const float* lam_k,
                                                    const float* mu_k,
                                                    float atol, int lane) {
  float acc = 0.0f;
  for (int r = lane; r < t.P; r += 32) {
    float c, g, imu;
    const float lam = lam_k[r];
    canon_row(t, r, z, lam, mu_k[r], atol, c, g, imu);
    acc = acc + (lam * c + 0.5f * c * imu * c);
  }
  return acc;
}

// Gauss-Newton AL expansion at one knot: alx (NX), alu (NU), alxx (NX×NX)
// and the diagonal aluu_d (NU) of JᵀIμJ (a linear row touches one diagonal
// entry, a sphere row only state coordinates, so luu gains no off-diagonal
// and lux nothing). g_s and imu_s are P floats of scratch each. Every sum
// has one owner and a fixed order: lane j sums the linear rows of z-column
// j, and each sphere group is reduced over the warp by shuffles.
template <int NX, int NU>
__device__ __forceinline__ void canon_al_expansion_warp(
    const CanonTables& t, const float* z, const float* lam_k,
    const float* mu_k, float atol, float* g_s, float* imu_s, float* alx,
    float* alu, float* alxx, float* aluu_d, int lane) {
  static_assert(NX + NU <= 32, "one lane per z-column");
  for (int e = lane; e < NX * NX; e += 32) alxx[e] = 0.0f;
  for (int r = lane; r < t.P; r += 32) {
    float c, g, imu;
    canon_row(t, r, z, lam_k[r], mu_k[r], atol, c, g, imu);
    g_s[r] = g;
    imu_s[r] = imu;
  }
  __syncwarp();

  if (lane < NX + NU) {
    float lz = 0.0f, dH = 0.0f;
    for (int i = t.col_ptr[lane]; i < t.col_ptr[lane + 1]; ++i) {
      const int r = t.col_rows[i];
      const float s = t.row_f[r].x;
      lz = lz + s * g_s[r];
      dH = dH + s * s * imu_s[r];
    }
    if (lane < NX) {
      alx[lane] = lz;
      alxx[lane * NX + lane] = dH;
    } else {
      alu[lane - NX] = lz;
      aluu_d[lane - NX] = dH;
    }
  }
  __syncwarp();

  for (int gi = 0; gi < t.G; ++gi) {
    const int* gr = t.groups + 6 * gi;
    const int r1 = gr[1], D = gr[2];
    float sx[3] = {0.f, 0.f, 0.f};
    float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // 00 01 02 11 12 22
    for (int r = gr[0] + lane; r < r1; r += 32) {
      const float4 rf = t.row_f[r];
      const float ctr[3] = {rf.x, rf.y, rf.z};
      float v[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < 3; ++d)
        if (d < D) v[d] = z[gr[3 + d]] - ctr[d];
      const float g = g_s[r], im = imu_s[r];
      int q = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        sx[a] = sx[a] + g * v[a];
#pragma unroll
        for (int b = a; b < 3; ++b, ++q) h[q] = h[q] + im * v[a] * v[b];
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) sx[a] = warp_sum(sx[a]);
#pragma unroll
    for (int q = 0; q < 6; ++q) h[q] = warp_sum(h[q]);
    if (lane == 0) {
      int q = 0;
      for (int a = 0; a < 3; ++a) {
        for (int b = a; b < 3; ++b, ++q) {
          if (a >= D || b >= D) continue;
          const int ca = gr[3 + a], cb = gr[3 + b];
          const float hv = 4.0f * h[q];
          alxx[ca * NX + cb] = alxx[ca * NX + cb] + hv;
          if (cb != ca) alxx[cb * NX + ca] = alxx[cb * NX + ca] + hv;
        }
        if (a < D) alx[gr[3 + a]] = alx[gr[3 + a]] - 2.0f * sx[a];
      }
    }
    __syncwarp();
  }
}

}  // namespace trajopt
