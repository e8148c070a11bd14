// The canonical constraint stack inside a kernel: sphere rows, single-entry
// linear rows and the forward-kinematics bubble rows of a rigid-body chain
// (K8) evaluated from flat tables, the active-set rule, the AL cost and its
// Gauss-Newton expansion.
//
// Counterpart of _fk_lanes, _group_c_g_imu, _al_cost_lanes and
// _al_expansion_accumulate in trajopt_tpu/ops/pallas_al_fused.py; the
// tables are built by trajopt_tpu_torch/ops/canonical.py::canonical_stack
// (see CanonStack for their layout). One warp works on one knot of one
// problem; z = [x; u] lies in shared memory.
//
//   sphere row: c = b − Σ_d (z[coord_d] − ctr_d)²   act = (c ≥ atol) | (λ > 0)
//   linear row: c = sign·z[col] + off               act = eq | (c ≥ atol) | (λ > 0)
//   fk row:     c = b − Σ_{d ∈ dims} (p_i[d] − ctr_d)²     act as a sphere row
//   Iμ = act ? μ : 0,  g = Iμ·c + λ
//
// An fk row's point p_i is a world point of the chain's forward kinematics
// from q = x[:J]: a joint frame's origin, or an offset in a joint's frame.
// The rotations are affine in (sin q, cos q), E1_k = R0 + Rs sin q_k +
// Rc cos q_k, so the sweep E_k = E1_k E_parent, r_k = r_parent +
// E_parentᵀ rf_k needs no trigonometric matrix assembly (fk_knot_warp
// computes it once per knot). The Gauss-Newton rows use the geometric
// Jacobian ∂p_i/∂q_k = z_k × (p_i − r_k) for the joints k up to the
// point's own, with z_k = E_kᵀ axis_k.
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
  // the chain of the fk rows: per joint R0, Rs, Rc (3×3 row-major), rf,
  // axis, parent (−1: the root) and two pads; per point its offset and
  // joint. J = 0: the stack has no fk rows.
  const float* fk_joint;  // (J, 36)
  const float4* fk_point;  // (npts) off0, off1, off2, joint
  int J, npts;
};

constexpr int kKindLinear = 0;
constexpr int kKindFk = 2;
constexpr int kFkMaxJoints = 8, kFkMaxPoints = 16;

// the chain's frames and points at one knot (shared memory)
struct FkWork {
  float E[kFkMaxJoints][9];   // world → joint frame rotation
  float r[kFkMaxJoints][3];   // joint frame origin
  float ax[kFkMaxJoints][3];  // joint axis in the world
  float p[kFkMaxPoints][3];   // the rows' points
};

// The forward kinematics of the fk rows from q = z[:J], by lane 0 (a chain
// of dependent 3×3 products; the other lanes wait at the __syncwarp), in
// the order of _fk_lanes: E1 entries R0 + Rs s + Rc c, products summed over
// a ascending, r_k = r_parent + Σ_a E_parent[a][i] rf[a].
__device__ __forceinline__ void fk_knot_warp(const CanonTables& t,
                                             const float* z, FkWork& w,
                                             int lane) {
  if (t.J == 0) return;
  if (lane == 0) {
    for (int k = 0; k < t.J; ++k) {
      const float* jt = t.fk_joint + 36 * k;
      const float s = sinf(z[k]), c = cosf(z[k]);
      float E1[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) E1[e] = jt[e] + jt[9 + e] * s + jt[18 + e] * c;
      const int p = (int)jt[33];
      if (p < 0) {
#pragma unroll
        for (int e = 0; e < 9; ++e) w.E[k][e] = E1[e];
#pragma unroll
        for (int i = 0; i < 3; ++i) w.r[k][i] = jt[27 + i];
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            float acc = E1[i * 3] * w.E[p][j];
            acc = acc + E1[i * 3 + 1] * w.E[p][3 + j];
            acc = acc + E1[i * 3 + 2] * w.E[p][6 + j];
            w.E[k][i * 3 + j] = acc;
          }
          float acc = w.r[p][i];
#pragma unroll
          for (int a = 0; a < 3; ++a) acc = acc + w.E[p][a * 3 + i] * jt[27 + a];
          w.r[k][i] = acc;
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float acc = w.E[k][d] * jt[30];
        acc = acc + w.E[k][3 + d] * jt[31];
        acc = acc + w.E[k][6 + d] * jt[32];
        w.ax[k][d] = acc;
      }
    }
    for (int i = 0; i < t.npts; ++i) {
      const float4 pt = t.fk_point[i];
      const int k = (int)pt.w;
      const float off[3] = {pt.x, pt.y, pt.z};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float acc = w.E[k][d] * off[0];
        acc = acc + w.E[k][3 + d] * off[1];
        acc = acc + w.E[k][6 + d] * off[2];
        w.p[i][d] = w.r[k][d] + acc;
      }
    }
  }
  __syncwarp();
}

// v_d = p[d] − ctr_d of an fk row (0 outside its dims) and its c
__device__ __forceinline__ float fk_row(const int4& ri, const float4& rf,
                                        const FkWork& w, float* v) {
  const float ctr[3] = {rf.x, rf.y, rf.z};
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    v[d] = (ri.z >> d) & 1 ? w.p[ri.y][d] - ctr[d] : 0.0f;
    acc = acc + v[d] * v[d];
  }
  return rf.w - acc;
}

// c, g and Iμ of row r at this knot (fk: the knot's FkWork)
__device__ __forceinline__ void canon_row(const CanonTables& t, int r,
                                          const float* z, const FkWork& fk,
                                          float lam, float mu, float atol,
                                          float& c, float& g, float& imu) {
  const int4 ri = t.row_i[r];
  const float4 rf = t.row_f[r];
  bool act;
  if (ri.x == kKindLinear) {
    c = rf.x * z[ri.y] + rf.y;
    act = rf.z > 0.5f;
  } else if (ri.x == kKindFk) {
    float v[3];
    c = fk_row(ri, rf, fk, v);
    act = false;
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
// get the knot's AL cost); fk_knot_warp must have filled fk.
__device__ __forceinline__ float canon_al_cost_lane(const CanonTables& t,
                                                    const float* z,
                                                    const FkWork& fk,
                                                    const float* lam_k,
                                                    const float* mu_k,
                                                    float atol, int lane) {
  float acc = 0.0f;
  for (int r = lane; r < t.P; r += 32) {
    float c, g, imu;
    const float lam = lam_k[r];
    canon_row(t, r, z, fk, lam, mu_k[r], atol, c, g, imu);
    acc = acc + (lam * c + 0.5f * c * imu * c);
  }
  return acc;
}

// Gauss-Newton AL expansion at one knot: alx (NX), alu (NU), alxx (NX×NX)
// and the diagonal aluu_d (NU) of JᵀIμJ (a linear row touches one diagonal
// entry, sphere and fk rows only state coordinates, so luu gains no
// off-diagonal and lux nothing). g_s and imu_s are P floats of scratch
// each; fk holds the knot's kinematics (fk_knot_warp). Every sum has one
// owner and a fixed order: the lane of z-column j sums its linear rows, and
// each sphere group and the fk rows are reduced over the warp by shuffles.
template <int NX, int NU>
__device__ __forceinline__ void canon_al_expansion_warp(
    const CanonTables& t, const float* z, const FkWork& fk,
    const float* lam_k, const float* mu_k, float atol, float* g_s,
    float* imu_s, float* alx, float* alu, float* alxx, float* aluu_d,
    int lane) {
  for (int e = lane; e < NX * NX; e += 32) alxx[e] = 0.0f;
  for (int r = lane; r < t.P; r += 32) {
    float c, g, imu;
    canon_row(t, r, z, fk, lam_k[r], mu_k[r], atol, c, g, imu);
    g_s[r] = g;
    imu_s[r] = imu;
  }
  __syncwarp();

  for (int col = lane; col < NX + NU; col += 32) {
    float lz = 0.0f, dH = 0.0f;
    for (int i = t.col_ptr[col]; i < t.col_ptr[col + 1]; ++i) {
      const int r = t.col_rows[i];
      const float s = t.row_f[r].x;
      lz = lz + s * g_s[r];
      dH = dH + s * s * imu_s[r];
    }
    if (col < NX) {
      alx[col] = lz;
      alxx[col * NX + col] = dH;
    } else {
      alu[col - NX] = lz;
      aluu_d[col - NX] = dH;
    }
  }
  __syncwarp();

  if (t.J > 0) {
    // fk rows: grow_k = −2 Σ_d v_d (z_k × (p − r_k))_d for k up to the
    // point's joint; lx_k += g grow_k, lxx_ab += (Iμ grow_a) grow_b
    float G[kFkMaxJoints];
    float Hq[kFkMaxJoints * (kFkMaxJoints + 1) / 2];
#pragma unroll
    for (int k = 0; k < kFkMaxJoints; ++k) G[k] = 0.0f;
#pragma unroll
    for (int q = 0; q < kFkMaxJoints * (kFkMaxJoints + 1) / 2; ++q)
      Hq[q] = 0.0f;
    for (int r = lane; r < t.P; r += 32) {
      const int4 ri = t.row_i[r];
      if (ri.x != kKindFk) continue;
      float v[3];
      fk_row(ri, t.row_f[r], fk, v);
      const int kmax = (int)t.fk_point[ri.y].w;
      const float* p = fk.p[ri.y];
      float grow[kFkMaxJoints];
#pragma unroll
      for (int k = 0; k < kFkMaxJoints; ++k) {
        grow[k] = 0.0f;
        if (k > kmax) continue;
        const float* zk = fk.ax[k];
        const float w[3] = {p[0] - fk.r[k][0], p[1] - fk.r[k][1],
                            p[2] - fk.r[k][2]};
        const float J[3] = {zk[1] * w[2] - zk[2] * w[1],
                            zk[2] * w[0] - zk[0] * w[2],
                            zk[0] * w[1] - zk[1] * w[0]};
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < 3; ++d) acc = acc + v[d] * J[d];
        grow[k] = -2.0f * acc;
      }
      const float g = g_s[r], im = imu_s[r];
      int q = 0;
#pragma unroll
      for (int a = 0; a < kFkMaxJoints; ++a) {
        G[a] = G[a] + g * grow[a];
        const float iga = im * grow[a];
#pragma unroll
        for (int b = a; b < kFkMaxJoints; ++b, ++q)
          Hq[q] = Hq[q] + iga * grow[b];
      }
    }
    int q = 0;
#pragma unroll
    for (int a = 0; a < kFkMaxJoints; ++a) {
      const float ga = warp_sum(G[a]);
      if (lane == 0 && a < t.J) alx[a] = alx[a] + ga;
#pragma unroll
      for (int b = a; b < kFkMaxJoints; ++b, ++q) {
        const float h = warp_sum(Hq[q]);
        if (lane == 0 && b < t.J) {
          alxx[a * NX + b] = alxx[a * NX + b] + h;
          if (b != a) alxx[b * NX + a] = alxx[b * NX + a] + h;
        }
      }
    }
    __syncwarp();
  }

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
