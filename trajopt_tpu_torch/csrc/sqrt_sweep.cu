// QR square-root Riccati backward sweep, batched over problems (kernel K1).
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_sqrt.py::_sqrt_kernel
// (front end sqrt_sweep_pallas). It computes, for every problem and every
// knot k = N-2 .. 0:
//   1. the upper Cholesky factor R1 of the joint stage Hessian
//      [[luu + rho I, lux], [luxᵀ, lxx]] (p = m + n), plain first with the
//      +1e-14 pivot acceptance; where that breaks down, the Jacobi-
//      equilibrated factor with pivot neg-tol 1e-3 and floor 1e-7;
//   2. the Householder triangularization of [R1 ; Ssqrt·[B A]], one
//      reflection per column against the n dense rows;
//   3. K = -Ruu⁻¹Rux, d = -Ruu⁻¹Ruu⁻ᵀQu, the value gradient, dV1/dV2 and
//      the fail flag (stage factor failure, a non-finite Ruu row, or a
//      Ruu diagonal ratio below 1e-8); Rxx is the next Ssqrt.
// Semantics follow the Pallas kernel line for line; the plain twin is
// trajopt_tpu_torch/ops/cuda_sqrt.py::sqrt_sweep.
//
// What bounds it on this card: nothing about bandwidth or FLOPs. The main
// path runs B = 128 problems of N-1 = 100 knots at p = 16 and moves about
// 24 MB; each knot is a chain of small dependent eliminations on the carry
// (the dense rows, p Householder columns, each a serial sum, a square root
// and a division, then the gains' triangular solves), so the sweep is bound
// by the latency of that chain, one knot after another.
//
// Design: a knot pipeline (knot_pipeline.cuh, shared with K3, K5 and K7a).
// The stage factor R1 reads only the knot's inputs, so it leaves the
// carry's chain: Wp producer warps copy a knot's [B A], lx, lu and joint
// Hessian into a slot of the ring (cp.async) and factor the Hessian there,
// G = ⌊32/p⌋ knots a warp, lane group g = lane / p on knot i0 + g (2 at
// p = 16), each lane the arithmetic of one column as one warp a knot had
// it. One consumer warp owns Ssqrt, Sx, the fail flag and the ΔV sums and
// runs the rest. Lane j owns column j of [R ; D]: it forms its column of
// the dense rows D = Ssqrt·[B A] in registers (Ssqrt's rows read four
// floats at a time), so the Householder triangularization needs no shared
// memory for D, no barrier and no bank conflict (the one-warp design
// stored D column by column, 32 floats apart: 16 lanes on one bank). Each
// column's pivot column is in every lane's registers, the next one formed
// by every lane from a shuffle issued a column ahead, so the column's
// chain is its σ, square root, division and update. The gains and the
// value update follow, lane c on column c. (n, m) are compile-time
// constants for slice 1's quadrotor error state (12, 4), so every loop
// unrolls into registers; any other n + m ≤ 32 runs one instantiation with
// run-time sizes. Slots, state and scratch are sized from the launch's
// (n, m).
// Every entry keeps the one-warp kernel's order of operations and the
// rounding nvcc gave its loops, written out with __fmaf_rn, __fmul_rn and
// __fadd_rn, so K, d, ΔV and the fail flag do not depend on the shape. The
// shape (1, Wp) is the first of the preferences whose B blocks fit on the
// card in one wave, else the lone warp. No fast-math: sqrtf and division
// are IEEE, as in the TPU kernel.
#include <cuda_runtime.h>

#include "knot_pipeline.cuh"

namespace {

using namespace trajopt;

constexpr int kMaxP = 32;
constexpr float kTiny = 1e-30f;
constexpr float kNegTol = 1e-3f;   // SQRT_PIVOT_NEG_TOL
constexpr float kFloor = 1e-7f;    // SQRT_PIVOT_FLOOR_F32

// Hooks at the parts of a knot, which tools/k1_knot_split.py defines to
// stamp the SM clock (K1_PART on the first consumer thread, K1_PRODUCER_PART
// on the last warp's lane 0); empty in the kernel.
#ifndef K1_PART
#define K1_PART(q)
#define K1_PRODUCER_PART(q)
#endif

// (Wc, Wp) in order of preference, one consumer warp: (1, 2) where the
// batch fits in one wave of it, else the lone warp. Measured by
// tools/k1_launch_shape.py (H100, ms a launch; the lone warp, the shape
// taken, the next best):
//   (12,4), B = 128    0.885 | (1,2) 0.444 | (1,3) 0.445
//   (12,4), B = 1024   1.011 (taken: (1,2) is 4 blocks an SM) | (1,2) 0.977
// Two producers keep the ring full at p = 16 (one leaves the consumer
// waiting a third of the knot); more gain nothing.
constexpr ShapeList kShapes{1, {{1, 2}}};

struct Args {
  const float *A, *B, *lx, *lu, *lxx, *luu, *lux, *rho;
  float *K, *d, *dV;
  unsigned char* fail;
  int batch, N, n, m;
};

// A launch's sizes from its (n, m): the offsets, in floats, of a slot's
// parts, of the consumers' state and of a producer's scratch.
struct Dims {
  int n, m, p, G;
  // a slot: R1 and then R (p×p), [B A] (n×p), lx (n), lu (m), the stage
  // factor's fail flag
  int sR, sBA, slx, slu, sfail, slot;
  // the consumer warp: Ssqrt (n rows of ls = n rounded up to 4 floats,
  // 16-byte aligned), Sx (ls), Qu (m) and Qx (n) side by side, and the
  // terminal factor's matrix (n×n)
  int ls, wS, wSx, wQ, wM, state;
  // a producer's scratch: the joint Hessian of each of its G knots
  int mstride, scratch;
  __host__ __device__ Dims(int n_, int m_)
      : n(n_), m(m_), p(n_ + m_), G(32 / (n_ + m_)) {
    sR = 0;
    sBA = sR + p * p;
    slx = sBA + n * p;
    slu = slx + n;
    sfail = slu + m;
    slot = sfail + 1;
    ls = (n + 3) & ~3;
    wS = 0;
    wSx = wS + n * ls;
    wQ = wSx + ls;
    wM = wQ + p;
    state = wM + n * n;
    mstride = p * p + p;   // each group's matrix a half bank-row apart
    scratch = G * mstride;
  }
};

using SqrtRing = Ring<float, float>;

// ring_slots(Wp, G) slots, a scratch for each producer (the lone warp's)
__host__ __device__ RingLayout layout(const Dims& D, int Wp) {
  return RingLayout(ring_slots(Wp, D.G), Wp > 0 ? Wp : 1,
                    sizeof(float) * D.slot, sizeof(float) * D.state,
                    sizeof(float) * D.scratch);
}

// The sizes of an instantiation: (NX, NU) fixed at compile time, so every
// loop over rows and columns unrolls and its arrays stay in registers
// ((12, 4), slice 1's), or (0, 0), any n + m ≤ 32 at run time.
template <int NX, int NU>
struct Fixed {
  static constexpr int nx = NX, nu = NU;
  static constexpr int LN = NX > 0 ? NX : kMaxP;   // array bounds
  static constexpr int LM = NU > 0 ? NU : kMaxP;
  static constexpr int LP = NX > 0 ? NX + NU : kMaxP;
  __device__ static int n(const Dims& D) { return NX > 0 ? NX : D.n; }
  __device__ static int m(const Dims& D) { return NU > 0 ? NU : D.m; }
  __device__ static int ls(const Dims& D) {
    return NX > 0 ? (NX + 3) & ~3 : D.ls;
  }
};

// v, once a and b are computed: the sums a and b are issued before what
// uses v (nvcc would otherwise sink them past the branches of the square
// root and of the division that follow, onto the chain of the column)
__device__ __forceinline__ float after(float v, float a, float b) {
  float out;
  asm volatile("mov.b32 %0, %1;" : "=f"(out) : "f"(v), "f"(a), "f"(b));
  return out;
}

// ------------------------------------------------------ the stage factor

// Plain upper Cholesky of the dim×dim matrix M (row stride dim, dim ≤ L)
// into U (row stride ldu) by a group of lanes: lane base + c owns column c, `on`
// where the group has a matrix; every lane of the warp calls it (the
// shuffles). Deferred-update rows, pivot accepted at s_ii + 1e-14
// (ops/pallas_sqrt.py chol_upper, plain path). Returns the group's
// failure flag.
template <int L>
__device__ bool chol_plain(const float* M, float* U, int ldu, int dim,
                           int base, int c, bool on) {
  const bool mine = on && c < dim;
  bool fail = false;
#pragma unroll 1
  for (int i = 0; i < dim; ++i) {
    float s = 0.f;
    if (mine) {
      float uki[L], ukc[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (k < i) {
          uki[k] = U[k * ldu + i];
          ukc[k] = U[k * ldu + c];
        }
      }
      s = M[i * dim + c];
#pragma unroll
      for (int k = 0; k < L; ++k)
        if (k < i) s = __fmaf_rn(-uki[k], ukc[k], s);
    }
    const float piv2 = __fadd_rn(__shfl_sync(kFullMask, s, base + i), 1e-14f);
    fail = fail || (piv2 <= 0.f) || !isfinite(piv2);
    const float piv = sqrtf(fmaxf(piv2, kTiny));
    __syncwarp();
    if (mine) U[i * ldu + c] = c == i ? piv : (c < i ? 0.f : s / piv);
    __syncwarp();
  }
  return fail;
}

// Jacobi-equilibrated upper Cholesky of M in place, by a group of lanes as
// chol_plain: factor D·M·D (unit diagonal) with pivots in (-neg_tol, floor)
// clamped to the floor, then unscale the columns, (U D⁻¹)ᵀ(U D⁻¹) = M (row
// i of M is read before U's row i is written over it). Returns the group's
// failure flag (a pivot below -neg_tol or non-finite).
template <int L>
__device__ bool chol_equilibrated(float* M, int dim, int base, int c,
                                  bool on) {
  const bool mine = on && c < dim;
  const float dinv = mine ? 1.f / sqrtf(fmaxf(M[c * dim + c], 1e-30f)) : 1.f;
  bool fail = false;
#pragma unroll 1
  for (int i = 0; i < dim; ++i) {
    const float dinv_i = __shfl_sync(kFullMask, dinv, base + i);
    float s = 0.f;
    if (mine) {
      float uki[L], ukc[L];
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (k < i) {
          uki[k] = M[k * dim + i];
          ukc[k] = M[k * dim + c];
        }
      }
      s = __fmul_rn(__fmul_rn(M[i * dim + c], dinv_i), dinv);
#pragma unroll
      for (int k = 0; k < L; ++k)
        if (k < i) s = __fmaf_rn(-uki[k], ukc[k], s);
    }
    const float piv2 = __shfl_sync(kFullMask, s, base + i);
    fail = fail || (piv2 < -kNegTol) || !isfinite(piv2);
    const float piv = sqrtf(fmaxf(piv2, kFloor));
    __syncwarp();
    if (mine) M[i * dim + c] = c == i ? piv : (c < i ? 0.f : s / piv);
    __syncwarp();
  }
  if (mine)
    for (int i = 0; i < dim; ++i) M[i * dim + c] = M[i * dim + c] / dinv;
  __syncwarp();
  return fail;
}

// Plain factor of M into U first; the equilibrated one (in M, then copied
// to U) where a group's plain one breaks down. Returns plain_fail &&
// equilibrated_fail.
template <int L>
__device__ bool chol_robust(float* M, float* U, int ldu, int dim, int base,
                            int c, bool on) {
  const bool fail = chol_plain<L>(M, U, ldu, dim, base, c, on);
  if (!__any_sync(kFullMask, on && fail)) return false;
  const bool fail_eq = chol_equilibrated<L>(M, dim, base, c, on);
  if (on && fail && c < dim)
    for (int i = 0; i < dim; ++i) U[i * ldu + c] = M[i * dim + c];
  __syncwarp();
  return fail && fail_eq;
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile(
      "cp.async.commit_group;\n"
      "cp.async.wait_group 0;" ::
          : "memory");
}

// The stage inputs of the knots of sweep indices i0 … i0 + cnt − 1 (knot
// k = N − 2 − i in slot i mod S) by one warp, lane group g = lane / p on
// knot i0 + g: its [B A], lx and lu into the slot and its joint Hessian
// into the group's scratch (asynchronous copies, all in flight at once),
// luu + ρI, then R1 and its fail flag into the slot.
template <int NX, int NU>
__device__ void stage_knots(const Args& a, const Dims& D, const SqrtRing& r,
                            float* scratch, int b, float rho, int i0,
                            int cnt, int lane) {
  using F = Fixed<NX, NU>;
  const int n = F::n(D), m = F::m(D), p = n + m, N = a.N;
  const int g = lane / p, c = lane - g * p;
  const bool on = g < cnt;
  float* M = scratch + (on ? g : 0) * D.mstride;
  float* slot = on ? &r.slot((i0 + g) % r.L.S) : scratch;
  if (on) {
    const int k = N - 2 - (i0 + g);
    const size_t bk = (size_t)b * (N - 1) + k, bkx = (size_t)b * N + k;
    const float* Ak = a.A + bk * n * n;
    const float* Bk = a.B + bk * n * m;
    const float* luuk = a.luu + bk * m * m;
    const float* luxk = a.lux + bk * m * n;
    const float* lxxk = a.lxx + bkx * n * n;
    for (int e = c; e < p * p; e += p) {
      const int row = e / p, col = e - row * p;
      copy_async(M + e, row < m ? (col < m ? luuk + row * m + col
                                           : luxk + row * n + col - m)
                                : (col < m ? luxk + col * n + row - m
                                           : lxxk + (row - m) * n + col - m));
    }
    for (int e = c; e < n * p; e += p) {
      const int row = e / p, col = e - row * p;
      copy_async(slot + D.sBA + e, col < m ? Bk + row * m + col
                                           : Ak + row * n + col - m);
    }
    for (int e = c; e < n + m; e += p)
      copy_async(slot + D.slx + e,
                 e < n ? a.lx + bkx * n + e : a.lu + bk * m + e - n);
  }
  copy_async_wait();
  __syncwarp();
  K1_PRODUCER_PART(0);
  // luu + ρI, every entry rounded as luu + (ρ or 0)
  if (on)
    for (int e = c; e < m * m; e += p) {
      const int row = e / m, col = e - row * m;
      M[row * p + col] = __fadd_rn(M[row * p + col], row == col ? rho : 0.f);
    }
  __syncwarp();
  const bool fail =
      chol_robust<F::LP>(M, slot + D.sR, p, p, on ? g * p : 0, c, on);
  if (on && c == 0) slot[D.sfail] = fail ? 1.f : 0.f;
  __syncwarp();
  K1_PRODUCER_PART(1);
}

// ------------------------------------------------------------ the step

// Knot k of problem b by the consumer warp on its slot and the carry in w.
// Lane j owns column j of [R ; D]: the dense rows' column in registers, R
// in the slot, so a Householder column is the pivot column's n shuffles
// from lane j and each lane's own update, with no barrier. Then the fail
// rules, the gains (to K and d) and the value update, lane c on column c,
// and the carry (Sx, Ssqrt = Rxx). Returns the stage's fail flag on lane
// 0, which also keeps dV1, dV2.
template <int NX, int NU>
__device__ __forceinline__ bool sqrt_step(const Args& a, const Dims& D,
                                          float* slot, float* w, int b,
                                          int k, float& dV1, float& dV2,
                                          int lane) {
  using F = Fixed<NX, NU>;
  constexpr int LN = F::LN, LM = F::LM;
  const int n = F::n(D), m = F::m(D), p = n + m, ls = F::ls(D);
  float* R = slot + D.sR;
  const float* BA = slot + D.sBA;
  float *S = w + D.wS, *Sx = w + D.wSx, *Q = w + D.wQ;
  K1_PART(0);

  // 2) the dense rows' column j = Ssqrt·(column j of [B A]) on lane j, and
  // Q[j] = lu[j] + (column j of B)·Sx (Qu) or lx[j - m] + (column j - m of
  // A)·Sx (Qx); Ssqrt's rows and Sx are read four floats at a time
  float dcol[LN];
  if (lane < p) {
    float ba[LN];
#pragma unroll
    for (int c = 0; c < n; ++c) ba[c] = BA[c * p + lane];
#pragma unroll
    for (int r = 0; r <= n; ++r) {
      const float4* row = reinterpret_cast<const float4*>(r < n ? S + r * ls
                                                                : Sx);
      float acc = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < ls / 4; ++c4) {
        const float4 v = row[c4];
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 4 * c4 + q;
          if (c < n)
            acc = c == 0 ? __fmul_rn(e[q], ba[0]) : __fmaf_rn(e[q], ba[c], acc);
        }
      }
      if (r < n)
        dcol[r] = acc;
      else
        Q[lane] = __fadd_rn(
            lane < m ? slot[D.slu + lane] : slot[D.slx + lane - m], acc);
    }
  }
  K1_PART(1);

  // 3) Householder triangularization of [R1 ; D], column by column. Every
  // lane holds the pivot column j (piv) and forms σ from it; lane l > j
  // forms its dot with it, τ_l and its own update, the other lanes take
  // τ = 0 and keep their columns (columns ≤ j are not read again). Every
  // lane also forms lane j + 1's dot, τ and update from column j + 1 as it
  // stood (nxt, shuffled from lane j + 1 a column ahead), so the next pivot
  // column is at hand without waiting for a shuffle: the same operations on
  // the same values as lane j + 1's. R's row j changes only in column j's
  // step, where lane l > j writes its own entry R[j][l] (lane j keeps the
  // diagonal α in a register until the loop ends). Lane j + 1's R[j][j+1]
  // (rjn) comes by a shuffle of that lane's own load, so no lane reads an
  // entry that another lane writes within the loop, and no barrier is
  // needed between a column's loads and its stores.
  float piv[LN], nxt[LN];
#pragma unroll
  for (int r = 0; r < n; ++r) piv[r] = __shfl_sync(kFullMask, dcol[r], 0);
  float alpha_own = 0.f;
#pragma unroll 1
  for (int j = 0; j < p; ++j) {
    const bool upd = lane > j && lane < p, more = j + 1 < p;
    const float a0 = R[j * p + j];
    const float rjl = R[j * p + (upd ? lane : j)];
#pragma unroll
    for (int r = 0; r < n; ++r)
      nxt[r] = __shfl_sync(kFullMask, dcol[r], more ? j + 1 : j);
    float sigma = __fmul_rn(piv[0], piv[0]);
    float dot = __fmul_rn(dcol[0], piv[0]);
    float dotn = __fmul_rn(nxt[0], piv[0]);
#pragma unroll
    for (int r = 1; r < n; ++r) {
      sigma = __fmaf_rn(piv[r], piv[r], sigma);
      dot = __fmaf_rn(dcol[r], piv[r], dot);
      dotn = __fmaf_rn(nxt[r], piv[r], dotn);
    }
    // after the dots: issued first, it would hold the nxt shuffles behind
    // the load of rjl
    const float rjn = __shfl_sync(kFullMask, rjl, more ? j + 1 : j);
    const float nrm = sqrtf(__fmaf_rn(a0, a0, after(sigma, dot, dotn)));
    const float alpha = a0 >= 0.f ? -nrm : nrm;
    const float v0 = __fadd_rn(a0, -alpha);
    const float denom = __fmul_rn(nrm, __fadd_rn(nrm, fabsf(a0)));  // vᵀv/2
    const float beta = denom > kTiny ? 1.f / fmaxf(denom, kTiny) : 0.f;
    const float tl = upd ? __fmul_rn(beta, __fmaf_rn(v0, rjl, dot)) : 0.f;
    const float tn = __fmul_rn(beta, __fmaf_rn(v0, rjn, dotn));
#pragma unroll
    for (int r = 0; r < n; ++r) {
      dcol[r] = __fmaf_rn(-tl, piv[r], dcol[r]);
      piv[r] = __fmaf_rn(-tn, piv[r], nxt[r]);
    }
    if (upd) R[j * p + lane] = __fmaf_rn(-tl, v0, rjl);
    if (lane == j) alpha_own = alpha;
  }
  if (lane < p) R[lane * p + lane] = alpha_own;
  __syncwarp();
  K1_PART(2);

  // the carry's Ssqrt = Rxx (rows m … p − 1 of R, which nothing below
  // writes; Ssqrt is not read again in this knot)
  if (lane < n) {
    float rxx[LN];
#pragma unroll
    for (int r = 0; r < n; ++r) rxx[r] = R[(m + r) * p + m + lane];
#pragma unroll
    for (int r = 0; r < n; ++r) S[r * ls + lane] = rxx[r];
  }

  // 4) fail rules, d and the value update terms (the same values on every
  // lane), 5) column c of K and Sx_new on lane c
  bool fail_k = false;
  if (lane < n) {
    const int c = lane;
    fail_k = slot[D.sfail] != 0.f;
    float dmin = fabsf(R[0]), dmax = dmin;
#pragma unroll
    for (int j = 1; j < m; ++j) {
      const float dd = fabsf(R[j * p + j]);
      dmin = fminf(dmin, dd);
      dmax = fmaxf(dmax, dd);
    }
    fail_k = fail_k || (dmin / fmaxf(dmax, kTiny) < 1e-8f);
#pragma unroll
    for (int j = 0; j < m; ++j) {
      float rs = fabsf(R[j * p]);
#pragma unroll
      for (int cc = 1; cc < p; ++cc) rs = __fadd_rn(rs, fabsf(R[j * p + cc]));
      fail_k = fail_k || !isfinite(rs);
    }

    float qu[LM], y[LM], dk[LM], rd[LM], qd[LM], kc[LM];
#pragma unroll
    for (int j = 0; j < m; ++j) qu[j] = Q[j];
    // y = Ruu⁻ᵀQu, dk = Ruu⁻¹y
#pragma unroll
    for (int j = 0; j < m; ++j) {
      float s = qu[j];
#pragma unroll
      for (int kk = 0; kk < j; ++kk) s = __fmaf_rn(-R[kk * p + j], y[kk], s);
      y[j] = s / R[j * p + j];
    }
#pragma unroll
    for (int j = m - 1; j >= 0; --j) {
      float s = y[j];
#pragma unroll
      for (int kk = j + 1; kk < m; ++kk)
        s = __fmaf_rn(-R[j * p + kk], dk[kk], s);
      dk[j] = s / R[j * p + j];
    }
#pragma unroll
    for (int j = 0; j < m; ++j) dk[j] = fail_k ? 0.f : -dk[j];
    // Ruu d, Ruuᵀ(Ruu d)
#pragma unroll
    for (int j = 0; j < m; ++j) {
      float s = __fmul_rn(R[j * p + j], dk[j]);
#pragma unroll
      for (int kk = j + 1; kk < m; ++kk)
        s = __fmaf_rn(R[j * p + kk], dk[kk], s);
      rd[j] = s;
    }
#pragma unroll
    for (int j = 0; j < m; ++j) {
      float s = __fmul_rn(R[j], rd[0]);
#pragma unroll
      for (int kk = 1; kk <= j; ++kk) s = __fmaf_rn(R[kk * p + j], rd[kk], s);
      qd[j] = s;
    }

    // K = -Ruu⁻¹Rux, column c
#pragma unroll
    for (int j = m - 1; j >= 0; --j) {
      float rr = R[j * p + m + c];
#pragma unroll
      for (int kk = j + 1; kk < m; ++kk)
        rr = __fmaf_rn(-R[j * p + kk], kc[kk], rr);
      kc[j] = rr / R[j * p + j];
    }
#pragma unroll
    for (int j = 0; j < m; ++j) kc[j] = fail_k ? 0.f : -kc[j];

    // Sx_new = Qx + KᵀRuuᵀRuu d + KᵀQu + Quxᵀd, Qux = RuuᵀRux
    float s1 = __fmul_rn(kc[0], qd[0]);
    float s2 = __fmul_rn(kc[0], qu[0]);
#pragma unroll
    for (int i = 1; i < m; ++i) {
      s1 = __fmaf_rn(kc[i], qd[i], s1);
      s2 = __fmaf_rn(kc[i], qu[i], s2);
    }
    float s3 = 0.f;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      float q = __fmul_rn(R[i], R[m + c]);
#pragma unroll
      for (int j2 = 1; j2 <= i; ++j2)
        q = __fmaf_rn(R[j2 * p + i], R[j2 * p + m + c], q);
      s3 = i == 0 ? __fmul_rn(q, dk[0]) : __fmaf_rn(q, dk[i], s3);
    }
    Sx[c] = __fadd_rn(__fadd_rn(__fadd_rn(Q[m + c], s1), s2), s3);

    const size_t bk = (size_t)b * (a.N - 1) + k;
    float* Kout = a.K + bk * m * n;
#pragma unroll
    for (int j = 0; j < m; ++j) Kout[j * n + c] = kc[j];
    if (c == 0) {
      float a1 = __fmul_rn(dk[0], qu[0]), a2 = __fmul_rn(rd[0], rd[0]);
#pragma unroll
      for (int j = 1; j < m; ++j) {
        a1 = __fmaf_rn(dk[j], qu[j], a1);
        a2 = __fmaf_rn(rd[j], rd[j], a2);
      }
      dV1 = __fadd_rn(dV1, a1);
      dV2 = __fmaf_rn(0.5f, a2, dV2);
#pragma unroll
      for (int j = 0; j < m; ++j) a.d[bk * m + j] = dk[j];
    }
  }
  __syncwarp();
  K1_PART(3);
  return fail_k;
}

// A block of one consumer warp (warp 0) and Wp producer warps, or with
// Wp = 0 one warp that does both.
template <int NX, int NU>
__global__ void __launch_bounds__(32 * kMaxWarps) sqrt_sweep_kernel(Args a,
                                                                    int Wp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims D(a.n, a.m);
  const SqrtRing r{smem, layout(D, Wp)};
  const int n = Fixed<NX, NU>::n(D), N = a.N, b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  r.init(1, Wp);
  __syncthreads();

  float* w = &r.state();
  bool fail_N = false;
  if (warp == 0) {
    // terminal: Ssqrt_N = chol(lxx_N) (upper), Sx = lx_N
    float* M = w + D.wM;
    const size_t bN = (size_t)b * N + (N - 1);
    for (int e = lane; e < n * n; e += 32) M[e] = a.lxx[bN * n * n + e];
    for (int e = lane; e < n; e += 32) w[D.wSx + e] = a.lx[bN * n + e];
    __syncwarp();
    fail_N = chol_robust<Fixed<NX, NU>::LN>(M, w + D.wS, D.ls, n, 0, lane,
                                            true);
  }

  float* scratch =
      reinterpret_cast<float*>(r.scratch(Wp == 0 || warp == 0 ? 0 : warp - 1));
  const float rho = a.rho[b];
  float dV1 = 0.0f, dV2 = 0.0f;
  K1_PART(-1);
  K1_PRODUCER_PART(-1);
  const bool fail = knot_pipeline(
      r, 1, Wp, D.G, N,
      [&](int i0, int cnt) {
        stage_knots<NX, NU>(a, D, r, scratch, b, rho, i0, cnt, lane);
      },
      [&](int s, int k) {
        return sqrt_step<NX, NU>(a, D, &r.slot(s), w, b, k, dV1, dV2, lane);
      });
  if (threadIdx.x == 0) {
    a.dV[2 * b] = dV1;
    a.dV[2 * b + 1] = dV2;
    a.fail[b] = fail || fail_N ? 1 : 0;
  }
}

template <int NX, int NU>
LaunchCache& launch_cache() {
  static LaunchCache cache;
  return cache;
}

// The first shape of kShapes whose `batch` blocks fit on the card in one
// wave, else one warp a problem; Wc = 0 when the device cannot be queried.
// The blocks an SM holds are cached per device and shape for the last
// (n, m) of the instantiation.
template <int NX, int NU>
Shape shape_for(const Dims& D, int batch) {
  return first_shape_in_one_wave(
      reinterpret_cast<const void*>(sqrt_sweep_kernel<NX, NU>), kShapes,
      batch, D.n * (kMaxP + 1) + D.m,
      [&](Shape sh) { return layout(D, sh.Wp).bytes(); },
      launch_cache<NX, NU>());
}

// Launches the sweep at (Wc, Wp); one consumer warp, so Wc = 1.
template <int NX, int NU>
int launch_shape(const Args& a, Shape sh, cudaStream_t stream) {
  if (sh.Wc != 1) return (int)cudaErrorInvalidValue;
  const Dims D(a.n, a.m);
  return launch_ring(sqrt_sweep_kernel<NX, NU>, a.batch, 32 * (1 + sh.Wp),
                     layout(D, sh.Wp).bytes(), launch_cache<NX, NU>(),
                     stream, a, sh.Wp);
}

// f(Fixed<12, 4>{}) for slice 1's quadrotor error state, the only shape a
// path of the port runs the sweep at, else f(Fixed<0, 0>{}), the
// instantiation for any n + m ≤ 32
template <class F>
auto dispatch(int n, int m, F f) {
  if (n == 12 && m == 4) return f(Fixed<12, 4>{});
  return f(Fixed<0, 0>{});
}

bool valid(int n, int m) { return n >= 1 && m >= 1 && n + m <= kMaxP; }

}  // namespace

// The launch shape K1 takes for (n, m) at `batch` problems: shape ← Wc,
// Wp, S, the block's shared-memory bytes and G, the knots a producer step.
// Returns 0, or cudaErrorInvalidValue for n + m > 32 or a device that
// cannot be queried.
extern "C" int trajopt_sqrt_sweep_shape(int n, int m, int batch,
                                        int* shape) {
  if (batch <= 0 || !valid(n, m)) return (int)cudaErrorInvalidValue;
  const Dims D(n, m);
  const Shape sh = dispatch(n, m, [&](auto f) {
    using S = decltype(f);
    return shape_for<S::nx, S::nu>(D, batch);
  });
  if (sh.Wc < 1) return (int)cudaErrorInvalidValue;
  const RingLayout L = layout(D, sh.Wp);
  shape[0] = sh.Wc;
  shape[1] = sh.Wp;
  shape[2] = L.S;
  shape[3] = (int)L.bytes();
  shape[4] = D.G;
  return 0;
}

// C entry point (bound with ctypes from ops/cuda_sqrt.py). Batch-first
// contiguous float32 inputs: A (B,N-1,n,n), Bm (B,N-1,n,m), lx (B,N,n),
// lu (B,N-1,m), lxx (B,N,n,n), luu (B,N-1,m,m), lux (B,N-1,m,n), rho (B,);
// outputs K (B,N-1,m,n), d (B,N-1,m), dV (B,2), fail (B,) bytes.
// Returns the CUDA error of the launch (0 on success).
extern "C" int trajopt_sqrt_sweep_f32(
    const float* A, const float* Bm, const float* lx, const float* lu,
    const float* lxx, const float* luu, const float* lux, const float* rho,
    float* K, float* d, float* dV, unsigned char* fail, int batch, int N,
    int n, int m, void* stream) {
  if (batch <= 0 || N < 2 || !valid(n, m)) return (int)cudaErrorInvalidValue;
  const Args a{A, Bm, lx, lu, lxx, luu, lux, rho, K, d, dV, fail, batch, N,
               n, m};
  return dispatch(n, m, [&](auto f) {
    using S = decltype(f);
    const Shape sh = shape_for<S::nx, S::nu>(Dims(n, m), batch);
    if (sh.Wc < 1) return (int)cudaErrorInvalidValue;
    return launch_shape<S::nx, S::nu>(a, sh, (cudaStream_t)stream);
  });
}
