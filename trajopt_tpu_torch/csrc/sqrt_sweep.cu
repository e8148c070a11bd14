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
// path runs B = 128 problems of N-1 = 100 knots at p = 16; each knot is a
// chain of dependent small eliminations (~p² sequential steps), so the
// sweep is latency-bound: its time is the length of the per-knot
// dependency chain times the shared-memory/shuffle latency.
//
// Design: one warp per problem (block = 32 threads). Lane c owns column c
// of every p-wide row (p = m + n <= 32), so each elimination step is one
// warp-wide vector operation and pivots are broadcast with __shfl_sync.
// R1, the transposed dense rows, Ssqrt and [B A] live in shared memory
// (~20 KB per block), and the knot loop runs inside the block, as the
// TPU's fori_loop did. B blocks spread over the SMs; at B = 128 that is
// one warp per SM, so there is no latency hiding yet — batching several
// problems per block is later work. No fast-math: sqrtf and division are
// IEEE, as in the TPU kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1e-30f;
constexpr float kNegTol = 1e-3f;   // SQRT_PIVOT_NEG_TOL
constexpr float kFloor = 1e-7f;    // SQRT_PIVOT_FLOOR_F32

struct Smem {
  float M[kMaxP][kMaxP];    // symmetric matrix being factored
  float R[kMaxP][kMaxP];    // R1: upper factor, then the triangularized R
  float D[kMaxP][kMaxP];    // dense rows transposed: D[j][r], j < p, r < n
  float S[kMaxP][kMaxP];    // Ssqrt (n x n, upper)
  float BA[kMaxP][kMaxP];   // [B A] of the current knot (n x p)
  float Sx[kMaxP];          // value gradient
};

// Plain upper Cholesky of M (dim x dim) into U, deferred-update row order,
// pivot accepted at s_ii + 1e-14 (ops/pallas_sqrt.py chol_upper, plain
// path). Returns the (warp-uniform) failure flag.
__device__ bool chol_plain(Smem& sm, float (*U)[kMaxP], int dim, int lane) {
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

// Jacobi-equilibrated upper Cholesky: factor D·M·D (unit diagonal) with
// pivots in (-neg_tol, floor) clamped to the floor, then unscale the
// columns, (U D⁻¹)ᵀ(U D⁻¹) = M. Returns the failure flag (a pivot below
// -neg_tol or non-finite).
__device__ bool chol_equilibrated(Smem& sm, float (*U)[kMaxP], int dim,
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

// Plain factor first; the equilibrated one only where it breaks down.
// Returns plain_fail && equilibrated_fail.
__device__ bool chol_robust(Smem& sm, float (*U)[kMaxP], int dim, int lane) {
  if (!chol_plain(sm, U, dim, lane)) return false;
  return chol_equilibrated(sm, U, dim, lane);
}

__global__ void __launch_bounds__(32)
sqrt_sweep_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ lx, const float* __restrict__ lu,
                  const float* __restrict__ lxx,
                  const float* __restrict__ luu,
                  const float* __restrict__ lux,
                  const float* __restrict__ rho, float* __restrict__ K,
                  float* __restrict__ d, float* __restrict__ dV,
                  unsigned char* __restrict__ fail_out, int N, int n, int m) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int p = m + n;
  const int Nm1 = N - 1;
  const float rho_b = rho[b];

  // ---- terminal: Ssqrt_N = chol(lxx_N)ᵀ (upper), value gradient lx_N ----
  const float* lxxN = lxx + ((size_t)b * N + Nm1) * n * n;
  if (lane < n)
    for (int r = 0; r < n; ++r) sm.M[r][lane] = lxxN[r * n + lane];
  __syncwarp();
  bool fail = chol_robust(sm, sm.S, n, lane);
  if (lane < n) sm.Sx[lane] = lx[((size_t)b * N + Nm1) * n + lane];
  __syncwarp();
  float dV1 = 0.f, dV2 = 0.f;

  for (int k = Nm1 - 1; k >= 0; --k) {
    const size_t bk = (size_t)b * Nm1 + k;
    const float* Ak = A + bk * n * n;
    const float* Bk = Bm + bk * n * m;
    const float* luuk = luu + bk * m * m;
    const float* luxk = lux + bk * m * n;
    const float* lxxk = lxx + ((size_t)b * N + k) * n * n;

    // ---- 1) stage factor R1 = chol([[luu + rho I, lux],[luxᵀ, lxx]])ᵀ ----
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
    __syncwarp();
    bool fail_k = chol_robust(sm, sm.R, p, lane);

    // ---- 2) dense rows D[j] = Ssqrt · (column j of [B A]) ----
    if (lane < p) {
      for (int r = 0; r < n; ++r) {
        float acc = sm.S[r][0] * sm.BA[0][lane];
        for (int c = 1; c < n; ++c) acc = acc + sm.S[r][c] * sm.BA[c][lane];
        sm.D[lane][r] = acc;
      }
    }
    __syncwarp();

    // ---- 3) Householder triangularization of [R1 ; D] ----
    for (int j = 0; j < p; ++j) {
      const float a0 = sm.R[j][j];
      float sigma = sm.D[j][0] * sm.D[j][0];
      for (int r = 1; r < n; ++r) sigma = sigma + sm.D[j][r] * sm.D[j][r];
      const float nrm = sqrtf(a0 * a0 + sigma);
      const float alpha = a0 >= 0.f ? -nrm : nrm;
      const float v0 = a0 - alpha;
      const float denom = nrm * (nrm + fabsf(a0));   // = vᵀv / 2
      const float beta = denom > kTiny ? 1.f / fmaxf(denom, kTiny) : 0.f;
      float t = 0.f;
      if (lane > j && lane < p) {
        float acc = sm.D[lane][0] * sm.D[j][0];
        for (int r = 1; r < n; ++r) acc = acc + sm.D[lane][r] * sm.D[j][r];
        t = beta * (v0 * sm.R[j][lane] + acc);
      }
      __syncwarp();
      if (lane > j && lane < p) {
        sm.R[j][lane] = sm.R[j][lane] - t * v0;
        for (int r = 0; r < n; ++r) sm.D[lane][r] = sm.D[lane][r] - t * sm.D[j][r];
      }
      if (lane == j) sm.R[j][j] = alpha;
      __syncwarp();
    }

    // ---- fail rules: diag ratio of Ruu, non-finite Ruu rows ----
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

    // ---- 4) Qu = lu + Bᵀ Sx; d = -Ruu⁻¹ Ruu⁻ᵀ Qu (every lane, uniform) ----
    float Qu[kMaxP], y[kMaxP], dk[kMaxP], Rd[kMaxP], Quu_d[kMaxP];
    const float* luk = lu + bk * m;
    for (int i = 0; i < m; ++i) {
      float acc = sm.BA[0][i] * sm.Sx[0];
      for (int r = 1; r < n; ++r) acc = acc + sm.BA[r][i] * sm.Sx[r];
      Qu[i] = luk[i] + acc;
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

    // ---- value update terms (uniform): Ruu d, Ruuᵀ(Ruu d) ----
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

    // ---- 5) per column c < n: K = -Ruu⁻¹Rux, Qx, Qux, Sx_new ----
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

      float acc = sm.BA[0][m + c] * sm.Sx[0];
      for (int r = 1; r < n; ++r) acc = acc + sm.BA[r][m + c] * sm.Sx[r];
      const float Qx = lx[((size_t)b * N + k) * n + c] + acc;
      float s1 = Kc[0] * Quu_d[0];
      for (int i = 1; i < m; ++i) s1 = s1 + Kc[i] * Quu_d[i];
      float s2 = Kc[0] * Qu[0];
      for (int i = 1; i < m; ++i) s2 = s2 + Kc[i] * Qu[i];
      float s3 = 0.f;
      for (int i = 0; i < m; ++i) {
        // Qux[i][c] = Σ_{j<=i} Ruu[j][i]·Rux[j][c]
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
    __syncwarp();
    // ---- carry: Sx, and Ssqrt = Rxx ----
    if (lane < n) {
      sm.Sx[lane] = sx_new;
      for (int r = 0; r < n; ++r) sm.S[r][lane] = sm.R[m + r][m + lane];
    }
    __syncwarp();
  }
  if (lane == 0) {
    dV[2 * b] = dV1;
    dV[2 * b + 1] = dV2;
    fail_out[b] = fail ? 1 : 0;
  }
}

}  // namespace

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
  if (batch <= 0 || N < 2 || n < 1 || m < 1 || n + m > kMaxP)
    return (int)cudaErrorInvalidValue;
  sqrt_sweep_kernel<<<batch, 32, 0, (cudaStream_t)stream>>>(
      A, Bm, lx, lu, lxx, luu, lux, rho, K, d, dV, fail, N, n, m);
  return (int)cudaGetLastError();
}
