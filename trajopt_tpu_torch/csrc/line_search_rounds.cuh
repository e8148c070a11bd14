// The backtracking line search of one iLQR iteration in parallel rounds of
// candidates: the kernel that the fused AL line search (K4,
// fused_al_forward.cu) and the fused unconstrained line search (K7b,
// fused_forward.cu) instantiate, with and without the AL cost.
//
// Per problem, the whole search (reference forwardpass!,
// forward_pass.jl:5-85): for each candidate step α the closed-loop
// full-state rollout u = U + K(x − X) + αd through the model's step (with
// slacks x⁺ = rk3(x, u_base) + u_slack), with the divergence guard (|x|,
// |u| < 1e8 and finite), the stage cost dt(½xᵀQx + ½uᵀRu + qᵀx + rᵀu + uᵀHx
// + c) and the terminal cost, with AL also Σ λc + ½ c Iμ c of the canonical
// stack (canon.cuh); the ratio z = (J_prev − J)/(−α(ΔV1 + αΔV2)),
// acceptance on lb < z ≤ ub or J < J_prev, α halving, and after
// iterations_linesearch candidates the restore of X, U, J_prev with the ρ
// bump dρ = max(dρ·f, f), ρ = max(ρ·dρ, ρ_min) + bp_reg_fp. The step
// reported is the one used (the halved α times two). A problem outside
// `active` is not searched and gets its inputs back.
//
// The candidates of one search in parallel. The serial search tries
// α_j = α0·2⁻ʲ for j = 0, 1, … and stops at the first candidate that is live
// (passes the divergence guard) and accepted, or restores after
// j = ls_iters. A candidate's rollout and cost depend only on its own α_j
// and on the inputs, never on an earlier candidate. A diverged candidate
// leaves J and z at the previous live candidate's values (or at the start's
// J = ∞, z = −1), which the search had already refused: a diverged
// candidate never ends the search. So the serial search ends at the lowest
// j whose candidate is live and accepted, with that candidate's X̄, Ū and J
// and α_used = α_j, or restores if there is none in 0…ls_iters; and any
// order of evaluating the candidates that takes the lowest such j gives
// the same result, bit for bit. Here a block of W warps takes one problem:
// in round r warp w evaluates candidate j = r·W + w (candidates past
// ls_iters are masked off), and after the round the block takes the lowest
// accepted j, or starts the next round, or restores after the round that
// reached ls_iters (tests/test_torch_line_search_rounds.py holds this
// against the serial search in float64, with and without the AL cost).
// Each candidate's arithmetic is the per-warp code of a serial search, so
// α, J, X̄ and Ū do not depend on W. Each warp writes its candidate's X̄ and
// Ū into its own buffer, and only the winner's is copied to the outputs.
// The buffers are a workspace in device memory that the wrapper allocates
// (B·W·(N·n + (N−1)·m) floats, 12 MB for the maze at B = 128, inside the
// 50 MB L2): in shared memory the maze's 12 KB a warp would cap the blocks
// an SM holds, and so W. With W = 1 the warp writes straight to the
// outputs, as the serial search does.
//
// W comes from the shapes: the largest W ≤ 8 such that the B blocks of W
// warps fit on the card in one wave at the kernel's occupancy
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor × the SM count), at least
// 1. At B = 128 that is W = 8: a search that runs out takes 3 rounds
// instead of 21 candidates. At B = 1024 it is W = 1 or 2: parallel rounds
// there would add waves instead of removing them.
//
// What bounds it on this card: latency. A candidate is a chain of N − 1
// dependent steps, each behind an m×n gain product (and the P-row AL
// cost); one candidate of the slack-augmented quadrotor (17×13, P = 89) at
// B=128, N=101 reads about 21 MB (K, λ, μ), far from the card's bandwidth
// for the time it takes. A launch lasts as long as the longest search in
// the batch, which the rounds shorten W-fold.
//
// A candidate's warp: the P rows, the gain rows and the cost's matrix rows
// split evenly over lanes with coalesced reads of λ and μ. The state lives
// in registers, identically on every lane; lane a < m owns control a and
// broadcasts it by shuffle; each lane keeps its own partial cost over the
// knots and the warp sums once per candidate. The step is the model's warp
// step (models.cuh): a scalar model's runs in registers on every lane (so
// the guard needs no vote), a chain's is computed by the warp together from
// the table that the block stages in shared memory once for its W warps,
// and rounds bit for bit as the one-thread chain step.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "canon.cuh"
#include "models.cuh"
#include "warp_linalg.cuh"

namespace trajopt {

constexpr float kMaxValue = 1e8f;
constexpr int kMaxSearchWarps = 8;   // candidates a round, at most

struct SearchArgs {
  const float *x0, *X, *U, *K, *d, *dV1, *dV2, *Jprev, *rho, *drho, *alpha0;
  const float *lam, *mu;     // the AL cost's duals (AL only)
  const float *dt, *Q, *R, *H, *q, *r, *c;
  const unsigned char* active;
  const ChainTable* chain;   // a chain model's table, else null
  float *Xout, *Uout, *scal;
  float* ws;                 // the candidates' buffers (W > 1), else null
  int batch, N, ls_iters;
  float ls_lb, ls_ub, reg_min, reg_factor, reg_fp, atol;
};

// the block's shared memory in floats: the chain's table, then per warp z,
// the fk rows' kinematics (AL only) and the chain step's scratch
template <class M, bool Slack, bool AL>
struct SearchLayout {
  static constexpr int NU = Slack ? M::NU + M::NX : M::NU;
  static constexpr int kZ = M::NX + NU;
  static constexpr int kFk = AL ? sizeof(FkWork) / sizeof(float) : 0;
  static constexpr int kWarp = kZ + kFk + M::kWarpScratch;
  static constexpr int kTable = M::kChain ? kChainTableFloats : 0;
  static constexpr size_t bytes(int W) {
    return sizeof(float) * (kTable + (size_t)W * kWarp);
  }
};

// z ← [x; u] for the row evaluation
template <int NX, int NU>
__device__ __forceinline__ void put_z(float* z, const float* x, float u_mine,
                                      int lane) {
#pragma unroll
  for (int i = 0; i < NX; ++i)
    if (lane == i) z[i] = x[i];
  if (lane < NU) z[NX + lane] = u_mine;
  __syncwarp();
}

// One candidate α of problem b by one warp: the rollout with its cost, X̄
// and Ū written to Xw and Uw as it goes. Returns whether it stayed live;
// then J holds its cost on every lane.
template <class M, bool Slack, bool AL>
__device__ __forceinline__ bool candidate(const SearchArgs& a,
                                          const CanonTables& tab, int b,
                                          float alpha, float* Xw, float* Uw,
                                          float* z, FkWork& fk,
                                          const ChainTable* chain,
                                          float* scr, int lane, float& J) {
  constexpr int NX = M::NX, MB = M::NU, NU = Slack ? MB + NX : MB;
  const int N = a.N, P = tab.P;
  const size_t uoff = (size_t)b * (N - 1) * NU;
  const float* Xb = a.X + (size_t)b * N * NX;
  const float* Ub = a.U + uoff;

  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = a.x0[(size_t)b * NX + i];
  if (lane < NX) Xw[lane] = a.x0[(size_t)b * NX + lane];
  float Jacc = 0.0f;
  for (int k = 0; k < N - 1; ++k) {
    const float dtv = a.dt[k];
    // u = U + K (x − X) + α d: lane i < m computes control i
    float u_mine = 0.0f;
    if (lane < NU) {
      const float* Kr = a.K + (uoff + (size_t)k * NU + lane) * NX;
      float acc = Kr[0] * (x[0] - Xb[k * NX]);
#pragma unroll
      for (int c = 1; c < NX; ++c)
        acc = acc + Kr[c] * (x[c] - Xb[k * NX + c]);
      u_mine = Ub[k * NU + lane] + acc + alpha * a.d[uoff + k * NU + lane];
    }
    float u[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = __shfl_sync(kFullMask, u_mine, i);
    put_z<NX, NU>(z, x, u_mine, lane);

    // stage cost dt(½xᵀQx + ½uᵀRu + qᵀx + rᵀu + uᵀHx + c), split by rows
    float part = 0.0f;
    if (lane < NX) {
      const float* Qr = a.Q + ((size_t)k * NX + lane) * NX;
      float Qx = Qr[0] * x[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) Qx = Qx + Qr[j] * x[j];
      part = 0.5f * z[lane] * Qx + z[lane] * a.q[(size_t)k * NX + lane];
    }
    if (lane < NU) {
      const float* Rr = a.R + ((size_t)k * NU + lane) * NU;
      const float* Hr = a.H + ((size_t)k * NU + lane) * NX;
      float Ru = Rr[0] * u[0];
#pragma unroll
      for (int j = 1; j < NU; ++j) Ru = Ru + Rr[j] * u[j];
      float Hx = Hr[0] * x[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) Hx = Hx + Hr[j] * x[j];
      part = part + 0.5f * u_mine * Ru
           + u_mine * a.r[(size_t)k * NU + lane] + u_mine * Hx;
    }
    if (lane == 0) part = part + a.c[k];
    Jacc = Jacc + part * dtv;
    if constexpr (AL) {
      fk_knot_warp(tab, z, fk, lane);
      Jacc = Jacc + canon_al_cost_lane(tab, z, fk,
                                       a.lam + ((size_t)b * N + k) * P,
                                       a.mu + ((size_t)b * N + k) * P, a.atol,
                                       lane);
    }

    // the step (the base controls lead u) and the divergence guard
    float xn[NX];
    M::step_warp(x, u, dtv, xn, chain, scr, lane);
    bool good = true;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if constexpr (Slack) xn[i] = xn[i] + u[MB + i];
      good = good && fabsf(xn[i]) < kMaxValue && isfinite(xn[i]);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) good = good && fabsf(u[i]) < kMaxValue;
    if (lane < NU) Uw[k * NU + lane] = u_mine;
    __syncwarp();            // z is read; the next knot may overwrite it
    if (!good) return false;   // abandoned where it dies
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
    if (lane < NX) Xw[(k + 1) * NX + lane] = lane_value(xn, lane);
  }

  // terminal cost ½xᵀQx + qᵀx + c (and the AL rows at u = 0)
  put_z<NX, NU>(z, x, 0.0f, lane);
  float part = 0.0f;
  if (lane < NX) {
    const float* Qr = a.Q + ((size_t)(N - 1) * NX + lane) * NX;
    float Qx = Qr[0] * x[0];
#pragma unroll
    for (int j = 1; j < NX; ++j) Qx = Qx + Qr[j] * x[j];
    part = 0.5f * z[lane] * Qx + z[lane] * a.q[(size_t)(N - 1) * NX + lane];
  }
  if (lane == 0) part = part + a.c[N - 1];
  Jacc = Jacc + part;
  if constexpr (AL) {
    fk_knot_warp(tab, z, fk, lane);
    Jacc = Jacc + canon_al_cost_lane(
        tab, z, fk, a.lam + ((size_t)b * N + N - 1) * P,
        a.mu + ((size_t)b * N + N - 1) * P, a.atol, lane);
  }
  __syncwarp();
  J = warp_sum(Jacc);
  return true;
}

// M: the base model's trait; Slack: NX slack controls after its MB controls;
// AL: the AL cost of the stack `tab` on top of the objective's
template <class M, bool Slack, bool AL>
__global__ void __launch_bounds__(32 * kMaxSearchWarps) line_search_kernel(
    SearchArgs a, CanonTables tab) {
  using L = SearchLayout<M, Slack, AL>;
  constexpr int NX = M::NX, NU = L::NU;
  static_assert(NU <= 32, "one lane per control");
  extern __shared__ float smem[];
  __shared__ unsigned char accepted[2][kMaxSearchWarps];
  __shared__ float Jcand[2][kMaxSearchWarps];
  const int W = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const ChainTable* chain = stage_chain_table<M>(a.chain, smem);
  float* z = smem + L::kTable + w * L::kWarp;
  FkWork& fk = *reinterpret_cast<FkWork*>(z + L::kZ);
  float* scr = z + L::kZ + L::kFk;

  const int b = blockIdx.x;
  const int N = a.N, len = N * NX + (N - 1) * NU;
  const size_t xoff = (size_t)b * N * NX, uoff = (size_t)b * (N - 1) * NU;
  const float* Xb = a.X + xoff;
  const float* Ub = a.U + uoff;
  float* Xo = a.Xout + xoff;
  float* Uo = a.Uout + uoff;
  const float Jprev = a.Jprev[b], dV1 = a.dV1[b], dV2 = a.dV2[b];
  const float alpha0 = a.alpha0[b];
  float rho = a.rho[b], drho = a.drho[b];

  // the inputs handed back: a problem not searched, or a search that ran out
  auto restore = [&]() {
    for (int e = threadIdx.x; e < N * NX; e += blockDim.x) Xo[e] = Xb[e];
    for (int e = threadIdx.x; e < (N - 1) * NU; e += blockDim.x) Uo[e] = Ub[e];
  };
  float J, alpha_used;
  if (a.active && !a.active[b]) {   // not searched
    restore();
    J = Jprev;
    alpha_used = 0.0f;
  } else if (!(((-1.0f <= a.ls_lb) || (-1.0f > a.ls_ub))
               && (INFINITY >= Jprev))) {
    // the serial search's loop test fails before its first candidate
    // (J = ∞, z = −1): nothing is tried
    restore();
    J = INFINITY;
    alpha_used = alpha0 * 2.0f;
  } else {
    float* Xw = W == 1 ? Xo : a.ws + ((size_t)b * W + w) * len;
    float* Uw = W == 1 ? Uo : Xw + N * NX;
    int win = -1;
    for (int r = 0;; ++r) {
      const int j = r * W + w;
      bool acc = false;
      float Jc = INFINITY;
      if (j <= a.ls_iters) {
        float alpha = alpha0;
        for (int t = 0; t < j; ++t) alpha = alpha * 0.5f;
        if (candidate<M, Slack, AL>(a, tab, b, alpha, Xw, Uw, z, fk, chain,
                                    scr, lane, Jc)) {
          const float expected = -alpha * (dV1 + alpha * dV2);
          const float zr = expected > 0.0f ? (Jprev - Jc) / expected : -1.0f;
          acc = !(((zr <= a.ls_lb) || (zr > a.ls_ub)) && (Jc >= Jprev));
        }
      }
      if (lane == 0) {
        accepted[r & 1][w] = acc;
        Jcand[r & 1][w] = Jc;
      }
      __syncthreads();
      for (int v = 0; v < W; ++v) {
        if (accepted[r & 1][v]) {
          win = r * W + v;
          J = Jcand[r & 1][v];
          break;
        }
      }
      if (win >= 0 || (r + 1) * W > a.ls_iters) break;
    }
    if (win < 0) {
      // the search ran out (forward_pass.jl:22-37): restore and bump ρ
      drho = fmaxf(drho * a.reg_factor, a.reg_factor);
      rho = fmaxf(rho * drho, a.reg_min) + a.reg_fp;
      J = Jprev;
      alpha_used = 0.0f;
      restore();
    } else {
      float alpha = alpha0;
      for (int t = 0; t < win; ++t) alpha = alpha * 0.5f;
      alpha_used = alpha * 0.5f * 2.0f;   // the serial search's halving
      if (W > 1) {   // the winner's buffer to the outputs
        const float* src = a.ws + ((size_t)b * W + win % W) * len;
        for (int e = threadIdx.x; e < N * NX; e += blockDim.x) Xo[e] = src[e];
        for (int e = threadIdx.x; e < (N - 1) * NU; e += blockDim.x)
          Uo[e] = src[N * NX + e];
      }
    }
  }
  if (threadIdx.x == 0) {
    a.scal[b] = J;
    a.scal[a.batch + b] = rho;
    a.scal[2 * a.batch + b] = drho;
    a.scal[3 * a.batch + b] = alpha_used;   // the step that was used
  }
}

// The largest W ≤ kMaxSearchWarps whose `batch` blocks fit on the card in
// one wave, at least 1; −1 when the device cannot be queried. The blocks an
// SM holds are cached per device and W.
template <class M, bool Slack, bool AL>
int search_warps(int batch) {
  static int per_sm[16][kMaxSearchWarps + 1];   // blocks an SM holds, + 1
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  for (int W = kMaxSearchWarps; W > 1; --W) {
    if (per_sm[dev][W] == 0) {
      int n = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, line_search_kernel<M, Slack, AL>, 32 * W,
              SearchLayout<M, Slack, AL>::bytes(W)) != cudaSuccess)
        return -1;
      per_sm[dev][W] = n + 1;
    }
    if ((long long)(per_sm[dev][W] - 1) * sms >= batch) return W;
  }
  return 1;
}

// Launches the search at the W of search_warps; cudaErrorInvalidValue when
// W > 1 and the workspace `a.ws` holds fewer than B·W·(N·n + (N−1)·m)
// floats (`ws_floats`).
template <class M, bool Slack, bool AL>
int launch_search(const SearchArgs& a, const CanonTables& tab,
                  long long ws_floats, cudaStream_t stream) {
  using L = SearchLayout<M, Slack, AL>;
  static_assert(L::bytes(kMaxSearchWarps) <= 48 * 1024,
                "static shared memory limit");
  const int W = search_warps<M, Slack, AL>(a.batch);
  if (W < 1) return (int)cudaErrorInvalidValue;
  const long long len = (long long)a.N * M::NX + (long long)(a.N - 1) * L::NU;
  if (W > 1 && (a.ws == nullptr || ws_floats < (long long)a.batch * W * len))
    return (int)cudaErrorInvalidValue;
  line_search_kernel<M, Slack, AL>
      <<<a.batch, 32 * W, L::bytes(W), stream>>>(a, tab);
  return (int)cudaGetLastError();
}

}  // namespace trajopt
