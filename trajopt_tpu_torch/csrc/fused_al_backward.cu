// Fused AL backward sweep (kernel K3), for every model of models.cuh with
// or without the slack controls of the infeasible-start transform, and with
// the forward-kinematics rows of a rigid-body chain (K8) in the stack.
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_al_fused.py::
// _fused_al_backward_kernel (front end fused_al_backward_pallas). Per
// problem, backward over the knots: the discrete-step Jacobians A and B (with
// slacks B = [B_base | I]: the slack controls enter linearly), the quadratic
// stage expansion, the Gauss-Newton AL expansion of the canonical constraint
// stack with its active set (canon.cuh), and the Riccati step with the
// equilibrated PD solve of Quu_reg against [Qux_reg | Qu] (riccati_step.cuh,
// posdef_solve.cuh). A, B and the expansion never reach device memory. A
// failed stage writes zero gains, sets the problem's fail flag, and the
// sweep goes on. The plain version is
// trajopt_tpu_torch/ops/cuda_al_fused.py::fused_al_backward.
//
// The TPU kernel linearizes its step with jax.linearize; here the Jacobians
// come from forward-mode dual numbers through the model's templated RK3 step
// (models.cuh), one tangent direction per lane: n state and m_base control
// directions fill n + m_base lanes of a warp (17 for the quadrotor, 3 for
// the pendulum), and the n slack columns are the identity and are never
// differentiated (_step_jac_cols of the TPU kernel takes the same shortcut).
//
// What bounds it on this card: latency, not bytes or operations. One launch
// for the slack-augmented quadrotor at B=128, N=101, P=89 moves about 23 MB
// (λ, μ and the gains K dominate) and does about 0.8 GFLOP, microseconds of
// either at the card's rates; but each problem is a chain of N − 1 dependent
// knots, each a chain of small dependent products and an m-pivot
// elimination.
//
// Design: a knot pipeline (knot_pipeline.cuh, shared with K7a and K5).
// Only the Riccati step depends on the carry (Sx, Sxx); a knot's
// Jacobians, stage and AL expansion read only X, U, λ, μ and the
// objective. So one block takes one problem with Wc consumer warps and Wp
// producer warps. Producer p expands the knots k = N−2−p,
// N−2−p−Wp, … ahead of the sweep into a ring of S slots in shared memory
// (KnotInputs: A, B, lx … lux, 4.4 KB a slot for the maze), each slot with
// a full and an empty mbarrier; producers never wait on the carry. The Wc
// consumer warps run the Riccati step on each slot in knot order together
// (riccati_step.cuh: the entries of each phase over 32·Wc threads, the
// consumers' own named barrier), and own the carry, the fail flag and the
// ΔV sums. Every entry keeps its summation order, so K, d, ΔV and the fail
// flag do not depend on (Wc, Wp, S). With Wp = 0 a block is one warp that
// expands and consumes each knot in turn, through the same code: that is
// the shape when the batch fills the card anyway.
//
// The shape comes from the batch and the occupancy: the first entry of the
// preference list (kShapes below, from tools/k3_launch_shape.py) whose B
// blocks fit on the card in one wave
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor × the SM count), else one
// warp. A thread takes up to 255 registers (a chain's Dual step; 128 for
// the scalar models), so a block has at most 8 warps: at B = 128 every
// instantiation takes (4, 4); at B = 1024 a scalar model's (1, 1), a
// chain's one warp a problem. The model and the slack flag are
// template parameters, so n, m_base and m are compile-time constants, one
// instantiation per (model, slack) pair; P, the stack's tables, N and the
// batch are arguments.
#include <cuda_runtime.h>
#include <stdint.h>

#include "canon.cuh"
#include "knot_pipeline.cuh"
#include "models.cuh"

namespace {

using namespace trajopt;

// (Wc, Wp) in order of preference, the largest block first. Measured by
// tools/k3_launch_shape.py (H100, ms a launch at B = 128; the lone warp,
// then the best shape with Wc = 1, 2 and 4):
//   maze quadrotor_slack  2.89 | (1,3) 1.86 | (2,1) 1.29 | (4,4) 1.07
//   car_slack             0.87 | (1,2) 0.36 | (2,2) 0.34 | (4,4) 0.34
//   cartpole rig          3.14 | (1,4) 0.87 | (2,4) 0.90 | (4,4) 0.86
//   kuka (checks only)    8.92 | (1,7) 4.76 | (2,6) 4.90 | (4,4) 5.04
// so (4, 4) first; at B = 1024 (1, 1) beats the lone warp by 1.2-1.3x on
// the maze, car_slack and the cartpole.
constexpr ShapeList kShapes{3, {{4, 4}, {2, 2}, {1, 1}}};

struct Args {
  const float *X, *U, *lam, *mu, *dt, *Q, *R, *H, *q, *r, *rho;
  const ChainTable* chain;   // a chain model's table, else null
  float *K, *d, *dV;
  unsigned char* fail;
  float *Aout, *Bout;        // the Jacobians, where asked for
  int batch, N, reg_state;
  float atol;
};

// ------------------------------------------------------- shared memory

// a warp's scratch for one knot's expansion; g and Iμ of the P rows follow
template <int NX, int NU>
struct Expansion {
  FkWork fk;
  float z[NX + NU];
  float alx[NX], alu[NU], alxx[NX * NX], aluu_d[NU];
};

// The block's dynamic shared memory at (Wc, Wp) and P rows: the ring of
// S = 2Wp slots (one without producers), the consumers' Riccati state, and
// Wp + 1 expansion scratches (the consumers' one for the terminal knot, or
// the lone warp's).
template <int NX, int NU>
__host__ __device__ RingLayout layout(int Wp, int P) {
  return riccati_layout<NX, NU>(
      ring_slots(Wp, 1), Wp + 1,
      sizeof(Expansion<NX, NU>) + 2 * sizeof(float) * P);
}

// ------------------------------------------------------------ the knots

// One knot's inputs by one warp into `in`: the Dual Jacobians, the stage
// expansion and the AL expansion of the stack (lux gets no AL term); the
// Jacobians also to Aout / Bout where asked for.
template <class M, bool Slack>
__device__ __forceinline__ void expand_knot(
    const Args& a, const CanonTables& tab, int b, int k,
    KnotInputs<M::NX, Slack ? M::NU + M::NX : M::NU>& in,
    Expansion<M::NX, Slack ? M::NU + M::NX : M::NU>& s, float* g_s,
    float* imu_s, int lane) {
  constexpr int NX = M::NX, MB = M::NU, NU = Slack ? MB + NX : MB;
  const int N = a.N, P = tab.P;
  const size_t bk = (size_t)b * (N - 1) + k;
  const float* xk = a.X + ((size_t)b * N + k) * NX;
  const float* uk = a.U + bk * NU;
  const float dtv = a.dt[k];
  for (int e = lane; e < NX + NU; e += 32)
    s.z[e] = e < NX ? xk[e] : uk[e - NX];
  __syncwarp();

  // Jacobians: lane j < n + m_base pushes tangent e_j of [x; u_base]
  // through the RK3 step; row i of its result is A[i][j] or
  // B_base[i][j − n]
  if (lane < NX + MB) {
    Dual xd[NX], ud[MB], out[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xd[i] = Dual(s.z[i], lane == i ? 1.f : 0.f);
#pragma unroll
    for (int i = 0; i < MB; ++i)
      ud[i] = Dual(s.z[NX + i], lane == NX + i ? 1.f : 0.f);
    M::template step<Dual>(xd, ud, dtv, out, a.chain);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (lane < NX) {
        in.A[i * NX + lane] = out[i].d;
        if (a.Aout) a.Aout[(bk * NX + i) * NX + lane] = out[i].d;
      } else {
        in.B[i * NU + lane - NX] = out[i].d;
        if (a.Bout) a.Bout[(bk * NX + i) * MB + lane - NX] = out[i].d;
      }
    }
  }

  // quadratic stage expansion: lx = dt(Qx + q + Hᵀu), lu = dt(Ru + r + Hx),
  // lxx = dtQ, luu = dtR, lux = dtH
  const float* Qk = a.Q + (size_t)k * NX * NX;
  const float* Rk = a.R + (size_t)k * NU * NU;
  const float* Hk = a.H + (size_t)k * NU * NX;
  const float* x = s.z;
  const float* u = s.z + NX;
  if (lane < NX) {
    float v = Qk[lane * NX] * x[0];
    for (int j = 1; j < NX; ++j) v = v + Qk[lane * NX + j] * x[j];
    float h = Hk[lane] * u[0];
    for (int j = 1; j < NU; ++j) h = h + Hk[j * NX + lane] * u[j];
    in.lx[lane] = (v + a.q[(size_t)k * NX + lane] + h) * dtv;
  }
  if (lane < NU) {
    float v = Rk[lane * NU] * u[0];
    for (int j = 1; j < NU; ++j) v = v + Rk[lane * NU + j] * u[j];
    float h = Hk[lane * NX] * x[0];
    for (int j = 1; j < NX; ++j) h = h + Hk[lane * NX + j] * x[j];
    in.lu[lane] = (v + a.r[(size_t)k * NU + lane] + h) * dtv;
  }
  for (int e = lane; e < NX * NX; e += 32) in.lxx[e] = Qk[e] * dtv;
  for (int e = lane; e < NU * NU; e += 32) in.luu[e] = Rk[e] * dtv;
  for (int e = lane; e < NU * NX; e += 32) in.lux[e] = Hk[e] * dtv;
  __syncwarp();

  fk_knot_warp(tab, s.z, s.fk, lane);
  canon_al_expansion_warp<NX, NU>(tab, s.z, s.fk,
                                  a.lam + ((size_t)b * N + k) * P,
                                  a.mu + ((size_t)b * N + k) * P, a.atol, g_s,
                                  imu_s, s.alx, s.alu, s.alxx, s.aluu_d, lane);
  if (lane < NX) in.lx[lane] = in.lx[lane] + s.alx[lane];
  if (lane < NU) {
    in.lu[lane] = in.lu[lane] + s.alu[lane];
    in.luu[lane * NU + lane] = in.luu[lane * NU + lane] + s.aluu_d[lane];
  }
  for (int e = lane; e < NX * NX; e += 32) in.lxx[e] = in.lxx[e] + s.alxx[e];
  __syncwarp();
}

// M: the base model's trait; Slack: NX slack controls after its MB controls.
// A block of 32·Wc threads (Wp = 0) or 32·(Wc + Wp) threads.
template <class M, bool Slack>
__global__ void __launch_bounds__(32 * kMaxWarps) fused_al_backward_kernel(
    Args a, CanonTables tab, int Wc, int Wp) {
  constexpr int NX = M::NX, MB = M::NU, NU = Slack ? MB + NX : MB;
  using Ex = Expansion<NX, NU>;
  extern __shared__ __align__(16) unsigned char smem[];
  const RiccatiRing<NX, NU> r{smem, layout<NX, NU>(Wp, tab.P)};
  const int S = r.L.S, N = a.N, P = tab.P, b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto scratch = [&](int i) -> Ex& {
    return *reinterpret_cast<Ex*>(r.scratch(i));
  };

  // the barriers, and the slack columns of every slot's B: the identity,
  // once and for all
  r.init(Wc, Wp);
  if constexpr (Slack) {
    for (int s = 0; s < S; ++s)
      for (int e = threadIdx.x; e < NX * NX; e += blockDim.x)
        r.slot(s).B[(e / NX) * NU + MB + e % NX] =
            (e / NX == e % NX) ? 1.0f : 0.0f;
  }
  __syncthreads();

  const bool cons = warp < Wc;
  if (cons) {
    // terminal knot: Sx = Q_N x_N + q_N + alx, Sxx = Q_N + alxx (u = 0)
    RiccatiState<NX, NU>& w = r.state();
    if (warp == 0) {
      Ex& s = scratch(0);
      float* g_s = reinterpret_cast<float*>(&s + 1);
      const float* xN = a.X + ((size_t)b * N + (N - 1)) * NX;
      for (int e = lane; e < NX + NU; e += 32) s.z[e] = e < NX ? xN[e] : 0.0f;
      __syncwarp();
      fk_knot_warp(tab, s.z, s.fk, lane);
      canon_al_expansion_warp<NX, NU>(
          tab, s.z, s.fk, a.lam + ((size_t)b * N + (N - 1)) * P,
          a.mu + ((size_t)b * N + (N - 1)) * P, a.atol, g_s, g_s + P, s.alx,
          s.alu, s.alxx, s.aluu_d, lane);
      const float* QN = a.Q + (size_t)(N - 1) * NX * NX;
      if (lane < NX) {
        float v = QN[lane * NX] * s.z[0];
        for (int j = 1; j < NX; ++j) v = v + QN[lane * NX + j] * s.z[j];
        w.Sx[lane] = v + a.q[(size_t)(N - 1) * NX + lane] + s.alx[lane];
      }
      for (int e = lane; e < NX * NX; e += 32) w.Sxx[e] = QN[e] + s.alxx[e];
    }
    NamedSync{1, 32 * Wc}();
  }

  // one knot a producer step, into its slot with the producer's scratch
  Ex& mine = scratch(Wp == 0 || cons ? 0 : 1 + warp - Wc);
  float* g_s = reinterpret_cast<float*>(&mine + 1);
  float dV1 = 0.0f, dV2 = 0.0f;
  const size_t b0 = (size_t)b * (N - 1);
  const bool fail = riccati_pipeline<NX, NU>(
      r, Wc, Wp, 1, N, a.rho[b], a.reg_state != 0, a.K + b0 * NU * NX,
      a.d + b0 * NU, dV1, dV2, [&](int i, int) {
        expand_knot<M, Slack>(a, tab, b, N - 2 - i, r.slot(i % S), mine,
                              g_s, g_s + P, lane);
      });
  if (threadIdx.x == 0) {
    a.dV[b] = dV1;
    a.dV[a.batch + b] = dV2;
    a.fail[b] = fail ? 1 : 0;
  }
}

// ------------------------------------------------------------ the launch

template <class M, bool Slack>
LaunchCache& launch_cache() {
  static LaunchCache cache;
  return cache;
}

template <class M, bool Slack>
constexpr int nu_of() {
  return Slack ? M::NU + M::NX : M::NU;
}

// Launches the sweep at (Wc, Wp); returns the CUDA error and the block's
// shared-memory bytes in `bytes`.
template <class M, bool Slack>
int launch_shape(const Args& a, const CanonTables& tab, Shape sh,
                 size_t* bytes, cudaStream_t stream) {
  const size_t need = layout<M::NX, nu_of<M, Slack>()>(sh.Wp, tab.P).bytes();
  if (bytes) *bytes = need;
  return launch_ring(fused_al_backward_kernel<M, Slack>, a.batch,
                     32 * (sh.Wc + sh.Wp), need, launch_cache<M, Slack>(),
                     stream, a, tab, sh.Wc, sh.Wp);
}

// The first shape of kShapes whose `batch` blocks fit on the card in one
// wave, else one warp a problem; Wc = 0 when the device cannot be queried.
// The blocks an SM holds are cached per device, shape and P.
template <class M, bool Slack>
Shape shape_for(int batch, int P) {
  return first_shape_in_one_wave(
      reinterpret_cast<const void*>(fused_al_backward_kernel<M, Slack>),
      kShapes, batch, P,
      [&](Shape sh) {
        return layout<M::NX, nu_of<M, Slack>()>(sh.Wp, P).bytes();
      },
      launch_cache<M, Slack>());
}

template <class M, bool Slack>
int launch(const Args& a, const CanonTables& tab, int* shape,
           cudaStream_t stream) {
  const Shape sh = shape_for<M, Slack>(a.batch, tab.P);
  if (sh.Wc < 1) return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  const int err = launch_shape<M, Slack>(a, tab, sh, &bytes, stream);
  if (shape) {
    shape[0] = sh.Wc;
    shape[1] = sh.Wp;
    shape[2] = layout<M::NX, nu_of<M, Slack>()>(sh.Wp, tab.P).S;
    shape[3] = (int)bytes;
  }
  return err;
}

// f(Inst<M, Slack>{}) for the instantiation of model id `model`, or
// `none` for a model that has none
template <class M_, bool Slack_>
struct Inst {
  using M = M_;
  static constexpr bool kSlack = Slack_;
};

template <class F>
int dispatch(int model, F f, int none) {
#define TRAJOPT_AL_BACKWARD(M)                 \
  case kModel##M:                              \
    return f(Inst<M, false>{});                \
  case kModelSlack + kModel##M:                \
    return f(Inst<M, true>{})
  switch (model) {
    TRAJOPT_AL_BACKWARD(Quadrotor);
    TRAJOPT_AL_BACKWARD(Cartpole);
    TRAJOPT_AL_BACKWARD(Car);
    TRAJOPT_AL_BACKWARD(Pendulum);
    TRAJOPT_AL_BACKWARD(DoubleIntegrator);
    TRAJOPT_AL_BACKWARD(Kuka);
    TRAJOPT_AL_BACKWARD(AcrobotUrdf);
    TRAJOPT_AL_BACKWARD(DoublependulumUrdf);
    TRAJOPT_AL_BACKWARD(CartpoleUrdf);
  }
#undef TRAJOPT_AL_BACKWARD
  return none;
}

}  // namespace

// C entry point (bound with ctypes from ops/cuda_al_fused.py). Contiguous
// float32, batch-first, for the model `model` (models.cuh ModelId, plus
// kModelSlack for its slack-augmented form) with n states, m_base base
// controls and m = m_base or m_base + n controls: X (B,N,n), U (B,N-1,m),
// lam, mu (B,N,P), dt (N-1), Q (N,n,n), R (N,m,m), H (N,m,n), q (N,n),
// r (N,m), rho (B); the stack's tables row_i (P,4) int32, row_f (P,4),
// groups (G,6) int32, col_ptr (n+m+1) int32, col_rows int32, fk_joint
// (J,36) and fk_point (npts,4) (J = 0: no fk rows), chain (a chain model's
// table, models.cuh ChainTable, on the device; else null) →
// K (B,N-1,m,n), d (B,N-1,m), dV (2,B), fail (B) bytes, and where Aout/Bout
// are not null the in-kernel Jacobians A (B,N-1,n,n), B_base (B,N-1,n,m_base).
// shape: 4 ints of host memory or null, → Wc, Wp, S and the block's
// shared-memory bytes of the launch. Returns the CUDA error of the launch
// (0 on success), or cudaErrorInvalidValue for a model that has no
// instantiation.
extern "C" int trajopt_fused_al_backward_f32(
    const float* X, const float* U, const float* lam, const float* mu,
    const float* dt, const float* Q, const float* R, const float* H,
    const float* q, const float* r, const float* rho, const int* row_i,
    const float* row_f, const int* groups, const int* col_ptr,
    const int* col_rows, const float* fk_joint, const float* fk_point,
    const float* chain, float* K, float* d, float* dV, unsigned char* fail,
    float* Aout, float* Bout, int batch, int N, int P, int G, int J,
    int npts, int model, int reg_state, float atol, int* shape,
    void* stream) {
  if (batch <= 0 || N < 2 || P < 0 || J < 0 || J > kFkMaxJoints ||
      npts < 0 || npts > kFkMaxPoints ||
      (is_chain_model(model) && chain == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{X, U, lam, mu, dt, Q, R, H, q, r, rho, (const ChainTable*)chain,
               K, d, dV, fail, Aout, Bout, batch, N, reg_state, atol};
  const CanonTables tab{(const int4*)row_i, (const float4*)row_f, groups,
                        col_ptr, col_rows, P, G, fk_joint,
                        (const float4*)fk_point, J, npts};
  return dispatch(model, [&](auto inst) {
    using I = decltype(inst);
    return launch<typename I::M, I::kSlack>(a, tab, shape,
                                            (cudaStream_t)stream);
  }, (int)cudaErrorInvalidValue);
}
