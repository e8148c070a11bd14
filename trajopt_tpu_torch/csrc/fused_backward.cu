// Fused backward sweep of an unconstrained iLQR iteration (kernel K7a).
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_fused.py::
// _fused_backward_kernel (front end fused_backward_pallas). Per problem,
// backward over the knots, from X, U and the objective's stacks alone: the
// discrete-step Jacobians A and B, the quadratic stage expansion
//   lx = dt(Qx + q + Hᵀu), lu = dt(Ru + r + Hx), lxx = dtQ, luu = dtR,
//   lux = dtH,
// and the Riccati step with the equilibrated PD solve (riccati_step.cuh).
// A, B and the expansion never reach device memory. The terminal carry is
// Sx = Q_N x_N + q_N, Sxx = Q_N. A failed stage writes zero gains, sets the
// problem's fail flag, and the sweep goes on. The plain version is
// trajopt_tpu_torch/ops/cuda_fused.py::fused_backward.
//
// The TPU kernel linearizes its step with jax.linearize; here the Jacobians
// come from forward-mode dual numbers through the model's templated RK3 step
// (models.cuh), one tangent direction per lane: n state and m control
// directions on n + m lanes (17 for the quadrotor, 21 for the kuka arm, 5
// for the cartpole and its rig). For a rigid-body chain (Chain<NDOF, NU>:
// kuka and the three two-link rigs) each of those lanes walks the chain in
// Dual on its own, the chain's table read from the device pointer the
// kernel is handed, its arrays in local memory, as in K3.
//
// What bounds it on this card: latency, not bytes or operations. For the
// quadrotor at B=128, N=101 a launch moves about 3.5 MB (the gains K
// dominate), a tenth of what the plain Riccati kernel (riccati_sweep.cu)
// reads for the same sweep; each problem is a chain of 100 dependent knots.
//
// Design: K3's knot pipeline without the constraint stack and the slack
// columns (knot_pipeline.cuh). Producer warps compute a knot's Jacobians
// and its stage expansion into a slot of the ring, Wc consumer warps run
// the Riccati step over 32·Wc threads. A producer warp takes G = ⌊32 /
// (n + m)⌋ knots a step (6 for the cartpole, the car and the two-link rigs
// with one control, 5 for the double pendulum rig, 10 for the pendulum and
// the double integrator, 1 for the quadrotor and kuka): lane j·(n + m) + t
// pushes tangent t of knot i0 + j through the step. Each lane runs the
// one-thread Dual step unchanged, so the warp fills 30 of its 32 lanes
// where one knot filled 5, in the time of one knot, and every Jacobian is
// the same float32 arithmetic as one knot a warp (tools/k7a_knot_split.py
// measured this against a warp form of the chain's Dual step: PERF.md).
// The shape (Wc, Wp) is the first of the model's preferences whose B
// blocks fit on the card in one wave, else the lone warp; K, d, ΔV, the
// fail flag and the Jacobians do not depend on it.
#include <cuda_runtime.h>

#include "knot_pipeline.cuh"
#include "models.cuh"

namespace {

using namespace trajopt;

// knots a producer warp takes a step: one tangent a lane
template <class M>
__host__ __device__ constexpr int knots_per_warp() {
  return 32 / (M::NX + M::NU) > 0 ? 32 / (M::NX + M::NU) : 1;
}

// (Wc, Wp) in order of preference, by the model's kind. Measured by
// tools/k7a_k5_launch_shape.py (H100, ms a launch; the lone warp, the
// shape taken, the next best):
//   quadrotor, B = 128    1.34 | (4,4) 0.394 | (4,3) 0.395
//   quadrotor, B = 1024   1.45 | (1,1) 0.998 | (2,2) 1.06
//   cartpole, B = 128     0.265 | (1,2) 0.179 | (1,1) 0.180
//   cartpole rig, B = 128 0.694 | (1,3) 0.244 | (2,3) 0.267
//   acrobot rig, B = 128  0.997 | (1,3) 0.340 | (4,3) 0.397
//   kuka, B = 128         8.06 | (2,6) 4.40 | (1,6) 4.44
// The scalar models of G = 1 (the quadrotor) are consumer-bound: the most
// consumers; with G > 1 one producer warp keeps up with the consumers of a
// small step; a two-link rig's producers (the Dual chain step) set the
// pace: three of them; kuka's 21-lane Dual step, more still.
template <class M>
constexpr ShapeList preferences() {
  if (M::kChain && knots_per_warp<M>() > 1)
    return ShapeList{2, {{1, 3}, {1, 1}}};
  if (M::kChain) return ShapeList{3, {{2, 6}, {1, 3}, {1, 1}}};
  if (knots_per_warp<M>() > 1) return ShapeList{2, {{1, 2}, {1, 1}}};
  return ShapeList{3, {{4, 4}, {2, 2}, {1, 1}}};
}

struct Args {
  const float *X, *U, *dt, *Q, *R, *H, *q, *r, *rho;
  const ChainTable* chain;   // a chain model's table, else null
  float *K, *d, *dV;
  unsigned char* fail;
  float *Aout, *Bout;        // the Jacobians, where asked for
  int batch, N, reg_state;
};

// a producer warp's scratch: the states and controls of its G knots
template <class M>
struct Stage {
  float z[knots_per_warp<M>()][M::NX + M::NU];
};

template <class M>
__host__ __device__ RingLayout layout(int Wp) {
  return riccati_layout<M::NX, M::NU>(ring_slots(Wp, knots_per_warp<M>()),
                                      Wp > 0 ? Wp : 1, sizeof(Stage<M>));
}

// The inputs of the knots of sweep indices i0 … i0 + cnt − 1 (knot k = N −
// 2 − i in slot i mod S) by one warp: the Dual Jacobians, lane j·(n + m) + t
// the tangent t of knot i0 + j, then the stage expansion of each knot over
// the lanes; the Jacobians also to Aout / Bout where asked for.
template <class M>
__device__ __forceinline__ void expand_knots(
    const Args& a, const RiccatiRing<M::NX, M::NU>& r, Stage<M>& st, int b,
    int i0, int cnt, int lane) {
  constexpr int NX = M::NX, NU = M::NU, W = NX + NU;
  const int N = a.N, S = r.L.S;
  for (int e = lane; e < cnt * W; e += 32) {
    const int j = e / W, c = e - j * W, k = N - 2 - (i0 + j);
    const size_t bk = (size_t)b * (N - 1) + k;
    st.z[j][c] = c < NX ? a.X[((size_t)b * N + k) * NX + c]
                        : a.U[bk * NU + c - NX];
  }
  __syncwarp();

  // Jacobians: lane j·W + t pushes tangent e_t of [x; u] of knot i0 + j
  // through the RK3 step; row i of its result is A[i][t] or B[i][t − n]
  const int j = lane / W, t = lane - (lane / W) * W;
  if (j < cnt) {
    const int k = N - 2 - (i0 + j);
    const size_t bk = (size_t)b * (N - 1) + k;
    KnotInputs<NX, NU>& in = r.slot((i0 + j) % S);
    const float* z = st.z[j];
    Dual xd[NX], ud[NU], out[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xd[i] = Dual(z[i], t == i ? 1.f : 0.f);
#pragma unroll
    for (int i = 0; i < NU; ++i)
      ud[i] = Dual(z[NX + i], t == NX + i ? 1.f : 0.f);
    M::template step<Dual>(xd, ud, a.dt[k], out, a.chain);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (t < NX) {
        in.A[i * NX + t] = out[i].d;
        if (a.Aout) a.Aout[(bk * NX + i) * NX + t] = out[i].d;
      } else {
        in.B[i * NU + t - NX] = out[i].d;
        if (a.Bout) a.Bout[(bk * NX + i) * NU + t - NX] = out[i].d;
      }
    }
  }

  // quadratic stage expansion: lx = dt(Qx + q + Hᵀu), lu = dt(Ru + r + Hx),
  // lxx = dtQ, luu = dtR, lux = dtH
  for (int jj = 0; jj < cnt; ++jj) {
    const int k = N - 2 - (i0 + jj);
    KnotInputs<NX, NU>& in = r.slot((i0 + jj) % S);
    const float dtv = a.dt[k];
    const float* Qk = a.Q + (size_t)k * NX * NX;
    const float* Rk = a.R + (size_t)k * NU * NU;
    const float* Hk = a.H + (size_t)k * NU * NX;
    const float* x = st.z[jj];
    const float* u = st.z[jj] + NX;
    if (lane < NX) {
      float v = Qk[lane * NX] * x[0];
      for (int c = 1; c < NX; ++c) v = v + Qk[lane * NX + c] * x[c];
      float h = Hk[lane] * u[0];
      for (int c = 1; c < NU; ++c) h = h + Hk[c * NX + lane] * u[c];
      in.lx[lane] = (v + a.q[(size_t)k * NX + lane] + h) * dtv;
    }
    if (lane < NU) {
      float v = Rk[lane * NU] * u[0];
      for (int c = 1; c < NU; ++c) v = v + Rk[lane * NU + c] * u[c];
      float h = Hk[lane * NX] * x[0];
      for (int c = 1; c < NX; ++c) h = h + Hk[lane * NX + c] * x[c];
      in.lu[lane] = (v + a.r[(size_t)k * NU + lane] + h) * dtv;
    }
    for (int e = lane; e < NX * NX; e += 32) in.lxx[e] = Qk[e] * dtv;
    for (int e = lane; e < NU * NU; e += 32) in.luu[e] = Rk[e] * dtv;
    for (int e = lane; e < NU * NX; e += 32) in.lux[e] = Hk[e] * dtv;
  }
  __syncwarp();
}

// A block of 32·Wc threads (Wp = 0) or 32·(Wc + Wp) threads a problem.
template <class M>
__global__ void __launch_bounds__(32 * kMaxWarps) fused_backward_kernel(
    Args a, int Wc, int Wp) {
  constexpr int NX = M::NX, NU = M::NU, G = knots_per_warp<M>();
  static_assert(NX + NU <= 32 && G * (NX + NU) <= 32,
                "one tangent direction per lane");
  extern __shared__ __align__(16) unsigned char smem[];
  const RiccatiRing<NX, NU> r{smem, layout<M>(Wp)};
  const int N = a.N, b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  r.init(Wc, Wp);
  __syncthreads();

  const bool cons = warp < Wc;
  if (cons) {
    // terminal knot: Sx = Q_N x_N + q_N, Sxx = Q_N
    RiccatiState<NX, NU>& w = r.state();
    const float* xN = a.X + ((size_t)b * N + (N - 1)) * NX;
    const float* QN = a.Q + (size_t)(N - 1) * NX * NX;
    if (warp == 0 && lane < NX) {
      float acc = QN[lane * NX] * xN[0];
      for (int j = 1; j < NX; ++j) acc = acc + QN[lane * NX + j] * xN[j];
      w.Sx[lane] = acc + a.q[(size_t)(N - 1) * NX + lane];
    }
    for (int e = threadIdx.x; e < NX * NX; e += 32 * Wc) w.Sxx[e] = QN[e];
    NamedSync{1, 32 * Wc}();
  }

  Stage<M>& st = *reinterpret_cast<Stage<M>*>(
      r.scratch(Wp == 0 || cons ? 0 : warp - Wc));
  float dV1 = 0.0f, dV2 = 0.0f;
  const size_t b0 = (size_t)b * (N - 1);
  const bool fail = riccati_pipeline<NX, NU>(
      r, Wc, Wp, G, N, a.rho[b], a.reg_state != 0, a.K + b0 * NU * NX,
      a.d + b0 * NU, dV1, dV2, [&](int i0, int cnt) {
        expand_knots<M>(a, r, st, b, i0, cnt, lane);
      });
  if (threadIdx.x == 0) {
    a.dV[b] = dV1;
    a.dV[a.batch + b] = dV2;
    a.fail[b] = fail ? 1 : 0;
  }
}

template <class M>
LaunchCache& launch_cache() {
  static LaunchCache cache;
  return cache;
}

template <class M>
int launch_shape(const Args& a, Shape sh, cudaStream_t stream) {
  return launch_ring(fused_backward_kernel<M>, a.batch,
                     32 * (sh.Wc + sh.Wp), layout<M>(sh.Wp).bytes(),
                     launch_cache<M>(), stream, a, sh.Wc, sh.Wp);
}

// The first shape of the model's preferences whose `batch` blocks fit on
// the card in one wave, else one warp a problem; Wc = 0 when the device
// cannot be queried.
template <class M>
Shape shape_for(int batch) {
  static constexpr ShapeList prefs = preferences<M>();
  return first_shape_in_one_wave(
      reinterpret_cast<const void*>(fused_backward_kernel<M>), prefs, batch,
      0, [](Shape sh) { return layout<M>(sh.Wp).bytes(); },
      launch_cache<M>());
}

template <class M_>
struct Of {
  using M = M_;
};

// f(Of<M>{}) for the trait M of model id `model`, or `none` for a model
// that has no instantiation
template <class F>
int dispatch(int model, F f, int none) {
  switch (model) {
    case kModelQuadrotor: return f(Of<Quadrotor>{});
    case kModelCartpole: return f(Of<Cartpole>{});
    case kModelCar: return f(Of<Car>{});
    case kModelPendulum: return f(Of<Pendulum>{});
    case kModelDoubleIntegrator: return f(Of<DoubleIntegrator>{});
    case kModelKuka: return f(Of<Kuka>{});
    case kModelAcrobotUrdf: return f(Of<AcrobotUrdf>{});
    case kModelDoublependulumUrdf: return f(Of<DoublependulumUrdf>{});
    case kModelCartpoleUrdf: return f(Of<CartpoleUrdf>{});
  }
  return none;
}

}  // namespace

// The launch shape K7a takes for model id `model` at `batch` problems:
// shape ← Wc, Wp, S, the block's shared-memory bytes and G, the knots a
// producer step. Returns 0, or cudaErrorInvalidValue for a model without
// an instantiation or a device that cannot be queried.
extern "C" int trajopt_fused_backward_shape(int model, int batch,
                                            int* shape) {
  return dispatch(model, [&](auto of) {
    using M = typename decltype(of)::M;
    const Shape sh = shape_for<M>(batch);
    if (sh.Wc < 1) return (int)cudaErrorInvalidValue;
    const RingLayout L = layout<M>(sh.Wp);
    shape[0] = sh.Wc;
    shape[1] = sh.Wp;
    shape[2] = L.S;
    shape[3] = (int)L.bytes();
    shape[4] = knots_per_warp<M>();
    return 0;
  }, (int)cudaErrorInvalidValue);
}

// C entry point (bound with ctypes from ops/cuda_fused.py). Contiguous
// float32, batch-first, for the model `model` (models.cuh ModelId) with n
// states and m controls: X (B,N,n), U (B,N-1,m), dt (N-1), Q (N,n,n),
// R (N,m,m), H (N,m,n), q (N,n), r (N,m), rho (B), chain (a chain model's
// table, models.cuh ChainTable, on the device; else null) → K (B,N-1,m,n),
// d (B,N-1,m), dV (2,B), fail (B) bytes, and where Aout/Bout are not null
// the in-kernel Jacobians A (B,N-1,n,n), B (B,N-1,n,m). Returns the CUDA
// error of the launch (0 on success), or cudaErrorInvalidValue for a model
// that has no instantiation.
extern "C" int trajopt_fused_backward_f32(
    const float* X, const float* U, const float* dt, const float* Q,
    const float* R, const float* H, const float* q, const float* r,
    const float* rho, const float* chain, float* K, float* d, float* dV,
    unsigned char* fail, float* Aout, float* Bout, int batch, int N,
    int model, int reg_state, void* stream) {
  if (batch <= 0 || N < 2 || (is_chain_model(model) && chain == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{X, U, dt, Q, R, H, q, r, rho, (const ChainTable*)chain, K, d,
               dV, fail, Aout, Bout, batch, N, reg_state};
  return dispatch(model, [&](auto of) {
    using M = typename decltype(of)::M;
    const Shape sh = shape_for<M>(batch);
    if (sh.Wc < 1) return (int)cudaErrorInvalidValue;
    return launch_shape<M>(a, sh, (cudaStream_t)stream);
  }, (int)cudaErrorInvalidValue);
}
