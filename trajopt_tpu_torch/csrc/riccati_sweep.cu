// Standard Riccati backward sweep, batched over problems (kernel K5).
//
// Replaces the TPU kernel trajopt_tpu/ops/pallas_riccati.py::_riccati_kernel
// (front end riccati_sweep_pallas, the default bp_type='scan' backward pass).
// Per problem, backward over the knots, from A, B and the cost expansion in
// device memory: the Q-function blocks, gains from the regularized Quu
// (control regularization ρI, or state regularization ρBᵀB / ρBᵀA) by the
// Jacobi-equilibrated PD solve with its float32 pivot policy
// (posdef_solve.cuh), the cost-to-go from the unregularized blocks, and the
// expected-decrease sums ΔV1, ΔV2 (riccati_step.cuh). A failed stage writes
// zero gains, sets the problem's fail flag, and the sweep goes on. The
// terminal carry is Sx = lx_N, Sxx = lxx_N. The plain version is
// trajopt_tpu_torch/ops/riccati.py::scan_sweep.
//
// What bounds it on this card: by the roofline, bytes. It reads A, B and
// five expansion stacks, about 0.21 MB per problem at n = 13, m = 4,
// N = 101 (27 MB for 128 problems), several times what the fused backward
// kernel (fused_backward.cu) moves for the same sweep; in practice each
// problem is a chain of N − 1 dependent knots and the launch is bound by
// latency: a knot's loads, then the step's 6 + m + 3 barrier phases.
//
// Design: a load pipeline feeding the team step (knot_pipeline.cuh, shared
// with K3 and K7a). One block a problem: Wp producer warps copy the knots'
// A, B, lx, lu, lxx, luu and lux from device memory into a ring of 2·Wp
// slots in shared memory, ahead of the sweep (plain loads, all of a knot's
// issued before any is stored; a knot's A at (13,4) is 676 B, so a bulk
// copy of it would start on a 16-byte boundary only every fourth knot),
// while Wc consumer warps run the Riccati step over 32·Wc threads. With
// Wp = 0 one warp loads and steps each knot in turn. The shape (Wc, Wp) is
// the first of the preferences whose B blocks fit on the card in one wave,
// else the lone warp; K, d, ΔV and the fail flag do not depend on it. (n, m)
// are compile-time constants, one instantiation per pair that a ported
// model produces; the wrapper refuses any other pair.
#include <cuda_runtime.h>

#include "knot_pipeline.cuh"

namespace {

using namespace trajopt;

// (Wc, Wp) in order of preference, by the step's size. Measured by
// tools/k7a_k5_launch_shape.py (H100, ms a launch; the lone warp, the
// shape taken, the fastest):
//   (13,4), B = 128    0.648 | (4,1) 0.312 | (4,1)
//   (13,4), B = 1024   0.747 | (2,1) 0.543 | (2,1)
//   (14,7), B = 128    0.376 | (4,1) 0.195 | (4,1)
//   (4,1), B = 128     0.247 | (1,1) 0.200 | (1,2) 0.200
//   (3,2), B = 128     0.142 | (1,1) 0.120 | (2,1) 0.117
//   (2,1), B = 128     0.071 | (1,1) 0.059 | (1,1)
// One producer warp keeps the ring full (a second one gains nothing). The
// arm's and the quadrotor's step wants the most consumers; a step of two
// to four states has too few entries a phase to spread over more than one
// warp (at (4,1), (4,1) took 0.204 ms at B = 128, and at B = 1024 was no
// faster than the lone warp). Several problems a block (two, four or
// eight, measured in that tool on a copy of this sweep) lost at every
// small shape: one problem a block.
template <int NX, int NU>
constexpr ShapeList preferences() {
  if (NX <= 4) return ShapeList{1, {{1, 1}}};
  return ShapeList{3, {{4, 1}, {2, 1}, {1, 1}}};
}

struct Args {
  const float *A, *B, *lx, *lu, *lxx, *luu, *lux, *rho;
  float *K, *d, *dV;
  unsigned char* fail;
  int batch, N, reg_state;
};

template <int NX, int NU>
__host__ __device__ RingLayout layout(int Wp) {
  return riccati_layout<NX, NU>(ring_slots(Wp, 1), 0, 0);
}

// entry e of knot k's inputs in the order of KnotInputs (A, B, lx, lu,
// lxx, luu, lux)
template <int NX, int NU>
__device__ __forceinline__ float knot_entry(const Args& a, size_t bk,
                                            size_t bkx, int e) {
  constexpr int oB = NX * NX, olx = oB + NX * NU, olu = olx + NX,
                olxx = olu + NU, oluu = olxx + NX * NX, olux = oluu + NU * NU;
  if (e < oB) return __ldg(a.A + bk * NX * NX + e);
  if (e < olx) return __ldg(a.B + bk * NX * NU + e - oB);
  if (e < olu) return __ldg(a.lx + bkx * NX + e - olx);
  if (e < olxx) return __ldg(a.lu + bk * NU + e - olu);
  if (e < oluu) return __ldg(a.lxx + bkx * NX * NX + e - olxx);
  if (e < olux) return __ldg(a.luu + bk * NU * NU + e - oluu);
  return __ldg(a.lux + bk * NU * NX + e - olux);
}

// knot k of problem b into the slot `in`, by one warp: every load in
// flight before the first store
template <int NX, int NU>
__device__ __forceinline__ void load_knot(const Args& a, int b, int k,
                                          KnotInputs<NX, NU>& in, int lane) {
  constexpr int T = sizeof(KnotInputs<NX, NU>) / sizeof(float);
  constexpr int R = (T + 31) / 32;
  const size_t bk = (size_t)b * (a.N - 1) + k, bkx = (size_t)b * a.N + k;
  float v[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int e = lane + 32 * q;
    v[q] = e < T ? knot_entry<NX, NU>(a, bk, bkx, e) : 0.0f;
  }
  float* dst = reinterpret_cast<float*>(&in);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int e = lane + 32 * q;
    if (e < T) dst[e] = v[q];
  }
  __syncwarp();
}

// A block of 32·Wc threads (Wp = 0) or 32·(Wc + Wp) threads a problem.
template <int NX, int NU>
__global__ void __launch_bounds__(32 * kMaxWarps) riccati_sweep_kernel(
    Args a, int Wc, int Wp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const RiccatiRing<NX, NU> r{smem, layout<NX, NU>(Wp)};
  const int S = r.L.S, N = a.N, b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31;
  r.init(Wc, Wp);
  __syncthreads();
  if (t < 32 * Wc) {
    // terminal knot: Sx = lx_N, Sxx = lxx_N
    RiccatiState<NX, NU>& w = r.state();
    const size_t bN = (size_t)b * N + (N - 1);
    for (int e = t; e < NX; e += 32 * Wc) w.Sx[e] = a.lx[bN * NX + e];
    for (int e = t; e < NX * NX; e += 32 * Wc)
      w.Sxx[e] = a.lxx[bN * NX * NX + e];
    NamedSync{1, 32 * Wc}();
  }

  float dV1 = 0.0f, dV2 = 0.0f;
  const size_t b0 = (size_t)b * (N - 1);
  const bool fail = riccati_pipeline<NX, NU>(
      r, Wc, Wp, 1, N, a.rho[b], a.reg_state != 0, a.K + b0 * NU * NX,
      a.d + b0 * NU, dV1, dV2, [&](int i, int) {
        load_knot<NX, NU>(a, b, N - 2 - i, r.slot(i % S), lane);
      });
  if (t == 0) {
    a.dV[b] = dV1;
    a.dV[a.batch + b] = dV2;
    a.fail[b] = fail ? 1 : 0;
  }
}

template <int NX, int NU>
LaunchCache& launch_cache() {
  static LaunchCache cache;
  return cache;
}

// The first shape of the preferences whose `batch` blocks fit on the card
// in one wave, else one warp a problem; Wc = 0 when the device cannot be
// queried.
template <int NX, int NU>
Shape shape_for(int batch) {
  static constexpr ShapeList prefs = preferences<NX, NU>();
  return first_shape_in_one_wave(
      reinterpret_cast<const void*>(riccati_sweep_kernel<NX, NU>), prefs,
      batch, 0, [](Shape sh) { return layout<NX, NU>(sh.Wp).bytes(); },
      launch_cache<NX, NU>());
}

template <int NX, int NU>
int launch_shape(const Args& a, Shape sh, cudaStream_t stream) {
  return launch_ring(riccati_sweep_kernel<NX, NU>, a.batch,
                     32 * (sh.Wc + sh.Wp), layout<NX, NU>(sh.Wp).bytes(),
                     launch_cache<NX, NU>(), stream, a, sh.Wc, sh.Wp);
}

template <int NX_, int NU_>
struct Dims {
  static constexpr int NX = NX_, NU = NU_;
};

// f(Dims<n, m>{}) for an (n, m) the kernel is built for, else `none`
template <class F>
int dispatch(int n, int m, F f, int none) {
#define TRAJOPT_RICCATI(NX, NU) \
  if (n == NX && m == NU) return f(Dims<NX, NU>{})
  TRAJOPT_RICCATI(13, 4);    // quadrotor
  TRAJOPT_RICCATI(12, 4);    // quadrotor, quaternion error state;
                             // Euler-angle quadrotor
  TRAJOPT_RICCATI(13, 17);   // quadrotor with the infeasible-start slacks;
                             // Euler-angle quadrotor under minimum time
                             // with the slacks
  TRAJOPT_RICCATI(4, 1);     // cartpole, the acrobot and cartpole rigs,
                             // ballonbeam, the acrobot
  TRAJOPT_RICCATI(3, 2);     // car; pendulum, double integrator under
                             // minimum time
  TRAJOPT_RICCATI(2, 1);     // pendulum, double integrator
  TRAJOPT_RICCATI(4, 5);     // cartpole (and the two rigs), ballonbeam,
                             // the acrobot with the slacks
  TRAJOPT_RICCATI(3, 5);     // car with the slacks
  TRAJOPT_RICCATI(2, 3);     // pendulum, double integrator with the slacks
  TRAJOPT_RICCATI(14, 7);    // kuka
  TRAJOPT_RICCATI(14, 21);   // kuka with the slacks
  TRAJOPT_RICCATI(4, 2);     // double pendulum (analytic and rig)
  TRAJOPT_RICCATI(4, 6);     // double pendulum with the slacks; car
                             // under minimum time with the slacks
  TRAJOPT_RICCATI(12, 16);   // Euler-angle quadrotor with the slacks
  // the minimum-time forms (one more state and control), with and without
  // the slacks; (3, 2), (4, 5) and (13, 17) are the pendulum's and double
  // integrator's, ballonbeam's and the cartpole's with slacks, and the
  // Euler-angle quadrotor's with slacks above
  TRAJOPT_RICCATI(5, 2);     // cartpole, ballonbeam, the acrobots, the
                             // cartpole rig
  TRAJOPT_RICCATI(4, 3);     // car
  TRAJOPT_RICCATI(14, 5);    // quadrotor
  TRAJOPT_RICCATI(13, 5);    // Euler-angle quadrotor
  TRAJOPT_RICCATI(3, 4);     // pendulum, double integrator with the slacks
  TRAJOPT_RICCATI(5, 6);     // cartpole, ballonbeam, the acrobots, the
                             // cartpole rig with the slacks
  TRAJOPT_RICCATI(14, 18);   // quadrotor with the slacks
  // the chains' and the analytic two-link models' minimum-time forms; the
  // acrobots' and the cartpole rig's are (5, 2) and (5, 6) above
  TRAJOPT_RICCATI(15, 8);    // kuka
  TRAJOPT_RICCATI(15, 22);   // kuka with the slacks
  TRAJOPT_RICCATI(5, 3);     // the double pendulum (analytic and rig)
  TRAJOPT_RICCATI(5, 7);     // the double pendulum with the slacks
#undef TRAJOPT_RICCATI
  return none;
}

}  // namespace

// The launch shape K5 takes for (n, m) at `batch` problems: shape ← Wc, Wp,
// S and the block's shared-memory bytes. Returns 0, or
// cudaErrorInvalidValue for an (n, m) without an instantiation or a device
// that cannot be queried.
extern "C" int trajopt_riccati_sweep_shape(int n, int m, int batch,
                                           int* shape) {
  return dispatch(n, m, [&](auto dims) {
    using D = decltype(dims);
    const Shape sh = shape_for<D::NX, D::NU>(batch);
    if (sh.Wc < 1) return (int)cudaErrorInvalidValue;
    shape[0] = sh.Wc;
    shape[1] = sh.Wp;
    shape[2] = layout<D::NX, D::NU>(sh.Wp).S;
    shape[3] = (int)layout<D::NX, D::NU>(sh.Wp).bytes();
    return 0;
  }, (int)cudaErrorInvalidValue);
}

// C entry point (bound with ctypes from ops/cuda_riccati.py). Contiguous
// float32, batch-first: A (B,N-1,n,n), B (B,N-1,n,m), lx (B,N,n),
// lu (B,N-1,m), lxx (B,N,n,n), luu (B,N-1,m,m), lux (B,N-1,m,n), rho (B) →
// K (B,N-1,m,n), d (B,N-1,m), dV (2,B), fail (B) bytes. Returns the CUDA
// error of the launch (0 on success), or cudaErrorInvalidValue for an (n, m)
// that has no instantiation.
extern "C" int trajopt_riccati_sweep_f32(
    const float* A, const float* B, const float* lx, const float* lu,
    const float* lxx, const float* luu, const float* lux, const float* rho,
    float* K, float* d, float* dV, unsigned char* fail, int batch, int N,
    int n, int m, int reg_state, void* stream) {
  if (batch <= 0 || N < 2) return (int)cudaErrorInvalidValue;
  const Args a{A, B, lx, lu, lxx, luu, lux, rho, K, d, dV, fail, batch, N,
               reg_state};
  return dispatch(n, m, [&](auto dims) {
    using D = decltype(dims);
    const Shape sh = shape_for<D::NX, D::NU>(batch);
    if (sh.Wc < 1) return (int)cudaErrorInvalidValue;
    return launch_shape<D::NX, D::NU>(a, sh, (cudaStream_t)stream);
  }, (int)cudaErrorInvalidValue);
}
