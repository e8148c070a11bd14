// The knot pipeline of the backward sweeps K3 (fused_al_backward.cu), K7a
// (fused_backward.cu), K5 (riccati_sweep.cu) and K1 (sqrt_sweep.cu): one
// block a problem, Wp producer warps that fill a knot's inputs into a ring
// of S slots in shared memory, Wc consumer warps that run the sweep's step
// on each slot in knot order. A kernel gives the ring its slot and its
// consumers' state (K3, K5, K7a: KnotInputs and RiccatiState, the Riccati
// step of riccati_step.cuh through riccati_pipeline; K1: the stage factor
// and its QR step, sized at run time from (n, m)).
//
// Only the step depends on the carry; what fills a slot reads only the
// problem's inputs. So the producers never wait on the carry: producer p
// fills the knots of sweep indices i = N − 2 − k in groups of G (g = p,
// p + Wp, …; G knots a step where one warp computes several knots at once,
// as K7a's Jacobians of a small model or K1's stage factors), each slot
// with a full and an empty mbarrier, slot i mod S in its generation i / S.
// The Wc consumer warps take every i in turn on their own named barrier
// (bar.sync 1, 32·Wc threads), and own the carry, the fail flag and the ΔV
// sums. Every entry of a step keeps its summation order, so the results
// do not depend on (Wc, Wp, S, G). With Wp = 0 a block is one warp that
// fills G slots and consumes them in turn, through the same code.
//
// The shape (Wc, Wp) of a launch is the first of a kernel's preference list
// whose B blocks fit on the card in one wave at the kernel's occupancy
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor × the SM count), else the
// lone warp (first_shape_in_one_wave): at a batch that fills the card with
// one warp a problem, more warps a problem only make a second wave. That
// holds where the consumers set the pace; where the producers do (a chain's
// Dual step), more warps a problem can pay even past one wave (K7a's
// cartpole rig at B = 1024: (1, 1) in two waves 1.58 ms, the lone warp
// 2.53), and the rule does not see it.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "riccati_step.cuh"

namespace trajopt {

constexpr int kMaxWarps = 8;   // a block's warps, consumers and producers

struct Shape {
  int Wc, Wp;
};

constexpr int kMaxShapes = 3;

// A kernel's launch shapes in order of preference: the first n of s.
struct ShapeList {
  int n;
  Shape s[kMaxShapes];
};

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival (release: this thread's shared-memory writes come first)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// waits until the phase of parity `parity` has completed (acquire)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// ------------------------------------------------------- shared memory

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// A block's dynamic shared memory: 2S mbarriers (full, then empty), S slots
// of `slot_bytes` each, the consumers' state of `state_bytes`, then
// `scratches` areas of `scratch_bytes` each (a warp's own, for what it
// fills a slot with).
struct RingLayout {
  int S, scratches;
  size_t slot_raw, state_raw, scratch_raw;
  __host__ __device__ RingLayout(int S_, int scratches_, size_t slot_bytes,
                                 size_t state_bytes, size_t scratch_bytes)
      : S(S_),
        scratches(scratches_),
        slot_raw(slot_bytes),
        state_raw(state_bytes),
        scratch_raw(scratch_bytes) {}
  __host__ __device__ size_t slot_bytes() const { return align16(slot_raw); }
  __host__ __device__ size_t scratch_bytes() const {
    return align16(scratch_raw);
  }
  __host__ __device__ size_t slots() const { return align16(16 * S); }
  __host__ __device__ size_t state() const {
    return slots() + S * slot_bytes();
  }
  __host__ __device__ size_t scratch() const {
    return state() + align16(state_raw);
  }
  __host__ __device__ size_t bytes() const {
    return scratch() + scratches * scratch_bytes();
  }
};

// The layout of a Riccati sweep's ring (K3, K5, K7a): a knot's inputs a
// slot, the Riccati state.
template <int NX, int NU>
__host__ __device__ RingLayout riccati_layout(int S, int scratches,
                                              size_t scratch_bytes) {
  return RingLayout(S, scratches, sizeof(KnotInputs<NX, NU>),
                    sizeof(RiccatiState<NX, NU>), scratch_bytes);
}

// The slots a shape takes: two groups of G for each producer, so a producer
// fills its next group while the consumers read its last; G for the lone
// warp.
__host__ __device__ constexpr int ring_slots(int Wp, int G) {
  return Wp > 0 ? 2 * Wp * G : G;
}

// The ring over a block's dynamic shared memory: slots of type Slot, the
// consumers' state of type State (K1: float, the start of each area).
template <class Slot, class State>
struct Ring {
  unsigned char* smem;
  RingLayout L;
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(smem) + s;
  }
  __device__ uint64_t* empty(int s) const {
    return reinterpret_cast<uint64_t*>(smem) + L.S + s;
  }
  __device__ Slot& slot(int s) const {
    return *reinterpret_cast<Slot*>(smem + L.slots() + s * L.slot_bytes());
  }
  __device__ State& state() const {
    return *reinterpret_cast<State*>(smem + L.state());
  }
  __device__ unsigned char* scratch(int i) const {
    return smem + L.scratch() + i * L.scratch_bytes();
  }
  // the barriers (a slot fills from one producer warp and empties from the
  // 32·Wc consumer threads); the caller syncs the block
  __device__ void init(int Wc, int Wp) const {
    if (threadIdx.x == 0 && Wp > 0) {
      for (int s = 0; s < L.S; ++s) {
        mbar_init(full(s), 32);
        mbar_init(empty(s), 32 * Wc);
      }
    }
  }
};

template <int NX, int NU>
using RiccatiRing = Ring<KnotInputs<NX, NU>, RiccatiState<NX, NU>>;

// The sweep by Wc consumer warps (the block's warps 0 … Wc − 1) and Wp
// producer warps, or with Wp = 0 by one warp. produce(i0, cnt) is called by
// a whole producer warp and fills the slots of sweep indices i0 … i0 + cnt
// − 1 (cnt ≤ G; knot k = N − 2 − i in slot i mod S), ending with
// __syncwarp. consume(s, k) is called by every consumer thread, runs the
// step of knot k on slot s and the carry (its terminal value set and synced
// before the call) and returns whether the stage failed. Returns whether a
// stage failed (on each consumer thread, as its consume said).
template <class R, class Produce, class Consume>
__device__ __forceinline__ bool knot_pipeline(const R& r, int Wc, int Wp,
                                              int G, int N, Produce produce,
                                              Consume consume) {
  const int warp = threadIdx.x >> 5, S = r.L.S;
  const bool solo = Wp == 0, cons = warp < Wc, prod = solo || !cons;
  const int groups = (N - 1 + G - 1) / G;
  const int first = solo || cons ? 0 : warp - Wc;
  const int stride = solo || cons ? 1 : Wp;
  bool fail = false;
  for (int g = first; g < groups; g += stride) {
    const int i0 = g * G, cnt = min(G, N - 1 - i0);
    if (prod) {
      if (!solo) {
        for (int j = 0; j < cnt; ++j) {
          const int i = i0 + j;
          if (i >= S) mbar_wait(r.empty(i % S), ((i / S) - 1) & 1);
        }
      }
      produce(i0, cnt);
      if (!solo)
        for (int j = 0; j < cnt; ++j) mbar_arrive(r.full((i0 + j) % S));
    }
    if (cons) {
      for (int j = 0; j < cnt; ++j) {
        const int i = i0 + j, s = i % S;
        if (!solo) mbar_wait(r.full(s), (i / S) & 1);
        const bool fail_k = consume(s, N - 2 - i);
        fail = fail || fail_k;
        if (!solo) mbar_arrive(r.empty(s));
      }
    }
  }
  return fail;
}

// The Riccati sweep on the pipeline (K3, K5, K7a): the consumers run the
// team step (riccati_step.cuh) on each slot, write knot k's gains at
// K_b + k·NU·NX and d_b + k·NU, and add to dV1, dV2.
template <int NX, int NU, class Produce>
__device__ __forceinline__ bool riccati_pipeline(
    const RiccatiRing<NX, NU>& r, int Wc, int Wp, int G, int N, float rho,
    bool reg_state, float* K_b, float* d_b, float& dV1, float& dV2,
    Produce produce) {
  const int t = threadIdx.x, nt = 32 * Wc;
  const NamedSync sync{1, nt};
  return knot_pipeline(r, Wc, Wp, G, N, produce, [&](int s, int k) {
    return riccati_step<NX, NU>(r.slot(s), r.state(), rho, reg_state,
                                K_b + (size_t)k * NU * NX,
                                d_b + (size_t)k * NU, dV1, dV2, t, nt, sync);
  });
}

// ------------------------------------------------------------ the launch

// What a kernel keeps between its launches, per device: the dynamic shared
// memory it may take, and the blocks an SM holds at each shape of its list
// under a key (what else sets the shared memory: K3's P), each measured
// once. One per kernel instantiation, zero-initialized (a static).
struct LaunchCache {
  size_t allowed[16];
  int key[16][kMaxShapes];
  int per_sm[16][kMaxShapes];
  // the kernel's dynamic shared memory raised to `need` bytes where that is
  // above the default 48 KB
  cudaError_t raise(const void* kernel, int dev, size_t need) {
    if (need <= 48 * 1024 || dev >= 16 || need <= allowed[dev])
      return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (e == cudaSuccess) allowed[dev] = need;
    return e;
  }
};

// The first shape of `list` whose `batch` blocks fit on the card in one
// wave at the kernel's occupancy, else the lone warp (1, 0); Wc = 0 when
// the device cannot be queried. need(shape) gives a shape's shared-memory
// bytes.
template <class Need>
Shape first_shape_in_one_wave(const void* kernel, const ShapeList& list,
                              int batch, int key, Need need,
                              LaunchCache& cache) {
  int dev = 0, sms = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return {0, 0};
  for (int i = 0; i < list.n; ++i) {
    const Shape sh = list.s[i];
    if (cache.key[dev][i] != key + 1) {
      const size_t bytes = need(sh);
      int n = 0;
      if (bytes <= (size_t)optin) {
        if (cache.raise(kernel, dev, bytes) != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, kernel, 32 * (sh.Wc + sh.Wp), bytes) != cudaSuccess)
          return {0, 0};
      }
      cache.per_sm[dev][i] = n;
      cache.key[dev][i] = key + 1;
    }
    if ((long long)cache.per_sm[dev][i] * sms >= batch) return sh;
  }
  return {1, 0};
}

// Raises the kernel's shared memory to `bytes` where needed and launches
// it on `blocks` blocks of `threads` threads; returns the CUDA error.
template <class... KArgs, class... Args>
int launch_ring(void (*kernel)(KArgs...), int blocks, int threads,
                size_t bytes, LaunchCache& cache, cudaStream_t stream,
                Args... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cache.raise(reinterpret_cast<const void*>(kernel), dev, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace trajopt
