// The ring of stages that K2's tall tiles run through (fused_cols.cu,
// cols.cuh, and the variants in csrc/probes/cols_variants.cu).
//
// A "unit" is what a CTA transforms at a time: one K2 tile of H rows by tc
// columns.  Where one tile fills an SM (H * tc >= 8192 points), the direct
// design loaded a tile into registers, ran its passes through shared memory
// and stored it, one tile after another, so the SM moved no bytes while the
// passes ran and ran no pass while the bytes moved.  Here a persistent grid
// (as many CTAs as fit on the card, at most one a unit) walks the units in
// a static order (unit i to CTA i mod grid, so no two CTAs touch one unit
// and in place stays safe), and each CTA keeps a ring of kRingStages stages
// in shared memory: while unit k runs its passes, unit k + 1 is landing in
// the other stage by asynchronous copy, which completes on that stage's
// mbarrier.  (K1 keeps its direct design: fused_lines.cu says why.)
//
// Layout.  A unit lands in its stage in position order (the copy's layout),
// and the first pass reads it from there; every pass then exchanges in
// place in the stage with one point of padding in every 16 (`padded`, the
// layout that spreads the strided autosort writes over the banks).  A pass
// reads all its points before the barrier and writes after it, so the
// first pass may change the layout in place: the one barrier the ring adds
// to a unit.  A stage holds `ring_stage_points` points: 69.6 KB for 8192,
// so two stages and their barriers (139,392 bytes) fit the 227 KB a CTA may
// opt in to up to 13,659 points.
//
// Copies (the shape rule; nothing is retried).  A tile lands by a 3-D
// tensor map (cols.cuh) where its rows are 16-byte aligned and whole; any
// other tile (an odd column count, a misaligned input, a ragged last tile)
// lands by cp.async of 16 bytes (two points) where both ends are 16-byte
// aligned and 8 bytes (one point) otherwise, every thread copying a share,
// each thread's copies completing on the stage's barrier through
// cp.async.mbarrier.arrive.noinc.  A point past the unit's edge is
// zero-filled by the copy and never stored.
//
// Barriers.  Every stage's mbarrier expects blockDim.x arrivals a fill: a
// tensor-map fill is thread 0's arrive.expect_tx of the unit's bytes plus a
// plain arrive from every other thread; a cp.async fill is every thread's
// noinc arrive.  Fill j of a stage completes phase j, waited on with parity
// j & 1.  Every thread fences the generic proxy's reads of a stage against
// the asynchronous writes before the stage is refilled.  A wait that has
// not completed after kRingWaitNs traps: a copy that never lands is a
// fault, not a reason to hang the card.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace wgfft {

constexpr int kRingStages = 2;
constexpr int kRingShared = 232448;      // 227 KB: the most a CTA may opt in to
constexpr int kRingBarBytes = 128;       // the stages' mbarriers; stage 0 starts 128-byte aligned
constexpr int kRingMinPoints = 8192;     // a K2 tile this large fills an SM in the direct design
constexpr long long kRingWaitNs = 10000000000LL;  // 10 s

// Points a stage holds for a unit of `points` points: the unit in the
// padded exchange layout, rounded up to 16 points (128 bytes) so that every
// stage starts 128-byte aligned.
__host__ __device__ constexpr int ring_stage_points(int points) {
  return (points + points / 16 + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t ring_shared_bytes(int points) {
  return kRingBarBytes + static_cast<size_t>(kRingStages) * ring_stage_points(points) * 8;
}

// Whether a ring of units of `points` points fits a CTA's shared memory.
__host__ __device__ constexpr bool ring_fits(int points) {
  return ring_shared_bytes(points) <= static_cast<size_t>(kRingShared);
}

// Where point i of a staged unit sits in the exchange layout.
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One point (8 bytes) or two (16 bytes) global -> shared, asynchronously;
// a dead copy (live false) reads nothing and writes zeros.
__device__ __forceinline__ void copy8(float2* dst, const float2* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void copy16(float2* dst, const float2* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Ring {
  uint64_t* bars;  // one mbarrier a stage
  float2* base;    // kRingStages stages of `points` points
  int points;      // ring_stage_points of the unit

  __device__ __forceinline__ Ring(unsigned char* smem, int unit_points)
      : bars(reinterpret_cast<uint64_t*>(smem)),
        base(reinterpret_cast<float2*>(smem + kRingBarBytes)),
        points(ring_stage_points(unit_points)) {}

  __device__ __forceinline__ float2* stage(int s) const { return base + s * points; }
  __device__ __forceinline__ uint32_t bar(int s) const { return smem_addr(bars + s); }

  // Thread 0 sets every stage's barrier to expect blockDim.x arrivals.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kRingStages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar(s)), "r"(blockDim.x)
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // A plain arrival on stage s's barrier (a thread with no copy to start).
  __device__ __forceinline__ void arrive(int s) const {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar(s)) : "memory");
  }

  // An arrival that also sets the bytes the fill's copies will bring.
  __device__ __forceinline__ void arrive_expect(int s, uint32_t bytes) const {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar(s)),
                 "r"(bytes)
                 : "memory");
  }

  // This thread's cp.async copies so far complete on stage s's barrier.
  __device__ __forceinline__ void async_arrive(int s) const {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar(s))
                 : "memory");
  }

  __device__ __forceinline__ void wait(int s, uint32_t parity) const {
    const long long t0 = global_ns();
    uint32_t done;
    for (;;) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(bar(s)), "r"(parity)
          : "memory");
      if (done) return;
      if (global_ns() - t0 > kRingWaitNs) __trap();
    }
  }
};

// The CTA's walk over `units` units: unit t = blockIdx.x + k * gridDim.x
// lands in stage k % kRingStages by fill(s, t), then run(stage, t) runs its
// passes in the stage, and the stage takes unit k + kRingStages.  The last
// pass's barrier between its reads and its stores to global memory is
// behind every thread by then, so every read of the stage is done and no
// barrier of the ring's own is needed; each thread fences its reads
// against the asynchronous writes of the refill.  Every thread calls it.
template <class Fill, class Run>
__device__ __forceinline__ void ring_walk(const Ring& ring, long long units, Fill fill, Run run) {
  const long long step = gridDim.x;
  long long t = blockIdx.x;
  for (int s = 0; s < kRingStages && t + s * step < units; ++s) fill(s, t + s * step);
  for (int k = 0; t < units; t += step, ++k) {
    const int s = k % kRingStages;
    ring.wait(s, static_cast<uint32_t>(k / kRingStages) & 1);
    run(ring.stage(s), t);
    const long long next = t + kRingStages * step;
    if (next < units) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fill(s, next);
    }
  }
}

// ---- host side ------------------------------------------------------------

// CTAs of `kernel` at `threads` threads and `smem` bytes of dynamic shared
// memory that the current device holds at once.  Asked of the runtime once
// per (kernel, device, threads, smem) and host thread, then read from a
// small cache: a launch costs no occupancy query.  The kernel is opted in
// to all the shared memory a CTA may have, not to `smem`: a later query
// with less would lower the limit that a cached entry's launches need.
inline cudaError_t ring_slots(const void* kernel, int threads, size_t smem, int* slots) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int slots;
  };
  constexpr int kEntries = 16;
  static thread_local Entry cache[kEntries];
  static thread_local int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < used && i < kEntries; ++i) {
    const Entry& c = cache[i];
    if (c.kernel == kernel && c.dev == dev && c.threads == threads && c.smem == smem) {
      *slots = c.slots;
      return cudaSuccess;
    }
  }
  int sms = 0, optin = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
          cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  cache[used++ % kEntries] = {kernel, dev, threads, smem, *slots};
  return cudaSuccess;
}

}  // namespace wgfft
