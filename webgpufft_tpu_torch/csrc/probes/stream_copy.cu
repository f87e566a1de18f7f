// Probe P1: a streaming copy of a contiguous f32 array, optionally times a
// scalar, global memory -> chip -> global memory, three ways.
//
// Replaces, as an experiment, the Pallas copy kernels of
// benches/r12_pallas_dma.py (make_block_copy, make_dma_copy),
// benches/r26_pallas_endgame.py (build_copy) and benches/r2_perf_experiments.py
// (the grid copies and the emit_pipeline copy in main): what does a kernel
// that stages every byte through on-chip memory reach, before it does any
// arithmetic?  On this card that asks whether a shared-memory pipeline fed by
// asynchronous copies comes nearer the memory rate than plain loads and
// stores, which is what overlapping the next lines' load in K1 would buy.
//
// What bounds it: bytes, 8 per element (one read, one write) at 3.35 TB/s.
//
// Modes:
//   0 direct    a CTA per tile; global -> registers -> global, 16 bytes a
//               thread, four loads in flight a thread (the grid copy)
//   1 cp_async  persistent CTAs loop over tiles; global -> shared by
//               cp.async.cg.shared.global 16-byte copies, commit_group /
//               wait_group, shared -> registers -> global; 2 or 4 stages (the
//               emit_pipeline copy and the 2-/4-slot DMA loop).  A thread
//               reads back exactly the 16-byte pieces it copied in, so
//               wait_group alone orders the slot and no CTA barrier is needed.
//   2 bulk      persistent CTAs; one elected thread moves whole tiles with
//               the 1-D bulk copy: cp.async.bulk.shared::cluster.global with
//               mbarrier::complete_tx::bytes in, cp.async.bulk.global.
//               shared::cta.bulk_group out; 2 or 4 stages, a phase bit per
//               stage.  Without a scale no thread touches the data; with one
//               the CTA multiplies the tile in shared memory between the two
//               copies.  A slot is filled again only after its outbound copy
//               has read it (cp.async.bulk.wait_group.read).
//
// The stage (tile) size is an argument: an SM has 227 KB of shared memory, so
// it is decided afresh here, not carried from the TPU's megabyte chunks.
//
// C interface: wgfft_stream_copy returns the cudaError_t of the launch,
// cudaErrorInvalidValue for arguments it cannot run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxShared = 232448;  // 227 KB: what a CTA may opt in to
constexpr int kBarrierBytes = 128;  // room for the stages' mbarriers, keeps the ring aligned

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mode 0 ---------------------------------------------------------------

constexpr int kInFlight = 4;

__global__ void __launch_bounds__(256)
copy_direct(const float4* __restrict__ x, float4* __restrict__ y, long long chunks,
            int tile_chunks, float scale, int use_scale) {
  const long long base = static_cast<long long>(blockIdx.x) * tile_chunks;
  for (int c0 = threadIdx.x; c0 < tile_chunks; c0 += kInFlight * blockDim.x) {
    float4 v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int c = c0 + k * blockDim.x;
      if (c < tile_chunks && base + c < chunks) v[k] = x[base + c];
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int c = c0 + k * blockDim.x;
      if (c < tile_chunks && base + c < chunks)
        y[base + c] = use_scale ? scaled(v[k], scale) : v[k];
    }
  }
}

// ---- mode 1 ---------------------------------------------------------------

template <int STAGES>
__global__ void __launch_bounds__(128)
copy_cp_async(const float4* __restrict__ x, float4* __restrict__ y, long long chunks,
              int tile_chunks, long long tiles, float scale, int use_scale) {
  extern __shared__ float4 ring[];  // STAGES slots of tile_chunks
  // Start the copy of this CTA's k-th tile into slot k % STAGES.  A group is
  // committed even when no tile is left, so that wait_group counts the same
  // in every iteration.
  auto start = [&](long long k) {
    const long long t = blockIdx.x + k * gridDim.x;
    if (t < tiles) {
      float4* slot = ring + (k % STAGES) * tile_chunks;
      const long long base = t * tile_chunks;
      for (int c = threadIdx.x; c < tile_chunks && base + c < chunks; c += blockDim.x)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_addr(slot + c)),
                     "l"(x + base + c)
                     : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int k = 0; k < STAGES - 1; ++k) start(k);
  for (long long k = 0; blockIdx.x + k * gridDim.x < tiles; ++k) {
    // slot (k - 1) % STAGES was read out by this thread in the last iteration
    start(k + STAGES - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
    const float4* slot = ring + (k % STAGES) * tile_chunks;
    const long long base = (blockIdx.x + k * gridDim.x) * tile_chunks;
    for (int c = threadIdx.x; c < tile_chunks && base + c < chunks; c += blockDim.x) {
      const float4 v = slot[c];
      y[base + c] = use_scale ? scaled(v, scale) : v;
    }
  }
}

// ---- mode 2 ---------------------------------------------------------------

__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

template <int STAGES>
__global__ void __launch_bounds__(128)
copy_bulk(const unsigned char* __restrict__ x, unsigned char* __restrict__ y, long long bytes,
          int tile_bytes, long long tiles, float scale, int use_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // one mbarrier a stage
  unsigned char* ring = smem + kBarrierBytes;          // STAGES slots of tile_bytes
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_addr(bars + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Without a scale only the elected thread has anything to do.
  if (!use_scale && threadIdx.x != 0) return;

  auto tile_size = [&](long long t) {
    const long long left = bytes - t * tile_bytes;
    return static_cast<uint32_t>(left < tile_bytes ? left : tile_bytes);
  };
  // Elected thread: arm slot k % STAGES's barrier with the tile's bytes and
  // start the bulk copy of this CTA's k-th tile into it.
  auto load = [&](long long k) {
    const long long t = blockIdx.x + k * gridDim.x;
    if (t >= tiles) return;
    const int slot = static_cast<int>(k % STAGES);
    const uint32_t bar = shared_addr(bars + slot), nb = tile_size(t);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(nb)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(shared_addr(ring + static_cast<size_t>(slot) * tile_bytes)),
        "l"(x + t * tile_bytes), "r"(nb), "r"(bar)
        : "memory");
  };
  if (threadIdx.x == 0)
    for (int k = 0; k < STAGES; ++k) load(k);

  for (long long k = 0; blockIdx.x + k * gridDim.x < tiles; ++k) {
    const long long t = blockIdx.x + k * gridDim.x;
    const int slot = static_cast<int>(k % STAGES);
    unsigned char* tile = ring + static_cast<size_t>(slot) * tile_bytes;
    const uint32_t nb = tile_size(t);
    mbarrier_wait(shared_addr(bars + slot), static_cast<uint32_t>((k / STAGES) & 1));
    if (use_scale) {
      float4* v = reinterpret_cast<float4*>(tile);
      for (uint32_t c = threadIdx.x; c < nb / 16; c += blockDim.x) v[c] = scaled(v[c], scale);
      // these writes must be visible to the bulk copy that reads the tile
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                       y + t * tile_bytes),
                   "r"(shared_addr(tile)), "r"(nb)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (k >= 1) {
        // all outbound copies but the one just started have read their slots:
        // slot (k - 1) % STAGES is free for the tile STAGES further on
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        load(k - 1 + STAGES);
      }
    }
  }
  // shared memory must outlive the outbound copies
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <class Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// count f32 elements from x to y (times scale when use_scale != 0).  x and y
// must be 16-byte aligned and count a multiple of 4; stage_bytes, the tile a
// CTA moves at a time, a multiple of 16.  stages (2 or 4) and ctas (the size
// of the persistent grid) are read by modes 1 and 2 only.
extern "C" int wgfft_stream_copy(const void* x, void* y, long long count, float scale,
                                 int use_scale, int mode, int stages, int stage_bytes, int ctas,
                                 void* stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (count < 4 || count % 4 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16 || stage_bytes < 16 || stage_bytes % 16 ||
      mode < 0 || mode > 2)
    return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long bytes = count * 4, chunks = count / 4;
  const long long tiles = (bytes + stage_bytes - 1) / stage_bytes;
  const int tile_chunks = stage_bytes / 16;
  if (mode == 0) {
    if (tiles > 0x7fffffffLL) return bad;
    copy_direct<<<static_cast<unsigned>(tiles), 256, 0, s>>>(
        static_cast<const float4*>(x), static_cast<float4*>(y), chunks, tile_chunks, scale,
        use_scale);
    return static_cast<int>(cudaGetLastError());
  }
  if ((stages != 2 && stages != 4) || ctas < 1) return bad;
  const size_t smem = static_cast<size_t>(stages) * stage_bytes + (mode == 2 ? kBarrierBytes : 0);
  if (smem > kMaxShared) return bad;
  const unsigned grid = static_cast<unsigned>(tiles < ctas ? tiles : ctas);
  cudaError_t e;
  if (mode == 1) {
    const auto kernel = stages == 2 ? copy_cp_async<2> : copy_cp_async<4>;
    if ((e = opt_in(kernel, smem)) != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, 128, smem, s>>>(static_cast<const float4*>(x), static_cast<float4*>(y),
                                   chunks, tile_chunks, tiles, scale, use_scale);
  } else {
    const auto kernel = stages == 2 ? copy_bulk<2> : copy_bulk<4>;
    if ((e = opt_in(kernel, smem)) != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, use_scale ? 128 : 32, smem, s>>>(
        static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y), bytes, stage_bytes,
        tiles, scale, use_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by a probe's entry point.
extern "C" const char* wgfft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
