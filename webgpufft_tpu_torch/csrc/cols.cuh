// K2 (fused_cols.cu) and what it decides on the host before it launches,
// shared with the probe kernels that launch one of K2's designs by name
// (probes/cols_variants.cu): the tile a CTA takes, where a point of it
// lives, which design and which kernel instantiation serve a chain.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "cols_fixed.cuh"
#include "cols_general.cuh"
#include "radix.cuh"
#include "stage.cuh"

namespace wgfft {

constexpr int kMaxTileElems = 16384;  // H * tc of the direct design's tile: 128 KB of float2

struct ColsLayout {
  static constexpr bool kStaged = false;
  size_t base;      // offset of (p, row 0, first column of the tile)
  long long cols;   // complex columns in the view: the row pitch
  long long left;   // columns from the tile's first to the view's edge
  int tc;           // columns in a tile, a power of two
  int shift;        // log2(tc)

  __device__ __forceinline__ int units() const { return tc; }
  __device__ __forceinline__ void split(int b, int, int& u, int& j) const {
    j = b >> shift;
    u = b & (tc - 1);
  }
  __device__ __forceinline__ bool live(int u) const { return u < left; }
  __device__ __forceinline__ size_t global(int u, int pos) const {
    return base + static_cast<size_t>(pos) * cols + u;
  }
  __device__ __forceinline__ int shared(int u, int pos) const { return pos * tc + u; }

  // Point the layout at tile t of a (pre, h, cols) view cut into `tiles`
  // tiles a pre index.
  __device__ __forceinline__ void at(long long t, long long tiles, int h) {
    const long long p = t / tiles;
    const long long col0 = (t - p * tiles) * tc;
    base = static_cast<size_t>(p) * h * cols + col0;
    left = cols - col0;
  }
};

// A K2 tile in a ring stage (stage.cuh): landed row by row in position
// order, exchanged in the padded layout (one point in 16 over the tile's
// row-major index, which also spreads the rows of a tile narrower than 16
// columns over the banks).
struct StagedCols : ColsLayout {
  static constexpr bool kStaged = true;
  __device__ __forceinline__ int landed(int u, int pos) const { return pos * tc + u; }
  __device__ __forceinline__ int shared(int u, int pos) const { return padded(pos * tc + u); }
};

struct ColsShape {
  int tc, shift;     // columns in a tile (a power of two) and its log2
  int e;             // points a thread holds
  int threads;
  long long tiles;   // tiles a pre index
};

// The direct design's tile: 16 columns (32 for a one-pass chain, which
// holds no tile), shrunk so that H * tc <= kMaxTileElems and no wider than
// the columns.
inline int cols_tile_direct(const Chain& chain, int h, long long cols) {
  int tc = chain.count > 1 ? 16 : 32;
  while (tc > 1 && h * tc > kMaxTileElems) tc >>= 1;
  while (tc > 1 && tc / 2 >= cols) tc >>= 1;
  return tc;
}

// The ring's tile: the direct design's, narrowed until two stages of it fit
// a CTA; 0 where none does or the chain has one pass.
inline int cols_tile_ring(const Chain& chain, int h, long long cols) {
  int tc = cols_tile_direct(chain, h, cols);
  while (tc > 1 && !ring_fits(h * tc)) tc >>= 1;
  return chain.count >= 2 && ring_fits(h * tc) ? tc : 0;
}

// The CTA shape for tiles of tc columns: the least of 8, 16, 32 points a
// thread that fits the tile's widest pass into 512 threads (1024 as the
// last resort).
inline bool cols_shape(const Chain& chain, int h, long long cols, int tc, ColsShape* out) {
  if (tc < 1) return false;
  int shift = 0;
  while ((1 << shift) < tc) ++shift;
  int e = 8;
  int t = threads_needed(chain, h, e, tc);
  while (t > 512 && e < 32) {
    e *= 2;
    t = threads_needed(chain, h, e, tc);
  }
  if (t > 1024) return false;
  out->tc = tc;
  out->shift = shift;
  out->e = e;
  out->threads = (t + 31) / 32 * 32;
  out->tiles = (cols + tc - 1) / tc;
  return true;
}

// One kernel per radix set, points per thread and thread limit.  Every one
// gets 128 registers a thread (two CTAs of 256 threads, or one of 512, on an
// SM): a radix-16 butterfly with its sixteen row addresses does not fit 64
// unspilled, and this kernel measured faster unspilled at half the occupancy
// than spilled at full.  `f.run<E, MAXT, MINB, SET>()` launches the
// instantiation chosen.
template <int SET, class F>
cudaError_t dispatch_cols_set(const ColsShape& shape, const F& f) {
  if (shape.threads > 512) return f.template run<32, 1024, 1, SET>();
  if (shape.e == 8 && shape.threads <= 256) return f.template run<8, 256, 2, SET>();
  if (shape.e == 8) return f.template run<8, 512, 1, SET>();
  if (shape.e == 16) return f.template run<16, 512, 1, SET>();
  return f.template run<32, 512, 1, SET>();
}

template <class F>
cudaError_t dispatch_cols(const Chain& chain, const ColsShape& shape, const F& f) {
  switch (radix_set(chain)) {
    case kSetPow2: return dispatch_cols_set<kSetPow2>(shape, f);
    case kSetSmall: return dispatch_cols_set<kSetSmall>(shape, f);
    default: return dispatch_cols_set<kSetAll>(shape, f);
  }
}

}  // namespace wgfft

// ---- K2's designs ---------------------------------------------------------
//
// In an anonymous namespace, as K1's (lines.cuh): each library instantiates
// its own copies.

namespace {

using wgfft::Chain;
using wgfft::ColsShape;

// The direct design: one CTA a tile; the first pass loads global memory into
// registers, the last stores registers to global memory.
template <int E, int MAXT, int MINB, int SET>
__global__ void __launch_bounds__(MAXT, MINB)
fused_cols_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                  const float2* __restrict__ tw, const float* __restrict__ params, int h,
                  long long cols, int tc, int shift, long long tiles, const Chain chain,
                  float cj) {
  extern __shared__ float2 sm[];  // H rows x tc columns
  const long long p = blockIdx.x / tiles;
  const long long col0 = (blockIdx.x % tiles) * tc;
  wgfft::ColsLayout lay;
  lay.base = static_cast<size_t>(p) * h * cols + col0;
  lay.cols = cols;
  lay.left = cols - col0;
  lay.tc = tc;
  lay.shift = shift;
  wgfft::radix_chain<E, SET>(lay, x, y, sm, tw, params, h, chain, cj);
}

// How a ring tile lands (the shape rule of stage.cuh, chosen per launch):
// a tensor map (one thread starts boxes of up to kBoxRows rows by tc
// columns), cp.async of 16 bytes (two columns) or of 8 bytes (one).
enum ColsCopy { kCopyTensor = 0, kCopy16 = 1, kCopy8 = 2 };
constexpr int kBoxRows = 256;  // the most rows a tensor-map box may have

// The ring design (stage.cuh): a persistent CTA walks the tiles (tile t =
// pre index t / tiles, columns (t % tiles) * tc on); the next tile lands
// by `copy` while this one runs its passes.  `map` is read by kCopyTensor
// only.
template <int E, int MAXT, int MINB, int SET>
__global__ void __launch_bounds__(MAXT, MINB)
cols_ring_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                 const float2* __restrict__ tw, const float* __restrict__ params, int h,
                 long long cols, int tc, int shift, long long tiles, long long units,
                 const Chain chain, float cj, int copy,
                 const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  const wgfft::Ring ring(ring_smem, h * tc);
  ring.init();
  wgfft::StagedCols lay;
  lay.cols = cols;
  lay.tc = tc;
  lay.shift = shift;
  const int box_rows = h < kBoxRows ? h : kBoxRows;
  wgfft::ring_walk(
      ring, units,
      [&](int s, long long t) {
        wgfft::StagedCols at = lay;
        at.at(t, tiles, h);
        float2* dst = ring.stage(s);
        if (copy == kCopyTensor) {
          if (threadIdx.x != 0) {
            ring.arrive(s);
            return;
          }
          const long long p = t / tiles;
          const int col0 = static_cast<int>(cols - at.left);
          ring.arrive_expect(s, static_cast<uint32_t>(h) * tc * sizeof(float2));
          for (int r0 = 0; r0 < h; r0 += box_rows)
            asm volatile(
                "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
                "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(wgfft::smem_addr(dst + r0 * tc)),
                "l"(reinterpret_cast<uint64_t>(&map)), "r"(col0), "r"(r0),
                "r"(static_cast<int>(p)), "r"(ring.bar(s))
                : "memory");
          return;
        }
        if (copy == kCopy16) {
          const int half = tc >> 1;  // 16-byte pieces a row
          for (int i = threadIdx.x; i < h * half; i += blockDim.x) {
            const int row = i >> (shift - 1), c = (i & (half - 1)) * 2;
            const bool live = c < at.left;
            wgfft::copy16(dst + row * tc + c, live ? x + at.global(c, row) : x, live);
          }
        } else {
          for (int i = threadIdx.x; i < h * tc; i += blockDim.x) {
            const int row = i >> shift, c = i & (tc - 1);
            const bool live = c < at.left;
            wgfft::copy8(dst + i, live ? x + at.global(c, row) : x, live);
          }
        }
        ring.async_arrive(s);
      },
      [&](float2* stage, long long t) {
        lay.at(t, tiles, h);
        wgfft::radix_chain<E, SET>(lay, x, y, stage, tw, params, h, chain, cj);
      });
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (the library does not link libcuda); null where it is missing.
inline EncodeTiled encode_tiled() {
  static void* fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
#endif
  }
  return reinterpret_cast<EncodeTiled>(fn);
}

// The copy a ring tile of `shape` over a (pre, h, cols) view at x takes: a
// tensor map where rows are 16-byte aligned (an even column count at a
// 16-byte aligned address), tiles are whole and two columns or more, and
// the box rows divide h; else 16-byte cp.async where rows are aligned and
// tiles two columns or more; else 8-byte cp.async.
inline int cols_copy(const void* x, long long pre, int h, long long cols,
                     const ColsShape& shape, bool async_only) {
  const bool rows16 = cols % 2 == 0 && wgfft::aligned16(x) && shape.tc >= 2;
  const int box_rows = h < kBoxRows ? h : kBoxRows;
  if (!async_only && rows16 && cols % shape.tc == 0 && h % box_rows == 0 &&
      cols <= 0x7fffffffLL && pre <= 0x7fffffffLL)
    return kCopyTensor;
  return rows16 ? kCopy16 : kCopy8;
}

// The tensor map of a (pre, h, cols) view of float2 at x, in boxes of
// tc columns by up to kBoxRows rows.
inline cudaError_t cols_map(const void* x, long long pre, int h, long long cols, int tc,
                            CUtensorMap* map) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(pre)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * sizeof(float2),
                                 static_cast<cuuint64_t>(cols) * h * sizeof(float2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(tc),
                             static_cast<cuuint32_t>(h < kBoxRows ? h : kBoxRows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3, const_cast<void*>(x), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

enum ColsDesign {
  kColsDirect = 0,
  kColsRing = 1,
  kColsRingAsync = 2,
  kColsFixed = 3,
  kColsGeneral = 4
};

// The choice by the tile alone, the rule's starting point: the ring
// where the direct design's tile holds kRingMinPoints points or more (H >=
// 512 at 16 columns: one tile fills a CTA and the CTA an SM), two stages of
// the ring's tile fit, and the ring's tile keeps kRingMinCols columns (a
// 32-byte sector a row) or the direct tile's width; the direct design
// elsewhere.
constexpr int kRingMinCols = 4;

inline int cols_design(const Chain& chain, int h, long long cols) {
  const int old = wgfft::cols_tile_direct(chain, h, cols);
  const int tc = wgfft::cols_tile_ring(chain, h, cols);
  return static_cast<long long>(h) * old >= wgfft::kRingMinPoints && tc > 0 &&
                 tc >= (old < kRingMinCols ? old : kRingMinCols)
             ? kColsRing
             : kColsDirect;
}

// What K2 launches for a view.
struct ColsPlan {
  int design;       // ColsDesign
  int entry;        // the kFixedCols (kColsFixed) or kGeneralCols (kColsGeneral) entry, else -1
  ColsShape shape;  // the direct or ring design's CTA shape
  int tile, cluster, threads;
  long long units;  // tiles: pre * ceil(cols / tile)
  long long grid;   // CTAs launched: units * cluster; the ring's at most one an SM
};

// The direct design or the ring (either ring design) for a view, with tiles
// of `tile` columns (a power of two; 0: the design's own tile, the direct
// design's or the ring's) in cols_shape's CTA shape; the ring's grid is
// left for the caller.  (A ring CTA of 32 points a thread, up to 256
// threads of 255 registers, measured 6 % slower at H = 1024: PERF.md.)
inline bool cols_plan(const Chain& chain, int h, long long pre, long long cols, int design,
                      int tile, ColsPlan* out) {
  if (pre < 1 || cols < 1 || tile < 0 || (tile & (tile - 1)) || design == kColsFixed)
    return false;
  const bool ring = design != kColsDirect;
  int tc = tile;
  if (tc == 0)
    tc = ring ? wgfft::cols_tile_ring(chain, h, cols) : wgfft::cols_tile_direct(chain, h, cols);
  if (ring && (chain.count < 2 || !wgfft::ring_fits(h * tc))) return false;
  if (!ring && chain.count > 1 &&
      static_cast<size_t>(h) * tc * sizeof(float2) > static_cast<size_t>(wgfft::kRingShared))
    return false;
  if (!wgfft::cols_shape(chain, h, cols, tc, &out->shape)) return false;
  out->design = design;
  out->entry = -1;
  out->tile = tc;
  out->cluster = 1;
  out->threads = out->shape.threads;
  out->units = pre * out->shape.tiles;
  out->grid = out->units;
  return out->units <= 0x7fffffffLL;
}

// Whether `chain` is radix[0, count): the chain a table entry's kernel and
// `cw` are laid out for.
inline bool same_chain(const Chain& chain, const int* radix, int count) {
  bool same = count == chain.count;
  for (int p = 0; same && p < count; ++p) same = radix[p] == chain.radix[p];
  return same;
}

// K2's rule (core/fused_cols.py, cols_rule, is the same rule in Python; a
// test on the card holds the two equal): what the plans' entry point
// launches for a (pre, h, cols) view on a device of `sms` SMs.  A height of
// kFixedCols whose view's columns in all fall in an entry's range runs that
// entry (and must come with the entry's chain); else a height of
// kGeneralCols runs its entry for the view's columns in all (and must come
// with the entry's chain, cols_chain); every other view runs the direct
// design or the ring at its own tile, the ring on one CTA an SM.
inline bool cols_rule(const Chain& chain, int h, long long pre, long long cols, int sms,
                      ColsPlan* out) {
  if (sms < 1 || pre < 1 || cols < 1) return false;
  for (int i = 0; i < wgfft::kFixedEntries; ++i) {
    const wgfft::FixedCols& f = wgfft::kFixedCols[i];
    if (f.h != h) continue;
    // the entry's kernel reads a `cw` laid out for its chain
    if (!same_chain(chain, f.radix, f.count)) return false;
    if (pre * cols < f.least || pre * cols > f.most) continue;
    out->design = kColsFixed;
    out->entry = i;
    out->tile = f.tile;
    out->cluster = f.cluster;
    out->threads = f.threads;
    out->units = pre * ((cols + f.tile - 1) / f.tile);
    out->grid = out->units * f.cluster;
    return out->grid <= 0x7fffffffLL;
  }
  const int g = wgfft::general_cols_entry(h, pre * cols);
  if (g != -1) {
    if (g < 0) return false;
    const wgfft::GeneralCols& e = wgfft::kGeneralCols[g];
    wgfft::general_cols::Plan plan;
    int threads = 0, smem = 0;
    if (!same_chain(chain, e.radix, e.count) ||
        !wgfft::general_cols::make_plan(h, e.radix, e.count, e.points, e.tile, &plan, &threads,
                                        &smem))
      return false;
    out->design = kColsGeneral;
    out->entry = g;
    out->tile = e.tile;
    out->cluster = 1;
    out->threads = threads;
    out->units = pre * ((cols + e.tile - 1) / e.tile);
    out->grid = out->units;
    return out->grid <= 0x7fffffffLL;
  }
  if (!cols_plan(chain, h, pre, cols, cols_design(chain, h, cols), 0, out)) return false;
  if (out->design == kColsRing && out->grid > sms) out->grid = sms;
  return true;
}

// Launches the direct design or the ring (kColsRingAsync: cp.async for every
// tile, the tensor map never) with the instantiation `dispatch_cols` picks,
// the ring on a persistent grid of `grid` CTAs; with `slots` set, only
// stores how many CTAs of that instantiation the device holds at once.
struct LaunchCols {
  const wgfft::ColsCall& call;
  const Chain& chain;
  const ColsShape& shape;
  int design;
  long long grid;
  int* slots;

  template <int E, int MAXT, int MINB, int SET>
  cudaError_t run() const {
    const float2* x = call.x;
    float2* y = call.y;
    const long long pre = call.pre, cols = call.cols;
    const int h = call.h;
    const long long units = pre * shape.tiles;
    if (design == kColsDirect) {
      const size_t smem =
          chain.count > 1 ? static_cast<size_t>(h) * shape.tc * sizeof(float2) : 0;
      const auto kernel = fused_cols_kernel<E, MAXT, MINB, SET>;
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return e;
      }
      if (slots != nullptr)
        return wgfft::ring_slots(reinterpret_cast<const void*>(kernel), shape.threads, smem,
                                 slots);
      kernel<<<static_cast<unsigned>(units), shape.threads, smem, call.stream>>>(
          x, y, call.tw, call.params, h, cols, shape.tc, shape.shift, shape.tiles, chain,
          call.cj);
      return cudaGetLastError();
    }
    const auto kernel = cols_ring_kernel<E, MAXT, MINB, SET>;
    const size_t smem = wgfft::ring_shared_bytes(h * shape.tc);
    int g = 0;
    cudaError_t e =
        wgfft::ring_slots(reinterpret_cast<const void*>(kernel), shape.threads, smem, &g);
    if (e != cudaSuccess || slots != nullptr) {
      if (slots != nullptr) *slots = g;
      return e;
    }
    const int copy = cols_copy(x, pre, h, cols, shape, design == kColsRingAsync);
    CUtensorMap map = {};
    if (copy == kCopyTensor && (e = cols_map(x, pre, h, cols, shape.tc, &map)) != cudaSuccess)
      return e;
    kernel<<<static_cast<unsigned>(grid), shape.threads, smem, call.stream>>>(
        x, y, call.tw, call.params, h, cols, shape.tc, shape.shift, shape.tiles, units, chain,
        call.cj, copy, map);
    return cudaGetLastError();
  }
};

// Launches `plan` (the fixed design through launch_cols_fixed; not the
// general design, which fused_cols.cu launches through launch_cols_general,
// so that the probes' library, which shares this header, builds none of
// its kernels), the ring on plan.grid CTAs; with `slots` set, only stores
// how many CTAs (clusters, for a fixed entry of a cluster of 2 or more) of
// its kernel the device holds at once.
inline cudaError_t launch_cols(const wgfft::ColsCall& call, const Chain& chain,
                               const ColsPlan& plan, int* slots) {
  if (plan.design == kColsFixed) return wgfft::launch_cols_fixed(call, plan.entry, slots);
  const LaunchCols f = {call, chain, plan.shape, plan.design, plan.grid, slots};
  return wgfft::dispatch_cols(chain, plan.shape, f);
}

}  // namespace
