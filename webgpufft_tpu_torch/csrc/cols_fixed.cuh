// K2's fixed design: one kernel per height, tile and cluster size, the whole
// chain fixed at compile time (cols_fixed.cu instantiates the entries of
// K2's rule, kFixedCols below; probes/cols_fixed_variants.cu the variants
// measured beside them).  See cols_fixed.cu for the design and
// what it is for.
//
// fixed_cols_kernel<H, TC, T, MINB, C, RX, P...> transforms a tile of TC
// columns (a power of two) of H rows with T threads a CTA, C CTAs a tile:
//
// - C = 1: the passes P... (their radices multiply to H) on the whole tile;
//   the first reads x, the last stores y in natural order, scaled.
// - C > 1 (a thread-block cluster): CTA c holds rows c, c + C, c + 2C, ...
//   (H / C rows) and runs the passes P... (their radices multiply to
//   H / RX) on them in its own shared memory; then the last pass, radix RX
//   (the chain's last entry, which C divides), across the cluster:
//   butterfly j of the points j + r * (H / RX) reads point r from CTA
//   r mod C at local position (r / C) * (H / RX) + j through distributed
//   shared memory and stores rows j + r * (H / RX).  (The Stockham state
//   after the first passes is the DFTs of the rows of each residue class,
//   so each CTA's own passes leave exactly its classes' DFTs: the same
//   strides, the same twiddle entries.)
//
// A pass P = Pass<G...> is one or more consecutive entries of K2's chain
// (radix_chain, which K2's `cw` table is laid out for) run as one
// butterfly of R = G_0 * G_1 * ... points in registers (mixed::Dft of
// lines_mixed.cuh).  Its twiddle W_{NS R}^{r k} (k = j mod NS) is the
// product, over its entries, of the table entries of the chain pass each
// entry is: entry i (stride NS * G_0 * ... * G_{i-1}) at digit d_i of r
// (r = sum d_i * G_{i+1} * ... ) and the same k.  So fewer passes read the
// same table.
//
// Butterfly b of a pass is column b mod TC, index b / TC: neighbouring
// threads take neighbouring columns, so a row's TC points are one run of
// TC * 8 bytes.  The exchange is in the ring's padded layout (stage.cuh,
// `padded` over the tile's row-major index).  Columns past the view's edge
// load zeros and store nothing.  In place (y = x) holds: every read of x
// is in the first pass, and every store comes after a barrier (of the
// cluster, for C > 1) that follows it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lines_mixed.cuh"
#include "radix.cuh"
#include "stage.cuh"

namespace wgfft {

// One K2 launch: the view, its tables, the direction of the launch.
struct ColsCall {
  const float2* x;
  float2* y;
  const float2* tw;
  const float* params;
  long long pre, cols;
  int h;
  float cj;  // +1, or -1 for the adjoint
  cudaStream_t stream;
};

// The fixed design's entries of K2's rule (cols.cuh, cols_rule): each serves height h with tiles of `tile`
// columns split over `cluster` CTAs of `threads` threads, for views of
// `least` to `most` columns in all (pre * cols), on radix_chain(h).
// cols_fixed.cu instantiates entry i as case i of launch_cols_fixed;
// core/fused_cols.py holds the same table (FIXED_COLS).
struct FixedCols {
  int h, tile, cluster, threads;
  long long least, most;
  int count, radix[5];  // the chain the entry's kernel and `cw` are laid out for
};
constexpr long long kAllColumns = 1LL << 40;  // no upper end
constexpr FixedCols kFixedCols[] = {
    {64, 16, 1, 128, 1, kAllColumns, 2, {8, 8}},
    {128, 32, 1, 256, 1, kAllColumns, 2, {16, 8}},
    {256, 8, 1, 128, 1, 1024, 2, {16, 16}},
    {256, 32, 1, 512, 1025, kAllColumns, 2, {16, 16}},
    {360, 16, 1, 384, 1, kAllColumns, 4, {8, 5, 3, 3}},
    {512, 8, 1, 256, 1, kAllColumns, 3, {8, 8, 8}},
    {1024, 8, 1, 512, 1, kAllColumns, 3, {16, 8, 8}},
    {1352, 4, 4, 128, 1, kAllColumns, 3, {13, 13, 8}},
    {2048, 4, 4, 128, 1, 128, 3, {16, 16, 8}},
    {2048, 8, 4, 256, 129, kAllColumns, 3, {16, 16, 8}},
    {2310, 1, 1, 128, 1, kAllColumns, 5, {11, 7, 5, 3, 2}},
    {4096, 4, 8, 128, 1, kAllColumns, 3, {16, 16, 16}},
    {8192, 4, 8, 256, 1, kAllColumns, 4, {16, 8, 8, 8}},
    {16384, 8, 8, 512, 1, 128, 4, {16, 16, 8, 8}},
    {16384, 4, 8, 512, 129, kAllColumns, 4, {16, 16, 8, 8}},
};
constexpr int kFixedEntries = sizeof(kFixedCols) / sizeof(kFixedCols[0]);

// Launches entry `entry` of kFixedCols for `call` (defined in cols_fixed.cu),
// or with `slots` set, only stores how many CTAs (clusters, for a cluster
// of 2 or more) of its kernel the device holds at once.
cudaError_t launch_cols_fixed(const ColsCall& call, int entry, int* slots);

namespace fixed {

template <int... G>
struct Pass {
  static constexpr int R = (G * ... * 1);
  static constexpr int kEntries = sizeof...(G);
  static __host__ __device__ constexpr int entry(int i) {
    constexpr int g[] = {G...};
    return g[i];
  }
};

// Where a tile of the view lives.
struct Tile {
  size_t base;     // offset of (p, row 0, the tile's first column)
  long long cols;  // the row pitch, complex columns
  int left;        // columns from the tile's first to the view's edge (capped)
  int rank;        // this CTA's place in its cluster (0 for C = 1)
};

// v[r] *= W_{NS R}^{r k}, r in [1, R), from the chain's table (above).
template <class P, int NS>
__device__ __forceinline__ void twiddle(float2 (&v)[P::R], const float2* __restrict__ tw, int k) {
  if constexpr (NS > 1) {
#pragma unroll
    for (int r = 1; r < P::R; ++r) {
      float2 w = make_float2(1.f, 0.f);
      bool any = false;
      int rem = r, base = P::R, lvl = NS;
#pragma unroll
      for (int i = 0; i < P::kEntries; ++i) {
        base /= P::entry(i);
        const int d = rem / base;
        rem -= d * base;
        if (d != 0) {
          const float2 t = __ldg(tw + (lvl - 1) + (d - 1) * lvl + k);
          w = any ? cmul(w, t) : t;
          any = true;
        }
        lvl *= P::entry(i);
      }
      v[r] = cmul(v[r], w);
    }
  }
}

// One pass of the CTA's N = H / C rows: FIRST reads x (rows rank + C * pos),
// LAST (C = 1 only) stores y, every other pass reads and writes the
// exchange sm.
template <int N, int TC, int T, int C, class P, int NS, bool FIRST, bool LAST>
__device__ __forceinline__ void pass(const Tile& tile, const float2* __restrict__ x,
                                     float2* __restrict__ y, float2* sm,
                                     const float2* __restrict__ tw, float s, float scale,
                                     float cj) {
  constexpr int R = P::R;
  constexpr int M = N / R;
  constexpr int B = TC * M;
  constexpr int PER = (B + T - 1) / T;
  constexpr bool EVEN = PER * T == B;
  float2 v[PER][R];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = static_cast<int>(threadIdx.x) + q * T;
    if (EVEN || b < B) {
      const int u = b % TC, j = b / TC;
      if constexpr (FIRST) {
        const bool live = u < tile.left;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const size_t row = static_cast<size_t>(tile.rank + C * (j + r * M));
          v[q][r] = live ? x[tile.base + row * tile.cols + u] : make_float2(0.f, 0.f);
          v[q][r].y *= cj;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) v[q][r] = sm[padded((j + r * M) * TC + u)];
        twiddle<P, NS>(v[q], tw, j % NS);
      }
      mixed::Dft<R>::run(v[q], s);
    }
  }
  // every read of this pass is done before it overwrites shared memory; the
  // last pass writes only global memory, read only by the first pass
  if constexpr (!FIRST && !LAST) __syncthreads();
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = static_cast<int>(threadIdx.x) + q * T;
    if (EVEN || b < B) {
      const int u = b % TC, j = b / TC;
      const int k = j % NS;
      const int j0 = (j - k) * R + k;
      if constexpr (LAST) {
        if (u < tile.left) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            y[tile.base + static_cast<size_t>(j0 + r * NS) * tile.cols + u] =
                make_float2(v[q][r].x * scale, v[q][r].y * (scale * cj));
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) sm[padded((j0 + r * NS) * TC + u)] = v[q][r];
      }
    }
  }
  if constexpr (!LAST) __syncthreads();
}

template <int N, int TC, int T, int C, int NS, bool FIRST, class P, class... Rest>
__device__ __forceinline__ void chain(const Tile& tile, const float2* __restrict__ x,
                                      float2* __restrict__ y, float2* sm,
                                      const float2* __restrict__ tw, float s, float scale,
                                      float cj) {
  constexpr bool LAST = sizeof...(Rest) == 0 && C == 1;
  pass<N, TC, T, C, P, NS, FIRST, LAST>(tile, x, y, sm, tw, s, scale, cj);
  if constexpr (sizeof...(Rest) > 0)
    chain<N, TC, T, C, NS * P::R, false, Rest...>(tile, x, y, sm, tw, s, scale, cj);
}

// The last pass across the cluster (radix RX, stride MX = H / RX): this
// CTA's share of butterflies, each reading its RX points from the C CTAs'
// shared memory, storing RX rows of y, scaled.
template <int H, int TC, int T, int C, int RX>
__device__ __forceinline__ void cross(const Tile& tile, float2* __restrict__ y, float2* sm,
                                      const float2* __restrict__ tw, float s, float scale,
                                      float cj) {
  static_assert(RX % C == 0, "the last radix spans the cluster");
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  constexpr int MX = H / RX;
  constexpr int SHARE = (MX + C - 1) / C;
  constexpr int B = SHARE * TC;
  constexpr int PER = (B + T - 1) / T;
  const float2* remote[C];
#pragma unroll
  for (int c = 0; c < C; ++c) remote[c] = cluster.map_shared_rank(sm, c);
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = static_cast<int>(threadIdx.x) + q * T;
    const int u = b % TC, j = tile.rank * SHARE + b / TC;
    if (b < B && j < MX) {
      float2 v[RX];
#pragma unroll
      for (int r = 0; r < RX; ++r) v[r] = remote[r % C][padded(((r / C) * MX + j) * TC + u)];
#pragma unroll
      for (int r = 1; r < RX; ++r) v[r] = cmul(v[r], __ldg(tw + (MX - 1) + (r - 1) * MX + j));
      mixed::Dft<RX>::run(v, s);
      if (u < tile.left) {
#pragma unroll
        for (int r = 0; r < RX; ++r)
          y[tile.base + static_cast<size_t>(j + r * MX) * tile.cols + u] =
              make_float2(v[r].x * scale, v[r].y * (scale * cj));
      }
    }
  }
}

template <int H, int TC, int T, int MINB, int C, int RX, class... P>
__global__ void __launch_bounds__(T, MINB)
fixed_cols_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                  const float2* __restrict__ tw, const float* __restrict__ params, long long cols,
                  long long tiles, float cj) {
  static_assert(sizeof...(P) >= 1 && H % C == 0, "passes, and whole rows a CTA");
  static_assert(C > 1 ? ((P::R * ...) * RX == H && RX % C == 0) : (P::R * ...) == H,
                "the passes multiply to H");
  static_assert(C > 1 || sizeof...(P) >= 2, "two passes or more: y may be x");
  extern __shared__ __align__(16) float2 fixed_smem[];  // H / C rows x TC columns, padded
  const long long t = static_cast<long long>(blockIdx.x) / C;
  const long long p = t / tiles;
  const long long col0 = (t - p * tiles) * TC;
  Tile tile;
  tile.base = static_cast<size_t>(p) * H * cols + col0;
  tile.cols = cols;
  tile.left = cols - col0 < TC ? static_cast<int>(cols - col0) : TC;
  tile.rank = C > 1 ? static_cast<int>(blockIdx.x % C) : 0;
  const float scale = __ldg(params);
  const float s = __ldg(params + 1);
  chain<H / C, TC, T, C, 1, true, P...>(tile, x, y, fixed_smem, tw, s, scale, cj);
  if constexpr (C > 1) {
    namespace cg = cooperative_groups;
    const cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA's rows are in its shared memory, every read of x done
    cross<H, TC, T, C, RX>(tile, y, fixed_smem, tw, s, scale, cj);
    cluster.sync();  // no CTA exits while another reads its shared memory
  }
}

// Launch fixed_cols_kernel<H, TC, T, MINB, C, RX, P...> over a (pre, H, cols)
// view (C > 1: cudaLaunchKernelEx with the cluster dimension and
// load-balancing cluster scheduling); with `slots` set, only store how many
// CTAs (clusters, for C > 1) of it the device holds at once.
template <int H, int TC, int T, int MINB, int C, int RX, class... P>
cudaError_t launch(const float2* x, float2* y, const float2* tw, const float* params,
                   long long pre, long long cols, float cj, cudaStream_t stream, int* slots) {
  auto* const kernel = &fixed_cols_kernel<H, TC, T, MINB, C, RX, P...>;
  constexpr int smem = ring_stage_points(H / C * TC) * static_cast<int>(sizeof(float2));
  static_assert(smem <= kRingShared, "a CTA's rows fit its shared memory");
  const long long tiles = (cols + TC - 1) / TC;
  const long long grid = pre * tiles * C;
  if (grid < 1 || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if constexpr (C == 1) {
    if (slots != nullptr) {
      int dev = 0, sms = 0, per_sm = 0;
      if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
          (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
          (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T, smem)) !=
              cudaSuccess)
        return e;
      *slots = per_sm * sms;
      return cudaSuccess;
    }
    kernel<<<static_cast<unsigned>(grid), T, smem, stream>>>(x, y, tw, params, cols, tiles, cj);
    return cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(grid), 1, 1);
    cfg.blockDim = dim3(T, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = C;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
    attrs[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicyLoadBalancing;
    cfg.attrs = attrs;
    cfg.numAttrs = 2;
    if (slots != nullptr) return cudaOccupancyMaxActiveClusters(slots, kernel, &cfg);
    e = cudaLaunchKernelEx(&cfg, kernel, x, y, tw, params, cols, tiles, cj);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
}

}  // namespace fixed
}  // namespace wgfft
