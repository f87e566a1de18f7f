// K1's and K2's cluster design: the general design's run-time chain (two to
// four passes of radices up to 32) split over a thread-block cluster of C =
// 2, 4 or 8 CTAs, for the lengths and heights from 11583 whose two exchange
// buffers no single CTA holds (CLUSTER_LINES and CLUSTER_COLS, below).  See
// cluster.cu for what it is for and how a length enters the tables.
//
// cluster_kernel<E, MAXT> transforms the H rows of a tile of tc columns of a
// (pre, H, cols) view (tc a power of two; K1 is the view (lines, N, 1) with
// tc = 1, a line a tile) with the C CTAs of one cluster, on the Stockham
// chain R0 * R1 * ... = H (radix.cuh):
//
// - the first pass crosses the cluster.  Its butterfly j in [0, M0), M0 =
//   H / R0, reads rows j + r * M0 (no twiddle) and writes output q to
//   Stockham position q + R0 * j.  CTA c runs butterflies [c S, (c + 1) S),
//   S = ceil(M0 / C), so its loads are runs along j of the view's rows (for
//   K1, runs of S points of a line), and sends output q to the CTA that owns
//   class q: CTA c owns classes [lo(c), lo(c + 1)), lo(c) = c R0 / C (Q_c =
//   lo(c + 1) - lo(c) of them, one more on some CTAs where C does not
//   divide R0: 11, 13, 25, 27 have no factor 2), at local position
//   (q - lo(c)) + Q_c j, through distributed shared memory;
// - every later pass keeps a position's class (position mod R0): pass p
//   reads and writes only positions of the same residue mod R0 as its
//   butterfly's k = j mod ns.  So each CTA runs passes 1 .. count - 1 on its
//   own Q_c * M0 points, in its own shared memory, as the Stockham chain of
//   local stride ns_l = Q_c ns / R0 (ns the chain's own), with the twiddle
//   entry of the chain's k = lo(c) + (k_l mod Q_c) + R0 (k_l div Q_c) (the
//   same `cw` table, laid out for the chain, as every other design), and
//   the last pass stores global row k + ns (t R + r) of its butterfly
//   (k_l, t), scaled: runs of Q_c points a line for K1.
//
// The passes are the general design's (lines_general.cuh): a __noinline__
// body a radix (and, for the first pass, a cluster size, so that the owner
// of each output is a constant), dispatched by a switch uniform across the
// CTA, one butterfly at a time, two exchange buffers in turn with one
// barrier a pass.  Or, in the kernel built for two CTAs an SM (CTAS = 2,
// half the threads at the same registers a thread), ONE exchange buffer:
// the first pass lands in it, each later pass but the last runs in place
// (`held`: a thread loads and runs all of its butterflies of the pass, the
// CTA passes a barrier, then it stores them), and the last reads it and
// stores to y; so a CTA takes half the shared memory, and one CTA's loads
// and crossing run beside another's passes on the same SM.  Every thread
// arrives at a cluster barrier first and waits
// on it after its first loads, before its first store to another CTA (no
// CTA writes another's shared memory before that one runs); a cluster sync
// follows the first pass (every class landed and every read of x done: y
// may be x); no CTA touches another's shared memory after that, so a CTA
// may exit when its passes are done.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cols_fixed.cuh"
#include "lines.cuh"
#include "lines_general.cuh"
#include "lines_mixed.cuh"
#include "radix.cuh"

namespace wgfft {

// K1's cluster design's table, one entry a length: X(N, points a thread
// (24, 32 or 64: the kernel's class), CTAs an SM the kernel is built for
// (1: two exchange buffers; 2: one, the middle passes in place), CTAs a
// cluster, chain...),
// the chain's first radix across the cluster.  Generated from the sweep's
// winners (chip_probes/k1_general_variants.py --cluster --fit); the plans'
// chain and `cw` of these lengths (core/radix.py CLUSTER_LINES, which reads
// this table, and lines_chain).
#define WGFFT_CLUSTER_LINES(X) \
  X(11583, 32, 1, 4, 11, 13, 9, 9) X(11858, 24, 1, 4, 11, 22, 7, 7)                              \
  X(11979, 32, 1, 4, 11, 11, 11, 9) X(12375, 24, 1, 2, 15, 15, 11, 5)                            \
  X(12705, 32, 1, 2, 21, 11, 11, 5) X(12870, 32, 1, 2, 11, 15, 13, 6)                            \
  X(13310, 24, 1, 2, 22, 11, 11, 5) X(13689, 32, 1, 2, 13, 13, 9, 9)                             \
  X(14157, 32, 1, 2, 11, 13, 11, 9) X(14336, 32, 2, 2, 16, 32, 28)                               \
  X(14520, 32, 1, 2, 22, 30, 22) X(14625, 32, 2, 4, 13, 15, 15, 5)                               \
  X(14641, 32, 1, 2, 11, 11, 11, 11) X(14742, 32, 1, 2, 26, 27, 21)                              \
  X(14976, 32, 1, 2, 24, 26, 24) X(15000, 32, 1, 2, 24, 25, 25) X(15120, 32, 1, 2, 24, 30, 21)   \
  X(15125, 32, 1, 2, 25, 11, 11, 5) X(15246, 32, 1, 2, 14, 11, 11, 9)                            \
  X(15488, 32, 1, 2, 32, 22, 22) X(15625, 64, 2, 2, 25, 25, 25) X(15750, 32, 1, 2, 30, 25, 21)   \
  X(15876, 32, 1, 2, 21, 28, 27) X(16000, 32, 1, 2, 32, 25, 20) X(16128, 32, 1, 2, 24, 28, 24)

// K2's: X(H, least, most columns in all (pre * cols) of the views it serves,
// points a thread, the tile's columns, CTAs a cluster, chain...); every
// entry of a height has the same chain and together they cover every column
// count (core/fused_cols.py CLUSTER_COLS reads it; cols_chain).
#define WGFFT_CLUSTER_COLS(X) \
  X(11583, 1, 128, 32, 1, 2, 11, 13, 9, 9) X(11583, 129, kAllColumns, 32, 2, 4, 11, 13, 9, 9)    \
  X(11858, 1, 128, 24, 2, 8, 22, 11, 7, 7) X(11858, 129, kAllColumns, 24, 4, 8, 22, 11, 7, 7)    \
  X(11979, 1, 128, 24, 1, 2, 9, 11, 11, 11) X(11979, 129, kAllColumns, 32, 2, 4, 9, 11, 11, 11)  \
  X(12375, 1, 128, 32, 1, 2, 11, 25, 9, 5) X(12375, 129, kAllColumns, 32, 2, 4, 11, 25, 9, 5)    \
  X(12705, 1, kAllColumns, 32, 4, 8, 21, 11, 11, 5) X(12870, 1, 128, 32, 1, 2, 10, 13, 11, 9)    \
  X(12870, 129, kAllColumns, 32, 2, 4, 10, 13, 11, 9) X(13310, 1, 128, 32, 4, 8, 22, 11, 11, 5)  \
  X(13310, 129, kAllColumns, 24, 4, 8, 22, 11, 11, 5) X(13689, 1, 128, 32, 1, 2, 9, 13, 13, 9)   \
  X(13689, 129, kAllColumns, 32, 2, 4, 9, 13, 13, 9) X(14157, 1, 128, 32, 1, 2, 13, 11, 11, 9)   \
  X(14157, 129, kAllColumns, 32, 2, 4, 13, 11, 11, 9) X(14336, 1, 128, 32, 4, 4, 28, 32, 16)     \
  X(14336, 129, kAllColumns, 32, 4, 8, 28, 32, 16)                                               \
  X(14520, 1, kAllColumns, 32, 4, 8, 22, 30, 22) X(14625, 1, 128, 32, 1, 2, 13, 15, 15, 5)       \
  X(14625, 129, kAllColumns, 32, 2, 4, 13, 15, 15, 5)                                            \
  X(14641, 1, 128, 32, 1, 2, 11, 11, 11, 11)                                                     \
  X(14641, 129, kAllColumns, 32, 2, 4, 11, 11, 11, 11)                                           \
  X(14742, 1, kAllColumns, 32, 4, 8, 21, 27, 26) X(14976, 1, 128, 32, 2, 8, 24, 26, 24)          \
  X(14976, 129, kAllColumns, 32, 4, 8, 24, 26, 24) X(15000, 1, 128, 32, 2, 8, 24, 25, 25)        \
  X(15000, 129, kAllColumns, 32, 4, 8, 24, 25, 25)                                               \
  X(15120, 1, kAllColumns, 32, 4, 8, 24, 30, 21)                                                 \
  X(15125, 1, kAllColumns, 32, 4, 8, 25, 11, 11, 5)                                              \
  X(15246, 1, kAllColumns, 24, 4, 8, 18, 11, 11, 7)                                              \
  X(15360, 1, kAllColumns, 32, 4, 8, 24, 32, 20) X(15488, 1, kAllColumns, 32, 4, 8, 22, 32, 22)  \
  X(15625, 1, kAllColumns, 32, 4, 8, 25, 25, 25) X(15750, 1, kAllColumns, 32, 4, 8, 21, 30, 25)  \
  X(15876, 1, kAllColumns, 32, 4, 8, 27, 28, 21) X(16000, 1, kAllColumns, 32, 4, 8, 20, 32, 25)  \
  X(16128, 1, kAllColumns, 32, 4, 8, 24, 28, 24)

namespace cluster {

constexpr int kMaxTile = 64;       // columns a tile
constexpr int kMaxShared = 227 * 1024;

// The cluster sizes the design has a kernel for.
__host__ __device__ constexpr bool cluster_size(int c) { return c == 2 || c == 4 || c == 8; }

// The classes of E points a thread the design has a kernel for and the
// most threads a CTA of each (core/radix.py CLUSTER_CLASSES), which sets
// the registers a thread may have (__launch_bounds__): 128 at 24 and 32
// points (the general design's 24-point class allows 640 threads and 96
// registers, where this design's first pass, which holds an address a CTA
// of the cluster beside its butterfly, spilled), 184 at 64.  The kernel
// built for `ctas` = 2 CTAs an SM has half as many threads, so the same
// registers a thread, at 32 and 64 points (at 24 points it won at no length
// of the sweep and was left out).
constexpr int max_threads(int e, int ctas = 1) {
  return ctas == 1 ? (e == 24 || e == 32 ? 512 : e == 64 ? 352 : 0)
         : ctas == 2 ? (e == 32 ? 256 : e == 64 ? 176 : 0)
                     : 0;
}

// Classes [lo(c), lo(c) + Q_c) of the first pass's R0 outputs that CTA c of
// C owns.
__host__ __device__ constexpr int class_lo(int c, int r0, int clusters) {
  return c * r0 / clusters;
}

// A local pass, in the frame of the CTA's own points.
struct Pass {
  int radix;
  int ns;             // the local stride: Q ns' / R0, ns' the chain's own
  int m;              // the CTA's points / radix
  int gns;            // the chain's stride at this pass (ns')
  unsigned ns_magic;  // j / ns
  unsigned pad_in;    // pos / period of the exchange the pass reads (0: none)
  unsigned pad_out;   // ... and of the one it writes
};

// What a CTA of Q classes runs after the first pass.
struct Side {
  int q;
  unsigned q_magic;   // k_l / Q
  Pass pass[general::kMaxPasses - 1];
};

// What a launch runs: passed by value, so every field is a kernel parameter.
struct Plan {
  int h;
  int tc, shift;      // columns a tile (a power of two) and its log2
  int clusters;       // C
  int count;          // passes, the first across the cluster
  int r0;             // the first pass's radix
  int m0;             // h / r0
  int share;          // the first pass's butterflies a CTA runs: ceil(m0 / C)
  int pitch;          // rows an exchange buffer holds, padding included
  int pad;            // the first pass pads its writes (tc < 16)
  long long tiles;    // tiles a pre index
  Side side[2];       // Q = floor(R0 / C) and ceil(R0 / C)
};

// Pass p (1 .. 3) of side `big` of the plan, read with constant offsets (a
// run-time index into a parameter, or a Side chosen at run time and held,
// copies the plan to local memory)
__device__ __forceinline__ Pass pass_at(const Plan& plan, bool big, int p) {
  return big ? (p == 1 ? plan.side[1].pass[0] : p == 2 ? plan.side[1].pass[1]
                                                      : plan.side[1].pass[2])
             : (p == 1 ? plan.side[0].pass[0] : p == 2 ? plan.side[0].pass[1]
                                                      : plan.side[0].pass[2]);
}

// The plan of `chain` down a height-h tile of `tile` columns split over
// `clusters` CTAs, E = `points` points a thread, in the kernel built for
// `ctas` CTAs an SM; its threads and shared memory.  False where the design
// cannot run it: not two to four passes of the class's radices that
// multiply to h, a cluster size it has no kernel for, a first radix under
// 2 C (a CTA holds two classes or more), a tile that is no power of two up
// to kMaxTile, too many threads for the class, or more shared memory than a
// CTA may have (two exchange buffers, one for two passes or two CTAs an SM).
inline bool make_plan(int h, const int* radices, int count, int points, int tile, int clusters,
                      Plan* plan, int* threads, int* smem, int ctas = 1) {
  const int limit = max_threads(points, ctas);
  if (count < 2 || count > general::kMaxPasses || limit == 0 || tile < 1 || tile > kMaxTile ||
      (tile & (tile - 1)) || h < 4 || h > kMaxLength || !cluster_size(clusters))
    return false;
  long long prod = 1;
  for (int p = 0; p < count; ++p) {
    if (!general::takes(points, radices[p])) return false;
    prod *= radices[p];
    if (prod > h) return false;
  }
  if (prod != h || radices[0] < 2 * clusters) return false;
  *plan = {};
  plan->h = h;
  plan->tc = tile;
  while ((1 << plan->shift) < tile) ++plan->shift;
  plan->clusters = clusters;
  plan->count = count;
  plan->r0 = radices[0];
  plan->m0 = h / radices[0];
  plan->share = (plan->m0 + clusters - 1) / clusters;
  // a row of padding pays only where a half-warp's accesses span rows
  const bool pad = tile < 16;
  plan->pad = pad;
  const int per0 = points / radices[0];
  int t = ((plan->share << plan->shift) + per0 - 1) / per0;
  int pitch = 0;
  const int qs[2] = {radices[0] / clusters, (radices[0] + clusters - 1) / clusters};
  for (int s = 0; s < 2; ++s) {
    Side& side = plan->side[s];
    const int q = qs[s];
    const int n = q * plan->m0;  // the CTA's points
    side.q = q;
    side.q_magic = general::magic(q);
    // the first pass's writes: one row of padding in every Q where Q is
    // even (a local pass of radix Q at stride 1)
    unsigned period_in = pad && q % 2 == 0 ? general::magic(q) : 0;
    if (period_in != 0 && n + (n - 1) / q > pitch) pitch = n + (n - 1) / q;
    if (n > pitch) pitch = n;
    int ns = q, gns = radices[0];
    for (int p = 1; p < count; ++p) {
      const int r = radices[p];
      const int m = n / r;
      const int per = points / r;
      const int need = ((m << plan->shift) + per - 1) / per;
      if (need > t) t = need;
      const int period = pad && p + 1 < count && r % 2 == 0 ? ns * r : 0;
      if (period > 0 && n + (n - 1) / period > pitch) pitch = n + (n - 1) / period;
      side.pass[p - 1] = {r, ns, m, gns, general::magic(ns), period_in, general::magic(period)};
      period_in = general::magic(period);
      ns *= r;
      gns *= r;
    }
  }
  plan->pitch = pitch;
  const int buffers = count > 2 && ctas == 1 ? 2 : 1;
  const long long bytes = static_cast<long long>(buffers) * pitch * tile * sizeof(float2);
  if (t > limit || bytes > kMaxShared) return false;
  *threads = t;
  *smem = static_cast<int>(bytes);
  return true;
}

// The first pass, radix R across a cluster of C: a thread loads butterfly
// b's R rows from x (rows j + r * m0 of column u), runs it and stores each
// output to the shared memory of the CTA that owns its class (buffer 0, a
// 32-bit address of the cluster's shared window a CTA), then takes b + T.
// Before its first store a thread waits on the cluster barrier the kernel
// arrived at (every CTA of the cluster runs), so that its first loads are
// in flight meanwhile; a thread without a butterfly waits at the end.  x
// points at the tile's first column in row 0.  Without STORE (the split
// probe's stop 0) the stores to the cluster are left out.
template <int E, int R, int C, bool STORE = true>
__device__ __noinline__ void cross(const float2* __restrict__ x, long long cols, int tc,
                                   int shift, int m0, int j0, int share, int live, bool pad,
                                   float s, float cj) {
  extern __shared__ float2 sm[];
  constexpr int PER = E / R;
  static_assert(PER >= 1 && R >= 2 * C, "a whole butterfly a thread, two classes a CTA");
  const unsigned own = static_cast<unsigned>(__cvta_generic_to_shared(sm));
  unsigned remote[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote[c]) : "r"(own), "r"(c));
  const int T = static_cast<int>(blockDim.x);
  const int B = share << shift;
  bool waited = false;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = static_cast<int>(threadIdx.x) + q * T;
    const int u = b & (tc - 1);
    const int j = j0 + (b >> shift);
    if (b >= B || j >= m0) break;
    const bool on = u < live;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = on ? x[static_cast<size_t>(j + r * m0) * cols + u] : make_float2(0.f, 0.f);
      v[r].y *= cj;
    }
    mixed::Dft<R>::run(v, s);
    if (!waited) {
      asm volatile("barrier.cluster.wait;" ::: "memory");
      waited = true;
    }
    if constexpr (!STORE) {
      general::keep(v);
      continue;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // r's owner, its first class and its class count: constants
      const int o = ((r + 1) * C - 1) / R;
      const int lo = class_lo(o, R, C);
      const int qo = class_lo(o + 1, R, C) - lo;
      int i = (r - lo) + qo * j;
      if (qo % 2 == 0 && pad) i += i / qo;
      const unsigned at = remote[o] + static_cast<unsigned>(i * tc + u) * sizeof(float2);
      asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(at), "f"(v[r].x),
                   "f"(v[r].y)
                   : "memory");
    }
  }
  if (!waited) asm volatile("barrier.cluster.wait;" ::: "memory");
}

// A later pass of radix R on the CTA's own points, a butterfly at a time
// (as general::pass): a thread loads butterfly b's R points from the
// exchange at `in` with the chain's twiddles for its k, runs it and stores
// it (to y in the last pass, else to the exchange at `out`), then takes
// b + T.  y points at the tile's first column in row 0.
template <int E, int R>
__device__ __noinline__ void local(float2* __restrict__ y, const float2* __restrict__ tw,
                                   long long cols, int tc, int shift, const Pass ps, int lo,
                                   int q, unsigned q_magic, int r0, int in, int out, int live,
                                   bool last, float s, float scale, float cj) {
  extern __shared__ float2 sm[];
  constexpr int PER = E / R;
  static_assert(PER >= 1, "a thread holds a whole butterfly");
  const int T = static_cast<int>(blockDim.x);
  const int B = ps.m << shift;
#pragma unroll
  for (int qq = 0; qq < PER; ++qq) {
    const int b = static_cast<int>(threadIdx.x) + qq * T;
    if (b >= B) break;
    const int u = b & (tc - 1);
    const int j = b >> shift;
    const int t = general::quot(j, ps.ns_magic);
    const int kl = j - t * ps.ns;
    const int kq = general::quot(kl, q_magic);
    const int k = lo + (kl - kq * q) + r0 * kq;  // the chain's k
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = sm[in + general::padded(j + r * ps.m, ps.pad_in) * tc + u];
    const float2* w = tw + (ps.gns - 1) + k;
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(w + (r - 1) * ps.gns));
    mixed::Dft<R>::run(v, s);
    if (last) {
      if (u < live) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          y[static_cast<size_t>(k + ps.gns * (t * R + r)) * cols + u] =
              make_float2(v[r].x * scale, v[r].y * (scale * cj));
      }
    } else {
      const int j0 = t * R * ps.ns + kl;
#pragma unroll
      for (int r = 0; r < R; ++r)
        sm[out + general::padded(j0 + r * ps.ns, ps.pad_out) * tc + u] = v[r];
    }
  }
}

// A later pass of the kernel of one exchange buffer (CTAS = 2): `local`'s
// butterflies, reads and stores, but a thread first loads and runs every
// butterfly it has of the pass, then (but in the last pass) the CTA passes a
// barrier, then the thread stores them, so that the pass reads and writes
// the buffer in place.  Every thread calls it (the barrier), with or
// without butterflies of its own.
template <int E, int R>
__device__ __noinline__ void held(float2* __restrict__ y, const float2* __restrict__ tw,
                                  long long cols, int tc, int shift, const Pass ps, int lo, int q,
                                  unsigned q_magic, int r0, int live, bool last, float s,
                                  float scale, float cj) {
  extern __shared__ float2 sm[];
  constexpr int PER = E / R;
  static_assert(PER >= 1, "a thread holds a whole butterfly");
  const int T = static_cast<int>(blockDim.x);
  const int B = ps.m << shift;
  float2 v[PER][R];
#pragma unroll
  for (int qq = 0; qq < PER; ++qq) {
    // a thread past the pass's last butterfly loads and runs that one
    // (stores nothing): loads under a guard kept the results in local memory
    const int b = min(static_cast<int>(threadIdx.x) + qq * T, B - 1);
    const int u = b & (tc - 1);
    const int j = b >> shift;
    const int t = general::quot(j, ps.ns_magic);
    const int kl = j - t * ps.ns;
    const int kq = general::quot(kl, q_magic);
    const int k = lo + (kl - kq * q) + r0 * kq;
#pragma unroll
    for (int r = 0; r < R; ++r) v[qq][r] = sm[general::padded(j + r * ps.m, ps.pad_in) * tc + u];
    const float2* w = tw + (ps.gns - 1) + k;
#pragma unroll
    for (int r = 1; r < R; ++r) v[qq][r] = cmul(v[qq][r], __ldg(w + (r - 1) * ps.gns));
    mixed::Dft<R>::run(v[qq], s);
  }
  if (!last) __syncthreads();
#pragma unroll
  for (int qq = 0; qq < PER; ++qq) {
    const int b = static_cast<int>(threadIdx.x) + qq * T;
    if (b >= B) break;
    const int u = b & (tc - 1);
    const int j = b >> shift;
    const int t = general::quot(j, ps.ns_magic);
    const int kl = j - t * ps.ns;
    if (last) {
      if (u < live) {
        const int kq = general::quot(kl, q_magic);
        const int k = lo + (kl - kq * q) + r0 * kq;
#pragma unroll
        for (int r = 0; r < R; ++r)
          y[static_cast<size_t>(k + ps.gns * (t * R + r)) * cols + u] =
              make_float2(v[qq][r].x * scale, v[qq][r].y * (scale * cj));
      }
    } else {
      const int j0 = t * R * ps.ns + kl;
#pragma unroll
      for (int r = 0; r < R; ++r)
        sm[general::padded(j0 + r * ps.ns, ps.pad_out) * tc + u] = v[qq][r];
    }
  }
}

template <int E, int C, bool STORE = true>
__device__ __forceinline__ void cross_at(const float2* __restrict__ x, long long cols,
                                         const Plan& plan, int j0, int live, float s, float cj) {
#define WGFFT_CLUSTER_CROSS(R)                                                              \
  case R:                                                                                   \
    if constexpr (general::takes(E, R) && R >= 2 * C)                                       \
      cross<E, R, C, STORE>(x, cols, plan.tc, plan.shift, plan.m0, j0, plan.share, live,    \
                            plan.pad != 0, s, cj);                                          \
    break;
  switch (plan.r0) {
    WGFFT_CLUSTER_CROSS(4) WGFFT_CLUSTER_CROSS(5) WGFFT_CLUSTER_CROSS(6)
    WGFFT_CLUSTER_CROSS(7) WGFFT_CLUSTER_CROSS(8) WGFFT_CLUSTER_CROSS(9)
    WGFFT_CLUSTER_CROSS(10) WGFFT_CLUSTER_CROSS(11) WGFFT_CLUSTER_CROSS(12)
    WGFFT_CLUSTER_CROSS(13) WGFFT_CLUSTER_CROSS(14) WGFFT_CLUSTER_CROSS(15)
    WGFFT_CLUSTER_CROSS(16) WGFFT_CLUSTER_CROSS(18) WGFFT_CLUSTER_CROSS(20)
    WGFFT_CLUSTER_CROSS(21) WGFFT_CLUSTER_CROSS(22) WGFFT_CLUSTER_CROSS(24)
    WGFFT_CLUSTER_CROSS(25) WGFFT_CLUSTER_CROSS(26) WGFFT_CLUSTER_CROSS(27)
    WGFFT_CLUSTER_CROSS(28) WGFFT_CLUSTER_CROSS(30) WGFFT_CLUSTER_CROSS(32)
    default: break;
  }
#undef WGFFT_CLUSTER_CROSS
}

// Pass ps of the CTA's own points (local) by its radix, a switch uniform
// across the CTA: the body of cluster_kernel's and cluster_split_kernel's
// loops over the later passes.
#define WGFFT_CLUSTER_PASS(R)                                                              \
  case R:                                                                                  \
    if constexpr (general::takes(E, R))                                                    \
      local<E, R>(y, tw, cols, plan.tc, plan.shift, ps, lo, q,                            \
                  big ? plan.side[1].q_magic : plan.side[0].q_magic, plan.r0, in, out, live, \
                  last, s, scale, cj);                                                     \
    break;
#define WGFFT_CLUSTER_LOCAL                                                                 \
  switch (ps.radix) {                                                                      \
    WGFFT_CLUSTER_PASS(2) WGFFT_CLUSTER_PASS(3) WGFFT_CLUSTER_PASS(4) WGFFT_CLUSTER_PASS(5) \
    WGFFT_CLUSTER_PASS(6) WGFFT_CLUSTER_PASS(7) WGFFT_CLUSTER_PASS(8) WGFFT_CLUSTER_PASS(9) \
    WGFFT_CLUSTER_PASS(10) WGFFT_CLUSTER_PASS(11) WGFFT_CLUSTER_PASS(12)                    \
    WGFFT_CLUSTER_PASS(13) WGFFT_CLUSTER_PASS(14) WGFFT_CLUSTER_PASS(15)                    \
    WGFFT_CLUSTER_PASS(16) WGFFT_CLUSTER_PASS(18) WGFFT_CLUSTER_PASS(20)                    \
    WGFFT_CLUSTER_PASS(21) WGFFT_CLUSTER_PASS(22) WGFFT_CLUSTER_PASS(24)                    \
    WGFFT_CLUSTER_PASS(25) WGFFT_CLUSTER_PASS(26) WGFFT_CLUSTER_PASS(27)                    \
    WGFFT_CLUSTER_PASS(28) WGFFT_CLUSTER_PASS(30) WGFFT_CLUSTER_PASS(32)                    \
    default: break;                                                                        \
  }
// ... and of the kernel of one exchange buffer (held)
#define WGFFT_CLUSTER_HOLD(R)                                                             \
  case R:                                                                                 \
    if constexpr (general::takes(E, R))                                                   \
      held<E, R>(y, tw, cols, plan.tc, plan.shift, ps, lo, q,                             \
                 big ? plan.side[1].q_magic : plan.side[0].q_magic, plan.r0, live, last, s, \
                 scale, cj);                                                              \
    break;
#define WGFFT_CLUSTER_HELD                                                                  \
  switch (ps.radix) {                                                                      \
    WGFFT_CLUSTER_HOLD(2) WGFFT_CLUSTER_HOLD(3) WGFFT_CLUSTER_HOLD(4) WGFFT_CLUSTER_HOLD(5) \
    WGFFT_CLUSTER_HOLD(6) WGFFT_CLUSTER_HOLD(7) WGFFT_CLUSTER_HOLD(8) WGFFT_CLUSTER_HOLD(9) \
    WGFFT_CLUSTER_HOLD(10) WGFFT_CLUSTER_HOLD(11) WGFFT_CLUSTER_HOLD(12)                    \
    WGFFT_CLUSTER_HOLD(13) WGFFT_CLUSTER_HOLD(14) WGFFT_CLUSTER_HOLD(15)                    \
    WGFFT_CLUSTER_HOLD(16) WGFFT_CLUSTER_HOLD(18) WGFFT_CLUSTER_HOLD(20)                    \
    WGFFT_CLUSTER_HOLD(21) WGFFT_CLUSTER_HOLD(22) WGFFT_CLUSTER_HOLD(24)                    \
    WGFFT_CLUSTER_HOLD(25) WGFFT_CLUSTER_HOLD(26) WGFFT_CLUSTER_HOLD(27)                    \
    WGFFT_CLUSTER_HOLD(28) WGFFT_CLUSTER_HOLD(30) WGFFT_CLUSTER_HOLD(32)                    \
    default: break;                                                                        \
  }

// CTAS = 1: two exchange buffers, one CTA an SM; CTAS = 2: one buffer, the
// middle passes in place (held), two CTAs an SM at the same registers.
template <int E, int MAXT, int CTAS = 1>
__global__ void __launch_bounds__(MAXT, CTAS)
cluster_kernel(const float2* __restrict__ x, float2* __restrict__ y,
               const float2* __restrict__ tw, const float* __restrict__ params, long long cols,
               float cj, const Plan plan) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const float scale = __ldg(params);
  const float s = __ldg(params + 1);
  const int rank = static_cast<int>(cluster.block_rank());
  const long long t = static_cast<long long>(blockIdx.x) / plan.clusters;
  const long long p = t / plan.tiles;
  const long long col0 = (t - p * plan.tiles) << plan.shift;
  const long long left = cols - col0;
  const int live = static_cast<int>(left < plan.tc ? left : plan.tc);
  const size_t at = static_cast<size_t>(p) * plan.h * cols + col0;
  x += at;
  y += at;
  const int lo = class_lo(rank, plan.r0, plan.clusters);
  const int q = class_lo(rank + 1, plan.r0, plan.clusters) - lo;
  const bool big = q == plan.side[1].q;
  // no CTA writes another's shared memory before that one runs: every thread
  // arrives here and waits in the first pass, after its first loads
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int j0 = rank * plan.share;
  switch (plan.clusters) {
    case 2: cross_at<E, 2>(x, cols, plan, j0, live, s, cj); break;
    case 4: cross_at<E, 4>(x, cols, plan, j0, live, s, cj); break;
    default: cross_at<E, 8>(x, cols, plan, j0, live, s, cj); break;
  }
  // every CTA's classes landed, and every read of x is done (y may be x);
  // from here on each CTA reads and writes only its own shared memory
  cluster.sync();
  if constexpr (CTAS == 1) {
    const int buffer = plan.pitch * plan.tc;
    for (int pp = 1; pp < plan.count; ++pp) {
      const Pass ps = pass_at(plan, big, pp);
      const bool last = pp == plan.count - 1;
      const int in = ((pp + 1) & 1) * buffer, out = (pp & 1) * buffer;
      WGFFT_CLUSTER_LOCAL
      if (!last) __syncthreads();
    }
  } else {
    for (int pp = 1; pp < plan.count; ++pp) {
      const Pass ps = pass_at(plan, big, pp);
      const bool last = pp == plan.count - 1;
      WGFFT_CLUSTER_HELD
      if (!last) __syncthreads();
    }
  }
}

// The split probe's kernel (cluster.cu's wgfft_cluster_split, instantiated
// beside cluster_kernel in cluster_24.cu .. _64.cu, on no plan's path):
// cluster_kernel stopped after the first `stop`
// passes of a tile, the last of them into shared memory, or running them
// all where `stop` is past the chain's last; a stop of 0 runs the first
// pass's loads and butterflies with its stores to the cluster left out.
template <int E, int MAXT, int CTAS = 1>
__global__ void __launch_bounds__(MAXT, CTAS)
cluster_split_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                     const float2* __restrict__ tw, const float* __restrict__ params,
                     long long cols, float cj, const Plan plan, int stop) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const float scale = __ldg(params);
  const float s = __ldg(params + 1);
  const int rank = static_cast<int>(cluster.block_rank());
  const long long t = static_cast<long long>(blockIdx.x) / plan.clusters;
  const long long p = t / plan.tiles;
  const long long col0 = (t - p * plan.tiles) << plan.shift;
  const long long left = cols - col0;
  const int live = static_cast<int>(left < plan.tc ? left : plan.tc);
  const size_t at = static_cast<size_t>(p) * plan.h * cols + col0;
  x += at;
  y += at;
  const int lo = class_lo(rank, plan.r0, plan.clusters);
  const int q = class_lo(rank + 1, plan.r0, plan.clusters) - lo;
  const bool big = q == plan.side[1].q;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int j0 = rank * plan.share;
  if (stop == 0) {
    switch (plan.clusters) {
      case 2: cross_at<E, 2, false>(x, cols, plan, j0, live, s, cj); break;
      case 4: cross_at<E, 4, false>(x, cols, plan, j0, live, s, cj); break;
      default: cross_at<E, 8, false>(x, cols, plan, j0, live, s, cj); break;
    }
    return;
  }
  switch (plan.clusters) {
    case 2: cross_at<E, 2>(x, cols, plan, j0, live, s, cj); break;
    case 4: cross_at<E, 4>(x, cols, plan, j0, live, s, cj); break;
    default: cross_at<E, 8>(x, cols, plan, j0, live, s, cj); break;
  }
  cluster.sync();
  const int buffer = plan.pitch * plan.tc;
  const int run = stop < plan.count ? stop : plan.count;
  const bool whole = stop > plan.count;
  for (int pp = 1; pp < run; ++pp) {
    const Pass ps = pass_at(plan, big, pp);
    const bool last = whole && pp == plan.count - 1;
    if constexpr (CTAS == 1) {
      const int in = ((pp + 1) & 1) * buffer, out = (pp & 1) * buffer;
      WGFFT_CLUSTER_LOCAL
    } else {
      WGFFT_CLUSTER_HELD
    }
    // (`!last` changes nothing here, but without it the kernel of two CTAs
    // an SM spilled 16 bytes at 64 points a thread)
    if (!last && pp + 1 < run) __syncthreads();
  }
}
#undef WGFFT_CLUSTER_HELD
#undef WGFFT_CLUSTER_HOLD
#undef WGFFT_CLUSTER_LOCAL
#undef WGFFT_CLUSTER_PASS

// A launch of the design over a (pre, h, cols) view.
struct Launch {
  const ColsCall* call;
  Plan plan;
  int threads;
  int smem;
  long long grid;     // CTAs: pre * tiles * C
  long long* report;  // not null: describe the launch there instead (below)
  int ctas;           // the kernel built for 1 or 2 CTAs an SM
};

// Launch cluster_kernel<E, MAXT, CTAS> as `g` says (cluster_24.cu, _32.cu
// and _64.cu each instantiate one class of E, so that they compile side by
// side): cudaLaunchKernelEx with the cluster dimension.  With `report`,
// nothing launches and report[0..2] get the CTAs an SM holds, the SMs and
// the clusters the device holds at once (cudaOccupancyMaxActiveClusters).
// With SPLIT, cluster_split_kernel with the split probe's `stop`.
template <int E, int MAXT, int CTAS = 1, bool SPLIT = false>
cudaError_t launch_kernel(const Launch& g, int stop = 0) {
  auto* const kernel = [] {
    if constexpr (SPLIT) return &cluster_split_kernel<E, MAXT, CTAS>;
    else return &cluster_kernel<E, MAXT, CTAS>;
  }();
  if (g.threads > MAXT || g.grid < 1 || g.grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return e;
  const ColsCall& c = *g.call;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(g.grid), 1, 1);
  cfg.blockDim = dim3(g.threads, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = c.stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = g.plan.clusters;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attrs[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  if (g.report != nullptr) {
    int dev = 0, sms = 0, resident = 0, clusters = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, g.threads, g.smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    g.report[0] = resident;
    g.report[1] = sms;
    g.report[2] = clusters;
    return e;
  }
  if constexpr (SPLIT)
    e = cudaLaunchKernelEx(&cfg, kernel, c.x, c.y, c.tw, c.params, c.cols, c.cj, g.plan, stop);
  else
    e = cudaLaunchKernelEx(&cfg, kernel, c.x, c.y, c.tw, c.params, c.cols, c.cj, g.plan);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t launch_24(const Launch& g);
cudaError_t launch_32(const Launch& g);
cudaError_t launch_64(const Launch& g);
// ... and the split probe's kernel (SPLIT) of each class, to `stop`
cudaError_t split_24(const Launch& g, int stop);
cudaError_t split_32(const Launch& g, int stop);
cudaError_t split_64(const Launch& g, int stop);


}  // namespace cluster

// The tables, each with an entry of height 0 that ends it.
struct ClusterLine {
  int n, points, ctas, clusters, count, radix[general::kMaxPasses];
};
struct ClusterCols {
  int h;
  long long least, most;
  int points, tile, clusters, count, radix[general::kMaxPasses];
};
template <int... R>
constexpr ClusterLine cluster_line_of(int n, int points, int ctas, int clusters) {
  return {n, points, ctas, clusters, static_cast<int>(sizeof...(R)), {R...}};
}
template <int... R>
constexpr ClusterCols cluster_cols_of(int h, long long least, long long most, int points,
                                      int tile, int clusters) {
  return {h, least, most, points, tile, clusters, static_cast<int>(sizeof...(R)), {R...}};
}
#define WGFFT_CLUSTER_LINES_RULE(N, POINTS, CTAS, CLUSTERS, ...) \
  cluster_line_of<__VA_ARGS__>(N, POINTS, CTAS, CLUSTERS),
#define WGFFT_CLUSTER_COLS_RULE(H, LEAST, MOST, POINTS, TILE, CLUSTERS, ...) \
  cluster_cols_of<__VA_ARGS__>(H, LEAST, MOST, POINTS, TILE, CLUSTERS),
constexpr ClusterLine kClusterLines[] = {WGFFT_CLUSTER_LINES(WGFFT_CLUSTER_LINES_RULE){}};
constexpr ClusterCols kClusterCols[] = {WGFFT_CLUSTER_COLS(WGFFT_CLUSTER_COLS_RULE){}};
#undef WGFFT_CLUSTER_LINES_RULE
#undef WGFFT_CLUSTER_COLS_RULE
constexpr int kClusterLineEntries = sizeof(kClusterLines) / sizeof(kClusterLines[0]) - 1;
constexpr int kClusterColsEntries = sizeof(kClusterCols) / sizeof(kClusterCols[0]) - 1;

// K1's cluster entry for length n, or nullptr where its table does not
// name n.
inline const ClusterLine* cluster_line(int n) {
  for (int i = 0; i < kClusterLineEntries; ++i)
    if (kClusterLines[i].n == n) return &kClusterLines[i];
  return nullptr;
}

// K2's cluster entry for a view of height h and `columns` columns in all, or
// -1 where its table does not name h; -2 where it names h but no entry's
// range holds `columns` (a table the fit wrote never does).
inline int cluster_cols_entry(int h, long long columns) {
  int found = -1;
  for (int i = 0; i < kClusterColsEntries; ++i) {
    const ClusterCols& g = kClusterCols[i];
    if (g.h != h) continue;
    if (columns >= g.least && columns <= g.most) return i;
    found = -2;
  }
  return found;
}

// cluster.cu: K1's rule at a length of kClusterLines over `lines` lines
// (with `report`, described as the other designs describe theirs), and K2's
// at entry `entry` of kClusterCols (with `slots`, only the clusters the
// device holds at once).
cudaError_t launch_cluster_lines(const float2* x, float2* y, const float2* tw, const float* params,
                                 long long lines, int n, float cj, cudaStream_t stream,
                                 LinesReport* report);
cudaError_t launch_cluster_cols(const ColsCall& call, int entry, int* slots);

}  // namespace wgfft
