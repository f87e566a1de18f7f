// K1's and K2's cluster design: the lengths and heights of its tables
// (WGFFT_CLUSTER_LINES, WGFFT_CLUSTER_COLS, cluster.cuh), three kernel
// instantiations in all (cluster_24.cu, _32.cu, _64.cu), launched for K1 by
// fused_lines.cu and for K2 by fused_cols.cu.
//
// Same function as the other designs of each kernel: the natural-order DFT
// of every line (K1) or down every column of a (pre, H, cols) view (K2)
// times the scale, the adjoint launch (cj = -1), y = x allowed, on the chain
// the table names and the `cw` table of that chain (core/radix.py
// lines_chain, core/fused_cols.py cols_chain).
//
// What held these lengths (11583 to 16128), and what this design does
// about it:
// - one CTA an SM.  Their only design was the direct one (for K2 also
//   the ring to 13310): radix_chain's four to seven passes of radices up to
//   16, an in-place buffer of up to 134 KB and about 500 threads, with
//   nothing to cover a line's loads and stores while its passes run.  The
//   general design's fewer passes need two buffers of the whole line, up to
//   252 KB, over the 227 KB a CTA may have.  Here a line (a tile) is split
//   over C = 2, 4 or 8 CTAs of a cluster, each holding H / C points in
//   two buffers (at most 126 KB at C = 2, 63 KB at C = 4), so the general
//   design's fewest-pass chains fit and, from C = 4, several CTAs share an
//   SM;
// - sectors: K2's one-column tiles read 8 bytes of each 32-byte sector.
//   Here a tile is tc columns wide (the table's, measured), each row a run
//   of tc * 8 bytes;
// - coalescing across the split: a CTA that held every C-th point of a
//   line would read (C - 1) / C of each sector it loads for nothing.  Here
//   the first pass crosses the cluster: each CTA reads its butterflies'
//   points as runs along the line and sends each output to the CTA that
//   owns its residue class through distributed shared memory; the later
//   passes stay in a CTA, which stores runs of R0 / C points.
// 14641 = 11^4 and the odd lengths split the first radix's classes
// unevenly (one class more on some CTAs).  Which chain (order included),
// class, cluster size and tile each length takes is the measured sweep's
// (chip_probes/k1_general_variants.py and k2_general_variants.py with
// --cluster, PERF.md).

#include <cuda_runtime.h>

#include "cluster.cuh"

namespace wgfft {
namespace cluster {

namespace {

// Launch (or, with `report`, describe: report[0..2] as launch_kernel's,
// report[3] the grid, report[4] the threads a CTA, report[5] the shared
// memory a CTA) `chain` over `call`'s view in the kernel built for `ctas`
// CTAs an SM.
cudaError_t launch(const ColsCall& call, const int* radices, int count, int points, int tile,
                   int clusters, int ctas, long long* report) {
  Launch g = {&call, {}, 0, 0, 0, report, ctas};
  if (call.pre < 1 || call.cols < 1 || max_threads(points, ctas) == 0 ||
      !make_plan(call.h, radices, count, points, tile, clusters, &g.plan, &g.threads, &g.smem,
                 ctas))
    return cudaErrorInvalidValue;
  g.plan.tiles = (call.cols + tile - 1) / tile;
  g.grid = call.pre * g.plan.tiles * clusters;
  if (report != nullptr) {
    report[3] = g.grid;
    report[4] = g.threads;
    report[5] = g.smem;
  }
  switch (points) {
    case 24: return launch_24(g);
    case 32: return launch_32(g);
    default: return launch_64(g);
  }
}

}  // namespace
}  // namespace cluster

cudaError_t launch_cluster_lines(const float2* x, float2* y, const float2* tw, const float* params,
                                 long long lines, int n, float cj, cudaStream_t stream,
                                 LinesReport* report) {
  const ClusterLine* c = cluster_line(n);
  if (c == nullptr) return cudaErrorInvalidValue;
  const ColsCall call = {x, y, tw, params, lines, 1, n, cj, stream};
  if (report == nullptr)
    return cluster::launch(call, c->radix, c->count, c->points, 1, c->clusters, c->ctas,
                           nullptr);
  long long r[6] = {};
  const cudaError_t e =
      cluster::launch(call, c->radix, c->count, c->points, 1, c->clusters, c->ctas, r);
  *report = {r[0], r[1], r[3], r[3], report->design};
  return e;
}

cudaError_t launch_cluster_cols(const ColsCall& call, int entry, int* slots) {
  if (entry < 0 || entry >= kClusterColsEntries) return cudaErrorInvalidValue;
  const ClusterCols& c = kClusterCols[entry];
  if (slots == nullptr)
    return cluster::launch(call, c.radix, c.count, c.points, c.tile, c.clusters, 1, nullptr);
  long long r[6] = {};
  const cudaError_t e =
      cluster::launch(call, c.radix, c.count, c.points, c.tile, c.clusters, 1, r);
  *slots = static_cast<int>(r[2]);
  return e;
}

}  // namespace wgfft

// The cluster design on any chain it can run, outside the kernels' rules:
// the variants of chip_probes/k1_general_variants.py (a (lines, N, 1) view,
// tile 1) and k2_general_variants.py with --cluster, whose sweeps the
// tables are fitted to.  `points` is the class (24, 32 or 64 points a
// thread at most), `tile` the columns a tile, `clusters` the CTAs a
// cluster (2, 4 or 8), `ctas` the CTAs an SM its kernel is built for (1:
// two exchange buffers; 2: one, the middle passes in place).  y may be x.  With `report` not null nothing
// launches, and report[0..5] get the CTAs an SM holds, the SMs, the
// clusters the device holds at once, the grid, the threads a CTA and the
// shared memory a CTA.  Returns the cudaError_t: cudaErrorInvalidValue for
// what the design cannot run.
extern "C" int wgfft_cluster(const void* x, void* y, const void* tw, const void* params,
                             long long pre, int h, long long cols, const int* radices, int count,
                             int points, int tile, int clusters, int ctas, int adjoint,
                             long long* report, void* stream) {
  const wgfft::ColsCall call = {static_cast<const float2*>(x), static_cast<float2*>(y),
                                static_cast<const float2*>(tw), static_cast<const float*>(params),
                                pre, cols, h, adjoint ? -1.f : 1.f,
                                static_cast<cudaStream_t>(stream)};
  return static_cast<int>(wgfft::cluster::launch(call, radices, count, points, tile, clusters,
                                                 ctas, report));
}

// The split probe of the cluster design (wgfft_cluster's arguments, without
// the report): the plans' kernel bodies (cluster_split_kernel) stopped after
// `stop` passes of a tile, the last of them into shared memory; 0 runs the
// first pass's loads and butterflies with its stores left out; a stop past
// the chain's last pass runs the whole transform, as wgfft_cluster.  The
// load is stop 0, pass p the step from stop p to p + 1, the store the step
// from stop count to the whole (chip_probes/k1_general_variants.py and
// k2_general_variants.py with --split).  A probe of no TPU kernel of its
// own; bound by bytes, as K1 and K2.  y may be x.  Returns the cudaError_t,
// cudaErrorInvalidValue for what it cannot run.
extern "C" int wgfft_cluster_split(const void* x, void* y, const void* tw, const void* params,
                                   long long pre, int h, long long cols, const int* radices,
                                   int count, int points, int tile, int clusters, int ctas,
                                   int stop, int adjoint, void* stream) {
  using namespace wgfft;
  const ColsCall call = {static_cast<const float2*>(x), static_cast<float2*>(y),
                         static_cast<const float2*>(tw), static_cast<const float*>(params), pre,
                         cols, h, adjoint ? -1.f : 1.f, static_cast<cudaStream_t>(stream)};
  cluster::Launch g = {&call, {}, 0, 0, 0, nullptr, ctas};
  if (pre < 1 || cols < 1 || stop < 0 || cluster::max_threads(points, ctas) == 0 ||
      !cluster::make_plan(h, radices, count, points, tile, clusters, &g.plan, &g.threads,
                          &g.smem, ctas) ||
      !general::split_room(stop, count, &g.smem, cluster::kMaxShared, ctas == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  g.plan.tiles = (cols + tile - 1) / tile;
  g.grid = pre * g.plan.tiles * clusters;
  switch (points) {
    case 24: return static_cast<int>(cluster::split_24(g, stop));
    case 32: return static_cast<int>(cluster::split_32(g, stop));
    default: return static_cast<int>(cluster::split_64(g, stop));
  }
}
