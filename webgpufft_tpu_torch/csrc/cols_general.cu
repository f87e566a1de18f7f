// K2's general mixed-radix design: every height of its table
// (WGFFT_GENERAL_COLS, cols_general.cuh), five kernel instantiations in all
// (cols_general_16.cu, _20.cu, _24.cu, _32.cu, _64.cu).
//
// Same function as K2's other designs (fused_cols.cu): the natural-order
// DFT down every column of a (pre, H, cols) view times the scale, the
// adjoint launch (cj = -1), y = x allowed (every chain of the table has two
// passes or more), on the chain the table names and the `cw` table of that
// chain (core/fused_cols.py cols_chain).
//
// What held the direct design and the ring at these heights, and what this
// design does about it:
// - too many passes: both run radix_chain, which gives every odd prime a
//   pass of its own (1080 = 8 * 5 * 3 * 3 * 3, five passes; 4 to 8 passes
//   at most heights).  Here each pass is a butterfly of up to 32 points in
//   registers, so every height runs in the fewest passes those radices
//   allow (1080 = 12 * 10 * 9): two, three or four trips through shared
//   memory, one barrier each;
// - one run-time chain kernel a radix set, whose widest radix sets the
//   registers of every height in it (128 a thread), and a tile sized by
//   the height alone.  Here each pass dispatches to a compile-time body of
//   its radix, the kernel is instantiated per class of E points a thread,
//   so that the widest butterfly of a height's class sets its registers,
//   and the tile (1 to 64 columns) and the class are the table's, measured
//   at a view of few tiles and one of 67 MB.
// Which chain (order included), class and tile each height takes is the
// measured sweep's (chip_probes/k2_general_variants.py, PERF.md).

#include <cuda_runtime.h>

#include "cols_general.cuh"

namespace wgfft {
namespace general_cols {

namespace {

// Launch (or describe) `chain` over `call`'s view in the class of `points`
// with tiles of `tile` columns; the threads a CTA into `threads` where it is
// not null.
cudaError_t launch(const ColsCall& call, const int* radices, int count, int points, int tile,
                   int* slots, long long* report, int* threads) {
  Launch g = {&call, {}, 0, 0, 0, slots, report};
  if (call.pre < 1 || call.cols < 1 ||
      !make_plan(call.h, radices, count, points, tile, &g.plan, &g.threads, &g.smem))
    return cudaErrorInvalidValue;
  g.plan.tiles = (call.cols + tile - 1) / tile;
  g.grid = call.pre * g.plan.tiles;
  if (g.grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (threads != nullptr) *threads = g.threads;
  switch (points) {
    case 16: return launch_16(g);
    case 20: return launch_20(g);
    case 24: return launch_24(g);
    case 32: return launch_32(g);
    default: return launch_64(g);
  }
}

}  // namespace
}  // namespace general_cols

cudaError_t launch_cols_general(const ColsCall& call, int entry, int* slots) {
  if (entry < 0 || entry >= kGeneralColsEntries) return cudaErrorInvalidValue;
  const GeneralCols& g = kGeneralCols[entry];
  return general_cols::launch(call, g.radix, g.count, g.points, g.tile, slots, nullptr, nullptr);
}

}  // namespace wgfft

// The general design on any chain it can run, in the class of `points`
// (16, 20, 24, 32 or 64 points a thread at most) with tiles of `tile`
// columns, outside K2's rule: the variants of
// chip_probes/k2_general_variants.py, whose sweep the rule's table is
// fitted to.  y may be x.  With `report` not null nothing launches, and
// report[0..3] get the CTAs an SM holds, the SMs, the grid and the threads
// a CTA.  Returns the cudaError_t: cudaErrorInvalidValue for what the
// design cannot run.
extern "C" int wgfft_general_cols(const void* x, void* y, const void* tw, const void* params,
                                  long long pre, int h, long long cols, const int* radices,
                                  int count, int points, int tile, int adjoint, long long* report,
                                  void* stream) {
  const wgfft::ColsCall call = {static_cast<const float2*>(x), static_cast<float2*>(y),
                                static_cast<const float2*>(tw), static_cast<const float*>(params),
                                pre, cols, h, adjoint ? -1.f : 1.f,
                                static_cast<cudaStream_t>(stream)};
  int threads = 0;
  const int rc = static_cast<int>(wgfft::general_cols::launch(
      call, radices, count, points, tile, nullptr, report, &threads));
  if (report != nullptr) {
    report[2] = pre * ((cols + tile - 1) / (tile > 0 ? tile : 1));
    report[3] = threads;
  }
  return rc;
}

// The split probe of K2's general design (wgfft_general_cols's arguments,
// without the report), to `stop` as wgfft_cluster_split (cluster.cu).
extern "C" int wgfft_general_cols_split(const void* x, void* y, const void* tw,
                                        const void* params, long long pre, int h, long long cols,
                                        const int* radices, int count, int points, int tile,
                                        int stop, int adjoint, void* stream) {
  using namespace wgfft;
  const ColsCall call = {static_cast<const float2*>(x), static_cast<float2*>(y),
                         static_cast<const float2*>(tw), static_cast<const float*>(params), pre,
                         cols, h, adjoint ? -1.f : 1.f, static_cast<cudaStream_t>(stream)};
  general_cols::Launch g = {&call, {}, 0, 0, 0, nullptr, nullptr};
  if (pre < 1 || cols < 1 || stop < 0 ||
      !general_cols::make_plan(h, radices, count, points, tile, &g.plan, &g.threads, &g.smem) ||
      !general::split_room(stop, count, &g.smem, general_cols::kMaxShared, false))
    return static_cast<int>(cudaErrorInvalidValue);
  g.plan.tiles = (cols + tile - 1) / tile;
  g.grid = pre * g.plan.tiles;
  if (g.grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  switch (points) {
    case 16: return static_cast<int>(general_cols::split_16(g, stop));
    case 20: return static_cast<int>(general_cols::split_20(g, stop));
    case 24: return static_cast<int>(general_cols::split_24(g, stop));
    case 32: return static_cast<int>(general_cols::split_32(g, stop));
    default: return static_cast<int>(general_cols::split_64(g, stop));
  }
}
