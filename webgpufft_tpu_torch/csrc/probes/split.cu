// Probe: the split of a launch of the cluster design (cluster.cuh) or of
// K2's general design (cols_general.cuh) into its load, its passes and its
// store, for chip_probes/k1_general_variants.py and k2_general_variants.py
// with --split.
//
// Stands for no Pallas kernel of its own: the kernels are the plans' own
// bodies (cluster::unit and general_cols::run_tile with SPLIT, instantiated
// one class a file in split_cluster_24.cu .. split_general_64.cu) on the
// same chains and tables, stopped early.  `stop` 1 .. count runs a tile's
// first `stop` passes, the last of them into shared memory, so that y is
// left as it was; 0 runs the first pass's loads and butterflies with its
// stores left out; a stop past the chain's last pass runs the whole
// transform, as the plans' launch.  So that the times add up: the load is
// stop 0, pass p the step from stop p to p + 1, the store the step from
// stop count to the whole transform.
//
// What bounds it: bytes, as K1 and K2 (16 bytes a point for the whole
// transform).
//
// C interface: each entry returns the cudaError_t of the launch,
// cudaErrorInvalidValue for a chain, class, tile, cluster or stop it cannot
// run.  y may be x.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "cols_general.cuh"

namespace wgfft {
namespace split {

cudaError_t cluster_24(const cluster::Launch& g, int stop);
cudaError_t cluster_32(const cluster::Launch& g, int stop);
cudaError_t general_16(const general_cols::Launch& g, int stop);
cudaError_t general_20(const general_cols::Launch& g, int stop);
cudaError_t general_24(const general_cols::Launch& g, int stop);
cudaError_t general_32(const general_cols::Launch& g, int stop);
cudaError_t general_64(const general_cols::Launch& g, int stop);

// A stop at the chain's last pass writes the exchange buffer that the last
// pass of a chain of two passes does not otherwise have: twice the shared
// memory there, or false where that does not fit.
inline bool room_for(int stop, int count, int* smem, int most) {
  if (stop != count || count != 2) return true;
  if (2LL * *smem > most) return false;
  *smem *= 2;
  return true;
}

}  // namespace split
}  // namespace wgfft

// The cluster design (wgfft_cluster's arguments), in the classes of 24 and
// 32 points a thread (those its tables use), to `stop`.
extern "C" int wgfft_cluster_split(const void* x, void* y, const void* tw, const void* params,
                                   long long pre, int h, long long cols, const int* radices,
                                   int count, int points, int tile, int clusters, int stop,
                                   int adjoint, void* stream) {
  using namespace wgfft;
  const ColsCall call = {static_cast<const float2*>(x), static_cast<float2*>(y),
                         static_cast<const float2*>(tw), static_cast<const float*>(params), pre,
                         cols, h, adjoint ? -1.f : 1.f, static_cast<cudaStream_t>(stream)};
  cluster::Launch g = {&call, {}, 0, 0, 0, nullptr};
  if (pre < 1 || cols < 1 || stop < 0 || (points != 24 && points != 32) ||
      !cluster::make_plan(h, radices, count, points, tile, clusters, &g.plan, &g.threads,
                          &g.smem) ||
      !split::room_for(stop, count, &g.smem, cluster::kMaxShared))
    return static_cast<int>(cudaErrorInvalidValue);
  g.plan.tiles = (cols + tile - 1) / tile;
  g.grid = pre * g.plan.tiles * clusters;
  return static_cast<int>(points == 24 ? split::cluster_24(g, stop) : split::cluster_32(g, stop));
}

// K2's general design (wgfft_general_cols's arguments) to `stop`.
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
      !split::room_for(stop, count, &g.smem, general_cols::kMaxShared))
    return static_cast<int>(cudaErrorInvalidValue);
  g.plan.tiles = (cols + tile - 1) / tile;
  g.grid = pre * g.plan.tiles;
  if (g.grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  switch (points) {
    case 16: return static_cast<int>(split::general_16(g, stop));
    case 20: return static_cast<int>(split::general_20(g, stop));
    case 24: return static_cast<int>(split::general_24(g, stop));
    case 32: return static_cast<int>(split::general_32(g, stop));
    default: return static_cast<int>(split::general_64(g, stop));
  }
}
