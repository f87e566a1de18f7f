// K1's and K2's cluster design (cluster.cuh), its class of 24 points a
// thread, in a translation unit of its own so that the classes compile side
// by side; with the split probe's kernel of the class (cluster_split_kernel,
// cluster.cu's wgfft_cluster_split), which calls this unit's pass bodies
// instead of compiling its own.

#include <cuda_runtime.h>

#include "cluster.cuh"

namespace wgfft {
namespace cluster {

// (no kernel of two CTAs an SM at 24 points: max_threads(24, 2) is 0, so
// make_plan refuses it)
cudaError_t launch_24(const Launch& g) { return launch_kernel<24, max_threads(24)>(g); }

cudaError_t split_24(const Launch& g, int stop) {
  return launch_kernel<24, max_threads(24), 1, true>(g, stop);
}

}  // namespace cluster
}  // namespace wgfft
