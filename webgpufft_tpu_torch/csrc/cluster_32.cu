// K1's and K2's cluster design (cluster.cuh), its class of 32 points a
// thread, in a translation unit of its own so that the classes compile side
// by side; with the split probe's kernel of the class (cluster_split_kernel,
// cluster.cu's wgfft_cluster_split), which calls this unit's pass bodies
// instead of compiling its own.

#include <cuda_runtime.h>

#include "cluster.cuh"

namespace wgfft {
namespace cluster {

cudaError_t launch_32(const Launch& g) {
  return g.ctas == 2 ? launch_kernel<32, max_threads(32, 2), 2>(g)
                    : launch_kernel<32, max_threads(32)>(g);
}

cudaError_t split_32(const Launch& g, int stop) {
  return g.ctas == 2 ? launch_kernel<32, max_threads(32, 2), 2, true>(g, stop)
                    : launch_kernel<32, max_threads(32), 1, true>(g, stop);
}

}  // namespace cluster
}  // namespace wgfft
