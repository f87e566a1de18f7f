// The split probe (split.cu) of the cluster design, its class of 24 points a
// thread, in a translation unit of its own so that the classes compile side
// by side.

#include <cuda_runtime.h>

#include "cluster.cuh"

namespace wgfft {
namespace split {

cudaError_t cluster_24(const cluster::Launch& g, int stop) {
  return cluster::launch_kernel<24, cluster::max_threads(24), true>(g, stop);
}

}  // namespace split
}  // namespace wgfft
