// The split probe (split.cu) of the cluster design, its class of 32 points a
// thread, in a translation unit of its own so that the classes compile side
// by side.

#include <cuda_runtime.h>

#include "cluster.cuh"

namespace wgfft {
namespace split {

cudaError_t cluster_32(const cluster::Launch& g, int stop) {
  return cluster::launch_kernel<32, cluster::max_threads(32), true>(g, stop);
}

}  // namespace split
}  // namespace wgfft
