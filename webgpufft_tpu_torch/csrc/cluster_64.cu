// K1's and K2's cluster design (cluster.cuh), its class of 64 points a
// thread, in a translation unit of its own so that the classes compile side
// by side.

#include <cuda_runtime.h>

#include "cluster.cuh"

namespace wgfft {
namespace cluster {

cudaError_t launch_64(const Launch& g) {
  return launch_kernel<64, max_threads(64)>(g);
}

}  // namespace cluster
}  // namespace wgfft
