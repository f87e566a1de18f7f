// K1's and K2's cluster design (cluster.cuh), its class of 24 points a
// thread, in a translation unit of its own so that the classes compile side
// by side.

#include <cuda_runtime.h>

#include "cluster.cuh"

namespace wgfft {
namespace cluster {

cudaError_t launch_24(const Launch& g) {
  return launch_kernel<24, max_threads(24)>(g);
}

}  // namespace cluster
}  // namespace wgfft
