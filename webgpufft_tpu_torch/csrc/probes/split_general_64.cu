// The split probe (split.cu) of K2's general design, its class of 64 points
// a thread, in a translation unit of its own so that the classes compile
// side by side.

#include <cuda_runtime.h>

#include "cols_general.cuh"

namespace wgfft {
namespace split {

cudaError_t general_64(const general_cols::Launch& g, int stop) {
  return general_cols::launch_kernel<64, general::max_threads(64), true>(g, stop);
}

}  // namespace split
}  // namespace wgfft
