// The split probe (split.cu) of K2's general design, its class of 32 points
// a thread, in a translation unit of its own so that the classes compile
// side by side.

#include <cuda_runtime.h>

#include "cols_general.cuh"

namespace wgfft {
namespace split {

cudaError_t general_32(const general_cols::Launch& g, int stop) {
  return general_cols::launch_kernel<32, general::max_threads(32), true>(g, stop);
}

}  // namespace split
}  // namespace wgfft
