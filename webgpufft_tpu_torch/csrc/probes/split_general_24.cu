// The split probe (split.cu) of K2's general design, its class of 24 points
// a thread, in a translation unit of its own so that the classes compile
// side by side.

#include <cuda_runtime.h>

#include "cols_general.cuh"

namespace wgfft {
namespace split {

cudaError_t general_24(const general_cols::Launch& g, int stop) {
  return general_cols::launch_kernel<24, general::max_threads(24), true>(g, stop);
}

}  // namespace split
}  // namespace wgfft
