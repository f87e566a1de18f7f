// K2's general design (cols_general.cuh), its class of 24 points a thread, in
// a translation unit of its own so that the classes compile side by side;
// with the split probe's kernel of the class (general_cols_split_kernel,
// cols_general.cu's wgfft_general_cols_split), which calls this unit's pass
// bodies instead of compiling its own.

#include <cuda_runtime.h>

#include "cols_general.cuh"

namespace wgfft {
namespace general_cols {

cudaError_t launch_24(const Launch& g) {
  return launch_kernel<24, general::max_threads(24)>(g);
}

cudaError_t split_24(const Launch& g, int stop) {
  return launch_kernel<24, general::max_threads(24), true>(g, stop);
}

}  // namespace general_cols
}  // namespace wgfft
