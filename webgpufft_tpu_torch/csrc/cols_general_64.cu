// K2's general design (cols_general.cuh), its class of 64 points a thread, in
// a translation unit of its own so that the classes compile side by side.

#include <cuda_runtime.h>

#include "cols_general.cuh"

namespace wgfft {
namespace general_cols {

cudaError_t launch_64(const Launch& g) {
  return launch_kernel<64, general::max_threads(64)>(g);
}

}  // namespace general_cols
}  // namespace wgfft
