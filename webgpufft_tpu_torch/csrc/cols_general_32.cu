// K2's general design (cols_general.cuh), its class of 32 points a thread, in
// a translation unit of its own so that the classes compile side by side.

#include <cuda_runtime.h>

#include "cols_general.cuh"

namespace wgfft {
namespace general_cols {

cudaError_t launch_32(const Launch& g) {
  return launch_kernel<32, general::max_threads(32)>(g);
}

}  // namespace general_cols
}  // namespace wgfft
