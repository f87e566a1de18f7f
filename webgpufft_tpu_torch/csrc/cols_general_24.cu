// K2's general design (cols_general.cuh), its class of 24 points a thread, in
// a translation unit of its own so that the classes compile side by side.

#include <cuda_runtime.h>

#include "cols_general.cuh"

namespace wgfft {
namespace general_cols {

cudaError_t launch_24(const Launch& g) {
  return launch_kernel<24, general::max_threads(24)>(g);
}

}  // namespace general_cols
}  // namespace wgfft
