// K1's general design (lines_general.cuh), its class of 64 points a thread, in
// a translation unit of its own so that the classes compile side by side.

#include <cuda_runtime.h>

#include "lines_general.cuh"

namespace wgfft {
namespace general {

cudaError_t launch_64(const Launch& g) {
  return launch_kernel<64, max_threads(64)>(g);
}

}  // namespace general
}  // namespace wgfft
