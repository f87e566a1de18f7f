// K1's general design (lines_general.cuh), its class of 32 points a thread, in
// a translation unit of its own so that the classes compile side by side.

#include <cuda_runtime.h>

#include "lines_general.cuh"

namespace wgfft {
namespace general {

cudaError_t launch_32(const Launch& g) {
  return launch_kernel<32, max_threads(32)>(g);
}

}  // namespace general
}  // namespace wgfft
