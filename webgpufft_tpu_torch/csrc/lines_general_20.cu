// K1's general design (lines_general.cuh), its class of 20 points a thread, in
// a translation unit of its own so that the classes compile side by side.

#include <cuda_runtime.h>

#include "lines_general.cuh"

namespace wgfft {
namespace general {

cudaError_t launch_20(const Launch& g) {
  return launch_kernel<20, max_threads(20)>(g);
}

}  // namespace general
}  // namespace wgfft
