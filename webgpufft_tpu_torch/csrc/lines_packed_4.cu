// K1's packed design: part 3 of its table (packed::part_of: the lengths
// from 98 points on), compiled beside the other parts; see lines_packed.cu,
// which holds the design's note and dispatches by length.

#include <cuda_runtime.h>

#include "lines.cuh"
#include "lines_packed.cuh"

namespace wgfft {

cudaError_t launch_packed_part_3(const float2* x, float2* y, const float2* tw,
                                 const float* params, long long lines, int n, float cj,
                                 cudaStream_t stream, LinesReport* report) {
  return packed::launch_part<3>(x, y, tw, params, lines, n, cj, stream, report);
}

}  // namespace wgfft
