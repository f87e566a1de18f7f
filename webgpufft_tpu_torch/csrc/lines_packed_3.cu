// K1's packed design: part 2 of its table (packed::part_of: the lengths
// from 60 to 91 points), compiled beside the other parts; see lines_packed.cu,
// which holds the design's note and dispatches by length.

#include <cuda_runtime.h>

#include "lines.cuh"
#include "lines_packed.cuh"

namespace wgfft {

cudaError_t launch_packed_part_2(const float2* x, float2* y, const float2* tw,
                                 const float* params, long long lines, int n, float cj,
                                 cudaStream_t stream, LinesReport* report) {
  return packed::launch_part<2>(x, y, tw, params, lines, n, cj, stream, report);
}

}  // namespace wgfft
