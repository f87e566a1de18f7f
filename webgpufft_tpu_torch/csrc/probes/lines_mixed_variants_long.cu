// K1's mixed-radix design in variants: the lengths from 5120 on (see
// lines_mixed_variants.cu, which holds the entry point and the shorter
// lengths; MIXED_VARIANTS of probes/variants.py lists both in order).

#include <cuda_runtime.h>

#include "lines_mixed.cuh"

namespace wgfft {

cudaError_t launch_mixed_variant_long(int variant, const float2* x, float2* y, const float2* tw,
                                      const float* params, long long lines, float cj,
                                      cudaStream_t stream, LinesReport* report) {
#define WGFFT_MIXED(I, ...) \
  case I: return mixed::launch<__VA_ARGS__>(x, y, tw, params, lines, cj, stream, report)
  switch (variant) {
    WGFFT_MIXED(21, 5120, 1, 320, 2, 16, 16, 20);     // the rule's
    WGFFT_MIXED(22, 6000, 1, 256, 2, 24, 25, 10);     // the rule's
    WGFFT_MIXED(23, 6000, 1, 256, 2, 30, 25, 8);
    WGFFT_MIXED(24, 6000, 1, 320, 2, 20, 30, 10);
    WGFFT_MIXED(25, 6000, 1, 256, 2, 30, 8, 25);
    WGFFT_MIXED(26, 6144, 1, 256, 2, 32, 24, 8);      // the rule's
    WGFFT_MIXED(27, 6144, 1, 256, 2, 24, 32, 8);
    WGFFT_MIXED(28, 8232, 1, 392, 2, 8, 21, 7, 7);    // the rule's: four passes
    WGFFT_MIXED(29, 8232, 1, 320, 1, 28, 14, 21);     // three passes, one CTA an SM
    WGFFT_MIXED(30, 8232, 1, 392, 1, 28, 14, 21);
    WGFFT_MIXED(31, 9216, 1, 384, 2, 32, 24, 12);     // the rule's
    WGFFT_MIXED(32, 12288, 1, 512, 1, 32, 32, 12);    // the rule's
    WGFFT_MIXED(33, 15360, 1, 512, 1, 32, 32, 15);    // the rule's
    default: return cudaErrorInvalidValue;
  }
#undef WGFFT_MIXED
}

}  // namespace wgfft
