// K1's power-of-two design in variants the caller names by index, for the
// one-run comparison of chip_probes/k1_pow2_variants.py.  No plan launches
// these; the plans' entry point (fused_lines.cu) launches the design its
// rule gives a length (lines_pow2.cu).  Each variant is one instantiation of
// lines_pow2.cuh: length, threads a CTA, CTAs an SM asked for, chain.  The
// table kLinesVariants of probes/variants.py holds the same list in the
// same order.

#include <cuda_runtime.h>

#include "lines_pow2.cuh"

namespace {

using wgfft::pow2::launch;

cudaError_t launch_variant(int variant, const float2* x, float2* y, const float2* tw,
                           const float* params, long long lines, float cj, cudaStream_t stream,
                           int* resident) {
#define WGFFT_VARIANT(I, ...) \
  case I: return launch<__VA_ARGS__>(x, y, tw, params, lines, cj, stream, resident)
  switch (variant) {
    WGFFT_VARIANT(0, 8192, 256, 2, 32, 16, 16);        // the rule's
    WGFFT_VARIANT(1, 8192, 256, 1, 32, 16, 16);        // one CTA an SM, up to 255 registers
    WGFFT_VARIANT(2, 8192, 256, 3, 32, 16, 16);        // three CTAs an SM, up to 80 registers
    WGFFT_VARIANT(3, 8192, 512, 2, 16, 8, 8, 8);       // the direct design's four passes
    WGFFT_VARIANT(4, 8192, 256, 2, 16, 16, 32);        // the radix-32 pass last
    WGFFT_VARIANT(5, 16384, 512, 1, 32, 32, 16);       // the rule's
    WGFFT_VARIANT(6, 16384, 512, 1, 16, 16, 8, 8);     // the direct design's four passes
    WGFFT_VARIANT(7, 16384, 1024, 1, 16, 16, 8, 8);    // the same in 1024 threads of 16 points
    WGFFT_VARIANT(8, 4096, 256, 4, 16, 16, 16);        // the rule's
    WGFFT_VARIANT(9, 4096, 128, 4, 32, 16, 8);         // 32 points a thread
    WGFFT_VARIANT(10, 2048, 128, 4, 16, 16, 8);        // the rule's
    WGFFT_VARIANT(11, 2048, 64, 8, 32, 8, 8);          // 32 points a thread
    WGFFT_VARIANT(12, 2048, 128, 6, 16, 16, 8);        // six CTAs an SM, up to 80 registers
    WGFFT_VARIANT(13, 2048, 128, 8, 16, 16, 8);        // eight CTAs an SM, up to 64 registers
    default: return cudaErrorInvalidValue;
  }
#undef WGFFT_VARIANT
}

}  // namespace

// x, y (y may be x), the variant's cw table and K1's cp table, lines; the
// variant's length n is checked against the caller's.  With `resident` not
// null nothing launches and the CTAs an SM holds are written there.
extern "C" int wgfft_lines_variant(const void* x, void* y, const void* tw, const void* params,
                                   long long lines, int n, int variant, int adjoint,
                                   int* resident, void* stream) {
  static const int kLengths[] = {8192, 8192, 8192, 8192, 8192, 16384, 16384,
                                 16384, 4096, 4096, 2048, 2048, 2048, 2048};
  if (lines < 1 || lines > 0x7fffffffLL || variant < 0 ||
      variant >= static_cast<int>(sizeof(kLengths) / sizeof(kLengths[0])) ||
      kLengths[variant] != n)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_variant(
      variant, static_cast<const float2*>(x), static_cast<float2*>(y),
      static_cast<const float2*>(tw), static_cast<const float*>(params), lines,
      adjoint ? -1.f : 1.f, static_cast<cudaStream_t>(stream), resident));
}
