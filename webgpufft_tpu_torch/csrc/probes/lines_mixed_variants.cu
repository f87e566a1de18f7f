// K1's mixed-radix design in variants the caller names by index, for the
// one-run comparison of chip_probes/k1_mixed_variants.py.  No plan launches
// these; the plans' entry point (fused_lines.cu) launches the design its
// rule gives a length (lines_mixed.cu for the lengths of kMixedLines).
// Each variant is one instantiation of lines_mixed.cuh (length, lines a
// CTA, threads a CTA, CTAs an SM asked for, chain); the lengths up to 3072
// are instantiated here, the longer ones in lines_mixed_variants_long.cu,
// so that the two compile side by side.  MIXED_VARIANTS of
// probes/variants.py holds the same list in the same order.

#include <cuda_runtime.h>

#include "lines_mixed.cuh"

namespace wgfft {

// lines_mixed_variants_long.cu: the variants from kLongVariants on
constexpr int kLongVariants = 21;
cudaError_t launch_mixed_variant_long(int variant, const float2* x, float2* y, const float2* tw,
                                      const float* params, long long lines, float cj,
                                      cudaStream_t stream, LinesReport* report);

}  // namespace wgfft

namespace {

using wgfft::LinesReport;

cudaError_t launch_variant(int variant, const float2* x, float2* y, const float2* tw,
                           const float* params, long long lines, float cj, cudaStream_t stream,
                           LinesReport* report) {
  if (variant >= wgfft::kLongVariants)
    return wgfft::launch_mixed_variant_long(variant, x, y, tw, params, lines, cj, stream, report);
#define WGFFT_MIXED(I, ...) \
  case I: return wgfft::mixed::launch<__VA_ARGS__>(x, y, tw, params, lines, cj, stream, report)
  switch (variant) {
    WGFFT_MIXED(0, 360, 4, 80, 8, 20, 18);            // the rule's
    WGFFT_MIXED(1, 360, 4, 64, 8, 24, 15);
    WGFFT_MIXED(2, 360, 8, 128, 6, 24, 15);
    WGFFT_MIXED(3, 1000, 1, 100, 10, 10, 10, 10);     // the rule's
    WGFFT_MIXED(4, 1000, 1, 128, 8, 10, 10, 10);
    WGFFT_MIXED(5, 1000, 2, 224, 6, 10, 10, 10);
    WGFFT_MIXED(6, 1352, 1, 128, 8, 13, 13, 8);       // the rule's (the direct design's chain)
    WGFFT_MIXED(7, 1352, 2, 224, 4, 13, 13, 8);
    WGFFT_MIXED(8, 1352, 1, 128, 8, 8, 13, 13);
    WGFFT_MIXED(9, 1536, 1, 64, 8, 8, 8, 24);         // the rule's
    WGFFT_MIXED(10, 2079, 1, 96, 4, 27, 7, 11);       // the rule's
    WGFFT_MIXED(11, 2079, 1, 96, 8, 27, 7, 11);
    WGFFT_MIXED(12, 2079, 1, 96, 8, 27, 11, 7);
    WGFFT_MIXED(13, 2310, 1, 160, 3, 22, 15, 7);      // the rule's
    WGFFT_MIXED(14, 2310, 1, 128, 5, 22, 21, 5);
    WGFFT_MIXED(15, 2310, 1, 112, 5, 30, 7, 11);
    WGFFT_MIXED(16, 3000, 1, 100, 4, 10, 10, 30);     // the rule's
    WGFFT_MIXED(17, 3000, 1, 100, 4, 30, 10, 10);
    WGFFT_MIXED(18, 3000, 1, 100, 4, 10, 30, 10);
    WGFFT_MIXED(19, 3072, 1, 128, 4, 32, 4, 24);      // the rule's
    WGFFT_MIXED(20, 3072, 1, 192, 3, 16, 8, 24);
    default: return cudaErrorInvalidValue;
  }
#undef WGFFT_MIXED
}

}  // namespace

// x, y (y may be x), the variant's cw table and K1's cp table, lines; the
// variant's length n is checked against the caller's.  With `resident` not
// null nothing launches and the CTAs an SM holds are written there.
extern "C" int wgfft_mixed_variant(const void* x, void* y, const void* tw, const void* params,
                                   long long lines, int n, int variant, int adjoint,
                                   int* resident, void* stream) {
  static const int kLengths[] = {360, 360, 360, 1000, 1000, 1000, 1352, 1352, 1352, 1536, 2079,
                                 2079, 2079, 2310, 2310, 2310, 3000, 3000, 3000, 3072, 3072, 5120,
                                 6000, 6000, 6000, 6000, 6144, 6144, 8232, 8232, 8232, 9216,
                                 12288, 15360};
  if (lines < 1 || lines > 0x7fffffffLL || variant < 0 ||
      variant >= static_cast<int>(sizeof(kLengths) / sizeof(kLengths[0])) ||
      kLengths[variant] != n)
    return static_cast<int>(cudaErrorInvalidValue);
  LinesReport report = {};
  const cudaError_t e = launch_variant(
      variant, static_cast<const float2*>(x), static_cast<float2*>(y),
      static_cast<const float2*>(tw), static_cast<const float*>(params), lines,
      adjoint ? -1.f : 1.f, static_cast<cudaStream_t>(stream),
      resident != nullptr ? &report : nullptr);
  if (resident != nullptr) *resident = static_cast<int>(report.resident);
  return static_cast<int>(e);
}
