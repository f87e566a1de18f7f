// K1's power-of-two and warp designs in variants the caller names by
// index, for the one-run comparison of chip_probes/k1_pow2_variants.py.  No
// plan launches these; the plans' entry point (fused_lines.cu) launches the
// design its rule gives a length (lines_pow2.cu, lines_warp.cu).  Each
// variant is one instantiation of lines_pow2.cuh (length, threads a CTA,
// CTAs an SM asked for, chain) or lines_warp.cuh (length, lanes a line,
// threads a CTA, CTAs an SM asked for, chain).  LINES_VARIANTS of
// probes/variants.py holds the same list in the same order.

#include <cuda_runtime.h>

#include "lines_pow2.cuh"
#include "lines_warp.cuh"

namespace {

using wgfft::LinesReport;

cudaError_t launch_variant(int variant, const float2* x, float2* y, const float2* tw,
                           const float* params, long long lines, float cj, cudaStream_t stream,
                           LinesReport* report) {
#define WGFFT_VARIANT(I, ...)                                                                 \
  case I:                                                                                     \
    return wgfft::pow2::launch<__VA_ARGS__>(x, y, tw, params, lines, cj, stream, report)
#define WGFFT_WARP(I, ...) \
  case I: return wgfft::warp::launch<__VA_ARGS__>(x, y, tw, params, lines, cj, stream, report)
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
    // the short lengths: the warp design (N, lanes a line, threads, CTAs an
    // SM, chain) and the power-of-two design's one line a CTA
    WGFFT_WARP(14, 1024, 32, 64, 8, 32, 32);           // a line a warp, 32 points a lane
    WGFFT_WARP(15, 1024, 32, 32, 16, 32, 32);          // the same, one warp a CTA
    WGFFT_WARP(16, 1024, 32, 128, 4, 32, 32);          // the same, four warps a CTA
    WGFFT_WARP(17, 1024, 32, 64, 8, 16, 8, 8);         // the direct chain (spills)
    WGFFT_VARIANT(18, 1024, 64, 12, 16, 8, 8);         // twelve CTAs an SM, up to 80 registers
    WGFFT_WARP(19, 512, 16, 64, 8, 32, 16);            // two passes, 32 points a lane
    WGFFT_WARP(20, 512, 16, 64, 8, 16, 32);            // the radix-32 pass last
    WGFFT_WARP(21, 512, 32, 64, 8, 8, 8, 8);           // the rule's chain, up to 128 registers
    WGFFT_VARIANT(22, 512, 64, 16, 8, 8, 8);           // a line a CTA of two warps
    WGFFT_WARP(23, 256, 16, 64, 8, 16, 16);            // two lines a warp, 16 points a lane
    WGFFT_WARP(24, 256, 8, 64, 8, 32, 8);              // four lines a warp, 32 points a lane
    WGFFT_WARP(25, 256, 16, 128, 4, 16, 16);           // four warps a CTA
    WGFFT_WARP(26, 32, 4, 64, 16, 8, 4);               // the rule's
    WGFFT_WARP(27, 32, 1, 64, 8, 32);                  // a line a lane, one pass
    WGFFT_WARP(28, 32, 4, 32, 32, 8, 4);               // one warp a CTA
    WGFFT_WARP(29, 64, 8, 64, 16, 8, 8);               // 64 and 128, not in the rule
    WGFFT_WARP(30, 128, 8, 64, 8, 16, 8);
    WGFFT_VARIANT(31, 1024, 64, 16, 16, 8, 8);         // the rule's
    WGFFT_VARIANT(32, 1024, 64, 12, 16, 16, 4);        // radix 16 twice
    WGFFT_VARIANT(33, 1024, 128, 8, 8, 8, 4, 4);       // 128 threads of 8 points
    WGFFT_VARIANT(34, 512, 32, 24, 8, 8, 8);           // a line a CTA of one warp
    WGFFT_WARP(35, 512, 32, 64, 6, 8, 8, 8);           // the rule's
    WGFFT_WARP(36, 256, 16, 64, 16, 16, 16);           // sixteen CTAs an SM (spills)
    WGFFT_WARP(37, 256, 32, 64, 16, 8, 8, 4);          // a line a warp, 8 points a lane (spills)
    WGFFT_VARIANT(38, 256, 32, 32, 8, 8, 4);           // the rule's
    WGFFT_WARP(39, 256, 16, 64, 12, 16, 16);           // twelve CTAs an SM
    WGFFT_WARP(40, 128, 8, 64, 12, 16, 8);             // twelve CTAs an SM, up to 80 registers
    WGFFT_WARP(41, 128, 16, 64, 16, 8, 4, 4);          // two lines a warp, 8 points a lane
    WGFFT_WARP(42, 128, 8, 32, 16, 16, 8);             // one warp a CTA
    default: return cudaErrorInvalidValue;
  }
#undef WGFFT_WARP
#undef WGFFT_VARIANT
}

}  // namespace

// x, y (y may be x), the variant's cw table and K1's cp table, lines; the
// variant's length n is checked against the caller's.  With `resident` not
// null nothing launches and the CTAs an SM holds are written there.
extern "C" int wgfft_lines_variant(const void* x, void* y, const void* tw, const void* params,
                                   long long lines, int n, int variant, int adjoint,
                                   int* resident, void* stream) {
  static const int kLengths[] = {8192, 8192, 8192, 8192, 8192, 16384, 16384, 16384,
                                 4096, 4096, 2048, 2048, 2048, 2048, 1024, 1024,
                                 1024, 1024, 1024, 512,  512,  512,  512,  256,
                                 256,  256,  32,   32,   32,   64,   128,  1024,
                                 1024, 1024, 512,  512,  256,  256,  256,  256,
                                 128,  128,  128};
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
