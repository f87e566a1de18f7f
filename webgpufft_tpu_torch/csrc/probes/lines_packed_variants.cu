// K1's packed design in variants the caller names by index, for the
// one-run comparison of chip_probes/k1_packed_variants.py.  No plan launches
// these; the plans' entry point (fused_lines.cu) launches the design its
// rule gives a length (lines_packed.cu for the lengths of kPackedLines).
// Each variant is one instantiation of lines_packed.cuh (length, lanes a
// line, stages, chain).  Kept: 128 points, which stays on the direct design
// because the packed design won at 8,192 lines and lost at 196,608 (a rule
// by line count would take it, PERF.md).  PACKED_VARIANTS of
// probes/variants.py holds the same list in the same order.

#include <cuda_runtime.h>

#include "lines_packed.cuh"

namespace {

using wgfft::LinesReport;

struct Variant {
  int n;
  cudaError_t (*launch)(const float2*, float2*, const float2*, const float*, long long, float,
                        cudaStream_t, LinesReport*);
};

const Variant kVariants[] = {
    {128, wgfft::packed::launch<128, 8, 2, 16, 8>},
    {128, wgfft::packed::launch<128, 8, 1, 16, 8>},
};

}  // namespace

// x, y (y may be x), the variant's cw table and K1's cp table, lines; the
// variant's length n is checked against the caller's.  With `resident` not
// null nothing launches and the CTAs an SM holds are written there.
extern "C" int wgfft_packed_variant(const void* x, void* y, const void* tw, const void* params,
                                    long long lines, int n, int variant, int adjoint,
                                    int* resident, void* stream) {
  if (lines < 1 || lines > 0x7fffffffLL || variant < 0 ||
      variant >= static_cast<int>(sizeof(kVariants) / sizeof(kVariants[0])) ||
      kVariants[variant].n != n)
    return static_cast<int>(cudaErrorInvalidValue);
  LinesReport report = {};
  const cudaError_t e = kVariants[variant].launch(
      static_cast<const float2*>(x), static_cast<float2*>(y), static_cast<const float2*>(tw),
      static_cast<const float*>(params), lines, adjoint ? -1.f : 1.f,
      static_cast<cudaStream_t>(stream), resident != nullptr ? &report : nullptr);
  if (resident != nullptr) *resident = static_cast<int>(report.resident);
  return static_cast<int>(e);
}
