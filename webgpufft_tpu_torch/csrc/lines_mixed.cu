// K1's mixed-radix design: the lengths of kMixedLines (lines.cuh), each in
// a kernel of its own (lines_mixed.cuh).
//
// Same function as the direct design (fused_lines.cu): the natural-order
// DFT of every line of interleaved f32 (lines, N, 2) times the scale, with
// the adjoint launch (cj = -1) and y = x allowed (every chain of the rule
// has two passes or more).  Same Stockham pass as radix.cuh, on the chain
// the rule names and on the `cw` table of that chain (core/radix.py
// MIXED_LINES).
//
// What it changes, against what held the direct design at these lengths
// (one CTA an SM from about 2048 points on, sized for the pass with the
// most butterflies; a run-time chain with a division per butterfly; one
// pass for every odd prime, so four or five passes at 2079, 6144, 8232,
// 9216 and 15360):
// - fewer, wider passes: each small odd factor folds into a neighbour as a
//   composite butterfly of at most 32 points in registers (lines_mixed.cuh,
//   its inner twiddles compile-time constants), so 2079 = 27 * 7 * 11,
//   6144 = 32 * 24 * 8 and 15360 = 32 * 32 * 15 take three passes, two trips
//   through shared memory, and 8232 = 8 * 21 * 7 * 7 four;
// - the chain, the strides, m, ns, the butterflies a thread runs and the
//   twiddle offsets are template constants: no pass is chosen at run time,
//   k = j mod ns and a butterfly's line are divisions by constants;
// - threads sized for the chain, not for its smallest radix: every thread
//   holds whole butterflies in every pass (the last round of a pass ragged
//   where the threads do not divide its butterflies), so a thread holds
//   20-32 points at the long lengths and two or more CTAs share an SM up
//   to 9216 points (one at 12288 and 15360, whose line fills most of an
//   SM's shared memory); four lines a CTA at 360.
// Which lengths it takes, and in which chain and CTA, is the measured
// sweep's (chip_probes/k1_mixed_variants.py, PERF.md): every other length
// stays on the direct design.

#include <cuda_runtime.h>

#include "lines.cuh"
#include "lines_mixed.cuh"

namespace wgfft {

// The rule's lengths (kMixedLines, lines.cuh), each as N, lines a CTA,
// threads, CTAs an SM and its chain.
cudaError_t launch_mixed_lines(const float2* x, float2* y, const float2* tw, const float* params,
                               long long lines, int n, float cj, cudaStream_t stream,
                               LinesReport* report) {
#define WGFFT_MIXED(N, ...) \
  case N: return mixed::launch<N, __VA_ARGS__>(x, y, tw, params, lines, cj, stream, report)
  switch (n) {
    WGFFT_MIXED(360, 4, 80, 8, 20, 18);
    WGFFT_MIXED(1000, 1, 100, 10, 10, 10, 10);
    WGFFT_MIXED(1352, 1, 128, 8, 13, 13, 8);
    WGFFT_MIXED(1536, 1, 64, 8, 8, 8, 24);
    WGFFT_MIXED(2079, 1, 96, 4, 27, 7, 11);
    WGFFT_MIXED(2310, 1, 160, 3, 22, 15, 7);
    WGFFT_MIXED(3000, 1, 100, 4, 10, 10, 30);
    WGFFT_MIXED(3072, 1, 128, 4, 32, 4, 24);
    WGFFT_MIXED(5120, 1, 320, 2, 16, 16, 20);
    WGFFT_MIXED(6000, 1, 256, 2, 24, 25, 10);
    WGFFT_MIXED(6144, 1, 256, 2, 32, 24, 8);
    WGFFT_MIXED(8232, 1, 392, 2, 8, 21, 7, 7);
    WGFFT_MIXED(9216, 1, 384, 2, 32, 24, 12);
    WGFFT_MIXED(12288, 1, 512, 1, 32, 32, 12);
    WGFFT_MIXED(15360, 1, 512, 1, 32, 32, 15);
    default: return cudaErrorInvalidValue;
  }
#undef WGFFT_MIXED
}

}  // namespace wgfft
