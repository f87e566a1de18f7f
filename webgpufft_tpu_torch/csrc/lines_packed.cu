// K1's packed design: the lengths of its table (WGFFT_PACKED_LINES and
// kPackedLines, lines.cuh), each in a kernel of its own (lines_packed.cuh).
//
// Same function as the direct design (fused_lines.cu): the natural-order
// DFT of every line of interleaved f32 (lines, N, 2) times the scale, with
// the adjoint launch (cj = -1), on radix_chain's own chain (so the `cw`
// table is the direct design's, and no exported artifact changes), and
// y = x allowed at every length, one-pass chains included.
//
// What held the direct design at these lengths (128 points or less): a CTA
// of about 256 threads over whole lines, its grid one CTA a group of lines
// whatever the SM count (100,003 lines of 16 points: 391 CTAs, 0.74 of a
// wave); the first pass reading global memory straight into registers, so
// that a warp's load touched 32 lines 8 bytes each (at N = 16, 128 bytes
// apart), and the last pass storing the same way; at 64 and 128 a run-time
// chain over 32 or 16 lines with two __syncthreads a pass across all of
// them.  What the packed design does about it:
// - a warp's lines are one contiguous block, landed in shared memory and
//   stored back by 16-byte copies, whatever the line length (odd N
//   included), every load and store coalesced;
// - the chain is a compile-time one; with one lane a line (the lengths up
//   to 32, and wherever the sweep found it fastest) the passes run in the
//   lane's registers with compile-time twiddles and no exchange at all;
//   with a few lanes a line, the exchanges go through the line's own
//   stretch of the stage under __syncwarp, never a CTA-wide barrier;
// - the grid is sized from the lines and the SMs, so a long launch runs one
//   wave of equal rounds and a short one spreads.
// Which shape each length takes (lanes a line, stages) is the measured
// sweep's (chip_probes/k1_packed_variants.py, PERF.md); a length enters the
// table only where a kernel that does not spill beat the direct design at
// both line counts of the sweep: one lane a line up to 30 points, 2 to 8 lanes
// from 32, two stages at most lengths.  On the H100 it ran 16 x 100,003 in
// 0.0081 ms where the direct design took 0.0355 (cuFFT 0.0096), and every
// one of its 62 lengths 3-79 % faster than the direct design (32: than the
// warp design) at both counts.  96, 108 and 120 (every kernel kept for them
// spilled) and 128 (2.6 % slower at 196,608 lines) stay on the direct
// design.

#include <cuda_runtime.h>

#include "lines.cuh"
#include "lines_packed.cuh"

namespace wgfft {

// lines_packed_2.cu .. _4.cu: parts 1 to 3 of the table (packed::part_of),
// in translation units of their own so that the four compile side by side.
#define WGFFT_PACKED_PART(K)                                                                  \
  cudaError_t launch_packed_part_##K(const float2* x, float2* y, const float2* tw,           \
                                     const float* params, long long lines, int n, float cj,  \
                                     cudaStream_t stream, LinesReport* report);
WGFFT_PACKED_PART(1)
WGFFT_PACKED_PART(2)
WGFFT_PACKED_PART(3)
#undef WGFFT_PACKED_PART

cudaError_t launch_packed_lines(const float2* x, float2* y, const float2* tw, const float* params,
                                long long lines, int n, float cj, cudaStream_t stream,
                                LinesReport* report) {
  switch (packed::part_of(n)) {
    case 0: return packed::launch_part<0>(x, y, tw, params, lines, n, cj, stream, report);
    case 1: return launch_packed_part_1(x, y, tw, params, lines, n, cj, stream, report);
    case 2: return launch_packed_part_2(x, y, tw, params, lines, n, cj, stream, report);
    default: return launch_packed_part_3(x, y, tw, params, lines, n, cj, stream, report);
  }
}

}  // namespace wgfft
