// K1's warp design: the length of kWarpLines (lines.cuh), 512, in a kernel
// of its own (lines_warp.cuh); 32, its other length until the packed design
// (lines_packed.cu) ran it faster, stays among the probe variants.
//
// Same function as the direct design (fused_lines.cu): the natural-order
// DFT of every line of interleaved f32 (lines, N, 2) times the scale, with
// the adjoint launch (cj = -1) and y = x allowed on a chain of two passes or
// more.  Same Stockham pass as radix.cuh, on radix_chain's own chain (8 * 4
// and 8 * 8 * 8, so the `cw` table is the direct design's).
//
// What it changes, against what held the direct design at these lengths
// (a CTA of about 256 threads over 4 to 64 whole lines, two __syncthreads a
// pass across all of them, a run-time chain with a division per butterfly,
// and a grid of one CTA a group of lines whatever the SM count):
// - a line lives in one warp (512: 32 lanes of 16 points; 32: 4 lanes of 8,
//   eight lines a warp), so a pass's exchange is a trip through the line's
//   own shared memory under __syncwarp, with no CTA-wide barrier, and no
//   warp waits for another;
// - the chain, the strides, m, ns and the twiddle offsets are template
//   constants: k = j mod ns is a mask, no lane divides, no pass is chosen at
//   run time; a warp's twiddles do not depend on the lines it takes, so
//   they stay in registers across its loop (at 512, 166 registers of the
//   168 that six CTAs an SM leave);
// - CTAs of two warps and a grid sized from the lines and the SMs
//   (lines_warp.cuh): 32 x 1536 spreads over 96 CTAs where the direct design
//   took 24; 512 x 4096 runs one wave of three equal rounds.
// On the H100 it ran 512 x 4096 in 0.0102 ms where the direct design took
// 0.0168, and 32 x 1536 in 0.0033 where it took 0.0054 (PERF.md).
// At 1024 and 256 the power-of-two design's one line a CTA ran faster
// (lines_pow2.cu); so did it, within 2 %, at 512.

#include <cuda_runtime.h>

#include "lines.cuh"
#include "lines_warp.cuh"

namespace wgfft {

// The rule's lengths (kWarpLines, lines.cuh), each as N, lanes a line,
// threads a CTA, CTAs an SM and its chain.
cudaError_t launch_warp_lines(const float2* x, float2* y, const float2* tw, const float* params,
                              long long lines, int n, float cj, cudaStream_t stream,
                              LinesReport* report) {
  switch (n) {
    case 512:
      return warp::launch<512, 32, 64, 6, 8, 8, 8>(x, y, tw, params, lines, cj, stream, report);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wgfft
