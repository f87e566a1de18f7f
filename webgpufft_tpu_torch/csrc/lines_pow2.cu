// K1's power-of-two design: the powers of two 256 and 1024 .. 16384 (the
// lengths of kPow2Lines, lines.cuh), each in a kernel of its own
// (lines_pow2.cuh).
//
// Same function as the direct design (fused_lines.cu): the natural-order
// DFT of every line of interleaved f32 (lines, N, 2) times the scale, with
// the adjoint launch (cj = -1) and y = x allowed.  Same Stockham pass as
// radix.cuh, on the chain the rule names and on the `cw` table of that
// chain (core/radix.py): 1024 = 16 * 8 * 8, 2048 = 16 * 16 * 8 and 4096 =
// 16 * 16 * 16 as the direct design runs them, 8192 = 32 * 16 * 16 and
// 16384 = 32 * 32 * 16 where it ran 16 * 8 * 8 * 8 and 16 * 16 * 8 * 8, and
// 256 = 8 * 8 * 4 where it ran 16 * 16.
//
// What it changes, against what held the direct design at these lengths:
// - three passes where the direct design ran four at 8192 and 16384: two
//   trips through shared memory, not three; the first pass is a 32-point
//   butterfly in registers (Butterfly<32>, radix.cuh);
// - the chain, the strides, m, ns, the butterflies a thread runs and the
//   twiddle offsets are template constants: k = j mod ns is a mask, the
//   passes are unrolled, no thread divides, no pass is chosen at run time
//   (a run-time switch over sizes spills);
// - CTAs sized so that several lines share an SM and one's loads and stores
//   overlap another's passes: at 8192 256 threads of 32 points (at most 128
//   registers, 67.6 KB of shared memory), two an SM; at 4096 256 threads of
//   16 points, four; at 2048 128 threads of 16, four; at 16384 the line's
//   135 KB leave room for one CTA of 512 threads; at 1024 64 threads of 16
//   points, sixteen (a CTA of two warps, its barriers over those two only);
//   at 256 one warp of 8 points, thirty-two (the most CTAs an SM takes,
//   every barrier a warp's);
// - shared memory padded by one point in every R0 (the first pass's
//   stride), so its strided writes hit 16 distinct 8-byte slots a
//   half-warp; every other access of the chain is contiguous across a warp;
// - the last pass writes global memory with no barrier before it: the
//   line's global reads all ended before the first barrier, and no shared
//   memory is written after it.
// One CTA takes one line, so no CTA is ragged.  At 1024 and 256 the short
// CTAs ran faster than the warp design (lines_warp.cu), whose lines share a
// warp's loop and its registers: 1024 x 4096 in 0.0259 ms against 0.0274
// and the direct design's 0.0333, 256 x 65,536 in 0.0918 against 0.1001
// and 0.0951 (PERF.md).

#include <cuda_runtime.h>

#include "lines.cuh"
#include "lines_pow2.cuh"

namespace wgfft {

// The rule's lengths (kPow2Lines, lines.cuh), each as N, threads, CTAs an
// SM and its chain.
cudaError_t launch_pow2_lines(const float2* x, float2* y, const float2* tw, const float* params,
                              long long lines, int n, float cj, cudaStream_t stream,
                              LinesReport* report) {
  switch (n) {
    case 256:
      return pow2::launch<256, 32, 32, 8, 8, 4>(x, y, tw, params, lines, cj, stream, report);
    case 1024:
      return pow2::launch<1024, 64, 16, 16, 8, 8>(x, y, tw, params, lines, cj, stream, report);
    case 2048:
      return pow2::launch<2048, 128, 4, 16, 16, 8>(x, y, tw, params, lines, cj, stream,
                                                   report);
    case 4096:
      return pow2::launch<4096, 256, 4, 16, 16, 16>(x, y, tw, params, lines, cj, stream,
                                                    report);
    case 8192:
      return pow2::launch<8192, 256, 2, 32, 16, 16>(x, y, tw, params, lines, cj, stream,
                                                    report);
    case 16384:
      return pow2::launch<16384, 512, 1, 32, 32, 16>(x, y, tw, params, lines, cj, stream,
                                                     report);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wgfft
