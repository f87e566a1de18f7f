// K1's power-of-two design: the powers of two 2048 .. 16384 (the lengths of
// kPow2Lines, lines.cuh), each in a kernel of its own (lines_pow2.cuh).
//
// Same function as the direct design (fused_lines.cu): the natural-order
// DFT of every line of interleaved f32 (lines, N, 2) times the scale, with
// the adjoint launch (cj = -1) and y = x allowed.  Same Stockham pass as
// radix.cuh, on the chain the rule names and on the `cw` table of that
// chain (core/radix.py): 2048 = 16 * 16 * 8 and 4096 = 16 * 16 * 16 as the
// direct design runs them, 8192 = 32 * 16 * 16 and 16384 = 32 * 32 * 16
// where it ran 16 * 8 * 8 * 8 and 16 * 16 * 8 * 8.
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
//   135 KB leave room for one CTA of 512 threads;
// - shared memory padded by one point in every R0 (the first pass's
//   stride), so its strided writes hit 16 distinct 8-byte slots a
//   half-warp; every other access of the chain is contiguous across a warp;
// - the last pass writes global memory with no barrier before it: the
//   line's global reads all ended before the first barrier, and no shared
//   memory is written after it.
// One CTA takes one line, so no CTA is ragged.

#include <cuda_runtime.h>

#include "lines.cuh"
#include "lines_pow2.cuh"

namespace wgfft {

// The rule's lengths (kPow2Lines, lines.cuh), each as N, threads, CTAs an
// SM and its chain.
cudaError_t launch_pow2_lines(const float2* x, float2* y, const float2* tw, const float* params,
                              long long lines, int n, float cj, cudaStream_t stream,
                              int* resident) {
  switch (n) {
    case 2048:
      return pow2::launch<2048, 128, 4, 16, 16, 8>(x, y, tw, params, lines, cj, stream,
                                                   resident);
    case 4096:
      return pow2::launch<4096, 256, 4, 16, 16, 16>(x, y, tw, params, lines, cj, stream,
                                                    resident);
    case 8192:
      return pow2::launch<8192, 256, 2, 32, 16, 16>(x, y, tw, params, lines, cj, stream,
                                                    resident);
    case 16384:
      return pow2::launch<16384, 512, 1, 32, 32, 16>(x, y, tw, params, lines, cj, stream,
                                                     resident);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wgfft
