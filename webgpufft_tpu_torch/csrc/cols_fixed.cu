// K2's fixed design: the entries of K2's rule (kFixedCols, cols_fixed.cuh),
// each a kernel of its own (fixed_cols_kernel, cols_fixed.cuh).
//
// Same function as the direct design (fused_cols.cu): the natural-order DFT
// down every column of a (pre, H, L) view times the scale, the adjoint
// launch (cj = -1), y = x allowed; the same chain (radix_chain) and `cw`
// table.
//
// What held K2 at the views it serves (PERF.md section 6): a tile
// is one CTA sized by its height and columns alone, so (1, 1024, 2048) ran
// 128 CTAs on 132 SMs, one 64 KB tile each with nothing to overlap its
// loads, (3, 2310, 66) 27, and (8, 16384, 64) fit one column a CTA, an
// 8-byte read of every 32-byte sector; and the run-time chain kernels,
// which dispatch every radix of their set in every pass, hold 128
// registers a thread and spill (300 to 5000 bytes in K2's kernels), so an
// SM holds one CTA of 512 threads (at 64 to 512 rows the direct design's
// 8-point CTAs do not spill, and the fixed kernels of 48 to 64 registers
// still ran 1.1 to 2.2 times as fast).  Here:
// - the tile is sized with the view (the rule's entry), 1 to 32 columns,
//   and at the tall heights split over a thread-block cluster of 2, 4 or
//   8 CTAs (the last pass through distributed shared memory, once), so a
//   view of few tiles still puts several CTAs on every SM, and H = 16384
//   takes 4-column tiles, a whole sector a row;
// - the chain, the strides, the butterflies a thread runs and the twiddle
//   offsets are template constants: no pass is chosen at run time, and
//   small odd radices run fused into one butterfly (2310 = 11 * 7 * 30),
//   reading the same table;
// - a kernel per cluster size (a size chosen at run time inside one kernel
//   spilled: PERF.md section 6), launched with cudaLaunchKernelEx,
//   the cluster dimension and load-balancing cluster scheduling as
//   attributes.
// Which heights, tiles and clusters it takes is the measured sweep's
// (chip_probes/k2_fill_variants.py, PERF.md): every other view stays on
// the direct design or the ring.
//
// What bounds it: bytes, 16 * H * cols * pre, as K2; a cluster moves each
// point once more through distributed shared memory.

#include <cuda_runtime.h>

#include "cols_fixed.cuh"

namespace wgfft {

cudaError_t launch_cols_fixed(const ColsCall& call, int entry, int* slots) {
  using fixed::Pass;
#define WGFFT_FIXED(I, H, TC, T, MINB, C, RX, ...)                                         \
  case I:                                                                                   \
    return fixed::launch<H, TC, T, MINB, C, RX, __VA_ARGS__>(                               \
        call.x, call.y, call.tw, call.params, call.pre, call.cols, call.cj, call.stream, slots)
  switch (entry) {
    WGFFT_FIXED(0, 64, 16, 128, 8, 1, 0, Pass<8>, Pass<8>);
    WGFFT_FIXED(1, 128, 32, 256, 4, 1, 0, Pass<16>, Pass<8>);
    WGFFT_FIXED(2, 256, 8, 128, 8, 1, 0, Pass<16>, Pass<16>);
    WGFFT_FIXED(3, 256, 32, 512, 2, 1, 0, Pass<16>, Pass<16>);
    WGFFT_FIXED(4, 360, 16, 384, 2, 1, 0, Pass<8>, Pass<5>, Pass<3, 3>);
    WGFFT_FIXED(5, 512, 8, 256, 4, 1, 0, Pass<8>, Pass<8>, Pass<8>);
    WGFFT_FIXED(6, 1024, 8, 512, 2, 1, 0, Pass<16>, Pass<8>, Pass<8>);
    WGFFT_FIXED(7, 1352, 4, 128, 8, 4, 8, Pass<13>, Pass<13>);
    WGFFT_FIXED(8, 2048, 4, 128, 8, 4, 8, Pass<16>, Pass<16>);
    WGFFT_FIXED(9, 2048, 8, 256, 4, 4, 8, Pass<16>, Pass<16>);
    WGFFT_FIXED(10, 2310, 1, 128, 5, 1, 0, Pass<11>, Pass<7>, Pass<5, 3, 2>);
    WGFFT_FIXED(11, 4096, 4, 128, 8, 8, 16, Pass<16>, Pass<16>);
    WGFFT_FIXED(12, 8192, 4, 256, 4, 8, 8, Pass<16>, Pass<8>, Pass<8>);
    WGFFT_FIXED(13, 16384, 8, 512, 1, 8, 8, Pass<16>, Pass<16>, Pass<8>);
    WGFFT_FIXED(14, 16384, 4, 512, 2, 8, 8, Pass<16>, Pass<16>, Pass<8>);
    default: return cudaErrorInvalidValue;
  }
#undef WGFFT_FIXED
}

}  // namespace wgfft
