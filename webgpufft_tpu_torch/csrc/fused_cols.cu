// K2: columns kernel, c2c FFT along axis 1 of a (pre, H, L) view.
//
// Replaces the Pallas kernel of webgpufft_tpu/core/fused_cols.py
// (build_fused_cols -> fn, kernel body _cols_kernel).  L = 2 * cols holds
// interleaved complex columns (everything that trails the transform axis);
// the transform runs down each column and the result is in natural order,
// times the plan's scale.  The TPU kernel's two direct digit DFTs
// (8 * (h1 + h2) flops per point on the matrix unit) are replaced by the
// chain of in-register radix butterflies of radix.cuh (about 5 * log2 H
// flops per point), shared with K1.
//
// What bounds it on an H100: bytes.  One read and one write of the view,
// 16 * H * cols * pre bytes (268 MB per axis pass of a 256^3 plan: 80 us at
// the data sheet's 3.35 TB/s); the butterflies need about 40 flops per point
// at H = 256 against the roughly 320 the card affords per 16-byte point.
// What holds it from that bound is, as for K1, the time an SM spends on the
// passes while it moves no bytes.
//
// A CTA owns one pre index and a tile of tc neighbouring complex columns.
// One thread owns the R rows of one column's butterfly, and neighbouring
// threads take neighbouring columns: every global access of a row is one
// contiguous run of tc * 8 bytes although rows are L floats apart, and a
// row's twiddle is one broadcast load.  Columns past the ragged edge load
// zeros and store nothing.  Two designs, chosen by the tile (cols.cuh,
// cols_design):
//
// - Tiles of fewer than 8192 points (the direct design; H < 512 at 16 columns):
//   tc = 16, shrunk so H * tc <= 16384 points and no wider than the column
//   count (32 for a one-pass H, which holds no tile); the first pass loads
//   rows straight into registers and the last stores them, so the tile
//   (H * tc * 8 bytes, 32 KB at H = 256 = 16 * 16) is crossed once per
//   inner pass; a warp's shared-memory access is whole rows of neighbouring
//   points (conflict-free by construction), and a one-pass H (2..13, 16)
//   uses no shared memory.  Several CTAs share an SM.  A copy of the same
//   tiles (read, write, no arithmetic) runs at the speed of a contiguous
//   copy, so the tile shape costs no bandwidth.
// - Tiles of 8192 points or more, where one tile filled a CTA and the CTA
//   an SM (H = 1024: a 128 KB tile, 512 threads of 32 points that spilled
//   1.4 KB each, 0.24 of the bound), the ring design (stage.cuh): a
//   persistent grid whose CTAs walk their tiles with two stages in shared
//   memory, the next tile landing by a 3-D tensor map (rows 16-byte aligned
//   and the tile whole; cp.async of 16 or 8 bytes otherwise, ragged columns
//   zero-filled) while the current one runs its passes.  Two stages must fit
//   227 KB, so the tile narrows to tc = 8 at H = 1024, 4 at 2048 (8192
//   points, 16 a thread: no longer 32, which spilled); the passes exchange
//   in place in the stage with one point of padding in 16 over the tile's
//   row-major index, which keeps the narrower tiles' strided writes
//   conflict-free.  At H = 1024 and 2048 it runs 1.6-1.8x faster than the
//   direct design and beats cuFFT (0.44 of the bound on the H100; PERF.md);
//   the load is hidden there, and what holds it now is again the passes, one
//   CTA an SM.  Where the ring's tile would fall below 4 columns (H = 4096,
//   8192: rows of 16 or 8 bytes, part of a 32-byte sector; measured slower)
//   or not fit twice (H = 14,641, 16,384), the direct design stays.
//   cp.async for every tile is measured beside the tensor map in
//   probes/cols_variants.cu.
//
// C interface: wgfft_fused_cols returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a chain it cannot run.  adjoint != 0 runs the
// conjugate transpose of the same tables' transform (autograd's backward).
// y may be x (in place) for a chain of two or more passes: a CTA owns every
// tile it transforms and reads a tile before it writes any of it.
// wgfft_fused_cols_ring says which design and tile a view takes.

#include <cuda_runtime.h>

#include "cols.cuh"
#include "radix.cuh"

extern "C" int wgfft_fused_cols(const void* x, void* y, const void* tw, const void* params,
                                long long pre, int h, long long cols, const int* radices,
                                int count, int adjoint, void* stream) {
  Chain chain;
  ColsShape shape;
  if (!wgfft::make_chain(radices, count, h, &chain))
    return static_cast<int>(cudaErrorInvalidValue);
  const int design = cols_design(chain, h, cols);
  if (!cols_plan(chain, h, pre, cols, design, &shape))
    return static_cast<int>(cudaErrorInvalidValue);
  const LaunchCols f = {static_cast<const float2*>(x), static_cast<float2*>(y),
                        static_cast<const float2*>(tw), static_cast<const float*>(params),
                        pre, cols, h, adjoint ? -1.f : 1.f, static_cast<cudaStream_t>(stream),
                        chain, shape, design, nullptr};
  return static_cast<int>(wgfft::dispatch_cols(chain, shape, f));
}

// The design wgfft_fused_cols takes for height h over `cols` complex
// columns on the current device: the ring's persistent grid (CTAs, for a
// tile count that fills it) where the ring serves the view, 0 where the
// direct design does, -1 for a chain no design runs; *tile is set to the
// columns of the design's tile.
extern "C" int wgfft_fused_cols_ring(int h, long long cols, const int* radices, int count,
                                     int* tile) {
  Chain chain;
  ColsShape shape;
  if (cols < 1 || !wgfft::make_chain(radices, count, h, &chain)) return -1;
  const int design = cols_design(chain, h, cols);
  if (!cols_plan(chain, h, 1, cols, design, &shape)) return -1;
  *tile = shape.tc;
  if (design == kColsDirect) return 0;
  int grid = 0;
  const LaunchCols f = {nullptr, nullptr, nullptr, nullptr, 0x7fffffffLL / shape.tiles, cols, h,
                        1.f, nullptr, chain, shape, design, &grid};
  return wgfft::dispatch_cols(chain, shape, f) == cudaSuccess ? grid : -1;
}
