// Probe: K2 in a design the caller names, for the one-run comparison of
// the direct design and the ring (chip_probes/k1_k2_ring.py).
//
// Stands for no Pallas kernel of its own: it launches the kernels of K2
// (webgpufft_tpu/core/fused_cols.py:161's counterpart, cols.cuh) with the
// same chains, tables and tiles, where the plans' entry point
// (fused_cols.cu) picks the design by tile:
//
//   design 0  the direct design, at any height it runs.  Where the ring
//             serves a view (cols.cuh, cols_design) no plan launches it
//             any more; this is where it stays reachable.
//   design 1  the ring with the plans' copy rule: a tile lands by a 3-D
//             tensor map (TMA) where its rows are 16-byte aligned and whole,
//             by cp.async otherwise.
//   design 2  the ring with cp.async (16 or 8 bytes a copy, every thread a
//             share) for every tile: the other way to land a tile, timed
//             where the tensor map would serve.
//
// The ring designs run any chain of two or more passes whose tile (the
// direct design's, narrowed until two stages fit) fits, below 8192 points
// and at narrow tiles too.
//
// What bounds it: bytes, 16 * H * cols * pre, as K2.
//
// C interface: wgfft_cols_variant returns the cudaError_t of the launch,
// cudaErrorInvalidValue for a design, chain or view it cannot run.

#include <cuda_runtime.h>

#include "cols.cuh"
#include "radix.cuh"

extern "C" int wgfft_cols_variant(const void* x, void* y, const void* tw, const void* params,
                                  long long pre, int h, long long cols, const int* radices,
                                  int count, int adjoint, int design, void* stream) {
  Chain chain;
  ColsShape shape;
  if (design < kColsDirect || design > kColsRingAsync ||
      !wgfft::make_chain(radices, count, h, &chain) ||
      !cols_plan(chain, h, pre, cols, design, &shape))
    return static_cast<int>(cudaErrorInvalidValue);
  const LaunchCols f = {static_cast<const float2*>(x), static_cast<float2*>(y),
                        static_cast<const float2*>(tw), static_cast<const float*>(params),
                        pre, cols, h, adjoint ? -1.f : 1.f, static_cast<cudaStream_t>(stream),
                        chain, shape, design, nullptr};
  return static_cast<int>(wgfft::dispatch_cols(chain, shape, f));
}
