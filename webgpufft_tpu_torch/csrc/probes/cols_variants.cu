// Probe: K2's direct design and ring at a tile the caller names, for the
// one-run comparisons of K2's designs (chip_probes/k1_k2_ring.py,
// chip_probes/k2_fill_variants.py); its fixed design's variants are in
// cols_fixed_variants.cu.
//
// Stands for no Pallas kernel of its own: it launches the kernels of K2
// (webgpufft_tpu/core/fused_cols.py:161's counterpart, cols.cuh) with the
// same chains and tables, where the plans' entry point (fused_cols.cu)
// takes what K2's rule (cols.cuh, cols_rule) picks:
//
//   design 0  the direct design (a CTA a tile, loaded into registers).
//   design 1  the ring with the plans' copy rule: a tile lands by a 3-D
//             tensor map (TMA) where its rows are 16-byte aligned and whole,
//             by cp.async otherwise.
//   design 2  the ring with cp.async (16 or 8 bytes a copy, every thread a
//             share) for every tile: the other way to land a tile, timed
//             where the tensor map would serve.
//
// `tile` is the tile's columns (a power of two; 0: the design's own, the
// direct design's or the ring's narrowed until two stages fit).  The ring's
// grid is the CTAs the device holds, at most one a tile.  With `slots` set,
// nothing launches: it receives how many CTAs the device holds at once.
//
// What bounds it: bytes, 16 * H * cols * pre, as K2.
//
// C interface: wgfft_cols_variant returns the cudaError_t of the launch,
// cudaErrorInvalidValue for a design, chain, tile or view it cannot run.

#include <cuda_runtime.h>

#include "cols.cuh"
#include "radix.cuh"

extern "C" int wgfft_cols_variant(const void* x, void* y, const void* tw, const void* params,
                                  long long pre, int h, long long cols, const int* radices,
                                  int count, int adjoint, int design, int tile, int* slots,
                                  void* stream) {
  Chain chain;
  ColsPlan plan;
  if (design < kColsDirect || design > kColsRingAsync ||
      !wgfft::make_chain(radices, count, h, &chain) ||
      !cols_plan(chain, h, pre, cols, design, tile, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  const wgfft::ColsCall call = {static_cast<const float2*>(x), static_cast<float2*>(y),
                                static_cast<const float2*>(tw), static_cast<const float*>(params),
                                pre, cols, h, adjoint ? -1.f : 1.f,
                                static_cast<cudaStream_t>(stream)};
  if (design != kColsDirect) {
    int ring = 0;
    const cudaError_t e = launch_cols(call, chain, plan, &ring);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (plan.grid > ring) plan.grid = ring;
  }
  return static_cast<int>(launch_cols(call, chain, plan, slots));
}
