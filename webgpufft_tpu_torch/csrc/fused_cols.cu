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
// zeros and store nothing.  Four designs, chosen by K2's rule (cols.cuh,
// cols_rule, with its Python copy fused_cols.cols_rule): the fixed design
// (cols_fixed.cu) for the views of its entries, kFixedCols, the general
// design (cols_general.cu) for the heights of its table,
// WGFFT_GENERAL_COLS, and by the tile alone (cols_design) elsewhere:
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
// - The fixed design (cols_fixed.cuh, cols_fixed.cu): a kernel per height,
//   tile and cluster size with the chain at compile time, at the heights
//   where the two designs above left the card half idle (few column tiles,
//   tall narrow columns, odd heights) and at the heights the paths launch
//   most (64 to 512), where it measured faster than both; a tile sized with
//   the view, split over a thread-block cluster at the tall heights.
// - The general design (cols_general.cuh, cols_general.cu): 772 of the
//   other heights, each in the fewest passes of radices up to 32 (a
//   run-time chain; 1080 = 12 * 10 * 9 where radix_chain takes five
//   passes), with K2's `cw` laid out for that chain (cols_chain); the
//   direct design and the ring keep the heights where it lost (PERF.md).
//
// C interface: wgfft_fused_cols returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a chain or view its rule does not cover (at a
// height of kFixedCols or kGeneralCols, any chain but the entry's).  adjoint != 0 runs the
// conjugate transpose of the same tables' transform (autograd's backward).
// y may be x (in place) for a chain of two or more passes: a CTA owns every
// tile it transforms and reads a tile before it writes any of it (a
// cluster, every one of its rows).  wgfft_fused_cols_plan says what the
// rule launches for a view.

#include <cuda_runtime.h>

#include "cols.cuh"
#include "radix.cuh"

namespace {

// SMs of the current device, asked of the runtime once per device.
cudaError_t device_sms(int* sms) {
  constexpr int kDevices = 64;
  static int known[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kDevices && known[dev] > 0) {
    *sms = known[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kDevices) known[dev] = *sms;
  return e;
}

// The chain an entry point is handed, as a Chain: at a height of the
// general design's table its radices as they are (up to 32; cols_rule
// holds them to the table's chain), elsewhere the direct design's radices
// that multiply to h (make_chain).
bool entry_chain(const int* radices, int count, int h, Chain* out) {
  if (wgfft::general_cols_entry(h, 1) == -1) return wgfft::make_chain(radices, count, h, out);
  if (count < 1 || count > wgfft::general::kMaxPasses) return false;
  *out = {};
  out->count = count;
  for (int p = 0; p < count; ++p) out->radix[p] = radices[p];
  return true;
}

// launch_cols, and the general design's entries, which it leaves out
cudaError_t launch_k2(const wgfft::ColsCall& call, const Chain& chain, const ColsPlan& plan,
                      int* slots) {
  if (plan.design == kColsGeneral) return wgfft::launch_cols_general(call, plan.entry, slots);
  return launch_cols(call, chain, plan, slots);
}

}  // namespace

extern "C" int wgfft_fused_cols(const void* x, void* y, const void* tw, const void* params,
                                long long pre, int h, long long cols, const int* radices,
                                int count, int adjoint, void* stream) {
  Chain chain;
  ColsPlan plan;
  int sms = 0;
  if (!entry_chain(radices, count, h, &chain))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!cols_rule(chain, h, pre, cols, sms, &plan)) return static_cast<int>(cudaErrorInvalidValue);
  const wgfft::ColsCall call = {static_cast<const float2*>(x), static_cast<float2*>(y),
                                static_cast<const float2*>(tw), static_cast<const float*>(params),
                                pre, cols, h, adjoint ? -1.f : 1.f,
                                static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_k2(call, chain, plan, nullptr));
}

// What wgfft_fused_cols launches for a (pre, h, cols) view: K2's rule on a
// device of `sms` SMs into out[0..5] = design (ColsDesign), tile (columns),
// CTAs a tile, units (tiles), grid (CTAs), threads a CTA; with sms = 0 the
// current device's SMs, and out[6] = how many CTAs (clusters, for a cluster
// of 2 or more) of the chosen kernel the device holds at once, else -1.
// cudaErrorInvalidValue for a view the rule does not cover.
extern "C" int wgfft_fused_cols_plan(long long pre, int h, long long cols, const int* radices,
                                     int count, int sms, long long* out) {
  Chain chain;
  ColsPlan plan;
  const bool device = sms == 0;
  if (!entry_chain(radices, count, h, &chain))
    return static_cast<int>(cudaErrorInvalidValue);
  if (device) {
    const cudaError_t e = device_sms(&sms);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (!cols_rule(chain, h, pre, cols, sms, &plan)) return static_cast<int>(cudaErrorInvalidValue);
  const long long fields[7] = {plan.design, plan.tile, plan.cluster, plan.units,
                               plan.grid,   plan.threads, -1};
  for (int i = 0; i < 7; ++i) out[i] = fields[i];
  if (!device) return 0;
  int slots = 0;
  const wgfft::ColsCall call = {nullptr, nullptr, nullptr, nullptr, pre, cols, h, 1.f, nullptr};
  const cudaError_t e = launch_k2(call, chain, plan, &slots);
  out[6] = slots;
  return static_cast<int>(e);
}
