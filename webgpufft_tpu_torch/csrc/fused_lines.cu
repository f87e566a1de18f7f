// K1: fused line kernel, batched c2c FFT along the contiguous last axis.
//
// Replaces the Pallas kernel of webgpufft_tpu/core/fused.py
// (build_fused_lines -> fused_fn, kernel bodies _fft_kernel_v1 and
// _fft_kernel_v2).  It computes the same function, the natural-order DFT of
// every line of interleaved f32 (lines, N, 2) times the plan's scale, not
// the same arithmetic: the TPU kernel's two direct digit DFTs (matrix-unit
// work, 8 * (n1 + n2) flops per point) are replaced by a chain of
// in-register radix butterflies (radix.cuh, about 5 * log2 N flops per
// point).
//
// What bounds it on an H100: bytes.  Each line is read once and written
// once, 16 * N * lines bytes (67 MB for N = 1024 x 4096 lines: 20 us at the
// data sheet's 3.35 TB/s); the butterflies need about 50 flops per point at
// N = 1024 against the roughly 320 the card affords per 16-byte point.
// What holds a CTA from that bound is the time its line spends in the
// passes, each inner pass a trip through shared memory between two
// barriers, with nothing to cover it when an SM holds one CTA.
//
// Seven designs, and a rule (kPow2Lines, kWarpLines, kMixedLines,
// kPackedLines and kGeneralLines, lines.cuh, and kClusterLines,
// cluster.cuh; core/radix.py POW2_LINES, WARP_LINES, MIXED_LINES,
// PACKED_LINES, GENERAL_LINES and CLUSTER_LINES) that gives each length one
// of them:
// - the power-of-two design (lines_pow2.cu, lines_pow2.cuh) for 256, 1024,
//   2048, 4096, 8192 and 16384: a kernel per length whose chain, strides
//   and twiddle offsets are template constants, one line a CTA, three
//   passes (8192 = 32 * 16 * 16 and 16384 = 32 * 32 * 16, where the direct
//   design took four; 256 = 8 * 8 * 4 in one warp) and CTAs small enough
//   that 2 (8192) to 32 (256) share an SM.  On the H100 it ran 1.7-1.9x
//   faster than the direct design at 8192 and 16384, 5-36 % faster at 2048
//   and 4096, 1.22-1.29x at 1024 and 3-4 % at 256 (PERF.md): of that, the
//   constants (no run-time chain loop, no division per butterfly) and the
//   smaller CTAs did most; the radix-32 pass did it at 16384 (four passes
//   9-16 % slower).  A ring of stages that lands the next line while the
//   current one runs its passes, and a split of a line over a thread-block
//   cluster, were measured at the long lengths before and lost to the
//   direct design: the load they hide is small beside the passes;
// - the warp design (lines_warp.cu, lines_warp.cuh) for 512: a line in the
//   lanes of one warp, its exchanges under __syncwarp, and a grid sized
//   from the lines and the SMs (1.6-1.65x faster than the direct design at
//   32 x 1536 and 512 x 4096; 32 runs the packed design now);
// - the mixed-radix design (lines_mixed.cu, lines_mixed.cuh) for the
//   measured lengths that are not powers of two: a kernel per length whose
//   chain of two to four passes folds the small odd factors into composite
//   butterflies of up to 32 points (2079 = 27 * 7 * 11 where the direct
//   design ran five passes), CTAs sized for the chain so that two or more
//   share an SM up to 9216 points; 1.7-4.4x faster than the direct design
//   at the fifteen lengths of its sweep (PERF.md);
// - the packed design (lines_packed.cu, lines_packed.cuh) for the short
//   lengths (128 points or less) where its sweep beat the direct design: a
//   kernel per length, a warp's lines landed in shared memory as one
//   contiguous block by 16-byte copies, run there in one lane's registers
//   (or a few lanes' under __syncwarp) and stored the same way, on a grid
//   sized from the lines and the SMs; it runs in place at every chain;
// - the general mixed-radix design (lines_general.cu, lines_general.cuh)
//   for the lengths of its table: the mixed-radix design's butterflies on
//   a run-time chain of two to four passes, the fewest its radices allow
//   (where radix_chain takes four to eight from 129 points), CTAs sized for
//   the chain, five kernel instantiations (16 to 64 points a thread) for
//   all of its 715 lengths; on the NVIDIA H100 80GB HBM3 at 700 W each ran
//   in 0.11-0.91 of the direct design's time at 1000 lines and at 67 MB
//   (PERF.md);
// - the cluster design (cluster.cu, cluster.cuh; shared with K2) for the
//   lengths of its table, from 11583 points, which no class of the general
//   design holds in one CTA (two exchange buffers over 227 KB, or more
//   threads than the class has): the general design's passes on a line
//   split over a thread-block cluster of 2 to 8 CTAs, the first pass across
//   it through distributed shared memory (PERF.md);
// - the direct design below for every other length.
//
// Direct design: a CTA takes as many whole lines as keep about 256 threads
// busy with one butterfly group each in every pass (16 lines at N = 128 =
// 16 * 8, 3 at N = 360 = 8 * 5 * 3 * 3, 1 from N = 2048 on), so short lines
// leave no thread idle.  The first pass loads global memory straight into
// registers (neighbouring threads on neighbouring points of a line), the
// last stores registers straight to global memory in natural order, and the
// passes between exchange through shared memory, padded by one point in
// every 16 so the strided autosort writes spread over the banks.  Shared
// memory is (N + N / 16) * 8 bytes a line: 8.3 KB at N = 1000, so several
// CTAs share an SM and one CTA's loads overlap another's butterflies;
// 127.5 KB at N = 15360, which needs the opt-in above 48 KB.  Strides are per-pass
// values, so no thread divides by a digit per output.
//
// C interface: wgfft_fused_lines returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a chain it cannot run.  adjoint != 0 runs the
// conjugate transpose of the same tables' transform (autograd's backward).

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "lines.cuh"
#include "radix.cuh"

namespace {

using wgfft::Chain;
using wgfft::LinesLayout;
using wgfft::LinesShape;

template <int E, int MAXT, int MINB, int SET>
__global__ void __launch_bounds__(MAXT, MINB)
fused_lines_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   const float2* __restrict__ tw, const float* __restrict__ params,
                   long long lines, int n, int per_cta, int pitch, const Chain chain,
                   float cj) {
  extern __shared__ float2 sm[];
  LinesLayout lay;
  lay.line0 = static_cast<long long>(blockIdx.x) * per_cta;
  lay.lines = lines;
  lay.n = n;
  lay.per_cta = per_cta;
  lay.pitch = pitch;
  wgfft::radix_chain<E, SET>(lay, x, y, sm, tw, params, n, chain, cj);
}

struct LaunchLines {
  const float2* x;
  float2* y;
  const float2* tw;
  const float* params;
  long long lines;
  int n;
  float cj;  // +1, or -1 for the adjoint
  cudaStream_t stream;
  const Chain& chain;
  const LinesShape& shape;
  size_t smem;

  template <int E, int MAXT, int MINB, int SET>
  cudaError_t run() const {
    return wgfft::launch_lines(fused_lines_kernel<E, MAXT, MINB, SET>, shape, lines, smem,
                               stream, x, y, tw, params, lines, n, shape.per_cta, shape.pitch,
                               chain, cj);
  }
};

// The direct design's launch for a shape, described instead of made.
struct DescribeLines {
  const LinesShape& shape;
  long long lines;
  size_t smem;
  wgfft::LinesReport* out;

  template <int E, int MAXT, int MINB, int SET>
  cudaError_t run() const {
    auto* const kernel = &fused_lines_kernel<E, MAXT, MINB, SET>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    const long long blocks = (lines + shape.per_cta - 1) / shape.per_cta;
    return wgfft::describe_launch(reinterpret_cast<const void*>(kernel), shape.threads, smem,
                                  blocks, blocks, out);
  }
};

// K1's rule: a length that kPow2Lines, kWarpLines, kMixedLines,
// kPackedLines, kGeneralLines (lines.cuh) or kClusterLines (cluster.cuh)
// names runs the power-of-two design (lines_pow2.cu), the warp design
// (lines_warp.cu), the mixed-radix design (lines_mixed.cu), the packed
// design (lines_packed.cu), the general design (lines_general.cu) or the
// cluster design (cluster.cu) and must be handed that design's chain;
// every other length runs the direct design on the chain it is handed.
// Each design launches or the call fails: there is no
// fallback from one to another.  With `report` the launch is not made, and
// it is described there instead, with the design the rule gave the length.
int lines_entry(const void* x, void* y, const void* tw, const void* params, long long lines,
                int n, const int* radices, int count, int adjoint, void* stream,
                wgfft::LinesReport* report) {
  if (lines < 1 || lines > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float cj = adjoint ? -1.f : 1.f;
  const auto* const xs = static_cast<const float2*>(x);
  auto* const ys = static_cast<float2*>(y);
  const auto* const tws = static_cast<const float2*>(tw);
  const auto* const ps = static_cast<const float*>(params);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto design = [report](wgfft::LinesDesign d) {
    if (report != nullptr) report->design = d;
  };
  if (const wgfft::LinesRule* rule = wgfft::lines_rule(wgfft::kPow2Lines, n)) {
    if (!wgfft::rule_chain(*rule, radices, count)) return static_cast<int>(cudaErrorInvalidValue);
    design(wgfft::kPow2);
    return static_cast<int>(wgfft::launch_pow2_lines(xs, ys, tws, ps, lines, n, cj, st, report));
  }
  if (const wgfft::LinesRule* rule = wgfft::lines_rule(wgfft::kWarpLines, n)) {
    if (!wgfft::rule_chain(*rule, radices, count) ||
        (report == nullptr && x == y && count < 2))
      return static_cast<int>(cudaErrorInvalidValue);
    design(wgfft::kWarp);
    return static_cast<int>(wgfft::launch_warp_lines(xs, ys, tws, ps, lines, n, cj, st, report));
  }
  if (const wgfft::LinesRule* rule = wgfft::lines_rule(wgfft::kMixedLines, n)) {
    if (!wgfft::rule_chain(*rule, radices, count)) return static_cast<int>(cudaErrorInvalidValue);
    design(wgfft::kMixed);
    return static_cast<int>(wgfft::launch_mixed_lines(xs, ys, tws, ps, lines, n, cj, st, report));
  }
  if (const wgfft::LinesRule* rule = wgfft::lines_rule(wgfft::kPackedLines, n)) {
    // in place at every chain, one pass included (lines_packed.cuh)
    if (!wgfft::rule_chain(*rule, radices, count)) return static_cast<int>(cudaErrorInvalidValue);
    design(wgfft::kPacked);
    return static_cast<int>(
        wgfft::launch_packed_lines(xs, ys, tws, ps, lines, n, cj, st, report));
  }
  if (const wgfft::GeneralLine* g = wgfft::general_line(n)) {
    if (!wgfft::rule_chain(g->rule, radices, count)) return static_cast<int>(cudaErrorInvalidValue);
    design(wgfft::kGeneral);
    return static_cast<int>(
        wgfft::launch_general_lines(xs, ys, tws, ps, lines, n, cj, st, report));
  }
  if (const wgfft::ClusterLine* c = wgfft::cluster_line(n)) {
    bool same = count == c->count;
    for (int p = 0; same && p < count; ++p) same = radices[p] == c->radix[p];
    if (!same) return static_cast<int>(cudaErrorInvalidValue);
    design(wgfft::kCluster);
    return static_cast<int>(
        wgfft::launch_cluster_lines(xs, ys, tws, ps, lines, n, cj, st, report));
  }
  design(wgfft::kDirect);
  Chain chain;
  LinesShape shape;
  if (!wgfft::make_chain(radices, count, n, &chain) ||
      !wgfft::lines_shape(chain, n, lines, &shape) ||
      (report == nullptr && x == y && chain.count < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  // a one-pass chain never touches shared memory
  const size_t smem =
      chain.count > 1 ? static_cast<size_t>(shape.per_cta) * shape.pitch * sizeof(float2) : 0;
  if (report != nullptr) {
    const DescribeLines f = {shape, lines, smem, report};
    return static_cast<int>(wgfft::dispatch_lines(chain, shape, f));
  }
  const LaunchLines f = {xs, ys, tws, ps, lines, n, cj, st, chain, shape, smem};
  return static_cast<int>(wgfft::dispatch_lines(chain, shape, f));
}

}  // namespace

// y may be x (in place) for a chain of two or more passes: a CTA owns whole
// lines, and the barrier after the first pass separates its last global read
// from the last pass's first global write.  A one-pass chain has no barrier
// and is refused in place, except at the lengths of the packed design,
// whose warps read their whole block before they write it.
extern "C" int wgfft_fused_lines(const void* x, void* y, const void* tw, const void* params,
                                 long long lines, int n, const int* radices, int count,
                                 int adjoint, void* stream) {
  return lines_entry(x, y, tw, params, lines, n, radices, count, adjoint, stream, nullptr);
}

// What wgfft_fused_lines would launch for `lines` lines of n points, into
// report[0..4]: the CTAs an SM holds of its kernel
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the SMs of the current
// device, the CTAs of its grid, the CTAs' worth of work (work over CTAs an
// SM times SMs is the waves it makes) and the design K1's rule gave n
// (LinesDesign, lines.cuh).  Returns the cudaError_t: nonzero where the
// launch would be refused.
extern "C" int wgfft_fused_lines_resident(long long lines, int n, const int* radices, int count,
                                          long long* report) {
  wgfft::LinesReport r = {};
  const int rc = lines_entry(nullptr, nullptr, nullptr, nullptr, lines, n, radices, count, 0,
                             nullptr, &r);
  report[0] = r.resident;
  report[1] = r.sms;
  report[2] = r.grid;
  report[3] = r.work;
  report[4] = r.design;
  return rc;
}

// Message for a code returned by either kernel's entry point.
extern "C" const char* wgfft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
