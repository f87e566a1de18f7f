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
// What holds it from that bound is the time an SM spends on the passes,
// each inner pass a trip through shared memory between two barriers: from
// N = 2048 on one line fills a CTA, and from 6144 (and 8192 = 16 * 8 * 8 *
// 8) the CTA an SM (512 threads of up to 128 registers), so the SM moves no
// bytes while its line runs its passes (0.37-0.39 of the bound at 8192 on
// the H100, half cuFFT's speed).  K2's ring of stages (stage.cuh:
// persistent CTAs landing the next line by one bulk copy while the current
// one runs its passes) was measured for these lengths and not kept: the
// load it hides is a fifth of a line's time, and the stage it lands in
// costs a barrier, shared memory the L1 cache held the twiddle table in,
// and spills, so it ran 4-15 % slower at every length a plan launches
// (PERF.md).  A split of each line over a thread-block cluster of C CTAs (C
// the chain's last radix; a radix-C step exchanged through distributed
// shared memory, the other passes on sub-lines of N / C points, several
// CTAs an SM) was measured too and not kept: it does the same passes plus
// an exchange, so it ran within 2 % of this design at 512-1032 lines of
// 8192 and 8-9 % slower at 131 lines of 8192 and at 16384; it won (13-39 %)
// only at lengths no plan launches, where this design's CTA runs many
// passes of odd radices or 16-32 points a thread with spills (9216, 6144,
// 12288, 5120; PERF.md).  Fewer passes, not an overlapped load or a smaller
// unit of work, is what would move it.
//
// Design: a CTA takes as many whole lines as keep about 256 threads busy
// with one butterfly group each in every pass (16 lines at N = 256 = 16 * 16,
// 2 at N = 1024 = 16 * 8 * 8, 1 from N = 2048 on), so short lines leave no
// thread idle.  The
// first pass loads global memory straight into registers (neighbouring
// threads on neighbouring points of a line), the last stores registers
// straight to global memory in natural order, and the passes between
// exchange through shared memory, padded by one point in every 16 so the
// strided autosort writes spread over the banks.  Shared memory is
// (N + N / 16) * 8 bytes a line: 8.5 KB at N = 1024, so several CTAs share an
// SM and one CTA's loads overlap another's butterflies; 136 KB at
// N = 16384, which needs the opt-in above 48 KB.  Strides are per-pass
// values, so no thread divides by a digit per output.
//
// C interface: wgfft_fused_lines returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a chain it cannot run.  adjoint != 0 runs the
// conjugate transpose of the same tables' transform (autograd's backward).

#include <cuda_runtime.h>

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

  template <int E, int MAXT, int MINB, int SET>
  cudaError_t run() const {
    // a one-pass chain never touches shared memory
    const size_t smem =
        chain.count > 1 ? static_cast<size_t>(shape.per_cta) * shape.pitch * sizeof(float2) : 0;
    return wgfft::launch_lines(fused_lines_kernel<E, MAXT, MINB, SET>, shape, lines, smem,
                               stream, x, y, tw, params, lines, n, shape.per_cta, shape.pitch,
                               chain, cj);
  }
};

}  // namespace

// y may be x (in place) for a chain of two or more passes: a CTA owns whole
// lines, and the barrier after the first pass separates its last global read
// from the last pass's first global write.  A one-pass chain has no barrier
// and is refused in place.
extern "C" int wgfft_fused_lines(const void* x, void* y, const void* tw, const void* params,
                                 long long lines, int n, const int* radices, int count,
                                 int adjoint, void* stream) {
  Chain chain;
  LinesShape shape;
  if (lines < 1 || lines > 0x7fffffffLL || !wgfft::make_chain(radices, count, n, &chain) ||
      !wgfft::lines_shape(chain, n, lines, &shape) || (x == y && chain.count < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const LaunchLines f = {static_cast<const float2*>(x), static_cast<float2*>(y),
                         static_cast<const float2*>(tw), static_cast<const float*>(params),
                         lines, n, adjoint ? -1.f : 1.f, static_cast<cudaStream_t>(stream),
                         chain, shape};
  return static_cast<int>(wgfft::dispatch_lines(chain, shape, f));
}

// Message for a code returned by either kernel's entry point.
extern "C" const char* wgfft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
