// Probe P2: K1's radix chain stopped after `stop` passes, with the same
// global reads and writes at every stop.
//
// Replaces, as an experiment, the Pallas probe of benches/r2_pallas_probe.py
// (main.make(stage)): the fused line kernel cut short at successive points
// with identical input and output bytes, so that the difference between two
// neighbouring cuts is what one step costs inside the kernel.  There the
// steps were the digit DFTs, the twiddle and the reorder of the two-digit
// matmul pipeline; here they are the passes of the radix chain of
// fused_lines.cu (radix.cuh).
//
//   stop = 0      a CTA loads its lines with the first pass's access pattern
//                 (radix[0] strided loads a thread), puts them into shared
//                 memory and writes them out: the copy every other stop
//                 contains
//   stop = p      passes 1 .. p run as in K1 (radix_pass, every one writing
//                 shared memory), then the shared-memory lines are written
//                 out in position order, neighbouring threads on
//                 neighbouring points
//   stop = count  the whole transform, times the plan's scale: K1's output
//
// Every stop therefore reads each line once in the first pass's pattern and
// writes it once, coalesced, from shared memory.  K1 itself stores its last
// pass from registers and skips that last trip through shared memory, so
// stop = count costs K1 plus one shared-memory write and read of the line.
// The CTA shape is K1's (lines.cuh: points a thread, lines a CTA, pitch,
// instantiation per radix set), or the differences would mean nothing.  The
// chain loop is the probe's own: radix_chain in radix.cuh has no way to stop
// and stays as it is.
//
// What bounds it: bytes, 16 * N * lines, as K1.
//
// C interface: wgfft_lines_stages returns the cudaError_t of the launch,
// cudaErrorInvalidValue for a chain or a stop it cannot run.

#include <cuda_runtime.h>

#include "lines.cuh"
#include "radix.cuh"

namespace {

using wgfft::Chain;
using wgfft::LinesLayout;
using wgfft::LinesShape;

// The loads of a first pass of radix R, stored to the same positions of
// shared memory with no arithmetic between.
template <int E, int R>
__device__ __forceinline__ void load_pass(const LinesLayout& lay, const float2* __restrict__ x,
                                          float2* sm, int n) {
  constexpr int PER = wgfft::per_thread(E, R);
  const int m = n / R;
  const int total = m * lay.units();
  float2 v[PER][R];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = threadIdx.x + q * blockDim.x;
    if (b < total) {
      int u, j;
      lay.split(b, m, u, j);
      const bool live = lay.live(u);
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[q][r] = live ? x[lay.global(u, j + r * m)] : make_float2(0.f, 0.f);
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = threadIdx.x + q * blockDim.x;
    if (b < total) {
      int u, j;
      lay.split(b, m, u, j);
#pragma unroll
      for (int r = 0; r < R; ++r) sm[lay.shared(u, j + r * m)] = v[q][r];
    }
  }
  __syncthreads();
}

// CALL(R) for the radix at run time, over the radices of the kernel's set.
#define WGFFT_FOR_RADIX(radix, CALL)                  \
  do {                                                \
    if (radix == 16) CALL(16);                        \
    else if (radix == 8) CALL(8);                     \
    else if (radix == 4) CALL(4);                     \
    else if (radix == 2) CALL(2);                     \
    else if constexpr (SET >= wgfft::kSetSmall) {     \
      if (radix == 3) CALL(3);                        \
      else if (radix == 5) CALL(5);                   \
      else if constexpr (SET >= wgfft::kSetAll) {     \
        if (radix == 7) CALL(7);                      \
        else if (radix == 11) CALL(11);               \
        else CALL(13);                                \
      }                                               \
    }                                                 \
  } while (0)

template <int E, int MAXT, int MINB, int SET>
__global__ void __launch_bounds__(MAXT, MINB)
lines_stages_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                    const float2* __restrict__ tw, const float* __restrict__ params,
                    long long lines, int n, int per_cta, int pitch, const Chain chain, int stop) {
  extern __shared__ float2 sm[];
  LinesLayout lay;
  lay.line0 = static_cast<long long>(blockIdx.x) * per_cta;
  lay.lines = lines;
  lay.n = n;
  lay.per_cta = per_cta;
  lay.pitch = pitch;
  const float scale = stop == chain.count ? __ldg(params) : 1.f;
  const float s = __ldg(params + 1);
  if (stop == 0) {
    const int radix = chain.radix[0];
#define WGFFT_LOAD(R) load_pass<E, R>(lay, x, sm, n)
    WGFFT_FOR_RADIX(radix, WGFFT_LOAD);
#undef WGFFT_LOAD
  }
  int ns = 1;
  for (int p = 0; p < stop; ++p) {
    const int radix = chain.radix[p];
    const bool first = p == 0;
    // as radix_chain: the smallest kernels compile the first pass apart from
    // the others, the larger ones keep one copy with a run-time flag
    constexpr bool kSplit = SET == wgfft::kSetPow2 && E == 8;
#define WGFFT_RUN(R, F) \
  wgfft::radix_pass<E, R, F, 0>(lay, x, y, sm, tw, n, ns, first, false, s, 1.f, 1.f)
#define WGFFT_PASS(R)                        \
  do {                                       \
    if constexpr (!kSplit) WGFFT_RUN(R, -1); \
    else if (first) WGFFT_RUN(R, 1);         \
    else WGFFT_RUN(R, 0);                    \
  } while (0)
    WGFFT_FOR_RADIX(radix, WGFFT_PASS);
#undef WGFFT_PASS
#undef WGFFT_RUN
    ns *= radix;
  }
  // the dump: shared memory in position order to global memory
  const int total = lay.units() * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int u = i / n, pos = i - u * n;
    if (lay.live(u)) {
      const float2 v = sm[lay.shared(u, pos)];
      y[lay.global(u, pos)] = make_float2(v.x * scale, v.y * scale);
    }
  }
}

#undef WGFFT_FOR_RADIX

struct LaunchStages {
  const float2* x;
  float2* y;
  const float2* tw;
  const float* params;
  long long lines;
  int n, stop;
  cudaStream_t stream;
  const Chain& chain;
  const LinesShape& shape;

  template <int E, int MAXT, int MINB, int SET>
  cudaError_t run() const {
    // every stop goes through shared memory, a one-pass chain too
    const size_t smem = static_cast<size_t>(shape.per_cta) * shape.pitch * sizeof(float2);
    return wgfft::launch_lines(lines_stages_kernel<E, MAXT, MINB, SET>, shape, lines, smem,
                               stream, x, y, tw, params, lines, n, shape.per_cta, shape.pitch,
                               chain, stop);
  }
};

}  // namespace

extern "C" int wgfft_lines_stages(const void* x, void* y, const void* tw, const void* params,
                                  long long lines, int n, const int* radices, int count,
                                  int stop, void* stream) {
  Chain chain;
  LinesShape shape;
  if (lines < 1 || lines > 0x7fffffffLL || !wgfft::make_chain(radices, count, n, &chain) ||
      !wgfft::lines_shape(chain, n, lines, &shape) || stop < 0 || stop > count || x == y)
    return static_cast<int>(cudaErrorInvalidValue);
  const LaunchStages f = {static_cast<const float2*>(x), static_cast<float2*>(y),
                          static_cast<const float2*>(tw), static_cast<const float*>(params),
                          lines, n, stop, static_cast<cudaStream_t>(stream), chain, shape};
  return static_cast<int>(wgfft::dispatch_lines(chain, shape, f));
}
