// Probe P3: K1's transform on re/im-split planes.
//
// Replaces, as an experiment, the split-layout kernels of
// benches/r26_pallas_endgame.py (build_split, layouts split_pre and
// split_il): the same batched line FFT with the real and imaginary parts in
// separate planes, to see what the interleaved layout costs the kernel.
// Input and output are f32 (lines, 2, N): plane 0 the real parts of a line,
// plane 1 the imaginary parts.  Every global load and store is then one
// unit-stride float per plane where K1 has one float2.  (The TPU script's
// other variant, de- and re-interleaving inside the kernel, is K1 itself on
// this card: K1 takes interleaved I/O and holds float2 in registers.)
//
// The passes between the first and the last are K1's (radix_pass on shared
// memory); the first pass's load and the last pass's store are the probe's
// own, because radix_pass reads and writes global memory as float2.  The CTA
// shape is K1's (lines.cuh).
//
// What bounds it: bytes, 16 * N * lines, as K1.
//
// C interface: wgfft_lines_planes returns the cudaError_t of the launch,
// cudaErrorInvalidValue for a chain it cannot run.

#include <cuda_runtime.h>

#include "lines.cuh"
#include "radix.cuh"

namespace {

using wgfft::Chain;
using wgfft::LinesLayout;
using wgfft::LinesShape;

// radix_pass with global memory in planes: point pos of line l has its real
// part at x[l * 2n + pos] and its imaginary part n floats further on.
template <int E, int R>
__device__ __forceinline__ void planes_pass(const LinesLayout& lay, const float* __restrict__ x,
                                            float* __restrict__ y, float2* sm,
                                            const float2* __restrict__ tw, int n, int ns,
                                            bool first, bool last, float s, float scale) {
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
      if (first) {
        const bool live = lay.live(u);
        const float* re = x + 2 * lay.global(u, 0) + j;
#pragma unroll
        for (int r = 0; r < R; ++r)
          v[q][r] = live ? make_float2(re[r * m], re[n + r * m]) : make_float2(0.f, 0.f);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) v[q][r] = sm[lay.shared(u, j + r * m)];
        const float2* t = tw + (ns - 1) + j % ns;
#pragma unroll
        for (int r = 1; r < R; ++r) v[q][r] = wgfft::cmul(v[q][r], __ldg(t + (r - 1) * ns));
      }
      wgfft::Butterfly<R>::run(v[q], s);
    }
  }
  if (!first) __syncthreads();  // every read of this pass is done: overwrite
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = threadIdx.x + q * blockDim.x;
    if (b < total) {
      int u, j;
      lay.split(b, m, u, j);
      const int k = j % ns;
      const int j0 = (j - k) * R + k;
      if (last) {
        if (lay.live(u)) {
          float* re = y + 2 * lay.global(u, 0) + j0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            re[r * ns] = v[q][r].x * scale;
            re[n + r * ns] = v[q][r].y * scale;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) sm[lay.shared(u, j0 + r * ns)] = v[q][r];
      }
    }
  }
  if (!last) __syncthreads();
}

template <int E, int MAXT, int MINB, int SET>
__global__ void __launch_bounds__(MAXT, MINB)
lines_planes_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const float2* __restrict__ tw, const float* __restrict__ params,
                    long long lines, int n, int per_cta, int pitch, const Chain chain) {
  extern __shared__ float2 sm[];
  LinesLayout lay;
  lay.line0 = static_cast<long long>(blockIdx.x) * per_cta;
  lay.lines = lines;
  lay.n = n;
  lay.per_cta = per_cta;
  lay.pitch = pitch;
  const float scale = __ldg(params);
  const float s = __ldg(params + 1);
  int ns = 1;
  for (int p = 0; p < chain.count; ++p) {
    const int radix = chain.radix[p];
    const bool first = p == 0;
    const bool last = p == chain.count - 1;
#define WGFFT_PASS(R)                                                               \
  do {                                                                              \
    if (first || last) planes_pass<E, R>(lay, x, y, sm, tw, n, ns, first, last, s, scale); \
    else wgfft::radix_pass<E, R, 0, 0>(lay, nullptr, nullptr, sm, tw, n, ns, false, false, s, \
                                       1.f, 1.f);                                   \
  } while (0)
    if (radix == 16) WGFFT_PASS(16);
    else if (radix == 8) WGFFT_PASS(8);
    else if (radix == 4) WGFFT_PASS(4);
    else if (radix == 2) WGFFT_PASS(2);
    else if constexpr (SET >= wgfft::kSetSmall) {
      if (radix == 3) WGFFT_PASS(3);
      else if (radix == 5) WGFFT_PASS(5);
      else if constexpr (SET >= wgfft::kSetAll) {
        if (radix == 7) WGFFT_PASS(7);
        else if (radix == 11) WGFFT_PASS(11);
        else WGFFT_PASS(13);
      }
    }
#undef WGFFT_PASS
    ns *= radix;
  }
}

struct LaunchPlanes {
  const float* x;
  float* y;
  const float2* tw;
  const float* params;
  long long lines;
  int n;
  cudaStream_t stream;
  const Chain& chain;
  const LinesShape& shape;

  template <int E, int MAXT, int MINB, int SET>
  cudaError_t run() const {
    const size_t smem =
        chain.count > 1 ? static_cast<size_t>(shape.per_cta) * shape.pitch * sizeof(float2) : 0;
    return wgfft::launch_lines(lines_planes_kernel<E, MAXT, MINB, SET>, shape, lines, smem,
                               stream, x, y, tw, params, lines, n, shape.per_cta, shape.pitch,
                               chain);
  }
};

}  // namespace

extern "C" int wgfft_lines_planes(const void* x, void* y, const void* tw, const void* params,
                                  long long lines, int n, const int* radices, int count,
                                  void* stream) {
  Chain chain;
  LinesShape shape;
  if (lines < 1 || lines > 0x7fffffffLL || !wgfft::make_chain(radices, count, n, &chain) ||
      !wgfft::lines_shape(chain, n, lines, &shape) || x == y)
    return static_cast<int>(cudaErrorInvalidValue);
  const LaunchPlanes f = {static_cast<const float*>(x), static_cast<float*>(y),
                          static_cast<const float2*>(tw), static_cast<const float*>(params),
                          lines, n, static_cast<cudaStream_t>(stream), chain, shape};
  return static_cast<int>(wgfft::dispatch_lines(chain, shape, f));
}
