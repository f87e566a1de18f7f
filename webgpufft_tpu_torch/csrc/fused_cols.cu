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
//
// Design: a CTA owns one pre index and a tile of tc neighbouring complex
// columns (tc = 16, shrunk so H * tc <= 16384 points and no wider than the
// column count; 32 for a one-pass H, which holds no tile).  One thread owns
// the R rows of one column's butterfly, and neighbouring threads take
// neighbouring columns: every global access of a row is one contiguous run
// of tc * 8 >= 128 bytes although rows are L floats apart, a warp's
// shared-memory access is whole rows of neighbouring points (conflict-free
// by construction), and a row's twiddle is one broadcast load.  The first
// pass loads rows straight into registers and the last stores them, so the
// tile (H * tc * 8 bytes, 32 KB at H = 256 = 16 * 16) is crossed once per
// inner pass, once in all at H = 256; a one-pass H (2..13, 16) uses no
// shared memory.  Columns past the ragged edge load zeros and store
// nothing.  A copy of the same tiles (read, write, no arithmetic) runs at
// the speed of a contiguous copy, so the tile shape costs no bandwidth.
//
// C interface: wgfft_fused_cols returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a chain it cannot run.  adjoint != 0 runs the
// conjugate transpose of the same tables' transform (autograd's backward).

#include <cuda_runtime.h>

#include "radix.cuh"

namespace {

using wgfft::Chain;

constexpr int kMaxTileElems = 16384;  // H * tc: 128 KB of float2

struct ColsLayout {
  size_t base;      // offset of (p, row 0, first column of the tile)
  long long cols;   // complex columns in the view: the row pitch
  long long left;   // columns from the tile's first to the view's edge
  int tc;           // columns in a tile, a power of two
  int shift;        // log2(tc)

  __device__ __forceinline__ int units() const { return tc; }
  __device__ __forceinline__ void split(int b, int, int& u, int& j) const {
    j = b >> shift;
    u = b & (tc - 1);
  }
  __device__ __forceinline__ bool live(int u) const { return u < left; }
  __device__ __forceinline__ size_t global(int u, int pos) const {
    return base + static_cast<size_t>(pos) * cols + u;
  }
  __device__ __forceinline__ int shared(int u, int pos) const { return pos * tc + u; }
};

template <int E, int MAXT, int MINB, int SET>
__global__ void __launch_bounds__(MAXT, MINB)
fused_cols_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                  const float2* __restrict__ tw, const float* __restrict__ params, int h,
                  long long cols, int tc, int shift, long long tiles, const Chain chain,
                  float cj) {
  extern __shared__ float2 sm[];  // H rows x tc columns
  const long long p = blockIdx.x / tiles;
  const long long col0 = (blockIdx.x % tiles) * tc;
  ColsLayout lay;
  lay.base = static_cast<size_t>(p) * h * cols + col0;
  lay.cols = cols;
  lay.left = cols - col0;
  lay.tc = tc;
  lay.shift = shift;
  wgfft::radix_chain<E, SET>(lay, x, y, sm, tw, params, h, chain, cj);
}

struct ColsArgs {
  const float2* x;
  float2* y;
  const float2* tw;
  const float* params;
  long long pre, cols;
  int h, tc, shift, threads;
  float cj;  // +1, or -1 for the adjoint
  cudaStream_t stream;
};

template <int E, int MAXT, int MINB, int SET>
cudaError_t launch(const ColsArgs& a, const Chain& chain) {
  const long long tiles = (a.cols + a.tc - 1) / a.tc;
  const long long blocks = a.pre * tiles;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = chain.count > 1 ? static_cast<size_t>(a.h) * a.tc * sizeof(float2) : 0;
  const auto kernel = fused_cols_kernel<E, MAXT, MINB, SET>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), a.threads, smem, a.stream>>>(
      a.x, a.y, a.tw, a.params, a.h, a.cols, a.tc, a.shift, tiles, chain, a.cj);
  return cudaGetLastError();
}

// One kernel per radix set, points per thread and thread limit.  Every one
// gets 128 registers a thread (two CTAs of 256 threads, or one of 512, on an
// SM): a radix-16 butterfly with its sixteen row addresses does not fit 64
// unspilled, and this kernel measured faster unspilled at half the occupancy
// than spilled at full.
template <int SET>
cudaError_t launch_set(int e, const ColsArgs& a, const Chain& chain) {
  if (a.threads > 512) return launch<32, 1024, 1, SET>(a, chain);
  if (e == 8 && a.threads <= 256) return launch<8, 256, 2, SET>(a, chain);
  if (e == 8) return launch<8, 512, 1, SET>(a, chain);
  if (e == 16) return launch<16, 512, 1, SET>(a, chain);
  return launch<32, 512, 1, SET>(a, chain);
}

}  // namespace

extern "C" int wgfft_fused_cols(const void* x, void* y, const void* tw, const void* params,
                                long long pre, int h, long long cols, const int* radices,
                                int count, int adjoint, void* stream) {
  Chain chain;
  if (pre < 1 || cols < 1 || !wgfft::make_chain(radices, count, h, &chain))
    return static_cast<int>(cudaErrorInvalidValue);
  int tc = chain.count > 1 ? 16 : 32;
  int shift = chain.count > 1 ? 4 : 5;
  while (tc > 1 && h * tc > kMaxTileElems) { tc >>= 1; --shift; }
  while (tc > 1 && tc / 2 >= cols) { tc >>= 1; --shift; }
  // points a thread holds: the least of 8, 16, 32 that fits the tile's
  // widest pass into 512 threads (1024 as the last resort)
  int e = 8;
  int t = wgfft::threads_needed(chain, h, e, tc);
  while (t > 512 && e < 32) {
    e *= 2;
    t = wgfft::threads_needed(chain, h, e, tc);
  }
  if (t > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (t + 31) / 32 * 32;
  const ColsArgs a = {static_cast<const float2*>(x), static_cast<float2*>(y),
                      static_cast<const float2*>(tw), static_cast<const float*>(params),
                      pre, cols, h, tc, shift, threads, adjoint ? -1.f : 1.f,
                      static_cast<cudaStream_t>(stream)};
  cudaError_t r;
  switch (wgfft::radix_set(chain)) {
    case wgfft::kSetPow2: r = launch_set<wgfft::kSetPow2>(e, a, chain); break;
    case wgfft::kSetSmall: r = launch_set<wgfft::kSetSmall>(e, a, chain); break;
    default: r = launch_set<wgfft::kSetAll>(e, a, chain); break;
  }
  return static_cast<int>(r);
}
