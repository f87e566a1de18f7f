// K2: columns kernel, c2c FFT along axis 1 of a (pre, H, L) view.
//
// Replaces the Pallas kernel of webgpufft_tpu/core/fused_cols.py
// (build_fused_cols -> fn, kernel body _cols_kernel).  L = 2 * cols holds
// interleaved complex columns (everything that trails the transform axis);
// the transform runs down each column.  The Mosaic-only pieces (the
// adjacent-lane fixes, the tbp = 1 pin) have no counterpart here.
//
// Math, for one column of H = h1 * h2 complex values (h1, h2 <= 128;
// h2 = 1 when H has no two-factor split):
//   input row     h = a + h1 * b          (a: low digit, b: high digit)
//   stage 1       U[a, k2] = sum_b x[a + h1 b] * W2[b, k2]      (DFT h2)
//   twiddle       U[a, k2] *= W_H^(a k2)
//   stage 2       X[h2 k1 + k2] = sum_a U[a, k2] * W1[a, k1]    (DFT h1, scale folded)
// Tables: cols_consts unchanged, as separate re/im f32 arrays:
//   w1 (h1, h1), t (h1, h2, 1), w2 (h2, h2).
//
// What bounds it on an H100: one read and one write of the view,
// 16 * H * cols * pre bytes (134 MB per axis pass of a 256^3 plan: 40 us at
// the data sheet's 3.35 TB/s); the arithmetic is 8 * (h1 + h2) FP32 flops
// per complex element, the same direct-DFT cost as K1, so FP32 issue and
// shared-memory throughput bound this form, not HBM.
//
// Design: one CTA of 512 threads owns one pre index and a tile of tc
// complex columns (tc a power of two <= 32, shrunk so H * tc <= 16384 and
// no wider than the column count).  Neighbouring threads take neighbouring
// columns, so every global load and store of a row is one contiguous run of
// tc * 8 bytes even though rows are L floats apart.  The tile lives in
// dynamic shared memory (H * tc * 8 <= 131072 bytes); stage-1 outputs stay
// in registers across a barrier and are written back over the tile; stage 2
// writes the rows in natural order.  Columns past the ragged edge load zeros
// and store nothing.
//
// C interface: wgfft_fused_cols returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxTileElems = 16384;  // H * tc: 128 KB of float2

__device__ __forceinline__ float2 cmac(float2 acc, float2 v, float re, float im) {
  acc.x = fmaf(v.x, re, fmaf(-v.y, im, acc.x));
  acc.y = fmaf(v.x, im, fmaf(v.y, re, acc.y));
  return acc;
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
fused_cols_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                  const float* __restrict__ w1re, const float* __restrict__ w1im,
                  const float* __restrict__ tre, const float* __restrict__ tim,
                  const float* __restrict__ w2re, const float* __restrict__ w2im,
                  int h1, int h2, long long cols, int tc, long long tiles) {
  extern __shared__ float2 sm[];  // H rows x tc columns
  const int h = h1 * h2;
  const long long p = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const int c = threadIdx.x % tc;       // column within the tile
  const int r = threadIdx.x / tc;       // row slot
  const int step = kThreads / tc;       // rows covered by one sweep
  const long long col = tile * tc + c;
  const bool live = col < cols;
  const size_t base = static_cast<size_t>(p) * h * cols + col;

  for (int i = r; i < h; i += step)
    sm[i * tc + c] = live ? x[base + static_cast<size_t>(i) * cols]
                          : make_float2(0.f, 0.f);
  __syncthreads();

  // stage 1 + twiddle: output row o = a + h1 * k2, held in registers
  float2 acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int o = r + j * step;
    float2 s = make_float2(0.f, 0.f);
    if (o < h) {
      const int a = o % h1;
      const int k2 = o / h1;
      for (int b = 0; b < h2; ++b) {
        const int w = b * h2 + k2;
        s = cmac(s, sm[(a + h1 * b) * tc + c], __ldg(w2re + w), __ldg(w2im + w));
      }
      const float t_re = __ldg(tre + a * h2 + k2);
      const float t_im = __ldg(tim + a * h2 + k2);
      s = make_float2(s.x * t_re - s.y * t_im, s.x * t_im + s.y * t_re);
    }
    acc[j] = s;
  }
  __syncthreads();  // every read of the tile is done: overwrite it
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int o = r + j * step;
    if (o < h) sm[o * tc + c] = acc[j];
  }
  __syncthreads();

  // stage 2: row k = h2 * k1 + k2
  for (int k = r; k < h; k += step) {
    const int k1 = k / h2;
    const int k2 = k % h2;
    float2 s = make_float2(0.f, 0.f);
    for (int a = 0; a < h1; ++a) {
      const int w = a * h1 + k1;
      s = cmac(s, sm[(a + h1 * k2) * tc + c], __ldg(w1re + w), __ldg(w1im + w));
    }
    if (live) y[base + static_cast<size_t>(k) * cols] = s;
  }
}

template <int PER>
cudaError_t launch(const float2* x, float2* y, const float* w1re, const float* w1im,
                   const float* tre, const float* tim, const float* w2re,
                   const float* w2im, long long pre, int h1, int h2, long long cols,
                   int tc, cudaStream_t stream) {
  const long long tiles = (cols + tc - 1) / tc;
  const long long blocks = pre * tiles;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(h1) * h2 * tc * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_cols_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fused_cols_kernel<PER><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, y, w1re, w1im, tre, tim, w2re, w2im, h1, h2, cols, tc, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wgfft_fused_cols(const void* x, void* y, const void* w1re,
                                const void* w1im, const void* tre, const void* tim,
                                const void* w2re, const void* w2im, long long pre,
                                int h1, int h2, long long cols, void* stream) {
  if (pre < 1 || cols < 1 || h1 < 1 || h1 > 128 || h2 < 1 || h2 > 128 || h1 * h2 < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int h = h1 * h2;
  int tc = 32;
  while (tc > 1 && h * tc > kMaxTileElems) tc >>= 1;
  while (tc > 1 && tc / 2 >= cols) tc >>= 1;
  const int per = (h * tc + kThreads - 1) / kThreads;
  const auto* xi = static_cast<const float2*>(x);
  auto* yo = static_cast<float2*>(y);
  const auto* a = static_cast<const float*>(w1re);
  const auto* b = static_cast<const float*>(w1im);
  const auto* c = static_cast<const float*>(tre);
  const auto* d = static_cast<const float*>(tim);
  const auto* e = static_cast<const float*>(w2re);
  const auto* f = static_cast<const float*>(w2im);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t r;
  if (per <= 1) r = launch<1>(xi, yo, a, b, c, d, e, f, pre, h1, h2, cols, tc, s);
  else if (per <= 2) r = launch<2>(xi, yo, a, b, c, d, e, f, pre, h1, h2, cols, tc, s);
  else if (per <= 4) r = launch<4>(xi, yo, a, b, c, d, e, f, pre, h1, h2, cols, tc, s);
  else if (per <= 8) r = launch<8>(xi, yo, a, b, c, d, e, f, pre, h1, h2, cols, tc, s);
  else if (per <= 16) r = launch<16>(xi, yo, a, b, c, d, e, f, pre, h1, h2, cols, tc, s);
  else r = launch<32>(xi, yo, a, b, c, d, e, f, pre, h1, h2, cols, tc, s);
  return static_cast<int>(r);
}
