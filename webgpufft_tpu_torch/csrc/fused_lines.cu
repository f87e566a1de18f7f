// K1: fused line kernel, batched c2c FFT along the contiguous last axis.
//
// Replaces the Pallas kernel of webgpufft_tpu/core/fused.py
// (build_fused_lines -> fused_fn, kernel bodies _fft_kernel_v1 and
// _fft_kernel_v2).  It computes the same math, not the same layout: the
// Mosaic-only pieces (block-lane G matrix, 0/1 lane-permutation matmul,
// adjacent-lane swaps, the v1/v2 split) have no counterpart here.
//
// Math, for one line of N = n1 * n2 complex values (n1, n2 in [2, 128]):
//   input index   n = a + n1 * b          (a: low digit, b: high digit)
//   stage A       A[a, k2] = sum_b x[a + n1 b] * F2[b, k2]      (DFT n2)
//   twiddle       A[a, k2] *= W_N^(a k2)
//   stage B       X[n2 k1 + k2] = sum_a A[a, k2] * F1[a, k1]    (DFT n1, scale folded)
// Tables are natural complex matrices as separate re/im f32 arrays:
//   f2 (n2, n2), tw (n1, n2), f1 (n1, n1), built in float64 on the host.
//
// What bounds it on an H100: the line is read once and written once, so
// the minimum traffic is 16 * N * lines bytes (67 MB for N = 1024 x 4096
// lines: 20 us at the data sheet's 3.35 TB/s).  The arithmetic is
// 8 * N * (n1 + n2) FP32 flops per line (2.1 GFLOP there: 32 us at the data
// sheet's 67 TFLOP/s without tensor cores), so this direct-DFT form is
// bounded by FP32 issue and shared-memory throughput, not by HBM.
//
// Design: one CTA of 512 threads owns one line.  The line is loaded into
// dynamic shared memory with coalesced float2 loads.  Each thread keeps its
// stage-A outputs in registers (PER of them), the block synchronises, and
// the outputs are written back over the line in a padded (n1 + 1) row pitch
// so that stage B reads shared memory without bank conflicts.  Stage B writes
// X in natural order with coalesced stores.  Tables are read through the
// read-only cache: six f32 arrays of at most 128 x 128 (24 KB in all for
// N = 1024), shared by every CTA and resident in L2.  Up to
// (n1 + 1) * n2 * 8 = 132096 bytes of shared memory per CTA, which needs the
// opt-in above 48 KB.
//
// C interface: wgfft_fused_lines returns the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float2 cmac(float2 acc, float2 v, float re, float im) {
  acc.x = fmaf(v.x, re, fmaf(-v.y, im, acc.x));
  acc.y = fmaf(v.x, im, fmaf(v.y, re, acc.y));
  return acc;
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
fused_lines_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   const float* __restrict__ f2re, const float* __restrict__ f2im,
                   const float* __restrict__ twre, const float* __restrict__ twim,
                   const float* __restrict__ f1re, const float* __restrict__ f1im,
                   int n1, int n2) {
  extern __shared__ float2 sm[];
  const int n = n1 * n2;
  const int ld = n1 + 1;  // padded row pitch of the stage-A grid (k2 rows)
  const size_t base = static_cast<size_t>(blockIdx.x) * n;

  const float2* xl = x + base;
  for (int i = threadIdx.x; i < n; i += kThreads) sm[i] = xl[i];
  __syncthreads();

  // stage A + twiddle: output o = a + n1 * k2, held in registers
  float2 acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int o = threadIdx.x + j * kThreads;
    float2 s = make_float2(0.f, 0.f);
    if (o < n) {
      const int a = o % n1;
      const int k2 = o / n1;
      for (int b = 0; b < n2; ++b) {
        const int w = b * n2 + k2;
        s = cmac(s, sm[a + n1 * b], __ldg(f2re + w), __ldg(f2im + w));
      }
      const float tr = __ldg(twre + a * n2 + k2);
      const float ti = __ldg(twim + a * n2 + k2);
      s = make_float2(s.x * tr - s.y * ti, s.x * ti + s.y * tr);
    }
    acc[j] = s;
  }
  __syncthreads();  // every read of the line is done: overwrite it
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int o = threadIdx.x + j * kThreads;
    if (o < n) sm[(o / n1) * ld + (o % n1)] = acc[j];
  }
  __syncthreads();

  // stage B: X[n2 * k1 + k2], consecutive threads on consecutive k
  float2* yl = y + base;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int k1 = k / n2;
    const int k2 = k % n2;
    const float2* row = sm + k2 * ld;
    float2 s = make_float2(0.f, 0.f);
    for (int a = 0; a < n1; ++a) {
      const int w = a * n1 + k1;
      s = cmac(s, row[a], __ldg(f1re + w), __ldg(f1im + w));
    }
    yl[k] = s;
  }
}

template <int PER>
cudaError_t launch(const float2* x, float2* y, const float* f2re, const float* f2im,
                   const float* twre, const float* twim, const float* f1re,
                   const float* f1im, long long lines, int n1, int n2,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n2) * (n1 + 1) * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_lines_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fused_lines_kernel<PER><<<static_cast<unsigned>(lines), kThreads, smem, stream>>>(
      x, y, f2re, f2im, twre, twim, f1re, f1im, n1, n2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wgfft_fused_lines(const void* x, void* y, const void* f2re,
                                 const void* f2im, const void* twre, const void* twim,
                                 const void* f1re, const void* f1im, long long lines,
                                 int n1, int n2, void* stream) {
  if (lines < 1 || lines > 0x7fffffffLL || n1 < 2 || n1 > 128 || n2 < 2 || n2 > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (n1 * n2 + kThreads - 1) / kThreads;
  const auto* xi = static_cast<const float2*>(x);
  auto* yo = static_cast<float2*>(y);
  const auto* a = static_cast<const float*>(f2re);
  const auto* b = static_cast<const float*>(f2im);
  const auto* c = static_cast<const float*>(twre);
  const auto* d = static_cast<const float*>(twim);
  const auto* e = static_cast<const float*>(f1re);
  const auto* f = static_cast<const float*>(f1im);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t r;
  if (per <= 1) r = launch<1>(xi, yo, a, b, c, d, e, f, lines, n1, n2, s);
  else if (per <= 2) r = launch<2>(xi, yo, a, b, c, d, e, f, lines, n1, n2, s);
  else if (per <= 4) r = launch<4>(xi, yo, a, b, c, d, e, f, lines, n1, n2, s);
  else if (per <= 8) r = launch<8>(xi, yo, a, b, c, d, e, f, lines, n1, n2, s);
  else if (per <= 16) r = launch<16>(xi, yo, a, b, c, d, e, f, lines, n1, n2, s);
  else r = launch<32>(xi, yo, a, b, c, d, e, f, lines, n1, n2, s);
  return static_cast<int>(r);
}

// Message for a code returned by either kernel's entry point.
extern "C" const char* wgfft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
