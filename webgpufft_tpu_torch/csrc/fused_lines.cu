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

#include "radix.cuh"

namespace {

using wgfft::Chain;

struct LinesLayout {
  long long line0;  // first line of this CTA
  long long lines;  // lines in the array
  int n;
  int per_cta;      // lines a CTA takes
  int pitch;        // points a line takes in shared memory, padding included

  __device__ __forceinline__ int units() const { return per_cta; }
  __device__ __forceinline__ void split(int b, int m, int& u, int& j) const {
    u = b / m;
    j = b - u * m;
  }
  __device__ __forceinline__ bool live(int u) const { return line0 + u < lines; }
  __device__ __forceinline__ size_t global(int u, int pos) const {
    return static_cast<size_t>(line0 + u) * n + pos;
  }
  __device__ __forceinline__ int shared(int u, int pos) const {
    return u * pitch + pos + (pos >> 4);
  }
};

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

struct LinesArgs {
  const float2* x;
  float2* y;
  const float2* tw;
  const float* params;
  long long lines;
  int n, per_cta, threads;
  float cj;  // +1, or -1 for the adjoint
  cudaStream_t stream;
};

template <int E, int MAXT, int MINB, int SET>
cudaError_t launch(const LinesArgs& a, const Chain& chain) {
  const int pitch = a.n + (a.n >> 4);
  const size_t smem =
      chain.count > 1 ? static_cast<size_t>(a.per_cta) * pitch * sizeof(float2) : 0;
  const auto kernel = fused_lines_kernel<E, MAXT, MINB, SET>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (a.lines + a.per_cta - 1) / a.per_cta;
  kernel<<<static_cast<unsigned>(blocks), a.threads, smem, a.stream>>>(
      a.x, a.y, a.tw, a.params, a.lines, a.n, a.per_cta, pitch, chain, a.cj);
  return cudaGetLastError();
}

// One kernel per radix set, points per thread and thread limit.  At 8 points
// a thread the register budget is 64 (four CTAs of 256 threads, or two of
// 512, on an SM: this kernel measured faster at full occupancy); the wide
// odd butterflies and the longer lines get 128.
template <int SET>
cudaError_t launch_set(int e, const LinesArgs& a, const Chain& chain) {
  constexpr int kMin256 = SET == wgfft::kSetAll ? 2 : 4;
  constexpr int kMin512 = SET == wgfft::kSetAll ? 1 : 2;
  if (a.threads > 512) return launch<32, 1024, 1, SET>(a, chain);
  if (e == 8 && a.threads <= 256) return launch<8, 256, kMin256, SET>(a, chain);
  if (e == 8) return launch<8, 512, kMin512, SET>(a, chain);
  if (e == 16) return launch<16, 512, 1, SET>(a, chain);
  return launch<32, 512, 1, SET>(a, chain);
}

}  // namespace

extern "C" int wgfft_fused_lines(const void* x, void* y, const void* tw, const void* params,
                                 long long lines, int n, const int* radices, int count,
                                 int adjoint, void* stream) {
  Chain chain;
  if (lines < 1 || lines > 0x7fffffffLL || !wgfft::make_chain(radices, count, n, &chain))
    return static_cast<int>(cudaErrorInvalidValue);
  // points a thread holds: the least of 8, 16, 32 that fits a line's widest
  // pass into 512 threads (1024 as the last resort)
  int e = 8;
  int t = wgfft::threads_needed(chain, n, e, 1);
  while (t > 512 && e < 32) {
    e *= 2;
    t = wgfft::threads_needed(chain, n, e, 1);
  }
  if (t > 1024) return static_cast<int>(cudaErrorInvalidValue);
  int per_cta = t < 256 ? 256 / t : 1;
  if (per_cta > lines) per_cta = static_cast<int>(lines);
  const int threads = (wgfft::threads_needed(chain, n, e, per_cta) + 31) / 32 * 32;
  const LinesArgs a = {static_cast<const float2*>(x), static_cast<float2*>(y),
                       static_cast<const float2*>(tw), static_cast<const float*>(params),
                       lines, n, per_cta, threads, adjoint ? -1.f : 1.f,
                       static_cast<cudaStream_t>(stream)};
  cudaError_t r;
  switch (wgfft::radix_set(chain)) {
    case wgfft::kSetPow2: r = launch_set<wgfft::kSetPow2>(e, a, chain); break;
    case wgfft::kSetSmall: r = launch_set<wgfft::kSetSmall>(e, a, chain); break;
    default: r = launch_set<wgfft::kSetAll>(e, a, chain); break;
  }
  return static_cast<int>(r);
}

// Message for a code returned by either kernel's entry point.
extern "C" const char* wgfft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
