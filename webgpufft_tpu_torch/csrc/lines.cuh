// What K1 (fused_lines.cu) decides on the host before it launches, shared
// with the probe kernels that must run in K1's CTA shape
// (probes/lines_stages.cu, probes/lines_planes.cu): where a point of a line
// lives, how many points a thread holds, how many lines a CTA takes, and
// which kernel instantiation serves a chain.

#pragma once

#include <cuda_runtime.h>

#include "radix.cuh"

namespace wgfft {

struct LinesLayout {
  static constexpr bool kStaged = false;  // the first pass reads x (radix.cuh)

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

// The CTA shape for a chain over `lines` lines of n points.
struct LinesShape {
  int e;        // points a thread holds: the least of 8, 16, 32 that fits a
                // line's widest pass into 512 threads (1024 as the last resort)
  int per_cta;  // lines a CTA takes: as many as keep about 256 threads busy
  int threads;
  int pitch;    // n + n / 16: one point of padding in every 16
};

inline bool lines_shape(const Chain& chain, int n, long long lines, LinesShape* out) {
  int e = 8;
  int t = threads_needed(chain, n, e, 1);
  while (t > 512 && e < 32) {
    e *= 2;
    t = threads_needed(chain, n, e, 1);
  }
  if (t > 1024) return false;
  int per_cta = t < 256 ? 256 / t : 1;
  if (per_cta > lines) per_cta = static_cast<int>(lines);
  out->e = e;
  out->per_cta = per_cta;
  out->threads = (threads_needed(chain, n, e, per_cta) + 31) / 32 * 32;
  out->pitch = n + (n >> 4);
  return true;
}

// One kernel per radix set, points per thread and thread limit.  At 8 points
// a thread the register budget is 64 (four CTAs of 256 threads, or two of
// 512, on an SM: K1 measured faster at full occupancy); the wide odd
// butterflies and the longer lines get 128.  `f.run<E, MAXT, MINB, SET>()`
// launches the instantiation chosen.
template <int SET, class F>
cudaError_t dispatch_lines_set(const LinesShape& shape, const F& f) {
  constexpr int kMin256 = SET == kSetAll ? 2 : 4;
  constexpr int kMin512 = SET == kSetAll ? 1 : 2;
  if (shape.threads > 512) return f.template run<32, 1024, 1, SET>();
  if (shape.e == 8 && shape.threads <= 256) return f.template run<8, 256, kMin256, SET>();
  if (shape.e == 8) return f.template run<8, 512, kMin512, SET>();
  if (shape.e == 16) return f.template run<16, 512, 1, SET>();
  return f.template run<32, 512, 1, SET>();
}

template <class F>
cudaError_t dispatch_lines(const Chain& chain, const LinesShape& shape, const F& f) {
  switch (radix_set(chain)) {
    case kSetPow2: return dispatch_lines_set<kSetPow2>(shape, f);
    case kSetSmall: return dispatch_lines_set<kSetSmall>(shape, f);
    default: return dispatch_lines_set<kSetAll>(shape, f);
  }
}

// Launch `kernel` on a grid of one CTA per `shape.per_cta` lines with `smem`
// bytes of dynamic shared memory (opting in above 48 KB).
template <class Kernel, class... Args>
cudaError_t launch_lines(Kernel kernel, const LinesShape& shape, long long lines, size_t smem,
                         cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (lines + shape.per_cta - 1) / shape.per_cta;
  kernel<<<static_cast<unsigned>(blocks), shape.threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace wgfft
