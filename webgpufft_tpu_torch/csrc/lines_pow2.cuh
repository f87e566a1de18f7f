// K1's power-of-two design: one kernel per length and chain, everything
// the passes need fixed at compile time (lines_pow2.cu instantiates the
// lengths of K1's rule; probes/lines_variants.cu the variants measured
// beside it).  See lines_pow2.cu for the design and what it is for.
//
// pow2_lines_kernel<N, T, MINB, R0, R1, ...> runs the Stockham chain
// R0 * R1 * ... = N (radix.cuh) on one line a CTA of T threads, each
// thread holding N / T points: pass p (radix R, ns = R0 * ... * R_{p-1},
// m = N / R) gives each thread m / T butterflies, threads on neighbouring
// j.  The first pass reads global memory into registers, the last writes
// registers to global memory in natural order with the scale applied, and
// the passes between exchange through shared memory, in place, padded by
// one point in every R0 (the first pass's write stride, so a half-warp's
// strided writes hit 16 distinct 8-byte slots; every other access of the
// chain is contiguous across a warp).  MINB is the CTAs an SM must hold
// (__launch_bounds__, and the shared-memory carveout asked for).

#pragma once

#include <cuda_runtime.h>

#include "lines.cuh"
#include "radix.cuh"

namespace wgfft {
namespace pow2 {

// Offset of point pos of the line in shared memory: one point of padding
// in every P.
template <int P>
__device__ __forceinline__ int padded(int pos) {
  return pos + static_cast<int>(static_cast<unsigned>(pos) / P);
}

// Pass (R, NS) of the line x -> y (x read by the first pass only, y
// written by the last only; the passes between exchange through sm).
template <int N, int T, int P, int R, int NS, bool FIRST, bool LAST>
__device__ __forceinline__ void pass(const float2* __restrict__ x, float2* __restrict__ y,
                                     float2* sm, const float2* __restrict__ tw, float s,
                                     float scale, float cj) {
  constexpr int M = N / R;
  constexpr int PER = M / T;
  static_assert(PER >= 1 && PER * T == M, "a pass's butterflies split evenly over the threads");
  static_assert((NS & (NS - 1)) == 0, "ns is a power of two");
  float2 v[PER][R];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = threadIdx.x + q * T;
    if constexpr (FIRST) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[q][r] = x[j + r * M];
        v[q][r].y *= cj;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) v[q][r] = sm[padded<P>(j + r * M)];
      const float2* t = tw + (NS - 1) + (j & (NS - 1));
#pragma unroll
      for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], __ldg(t + (r - 1) * NS));
    }
    Butterfly<R>::run(v[q], s);
  }
  // every read of this pass is done before it overwrites shared memory; the
  // last pass writes only global memory, whose reads all ended before the
  // first barrier, so it needs none (y may be x)
  if constexpr (!FIRST && !LAST) __syncthreads();
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = threadIdx.x + q * T;
    const int k = j & (NS - 1);
    const int j0 = (j - k) * R + k;
    if constexpr (LAST) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        y[j0 + r * NS] = make_float2(v[q][r].x * scale, v[q][r].y * (scale * cj));
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) sm[padded<P>(j0 + r * NS)] = v[q][r];
    }
  }
  if constexpr (!LAST) __syncthreads();
}

// Passes R, Rest... of the chain, the first of them with stride NS.
template <int N, int T, int P, int NS, bool FIRST, int R, int... Rest>
__device__ __forceinline__ void chain(const float2* __restrict__ x, float2* __restrict__ y,
                                      float2* sm, const float2* __restrict__ tw, float s,
                                      float scale, float cj) {
  pass<N, T, P, R, NS, FIRST, sizeof...(Rest) == 0>(x, y, sm, tw, s, scale, cj);
  if constexpr (sizeof...(Rest) > 0)
    chain<N, T, P, NS * R, false, Rest...>(x, y, sm, tw, s, scale, cj);
}

template <int N, int T, int MINB, int R0, int... Rs>
__global__ void __launch_bounds__(T, MINB)
pow2_lines_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                  const float2* __restrict__ tw, const float* __restrict__ params, float cj) {
  static_assert(sizeof...(Rs) >= 1, "two passes or more: a barrier separates reads from writes");
  extern __shared__ float2 sm[];
  const float scale = __ldg(params);
  const float s = __ldg(params + 1);
  const size_t line = static_cast<size_t>(blockIdx.x) * N;
  chain<N, T, R0, 1, true, R0, Rs...>(x + line, y + line, sm, tw, s, scale, cj);
}

// Launch pow2_lines_kernel<N, T, MINB, Rs...> over `lines` lines, one a CTA;
// with `report` not null, describe the launch there instead.
template <int N, int T, int MINB, int R0, int... Rs>
cudaError_t launch(const float2* x, float2* y, const float2* tw, const float* params,
                   long long lines, float cj, cudaStream_t stream, LinesReport* report) {
  auto* const kernel = &pow2_lines_kernel<N, T, MINB, R0, Rs...>;
  static_assert((R0 * ... * Rs) == N, "the chain multiplies to N");
  constexpr int smem = (N + N / R0) * static_cast<int>(sizeof(float2));
  // the opt-in above 48 KB, and a carveout that leaves the SM room for MINB
  // CTAs' shared memory (1 KB each the system's) and the rest to L1, which
  // holds the twiddle table: both are the kernel's state, set per launch
  constexpr int kSmPerSm = 228 * 1024;
  constexpr int carveout = (MINB * (smem + 1024) * 100 + kSmPerSm - 1) / kSmPerSm;
  static_assert(carveout <= 100, "MINB CTAs' shared memory fits an SM");
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (e != cudaSuccess) return e;
  if (report != nullptr)
    return describe_launch(reinterpret_cast<const void*>(kernel), T, smem, lines, lines, report);
  kernel<<<static_cast<unsigned>(lines), T, smem, stream>>>(x, y, tw, params, cj);
  return cudaGetLastError();
}

}  // namespace pow2
}  // namespace wgfft
