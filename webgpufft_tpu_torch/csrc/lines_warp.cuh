// K1's warp design: one kernel per length and chain, a line held by the
// lanes of one warp (or a part of a warp), the passes exchanging through
// shared memory under __syncwarp only.  lines_warp.cu instantiates the
// lengths of K1's rule (kWarpLines, lines.cuh); probes/lines_variants.cu
// the variants measured beside it.  A sibling of lines_pow2.cuh, not a
// template parameter of it: there a CTA holds one line and its passes need
// __syncthreads; here a CTA holds several warps that share nothing, and a
// warp several lines, so the synchronisation, the indexing and the grid
// (a run-time loop over groups of lines) all differ.
//
// warp_lines_kernel<N, L, T, MINB, R0, R1, ...> runs the Stockham chain
// R0 * R1 * ... = N (radix.cuh) with L lanes a line (L a power of two up to
// 32, so a warp holds G = 32 / L lines) and T threads a CTA: every lane
// holds N / L points, and pass p (radix R, ns = R0 * ... * R_{p-1},
// m = N / R) gives each lane m / L butterflies, lanes on neighbouring j.
// The first pass reads global memory into registers, the last writes
// registers to global memory in natural order with the scale applied, and
// the passes between exchange through the line's own stretch of shared
// memory, in place, padded by one point in every R0 (the first pass's
// write stride).  A one-pass chain (N = R0) touches no shared memory.
//
// Grid: a warp takes one group of G lines at a time and loops over the
// groups with the grid's stride; the launch sizes the grid from the lines
// and the CTAs the card holds at once (as many CTAs as there are groups'
// worth of work, folded into the fewest equal rounds that fit one wave), so
// a small launch spreads over every SM and a large one runs one wave with
// no ragged tail.  Lines past the end load zeros and store nothing; every
// lane of a warp runs the same passes, so __syncwarp always has the full
// warp.  MINB is the CTAs an SM must hold (__launch_bounds__, and the
// shared-memory carveout asked for).

#pragma once

#include <cuda_runtime.h>

#include "lines.cuh"
#include "lines_pow2.cuh"
#include "radix.cuh"
#include "stage.cuh"

namespace wgfft {
namespace warp {

using pow2::padded;  // one point of padding in every P

// Pass (R, NS) of the line x -> y by lane `lane` of its L (x read by the
// first pass only, y written by the last only; the passes between exchange
// through sm).  A line that is not live loads zeros and stores nothing.
template <int N, int L, int P, int R, int NS, bool FIRST, bool LAST>
__device__ __forceinline__ void pass(const float2* __restrict__ x, float2* __restrict__ y,
                                     float2* sm, const float2* __restrict__ tw, int lane,
                                     bool live, float s, float scale, float cj) {
  constexpr int M = N / R;
  constexpr int PER = M / L;
  static_assert(PER >= 1 && PER * L == M, "a pass's butterflies split evenly over the lanes");
  static_assert((NS & (NS - 1)) == 0, "ns is a power of two");
  float2 v[PER][R];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = lane + q * L;
    if constexpr (FIRST) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[q][r] = live ? x[j + r * M] : make_float2(0.f, 0.f);
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
  // every lane's reads of this pass are done before any overwrites the
  // line's shared memory; the last pass writes only global memory, whose
  // reads all ended before the first pass's __syncwarp (y may be x)
  if constexpr (!FIRST && !LAST) __syncwarp();
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = lane + q * L;
    const int k = j & (NS - 1);
    const int j0 = (j - k) * R + k;
    if constexpr (LAST) {
      if (live) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          y[j0 + r * NS] = make_float2(v[q][r].x * scale, v[q][r].y * (scale * cj));
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) sm[padded<P>(j0 + r * NS)] = v[q][r];
    }
  }
  if constexpr (!LAST) __syncwarp();
}

// Passes R, Rest... of the chain, the first of them with stride NS.
template <int N, int L, int P, int NS, bool FIRST, int R, int... Rest>
__device__ __forceinline__ void chain(const float2* __restrict__ x, float2* __restrict__ y,
                                      float2* sm, const float2* __restrict__ tw, int lane,
                                      bool live, float s, float scale, float cj) {
  pass<N, L, P, R, NS, FIRST, sizeof...(Rest) == 0>(x, y, sm, tw, lane, live, s, scale, cj);
  if constexpr (sizeof...(Rest) > 0)
    chain<N, L, P, NS * R, false, Rest...>(x, y, sm, tw, lane, live, s, scale, cj);
}

// Points of shared memory a line takes: none for a one-pass chain.
template <int N, int R0, int... Rs>
__host__ __device__ constexpr int pitch() {
  return sizeof...(Rs) > 0 ? N + N / R0 : 0;
}

template <int N, int L, int T, int MINB, int R0, int... Rs>
__global__ void __launch_bounds__(T, MINB)
warp_lines_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                  const float2* __restrict__ tw, const float* __restrict__ params,
                  long long lines, float cj) {
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "a power of two lanes a line");
  static_assert(T % 32 == 0, "whole warps");
  constexpr int G = 32 / L;  // lines a warp
  constexpr int W = T / 32;  // warps a CTA
  extern __shared__ float2 sm[];
  const float scale = __ldg(params);
  const float s = __ldg(params + 1);
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  float2* const mine = sm + (warp * G + lane / L) * pitch<N, R0, Rs...>();
  const long long groups = (lines + G - 1) / G;
  for (long long g = static_cast<long long>(blockIdx.x) * W + warp; g < groups;
       g += static_cast<long long>(gridDim.x) * W) {
    const long long line = g * G + lane / L;
    const bool live = line < lines;
    const size_t at = static_cast<size_t>(live ? line : 0) * N;
    chain<N, L, R0, 1, true, R0, Rs...>(x + at, y + at, mine, tw, lane % L, live, s, scale,
                                         cj);
    // the last pass's reads of shared memory before the next group's first
    // pass writes it
    if constexpr (sizeof...(Rs) > 0) __syncwarp();
  }
}

// Launch warp_lines_kernel<N, L, T, MINB, Rs...> over `lines` lines; with
// `report` not null nothing launches and the launch is described there
// instead (its work: the CTAs a grid of one round would take).
template <int N, int L, int T, int MINB, int R0, int... Rs>
cudaError_t launch(const float2* x, float2* y, const float2* tw, const float* params,
                   long long lines, float cj, cudaStream_t stream, LinesReport* report) {
  auto* const kernel = &warp_lines_kernel<N, L, T, MINB, R0, Rs...>;
  static_assert((R0 * ... * Rs) == N, "the chain multiplies to N");
  constexpr int kG = 32 / L;
  constexpr int kW = T / 32;
  constexpr int smem = kW * kG * pitch<N, R0, Rs...>() * static_cast<int>(sizeof(float2));
  // a carveout that leaves the SM room for MINB CTAs' shared memory (1 KB
  // each the system's) and the rest to L1, which holds the twiddle table
  constexpr int kSmPerSm = 228 * 1024;
  constexpr int carveout = (MINB * (smem + 1024) * 100 + kSmPerSm - 1) / kSmPerSm;
  static_assert(carveout <= 100, "MINB CTAs' shared memory fits an SM");
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  int slots = 0;
  if (e == cudaSuccess) e = ring_slots(reinterpret_cast<const void*>(kernel), T, smem, &slots);
  if (e != cudaSuccess) return e;
  const long long groups = (lines + kG - 1) / kG;
  const long long work = (groups + kW - 1) / kW;
  const long long rounds = (work + slots - 1) / slots;
  const long long grid = (work + rounds - 1) / rounds;
  if (report != nullptr)
    return describe_launch(reinterpret_cast<const void*>(kernel), T, smem, grid, work, report);
  kernel<<<static_cast<unsigned>(grid), T, smem, stream>>>(x, y, tw, params, lines, cj);
  return cudaGetLastError();
}

}  // namespace warp
}  // namespace wgfft
