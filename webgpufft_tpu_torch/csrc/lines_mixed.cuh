// K1's mixed-radix design: one kernel per chain, everything the passes need
// fixed at compile time, for the lengths that are not powers of two
// (lines_mixed.cu instantiates the lengths of K1's rule, kMixedLines in
// lines.cuh; probes/lines_mixed_variants.cu the variants measured beside
// it).  See lines_mixed.cu for the design and what it is for.
//
// mixed_lines_kernel<N, L, T, MINB, R0, R1, ...> runs the Stockham chain
// R0 * R1 * ... = N (radix.cuh) on L lines a CTA of T threads.  A radix is
// any of 2 .. 32 whose prime factors are 2, 3, 5, 7, 11 and 13; a composite
// one (6, 9, 10, 12, 14, 15, 18, 20, 21, 22, 24, 25, 26, 27, 28, 30) is one
// butterfly in registers (Dft below, its inner twiddles compile-time
// constants), so a chain takes fewer passes than radix_chain's, which gives
// every odd prime a pass of its own.  Pass p (radix R, ns = R0 * ... *
// R_{p-1}, m = N / R) has L * m butterflies; thread t runs butterflies
// t, t + T, ... (the last round ragged where T does not divide L * m), so a
// thread holds whole butterflies in every pass and T is not sized by the
// smallest radix.  The first pass reads global memory into registers, the
// last writes registers to global memory in natural order with the scale
// applied, and the passes between exchange through shared memory in place.
// The exchange after pass p is padded by one point in every
// R0 * ... * R_p where R_p is even (the stride of that pass's writes across
// a half-warp), and not at all where R_p is odd (an odd stride already
// spreads over the banks).  k = j mod ns and the line of a butterfly are
// divisions by constants.  MINB is the CTAs an SM must hold
// (__launch_bounds__, and the shared-memory carveout asked for).

#pragma once

#include <cuda_runtime.h>

#include <utility>

#include "lines.cuh"
#include "radix.cuh"

namespace wgfft {
namespace mixed {

// ---- compile-time roots of unity -----------------------------------------

constexpr double kPi = 3.14159265358979323846;

__host__ __device__ constexpr double taylor_cos(double x) {
  double term = 1.0, sum = 1.0;
  for (int k = 1; k < 14; ++k) {
    term *= -x * x / ((2 * k - 1) * (2 * k));
    sum += term;
  }
  return sum;
}

__host__ __device__ constexpr double taylor_sin(double x) {
  double term = x, sum = x;
  for (int k = 1; k < 14; ++k) {
    term *= -x * x / ((2 * k) * (2 * k + 1));
    sum += term;
  }
  return sum;
}

struct CosSin {
  double c, s;
};

// cos and sin of 2 pi m / r for 0 <= m < r, reduced by symmetry to an
// angle of at most pi / 4 in integers, then a Taylor series in double.
__host__ __device__ constexpr CosSin turn(int m, int r) {
  double sc = 1.0, ss = 1.0;
  bool swap = false;
  if (2 * m > r) {  // theta -> 2 pi - theta
    m = r - m;
    ss = -1.0;
  }
  if (4 * m > r) {  // theta -> pi - theta
    m = r - 2 * m;
    r = 2 * r;
    sc = -1.0;
  }
  if (8 * m > r) {  // theta -> pi / 2 - theta
    m = r - 4 * m;
    r = 4 * r;
    swap = true;
  }
  const double x = 2.0 * kPi * m / r;
  const double c = taylor_cos(x), s = taylor_sin(x);
  return swap ? CosSin{sc * s, ss * c} : CosSin{sc * c, ss * s};
}

// a * w^M with w = exp(s 2 pi i / R): quarter turns exactly, every other
// root as two float constants
template <int R, int M>
__device__ __forceinline__ float2 rotate(float2 a, float s) {
  if constexpr (4 * M == R) {
    return muli(a, s);
  } else if constexpr (2 * M == R) {
    return make_float2(-a.x, -a.y);
  } else if constexpr (4 * M == 3 * R) {
    return muli(a, -s);
  } else {
    constexpr float c = static_cast<float>(turn(M, R).c);
    constexpr float si = static_cast<float>(turn(M, R).s);
    const float ss = s * si;
    return make_float2(fmaf(a.x, c, -a.y * ss), fmaf(a.x, ss, a.y * c));
  }
}

// ---- butterflies -----------------------------------------------------------

__host__ __device__ constexpr bool own_butterfly(int r) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8 || r == 11 || r == 13 ||
         r == 16 || r == 32;
}

// R = A * B for a composite radix: A the power of two in R where R is even,
// else R's least prime factor
__host__ __device__ constexpr int first_factor(int r) {
  return r % 2 == 0 ? (r & -r) : r % 3 == 0 ? 3 : r % 5 == 0 ? 5 : 7;
}

// X[q] = sum_r v[r] * exp(s * 2 * pi * i * r * q / R), in place: radix.cuh's
// Butterfly where it has one, else Cooley-Tukey on R = A * B with
// n = B * n1 + n2 and q = k1 + A * k2: B DFTs of A points on the residue
// classes n2 of n mod B, G[n2][k1] rotated by w_R^(n2 k1), then A DFTs of B
// points across the classes, X[k1 + A * k2].
template <int R, bool OWN = own_butterfly(R)>
struct Dft {
  static __device__ __forceinline__ void run(float2 (&v)[R], float s) { Butterfly<R>::run(v, s); }
};

template <int R, int A, int B, int I>
__device__ __forceinline__ void rotate_entry(float2 (&g)[B][A], float s) {
  constexpr int M = (I / A) * (I % A);
  if constexpr (M != 0) g[I / A][I % A] = rotate<R, M>(g[I / A][I % A], s);
}

template <int R, int A, int B, int... I>
__device__ __forceinline__ void rotate_all(float2 (&g)[B][A], float s,
                                           std::integer_sequence<int, I...>) {
  (rotate_entry<R, A, B, I>(g, s), ...);
}

template <int R>
struct Dft<R, false> {
  static constexpr int A = first_factor(R);
  static constexpr int B = R / A;
  static_assert(A > 1 && B > 1 && R <= 32, "a composite radix of at most 32 points");
  static __device__ __forceinline__ void run(float2 (&v)[R], float s) {
    float2 g[B][A];
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) {
#pragma unroll
      for (int n1 = 0; n1 < A; ++n1) g[n2][n1] = v[B * n1 + n2];
      Dft<A>::run(g[n2], s);
    }
    rotate_all<R, A, B>(g, s, std::make_integer_sequence<int, A * B>{});
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
      float2 t[B];
#pragma unroll
      for (int n2 = 0; n2 < B; ++n2) t[n2] = g[n2][k1];
      Dft<B>::run(t, s);
#pragma unroll
      for (int k2 = 0; k2 < B; ++k2) v[k1 + A * k2] = t[k2];
    }
  }
};

// ---- the chain -------------------------------------------------------------

// Offset of point pos of a line in shared memory: one point of padding in
// every P, none for P = 0.
template <int P>
__device__ __forceinline__ int padded(int pos) {
  if constexpr (P == 0) {
    return pos;
  } else {
    return pos + static_cast<int>(static_cast<unsigned>(pos) / P);
  }
}

// The padding of the exchange written by a pass of radix R whose output
// stride is NS * R.
__host__ __device__ constexpr int exchange_pad(int r, int ns) { return r % 2 == 0 ? ns * r : 0; }

// Points a line takes in shared memory: the longest of its exchanges (the
// last pass writes global memory).
template <int N, int NS, int R, int... Rest>
__host__ __device__ constexpr int pitch() {
  if constexpr (sizeof...(Rest) == 0) {
    return 0;
  } else {
    constexpr int p = exchange_pad(R, NS);
    constexpr int here = p == 0 ? N : N + (N - 1) / p;
    constexpr int next = pitch<N, NS * R, Rest...>();
    return here > next ? here : next;
  }
}

// Pass (R, NS) of the CTA's L lines x -> y (x read by the first pass only,
// y written by the last only; the passes between exchange through sm, read
// with padding PIN and written with POUT).  Lines from `live` on load zeros
// and store nothing.
template <int N, int L, int T, int PITCH, int PIN, int POUT, int R, int NS, bool FIRST,
          bool LAST>
__device__ __forceinline__ void pass(const float2* __restrict__ x, float2* __restrict__ y,
                                     float2* sm, const float2* __restrict__ tw, int live,
                                     float s, float scale, float cj) {
  constexpr int M = N / R;
  constexpr int B = L * M;                 // butterflies of the CTA
  constexpr int PER = (B + T - 1) / T;     // rounds of the threads
  constexpr bool EVEN = PER * T == B;
  static_assert(M * R == N, "the radix divides N");
  float2 v[PER][R];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = static_cast<int>(threadIdx.x) + q * T;
    if (EVEN || b < B) {
      const int u = L == 1 ? 0 : b / M;
      const int j = b - u * M;
      if constexpr (FIRST) {
        const bool on = L == 1 || u < live;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          v[q][r] = on ? x[u * N + j + r * M] : make_float2(0.f, 0.f);
          v[q][r].y *= cj;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) v[q][r] = sm[u * PITCH + padded<PIN>(j + r * M)];
        const float2* t = tw + (NS - 1) + j % NS;
#pragma unroll
        for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], __ldg(t + (r - 1) * NS));
      }
      Dft<R>::run(v[q], s);
    }
  }
  // every read of this pass is done before it overwrites shared memory; the
  // last pass writes only global memory, whose reads all ended before the
  // first barrier, so it needs none (y may be x)
  if constexpr (!FIRST && !LAST) __syncthreads();
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = static_cast<int>(threadIdx.x) + q * T;
    if (EVEN || b < B) {
      const int u = L == 1 ? 0 : b / M;
      const int j = b - u * M;
      const int k = j % NS;
      const int j0 = (j - k) * R + k;
      if constexpr (LAST) {
        if (L == 1 || u < live) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            y[u * N + j0 + r * NS] = make_float2(v[q][r].x * scale, v[q][r].y * (scale * cj));
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) sm[u * PITCH + padded<POUT>(j0 + r * NS)] = v[q][r];
      }
    }
  }
  if constexpr (!LAST) __syncthreads();
}

// Passes R, Rest... of the chain, the first of them with stride NS and
// reading the exchange padded by PIN.
template <int N, int L, int T, int PITCH, int PIN, int NS, bool FIRST, int R, int... Rest>
__device__ __forceinline__ void chain(const float2* __restrict__ x, float2* __restrict__ y,
                                      float2* sm, const float2* __restrict__ tw, int live,
                                      float s, float scale, float cj) {
  constexpr int POUT = exchange_pad(R, NS);
  pass<N, L, T, PITCH, PIN, POUT, R, NS, FIRST, sizeof...(Rest) == 0>(x, y, sm, tw, live, s,
                                                                      scale, cj);
  if constexpr (sizeof...(Rest) > 0)
    chain<N, L, T, PITCH, POUT, NS * R, false, Rest...>(x, y, sm, tw, live, s, scale, cj);
}

template <int N, int L, int T, int MINB, int R0, int... Rs>
__global__ void __launch_bounds__(T, MINB)
mixed_lines_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   const float2* __restrict__ tw, const float* __restrict__ params,
                   long long lines, float cj) {
  static_assert(sizeof...(Rs) >= 1, "two passes or more: a barrier separates reads from writes");
  constexpr int kPitch = pitch<N, 1, R0, Rs...>();
  extern __shared__ float2 sm[];
  const float scale = __ldg(params);
  const float s = __ldg(params + 1);
  const long long line0 = static_cast<long long>(blockIdx.x) * L;
  const int live = L == 1 ? 1 : static_cast<int>(lines - line0 < L ? lines - line0 : L);
  const size_t at = static_cast<size_t>(line0) * N;
  chain<N, L, T, kPitch, 0, 1, true, R0, Rs...>(x + at, y + at, sm, tw, live, s, scale, cj);
}

// Launch mixed_lines_kernel<N, L, T, MINB, Rs...> over `lines` lines, L a
// CTA; with `report` not null, describe the launch there instead.
template <int N, int L, int T, int MINB, int R0, int... Rs>
cudaError_t launch(const float2* x, float2* y, const float2* tw, const float* params,
                   long long lines, float cj, cudaStream_t stream, LinesReport* report) {
  auto* const kernel = &mixed_lines_kernel<N, L, T, MINB, R0, Rs...>;
  static_assert((R0 * ... * Rs) == N, "the chain multiplies to N");
  constexpr int smem = L * pitch<N, 1, R0, Rs...>() * static_cast<int>(sizeof(float2));
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
  const long long grid = (lines + L - 1) / L;
  if (report != nullptr)
    return describe_launch(reinterpret_cast<const void*>(kernel), T, smem, grid, grid, report);
  kernel<<<static_cast<unsigned>(grid), T, smem, stream>>>(x, y, tw, params, lines, cj);
  return cudaGetLastError();
}

}  // namespace mixed
}  // namespace wgfft
