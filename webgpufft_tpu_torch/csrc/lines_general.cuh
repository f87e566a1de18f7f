// K1's general mixed-radix design: one kernel for every chain of two to four
// passes, a few instantiations for every length of its table
// (WGFFT_GENERAL_LINES, lines.cuh).  See lines_general.cu for what it is
// for and how a length enters the table.
//
// general_lines_kernel<E, MAXT> runs the Stockham chain R0 * R1 * ... = N
// (radix.cuh) on L lines a CTA of T threads, the chain, L and T run-time
// values (Plan, below).  A radix is one of 2 .. 32 whose prime factors are
// 2, 3, 5, 7, 11 and 13, within its class's range (takes), each pass one
// butterfly in registers (lines_mixed.cuh's Dft<R>, the composite ones with
// compile-time inner twiddles): a pass dispatches on its radix, by a
// switch that is uniform across the CTA, to a compiled body of its own.
// Pass p (radix R, ns = R0 * ... * R_{p-1}, m = N / R) has L * m
// butterflies; thread t runs butterflies t, t + T, ... one at a time, at
// most E / R of them, so T >= L * m / (E / R) in every pass; the class's
// widest radix sets its registers (max_threads).  The first pass reads
// global memory into registers, the last writes registers to global memory
// in natural order with the scale applied, and the passes between exchange
// through two buffers of shared memory in turn (one for a chain of two
// passes), padded by one point in every R0 * ... * R_p where R_p is even
// (as lines_mixed.cuh), one barrier between passes.  A butterfly's line
// (b / m), k = j mod ns and the padding (pos / period) are multiply-highs
// by constants the host computed (Plan), never a division on the device.

#pragma once

#include <cuda_runtime.h>

#include "lines.cuh"
#include "lines_mixed.cuh"
#include "radix.cuh"

namespace wgfft {
namespace general {

constexpr int kMaxPasses = 4;

// x / d as __umulhi(x, magic(d)) for d >= 2: magic = ceil(2^32 / d) =
// (2^32 + e) / d with 0 <= e < d, so x * magic / 2^32 = x / d + x * e /
// (d 2^32), which floors to x / d while x * e < 2^32 (x and d below 2^16
// here: a butterfly of the CTA below L * N / 2, a position below N, d at
// most N <= 16384, and L * N at most 227 KB of shared memory over 8 bytes).
// 0 for d < 2: x / 0 -> 0 is the "no padding" of an exchange; no caller
// divides by 1.
__host__ __device__ constexpr unsigned magic(int d) {
  return d < 2 ? 0u : static_cast<unsigned>(0xffffffffu / static_cast<unsigned>(d) + 1u);
}

__device__ __forceinline__ int quot(int x, unsigned magic) {
  return static_cast<int>(__umulhi(static_cast<unsigned>(x), magic));
}

struct Pass {
  int radix;
  int ns;            // R0 * ... * R_{p-1}
  int m;             // N / radix
  unsigned m_magic;  // b / m: a butterfly's line in the CTA
  unsigned ns_magic; // j / ns (not read in the first pass, where ns = 1)
  unsigned pad_in;   // pos / period of the exchange the pass reads (0: none)
  unsigned pad_out;  // ... and of the one it writes
};

// What a launch runs: passed by value, so every field is a kernel parameter.
struct Plan {
  int n;
  int lines;   // lines a CTA (L)
  int count;   // passes
  int pitch;   // points a line takes in shared memory, padding included
  Pass pass[kMaxPasses];
};

// pass p of the plan, read with constant offsets (a run-time index into a
// parameter would copy the plan to local memory)
__device__ __forceinline__ Pass pass_at(const Plan& plan, int p) {
  return p == 0 ? plan.pass[0] : p == 1 ? plan.pass[1] : p == 2 ? plan.pass[2] : plan.pass[3];
}

__device__ __forceinline__ int padded(int pos, unsigned period) { return pos + quot(pos, period); }

// The split probe (wgfft_cluster_split, wgfft_general_cols_split): a stop
// at the chain's last pass writes the exchange buffer that the last pass of
// a chain of two passes does not otherwise have: twice the shared memory
// there, or false where that does not fit.  A kernel of one exchange buffer
// (`in_place`: the cluster design's of two CTAs an SM) writes it in place.
inline bool split_room(int stop, int count, int* smem, int most, bool in_place) {
  if (stop != count || count != 2 || in_place) return true;
  if (2LL * *smem > most) return false;
  *smem *= 2;
  return true;
}

// A first-pass butterfly whose stores the split probe suppresses (its stop
// 0: wgfft_cluster_split, wgfft_general_cols_split): its outputs summed and
// the sum stored to the CTA's shared memory only where its bits are a
// signalling NaN, which no arithmetic gives, so that its loads and its
// butterfly are not dead code.
template <int R>
__device__ __forceinline__ void keep(const float2 (&v)[R]) {
  extern __shared__ float2 sm[];
  float a = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) a += v[r].x + v[r].y;
  if (__float_as_uint(a) == 0x7f800001u) sm[threadIdx.x] = v[0];
}

// One pass of radix R over the CTA's lines, a butterfly at a time: a thread
// loads butterfly b's R points (from x in the first pass, else from the
// exchange at `in` with their twiddles), runs it and stores it (to y in the
// last pass, else to the exchange at `out`), then takes b + T.  The
// exchanges alternate between two buffers, so a pass reads one while it
// writes the other and holds no butterfly across a barrier (the kernel puts
// one between passes).  A function of its own for each radix and class,
// not inlined into the kernel's switch, so that ptxas allocates each body's
// registers apart: a body inlined into the switch, or one that held its
// butterflies across a barrier, spilled them (PERF.md).  Lines from `live`
// on load zeros and store nothing.
template <int E, int R>
__device__ __noinline__ void pass(const float2* __restrict__ x, float2* __restrict__ y,
                                  const float2* __restrict__ tw, int n, int lines, int pitch,
                                  const Pass ps, int in, int out, int live, bool first,
                                  bool last, float s, float scale, float cj) {
  extern __shared__ float2 sm[];
  constexpr int PER = E / R;  // rounds a thread runs at most
  static_assert(PER >= 1, "a thread holds a whole butterfly");
  const int T = static_cast<int>(blockDim.x);
  const int B = lines * ps.m;  // butterflies of the CTA
  const int m = ps.m, ns = ps.ns;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = static_cast<int>(threadIdx.x) + q * T;
    if (b >= B) break;
    const int u = quot(b, ps.m_magic);
    const int j = b - u * m;
    const int k = first ? 0 : j - quot(j, ps.ns_magic) * ns;
    float2 v[R];
    if (first) {
      const bool on = u < live;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[r] = on ? x[u * n + j + r * m] : make_float2(0.f, 0.f);
        v[r].y *= cj;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = sm[in + u * pitch + padded(j + r * m, ps.pad_in)];
      const float2* t = tw + (ns - 1) + k;
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], __ldg(t + (r - 1) * ns));
    }
    mixed::Dft<R>::run(v, s);
    const int j0 = (j - k) * R + k;
    if (last) {
      if (u < live) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          y[u * n + j0 + r * ns] = make_float2(v[r].x * scale, v[r].y * (scale * cj));
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) sm[out + u * pitch + padded(j0 + r * ns, ps.pad_out)] = v[r];
    }
  }
}

// The radices a kernel of E points a thread takes: those of 2 .. 32 whose
// primes are 2 .. 13 (lines_mixed.cuh's Dft) from the class's least radix
// to E, so that no body runs more than E / least rounds (16 points a thread
// take radices 2 .. 16, 20 and 24 take 4 .. 20 and 4 .. 24, 32 take 5 .. 32,
// 64 take 16 .. 32).
__host__ __device__ constexpr int least_radix(int e) {
  return e == 16 ? 2 : e == 20 || e == 24 ? 4 : e == 32 ? 5 : 16;
}

__host__ __device__ constexpr bool takes(int e, int r) {
  int f = r;
  while (f % 2 == 0 && f > 1) f /= 2;
  while (f % 3 == 0) f /= 3;
  while (f % 5 == 0) f /= 5;
  while (f % 7 == 0) f /= 7;
  while (f % 11 == 0) f /= 11;
  while (f % 13 == 0) f /= 13;
  return f == 1 && r >= least_radix(e) && r <= 32 && r <= e;
}

template <int E, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
general_lines_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                     const float2* __restrict__ tw, const float* __restrict__ params,
                     long long lines, float cj, const Plan plan) {
  const float scale = __ldg(params);
  const float s = __ldg(params + 1);
  const long long line0 = static_cast<long long>(blockIdx.x) * plan.lines;
  const int live = static_cast<int>(lines - line0 < plan.lines ? lines - line0 : plan.lines);
  const size_t at = static_cast<size_t>(line0) * plan.n;
  x += at;
  y += at;
  // the two exchange buffers, plan.lines * plan.pitch points each: pass p
  // writes buffer p % 2 and pass p + 1 reads it after the barrier between
  const int buffer = plan.lines * plan.pitch;
  for (int p = 0; p < plan.count; ++p) {
    const Pass ps = pass_at(plan, p);
    const bool first = p == 0, last = p == plan.count - 1;
    const int in = ((p + 1) & 1) * buffer, out = (p & 1) * buffer;
#define WGFFT_GENERAL_PASS(R)                                                          \
  case R:                                                                              \
    if constexpr (takes(E, R))                                                         \
      pass<E, R>(x, y, tw, plan.n, plan.lines, plan.pitch, ps, in, out, live, first, last, s, \
                 scale, cj);                                                           \
    break;
    switch (ps.radix) {
      WGFFT_GENERAL_PASS(2) WGFFT_GENERAL_PASS(3) WGFFT_GENERAL_PASS(4) WGFFT_GENERAL_PASS(5)
      WGFFT_GENERAL_PASS(6) WGFFT_GENERAL_PASS(7) WGFFT_GENERAL_PASS(8) WGFFT_GENERAL_PASS(9)
      WGFFT_GENERAL_PASS(10) WGFFT_GENERAL_PASS(11) WGFFT_GENERAL_PASS(12)
      WGFFT_GENERAL_PASS(13) WGFFT_GENERAL_PASS(14) WGFFT_GENERAL_PASS(15)
      WGFFT_GENERAL_PASS(16) WGFFT_GENERAL_PASS(18) WGFFT_GENERAL_PASS(20)
      WGFFT_GENERAL_PASS(21) WGFFT_GENERAL_PASS(22) WGFFT_GENERAL_PASS(24)
      WGFFT_GENERAL_PASS(25) WGFFT_GENERAL_PASS(26) WGFFT_GENERAL_PASS(27)
      WGFFT_GENERAL_PASS(28) WGFFT_GENERAL_PASS(30) WGFFT_GENERAL_PASS(32)
      default: break;
    }
#undef WGFFT_GENERAL_PASS
    // every write of this pass is done before the next reads it, and every
    // read of the buffer the next overwrites was done in this one or before;
    // the first pass's reads of x end here too, before the last pass writes y
    // (y may be x)
    if (!last) __syncthreads();
  }
}

// A launch of the design: the plan, its CTA and where it goes.
struct Launch {
  const float2* x;
  float2* y;
  const float2* tw;
  const float* params;
  long long lines;
  float cj;
  cudaStream_t stream;
  LinesReport* report;  // not null: describe the launch there instead
  Plan plan;
  int threads;
  int smem;
};

// Launch general_lines_kernel<E, MAXT> as `g` says (lines_general_16.cu,
// _32.cu and _64.cu each instantiate one class of E, so that they compile
// side by side).
template <int E, int MAXT>
cudaError_t launch_kernel(const Launch& g) {
  auto* const kernel = &general_lines_kernel<E, MAXT>;
  if (g.threads > MAXT) return cudaErrorInvalidValue;
  if (g.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
  }
  const long long grid = (g.lines + g.plan.lines - 1) / g.plan.lines;
  if (g.report != nullptr)
    return describe_launch(reinterpret_cast<const void*>(kernel), g.threads, g.smem, grid, grid,
                           g.report);
  kernel<<<static_cast<unsigned>(grid), g.threads, g.smem, g.stream>>>(g.x, g.y, g.tw, g.params,
                                                                       g.lines, g.cj, g.plan);
  return cudaGetLastError();
}

// The classes of E and the most threads a CTA of each (core/radix.py
// GENERAL_CLASSES), which sets the registers a thread may have
// (__launch_bounds__): a thread holds one butterfly at a time, so its
// widest radix R sets them, about 2 R + 40: 80 at 16 points and 768
// threads, 88 at 20 and 704, 96 at 24 and 640, 128 at 32 and 512, 184 at 64
// and 352.  A class of fewer registers holds more CTAs an SM.
constexpr int max_threads(int e) {
  return e == 16 ? 768 : e == 20 ? 704 : e == 24 ? 640 : e == 32 ? 512 : e == 64 ? 352 : 0;
}

cudaError_t launch_16(const Launch& g);
cudaError_t launch_20(const Launch& g);
cudaError_t launch_24(const Launch& g);
cudaError_t launch_32(const Launch& g);
cudaError_t launch_64(const Launch& g);

}  // namespace general
}  // namespace wgfft
