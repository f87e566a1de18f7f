// K1's packed design: one kernel per length and shape, for the short lines
// (N <= 128) where a warp's lines are one contiguous block of device memory.
// The table WGFFT_PACKED_LINES (lines.cuh) gives each length of K1's rule
// its shape and chain; launch_part below instantiates it (lines_packed.cu and
// its parts), probes/lines_packed_variants.cu the variants measured beside
// it.  See lines_packed.cu for what the design is for.
//
// packed_lines_kernel<N, LANES, STAGES, R0, R1, ...> runs the Stockham
// chain R0 * R1 * ... = N (radix.cuh) on CTAs of kWarps warps.  A warp takes
// a block of B = 32 / LANES whole lines at a time: lines [g * B, g * B + B)
// of block g, B * N * 8 contiguous bytes (the last block ragged).  Each
// block goes through three steps, all of them the warp's own, synchronised
// by __syncwarp alone:
//
// 1. The load.  The warp lands the block in its stage of shared memory by
//    cp.async copies of 16 bytes (two points), lane l taking copies l,
//    l + 32, ... (a 16-byte load into registers and a store to shared
//    memory ran slower at every length, PERF.md).  Point q of the block
//    lands at (q / N) * P + q % N: line u of the block at u * P, in natural
//    order, P the line's pitch (`Shape::P`).  Where x or y is only 8-byte
//    aligned (an offset view), every copy is of 8 bytes (one point); where
//    the block has an odd number of points (odd N, odd lines in the last
//    block), its last point is.  That path is the same kernel, not a
//    fallback: the choice is made per launch on the pointers.
// 2. The butterflies.  With LANES = 1 lane l holds line l of the block in
//    registers and runs the whole chain there: the passes exchange by
//    register renaming, the twiddles are compile-time constants
//    (mixed::rotate), and nothing is read but the line.  With LANES > 1 the
//    LANES lanes of a line run the chain as the warp design does
//    (lines_warp.cuh), butterflies split over the lanes (the last round
//    ragged where LANES does not divide N / R), every pass reading and
//    writing the line's own stretch of the stage under __syncwarp and the
//    twiddles read from `cw` (the chain's table).  The last pass writes
//    natural order back to the stage, scaled (and conjugated for the
//    adjoint).
// 3. The store.  The warp copies the stage to y by 16-byte stores (8-byte
//    on the path of step 1), lane l taking copies l, l + 32, ...
//
// With STAGES = 2 each warp has two stages and lands block g + step by
// cp.async while it runs block g (a block is the warp's own, so no other
// warp waits for it).
//
// Layout.  The pitch P keeps the strided reads of step 2 off one bank.
// With odd N every radix is odd, no exchange is padded and P = N: lines at
// an odd pitch, read a point at a time, spread over the banks, and the
// block is contiguous, so a 16-byte copy may straddle two lines.  With even
// N a line never splits a 16-byte copy, the exchanges are padded as the
// mixed-radix design pads them (mixed::exchange_pad) and P is the least
// pitch that holds them with P = 2 (mod 4) (LANES = 1: a lane reads its
// line 16 bytes at a time, 8 lanes on 8 different bank groups) or P =
// LANES (mod 2 LANES) (LANES > 1: the lanes of one line on neighbouring
// points, the lines of a half-warp on different banks).
//
// In place (y = x).  A warp reads its whole block into shared memory before
// it writes any of it back, and no other warp touches the block, so y may
// be x at every chain, one pass included: this widens the direct design's
// condition (two passes or more, fused_lines.cu) for the lengths of the
// packed design's table; the wrappers' contract (FusedLines writes a new
// tensor) does not change.
//
// Grid: a warp takes block blockIdx.x * kWarps + warp, then loops over the
// blocks with the grid's stride; the launch sizes the grid from the lines
// and the CTAs the card holds at once (query_slots), as the warp design
// does: as many CTAs as there are kWarps blocks' worth of work, folded into
// the fewest equal rounds that fit one wave.  A 100,003-line launch at
// N = 16 spreads over every SM; a 1,000-line launch over as many SMs as it
// has warps' blocks.

#pragma once

#include <cuda_runtime.h>

#include <utility>

#include "lines.cuh"
#include "lines_mixed.cuh"
#include "radix.cuh"
#include "stage.cuh"

namespace wgfft {
namespace packed {

// ---- the layout --------------------------------------------------------------

// The line's pitch in a stage: the extent (N where one lane holds the line
// and the passes run in its registers, else the longest of its padded
// exchanges, mixed::pitch) for odd N, which is N, else the least pitch from
// the extent up with pitch = want (mod modulus).
__host__ __device__ constexpr int line_pitch(int n, int extent, int lanes) {
  if (n % 2 != 0) return extent;
  const int modulus = lanes == 1 ? 4 : 2 * lanes;
  const int want = lanes == 1 ? 2 : lanes;
  int p = extent;
  while (p % modulus != want) ++p;
  return p;
}

// Points a lane holds in its widest pass: the whole line with one lane a
// line, else the rounds of butterflies a lane runs (ragged where LANES
// does not divide N / R) times the radix.
template <int N, int LANES, int... R>
__host__ __device__ constexpr int lane_points() {
  if constexpr (LANES == 1) {
    return N;
  } else {
    int most = 0;
    ((most = (N / R + LANES - 1) / LANES * R > most ? (N / R + LANES - 1) / LANES * R : most),
     ...);
    return most;
  }
}

// Warps a CTA, at every length (the sweep's, PERF.md).
constexpr int kWarps = 4;

template <int N, int LANES, int STAGES, int R0, int... Rs>
struct Shape {
  static_assert((R0 * ... * Rs) == N, "the chain multiplies to N");
  static_assert(LANES >= 1 && LANES <= 8 && (LANES & (LANES - 1)) == 0,
                "a power of two lanes a line, at most 8: a warp's block is an even number of "
                "lines, so every block starts 16-byte aligned");
  static_assert(LANES == 1 || sizeof...(Rs) > 0, "lanes share a line only across passes");
  static_assert(STAGES == 1 || STAGES == 2, "one stage a warp, or two");
  static constexpr int B = 32 / LANES;           // lines a warp's block
  static constexpr int E = LANES == 1 ? N : mixed::pitch<N, 1, R0, Rs...>();
  static constexpr int P = line_pitch(N, E, LANES);
  static_assert(N % 2 == 0 || P == N, "odd N: every radix odd, no padding");
  static constexpr int SP = (B * P + 1) / 2 * 2;  // points a stage, 16-byte multiple
  static constexpr int kWarpPoints = STAGES * SP;
  static constexpr int T = 32 * kWarps;
  static constexpr int kSmem = kWarps * kWarpPoints * static_cast<int>(sizeof(float2));
  static constexpr int kPer16 = (B * N / 2 + 31) / 32;  // 16-byte copies a lane, at most
  static constexpr int kPer8 = (B * N + 31) / 32;       // 8-byte copies a lane, at most
  // registers a thread may take: twice its points' floats (a pass's inputs
  // and outputs, a butterfly's temporaries) and some for addresses; the
  // CTAs an SM must hold so that the allocation stays under that
  // (__launch_bounds__), and no more than the SM's shared memory takes.
  // Tighter budgets spilled (PERF.md).
  static constexpr int kRegs = 4 * lane_points<N, LANES, R0, Rs...>() + 96;
  static constexpr int kByRegs = 65536 / (T * (kRegs < 255 ? kRegs : 255));
  static constexpr int kBySmem = kRingShared / (kSmem + 1024);
  static constexpr int kMinBlocks0 = kByRegs < kBySmem ? kByRegs : kBySmem;
  static constexpr int kMinBlocks =
      kMinBlocks0 < 1 ? 1 : (kMinBlocks0 > 64 / kWarps ? 64 / kWarps : kMinBlocks0);

  // where point q of a block lands in the stage
  static __device__ __forceinline__ int at(int q) {
    if constexpr (N % 2 != 0) {
      return q;
    } else {
      const int u = q / N;
      return u * P + (q - u * N);
    }
  }
};

// ---- the load and the store --------------------------------------------------

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Land `points` points of src (a block's first point) in stage st: 16-byte
// copies where `wide`, the last point alone where `points` is odd, 8-byte
// copies otherwise.
template <class S>
__device__ __forceinline__ void fill(float2* st, const float2* __restrict__ src, int points,
                                     bool wide, int lane) {
  if (wide) {
    const int chunks = points >> 1;
#pragma unroll
    for (int i = 0; i < S::kPer16; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) copy16(st + S::at(2 * c), src + 2 * c, true);
    }
    if ((points & 1) && lane == 0) copy8(st + S::at(points - 1), src + points - 1, true);
  } else {
#pragma unroll
    for (int i = 0; i < S::kPer8; ++i) {
      const int q = lane + 32 * i;
      if (q < points) copy8(st + S::at(q), src + q, true);
    }
  }
}

// Copy `points` points of stage st to dst (a block's first point), as
// `fill` lands them.
template <class S>
__device__ __forceinline__ void drain(const float2* st, float2* __restrict__ dst, int points,
                                      bool wide, int lane) {
  if (wide) {
    const int chunks = points >> 1;
#pragma unroll
    for (int i = 0; i < S::kPer16; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks)
        *reinterpret_cast<float4*>(dst + 2 * c) =
            *reinterpret_cast<const float4*>(st + S::at(2 * c));
    }
    if ((points & 1) && lane == 0) dst[points - 1] = st[S::at(points - 1)];
  } else {
#pragma unroll
    for (int i = 0; i < S::kPer8; ++i) {
      const int q = lane + 32 * i;
      if (q < points) dst[q] = st[S::at(q)];
    }
  }
}

// ---- a line in one lane's registers (LANES = 1) -------------------------------

// a * w^M, w = exp(s 2 pi i / RR): nothing where M is 0
template <int RR, int M>
__device__ __forceinline__ void twiddle(float2& a, float s) {
  if constexpr (M != 0) a = mixed::rotate<RR, M>(a, s);
}

template <int RR, int K, int R, int... I>
__device__ __forceinline__ void twiddle_all(float2 (&b)[R], float s,
                                            std::integer_sequence<int, I...>) {
  (twiddle<RR, I * K>(b[I], s), ...);
}

// Butterfly J of pass (R, NS) from v into o, its twiddles W_N^(r k N / (NS R))
// = exp(s 2 pi i r k / (NS R)) compile-time constants.
template <int N, int NS, int R, int J>
__device__ __forceinline__ void reg_butterfly(const float2 (&v)[N], float2 (&o)[N], float s) {
  constexpr int M = N / R;
  constexpr int K = J % NS;
  float2 b[R];
#pragma unroll
  for (int r = 0; r < R; ++r) b[r] = v[J + r * M];
  if constexpr (K != 0) twiddle_all<NS * R, K>(b, s, std::make_integer_sequence<int, R>{});
  mixed::Dft<R>::run(b, s);
  constexpr int J0 = (J - K) * R + K;
#pragma unroll
  for (int r = 0; r < R; ++r) o[J0 + r * NS] = b[r];
}

template <int N, int NS, int R, int... J>
__device__ __forceinline__ void reg_pass(float2 (&v)[N], float s, std::integer_sequence<int, J...>) {
  float2 o[N];
  (reg_butterfly<N, NS, R, J>(v, o, s), ...);
#pragma unroll
  for (int p = 0; p < N; ++p) v[p] = o[p];
}

template <int N, int NS, int R, int... Rest>
__device__ __forceinline__ void reg_chain(float2 (&v)[N], float s) {
  reg_pass<N, NS, R>(v, s, std::make_integer_sequence<int, N / R>{});
  if constexpr (sizeof...(Rest) > 0) reg_chain<N, NS * R, Rest...>(v, s);
}

// The lane's line of the block in its registers, out of the stage and
// back, scaled.
template <class S, int N, int R0, int... Rs>
__device__ __forceinline__ void line_in_lane(float2* st, int lane, float s, float scale,
                                             float cj) {
  float2* const line = st + lane * S::P;
  float2 v[N];
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int p = 0; p < N; p += 2) {
      const float4 w = *reinterpret_cast<const float4*>(line + p);
      v[p] = make_float2(w.x, w.y * cj);
      v[p + 1] = make_float2(w.z, w.w * cj);
    }
  } else {
#pragma unroll
    for (int p = 0; p < N; ++p) v[p] = make_float2(line[p].x, line[p].y * cj);
  }
  reg_chain<N, 1, R0, Rs...>(v, s);
  const float si = scale * cj;
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int p = 0; p < N; p += 2)
      *reinterpret_cast<float4*>(line + p) =
          make_float4(v[p].x * scale, v[p].y * si, v[p + 1].x * scale, v[p + 1].y * si);
  } else {
#pragma unroll
    for (int p = 0; p < N; ++p) line[p] = make_float2(v[p].x * scale, v[p].y * si);
  }
}

// ---- a line over LANES lanes (LANES > 1) ---------------------------------------

// Pass (R, NS) over the block's lines in the stage, read with padding PIN
// and written with POUT (0: natural order); the first pass conjugates for
// the adjoint, the last scales.
template <class S, int N, int LANES, int PIN, int POUT, int R, int NS, bool FIRST, bool LAST>
__device__ __forceinline__ void lanes_pass(float2* st, const float2* __restrict__ tw, int lane,
                                           float s, float scale, float cj) {
  constexpr int M = N / R;
  constexpr int PER = (M + LANES - 1) / LANES;
  constexpr bool EVEN = PER * LANES == M;
  const int sub = lane % LANES;
  float2* const line = st + (lane / LANES) * S::P;
  float2 v[PER][R];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = sub + q * LANES;
    if (EVEN || j < M) {
      float2 w[R];
      if constexpr (!FIRST) {
        const float2* t = tw + (NS - 1) + j % NS;
#pragma unroll
        for (int r = 1; r < R; ++r) w[r] = __ldg(t + (r - 1) * NS);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) v[q][r] = line[mixed::padded<PIN>(j + r * M)];
      if constexpr (FIRST) {
#pragma unroll
        for (int r = 0; r < R; ++r) v[q][r].y *= cj;
      } else {
#pragma unroll
        for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], w[r]);
      }
      mixed::Dft<R>::run(v[q], s);
    }
  }
  // every lane's reads of this pass are done before any overwrites the
  // line's stretch
  __syncwarp();
  const float si = scale * cj;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = sub + q * LANES;
    if (EVEN || j < M) {
      const int k = j % NS;
      const int j0 = (j - k) * R + k;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (LAST)
          line[j0 + r * NS] = make_float2(v[q][r].x * scale, v[q][r].y * si);
        else
          line[mixed::padded<POUT>(j0 + r * NS)] = v[q][r];
      }
    }
  }
  __syncwarp();
}

template <class S, int N, int LANES, int PIN, int NS, bool FIRST, int R, int... Rest>
__device__ __forceinline__ void lanes_chain(float2* st, const float2* __restrict__ tw, int lane,
                                            float s, float scale, float cj) {
  constexpr bool LAST = sizeof...(Rest) == 0;
  constexpr int POUT = LAST ? 0 : mixed::exchange_pad(R, NS);
  lanes_pass<S, N, LANES, PIN, POUT, R, NS, FIRST, LAST>(st, tw, lane, s, scale, cj);
  if constexpr (!LAST)
    lanes_chain<S, N, LANES, POUT, NS * R, false, Rest...>(st, tw, lane, s, scale, cj);
}

// ---- the kernel ------------------------------------------------------------------

template <int N, int LANES, int STAGES, int R0, int... Rs>
__global__ void __launch_bounds__(32 * kWarps, (Shape<N, LANES, STAGES, R0, Rs...>::kMinBlocks))
packed_lines_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                    const float2* __restrict__ tw, const float* __restrict__ params,
                    long long lines, float cj) {
  using S = Shape<N, LANES, STAGES, R0, Rs...>;
  constexpr int B = S::B;
  extern __shared__ __align__(16) float2 sm[];
  const float scale = __ldg(params);
  const float s = __ldg(params + 1);
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  float2* const mine = sm + warp * S::kWarpPoints;
  // 16-byte copies where both ends allow them (a block starts at an even
  // line count, so at a 16-byte multiple of the base)
  const bool wide = aligned16(x) && aligned16(y);
  const long long blocks = (lines + B - 1) / B;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const auto points = [lines](long long b) {
    const long long left = lines - b * B;
    return static_cast<int>(left < B ? left : B) * N;
  };
  if constexpr (STAGES == 2) {
    if (g < blocks) fill<S>(mine, x + g * B * N, points(g), wide, lane);
    commit();
  }
  for (int k = 0; g < blocks; g += step, ++k) {
    float2* const st = mine + (STAGES == 2 ? (k & 1) * S::SP : 0);
    const int here = points(g);
    if constexpr (STAGES == 2) {
      // the other stage's last store ended before the __syncwarp that closed
      // the previous block
      const long long next = g + step;
      if (next < blocks)
        fill<S>(mine + ((k + 1) & 1) * S::SP, x + next * B * N, points(next), wide, lane);
      commit();
      wait_groups<1>();
    } else {
      fill<S>(st, x + g * B * N, here, wide, lane);
      commit();
      wait_groups<0>();
    }
    // every lane's copies of this block are in the stage
    __syncwarp();
    if constexpr (LANES == 1) {
      line_in_lane<S, N, R0, Rs...>(st, lane, s, scale, cj);
      __syncwarp();
    } else {
      lanes_chain<S, N, LANES, 0, 1, true, R0, Rs...>(st, tw, lane, s, scale, cj);
    }
    drain<S>(st, y + g * B * N, here, wide, lane);
    // every lane's reads of the stage are done before it is refilled
    __syncwarp();
  }
}

// Launch packed_lines_kernel<N, LANES, STAGES, Rs...> over `lines` lines;
// with `report` not null nothing launches and the launch is described there
// instead (its work: the CTAs a grid of one round would take).
template <int N, int LANES, int STAGES, int R0, int... Rs>
cudaError_t launch(const float2* x, float2* y, const float2* tw, const float* params,
                   long long lines, float cj, cudaStream_t stream, LinesReport* report) {
  using S = Shape<N, LANES, STAGES, R0, Rs...>;
  auto* const kernel = &packed_lines_kernel<N, LANES, STAGES, R0, Rs...>;
  // The CTAs the device holds, asked once per device and host thread for
  // this kernel alone: the table's kernels would evict one another from
  // ring_slots' shared cache, and a launch would pay the query.
  static thread_local int cached_dev = -1, cached_slots = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != cached_dev) {
    e = query_slots(reinterpret_cast<const void*>(kernel), dev, S::T, S::kSmem, &cached_slots);
    if (e != cudaSuccess) return e;
    cached_dev = dev;
  }
  const long long blocks = (lines + S::B - 1) / S::B;
  const long long work = (blocks + kWarps - 1) / kWarps;
  const long long rounds = (work + cached_slots - 1) / cached_slots;
  const long long grid = (work + rounds - 1) / rounds;
  if (report != nullptr)
    return describe_launch(reinterpret_cast<const void*>(kernel), S::T, S::kSmem, grid, work,
                           report);
  kernel<<<static_cast<unsigned>(grid), S::T, S::kSmem, stream>>>(x, y, tw, params, lines, cj);
  return cudaGetLastError();
}

// ---- the rule's lengths ------------------------------------------------------------

// The part of the table (WGFFT_PACKED_LINES, lines.cuh) that length n is
// instantiated in: lines_packed.cu holds part 0, lines_packed_2.cu .. _4.cu
// parts 1 to 3, so that the four compile side by side.
__host__ __device__ constexpr int part_of(int n) {
  return n < 25 ? 0 : n < 60 ? 1 : n < 98 ? 2 : 3;
}

template <int PART, int N, int LANES, int STAGES, int... R>
cudaError_t launch_in_part(const float2* x, float2* y, const float2* tw, const float* params,
                           long long lines, float cj, cudaStream_t stream, LinesReport* report) {
  if constexpr (part_of(N) == PART)
    return launch<N, LANES, STAGES, R...>(x, y, tw, params, lines, cj, stream, report);
  else
    return cudaErrorInvalidValue;
}

// Launch length n of the table if part PART holds it, on the table's shape
// and chain.
template <int PART>
cudaError_t launch_part(const float2* x, float2* y, const float2* tw, const float* params,
                        long long lines, int n, float cj, cudaStream_t stream,
                        LinesReport* report) {
#define WGFFT_PACKED_CASE(N, LANES, STAGES, ...)                                              \
  case N:                                                                                    \
    return launch_in_part<PART, N, LANES, STAGES, __VA_ARGS__>(x, y, tw, params, lines, cj, \
                                                               stream, report);
  switch (n) {
    WGFFT_PACKED_LINES(WGFFT_PACKED_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef WGFFT_PACKED_CASE
}

}  // namespace packed
}  // namespace wgfft
