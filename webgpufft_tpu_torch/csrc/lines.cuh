// What K1 (fused_lines.cu) decides on the host before it launches, shared
// with the probe kernels that must run in K1's CTA shape
// (probes/lines_stages.cu, probes/lines_planes.cu): where a point of a line
// lives, how many points a thread holds, how many lines a CTA takes, and
// which kernel instantiation serves a chain; and K1's rule, which sends a
// length to one of its five designs, with what a launch would be
// (LinesReport).

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

// K1's designs, in the numbering of LinesReport::design (core/fused.py
// DESIGNS holds the same names in the same order).
enum LinesDesign { kDirect = 0, kPow2 = 1, kWarp = 2, kMixed = 3, kPacked = 4 };

// What a K1 launch would be, written by the launch functions instead of
// launching when a caller asks (wgfft_fused_lines_resident): the CTAs an SM
// holds of its kernel, the SMs of the device, the CTAs of its grid, the
// CTAs' worth of work (equal to the grid, except where a design loops over
// its lines: work / (resident * sms) is the waves the launch makes) and the
// design the rule gave the length (LinesDesign, set by the entry point).
struct LinesReport {
  long long resident;
  long long sms;
  long long grid;
  long long work;
  long long design;
};

inline cudaError_t describe_launch(const void* kernel, int threads, size_t smem, long long grid,
                                   long long work, LinesReport* out) {
  int dev = 0, sms = 0, resident = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, smem);
  *out = {resident, sms, grid, work, out->design};
  return e;
}

// K1's rule, one table a design (core/radix.py holds the same four
// tables, POW2_LINES, WARP_LINES, MIXED_LINES and PACKED_LINES): the
// lengths that run the power-of-two design of lines_pow2.cu, the warp
// design of lines_warp.cu, the mixed-radix design of lines_mixed.cu and the
// packed design of lines_packed.cu, each on one chain; every other length
// runs the direct design above on the chain it is handed.
struct LinesRule {
  int n;
  int count;
  int radix[4];
};
constexpr LinesRule kPow2Lines[] = {{256, 3, {8, 8, 4}},      {1024, 3, {16, 8, 8}},
                                    {2048, 3, {16, 16, 8}},    {4096, 3, {16, 16, 16}},
                                    {8192, 3, {32, 16, 16}},   {16384, 3, {32, 32, 16}}};
constexpr LinesRule kWarpLines[] = {{512, 3, {8, 8, 8}}};
constexpr LinesRule kMixedLines[] = {
    {360, 2, {20, 18}}, {1000, 3, {10, 10, 10}}, {1352, 3, {13, 13, 8}}, {1536, 3, {8, 8, 24}},
    {2079, 3, {27, 7, 11}}, {2310, 3, {22, 15, 7}}, {3000, 3, {10, 10, 30}},
    {3072, 3, {32, 4, 24}}, {5120, 3, {16, 16, 20}}, {6000, 3, {24, 25, 10}},
    {6144, 3, {32, 24, 8}}, {8232, 4, {8, 21, 7, 7}}, {9216, 3, {32, 24, 12}},
    {12288, 3, {32, 32, 12}}, {15360, 3, {32, 32, 15}}};
// The packed design's table (lines_packed.cuh), one entry a length: N,
// lanes a line (1: the whole line in one lane's registers), stages a warp
// (2: the next block lands meanwhile), then its chain, radix_chain's own.
// kPackedLines and the design's launch switch (packed::launch_part) are
// both made from it.
#define WGFFT_PACKED_LINES(X)                                                                     \
  X(4, 1, 2, 4) X(6, 1, 2, 3, 2) X(8, 1, 2, 8) X(9, 1, 2, 3, 3) X(10, 1, 2, 5, 2)                 \
  X(12, 1, 2, 4, 3) X(14, 1, 2, 7, 2) X(15, 1, 2, 5, 3) X(16, 1, 2, 16) X(18, 1, 2, 3, 3, 2)      \
  X(20, 1, 2, 5, 4) X(21, 1, 2, 7, 3) X(22, 1, 2, 11, 2) X(24, 1, 2, 8, 3) X(25, 1, 2, 5, 5)      \
  X(26, 1, 2, 13, 2) X(27, 1, 2, 3, 3, 3) X(28, 1, 2, 7, 4) X(30, 1, 1, 5, 3, 2)                  \
  X(32, 4, 2, 8, 4) X(33, 4, 2, 11, 3) X(35, 4, 2, 7, 5) X(36, 4, 1, 4, 3, 3)                     \
  X(39, 4, 2, 13, 3) X(40, 4, 2, 8, 5) X(42, 4, 1, 7, 3, 2) X(44, 4, 2, 11, 4)                    \
  X(45, 4, 2, 5, 3, 3) X(48, 2, 2, 16, 3) X(49, 4, 2, 7, 7) X(50, 1, 1, 5, 5, 2)                  \
  X(52, 4, 2, 13, 4) X(54, 4, 1, 3, 3, 3, 2) X(55, 4, 2, 11, 5) X(56, 4, 1, 8, 7)                 \
  X(60, 4, 1, 5, 4, 3) X(63, 4, 2, 7, 3, 3) X(64, 4, 2, 8, 8) X(65, 8, 2, 13, 5)                  \
  X(66, 8, 2, 11, 3, 2) X(70, 8, 1, 7, 5, 2) X(72, 8, 2, 8, 3, 3) X(75, 8, 1, 5, 5, 3)            \
  X(77, 8, 2, 11, 7) X(78, 8, 1, 13, 3, 2) X(80, 8, 2, 16, 5) X(81, 8, 2, 3, 3, 3, 3)             \
  X(84, 8, 1, 7, 4, 3) X(88, 8, 2, 11, 8) X(90, 8, 1, 5, 3, 3, 2) X(91, 8, 2, 13, 7)              \
  X(98, 4, 1, 7, 7, 2) X(99, 8, 2, 11, 3, 3) X(100, 4, 2, 5, 5, 4) X(104, 8, 2, 13, 8)            \
  X(105, 8, 2, 7, 5, 3) X(110, 8, 1, 11, 5, 2) X(112, 8, 1, 16, 7) X(117, 8, 1, 13, 3, 3)         \
  X(121, 8, 2, 11, 11) X(125, 8, 1, 5, 5, 5) X(126, 4, 1, 7, 3, 3, 2)
template <int... R>
constexpr LinesRule rule_of(int n) {
  return {n, static_cast<int>(sizeof...(R)), {R...}};
}
#define WGFFT_PACKED_RULE(N, LANES, STAGES, ...) rule_of<__VA_ARGS__>(N),
constexpr LinesRule kPackedLines[] = {WGFFT_PACKED_LINES(WGFFT_PACKED_RULE)};
#undef WGFFT_PACKED_RULE

// The rule of `table` for length n, or nullptr where the table does not
// name n.
template <size_t K>
inline const LinesRule* lines_rule(const LinesRule (&table)[K], int n) {
  for (const LinesRule& rule : table)
    if (rule.n == n) return &rule;
  return nullptr;
}

// Whether radices[0, count) is the rule's chain.
inline bool rule_chain(const LinesRule& rule, const int* radices, int count) {
  if (count != rule.count) return false;
  for (int p = 0; p < count; ++p)
    if (radices[p] != rule.radix[p]) return false;
  return true;
}

// lines_pow2.cu, lines_warp.cu, lines_mixed.cu, lines_packed.cu: launch the
// power-of-two, the warp, the mixed-radix or the packed design at a length
// its table names over `lines` lines; y may be x where the chain has two
// passes or more, and at every length of the packed design.  With `report`
// not null nothing launches and the launch is described there instead.
cudaError_t launch_pow2_lines(const float2* x, float2* y, const float2* tw, const float* params,
                              long long lines, int n, float cj, cudaStream_t stream,
                              LinesReport* report);
cudaError_t launch_warp_lines(const float2* x, float2* y, const float2* tw, const float* params,
                              long long lines, int n, float cj, cudaStream_t stream,
                              LinesReport* report);
cudaError_t launch_mixed_lines(const float2* x, float2* y, const float2* tw, const float* params,
                               long long lines, int n, float cj, cudaStream_t stream,
                               LinesReport* report);
cudaError_t launch_packed_lines(const float2* x, float2* y, const float2* tw, const float* params,
                                long long lines, int n, float cj, cudaStream_t stream,
                                LinesReport* report);

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
