// What K1 (fused_lines.cu) decides on the host before it launches, shared
// with the probe kernels that must run in K1's CTA shape
// (probes/lines_stages.cu, probes/lines_planes.cu): where a point of a line
// lives, how many points a thread holds, how many lines a CTA takes, and
// which kernel instantiation serves a chain; and K1's rule, which sends a
// length to one of its six designs, with what a launch would be
// (LinesReport).

#pragma once

#include <cuda_runtime.h>

#include <array>

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
enum LinesDesign {
  kDirect = 0,
  kPow2 = 1,
  kWarp = 2,
  kMixed = 3,
  kPacked = 4,
  kGeneral = 5,
  kCluster = 6
};

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

// K1's rule, one table a design (core/radix.py holds the same five
// tables, POW2_LINES, WARP_LINES, MIXED_LINES, PACKED_LINES and
// GENERAL_LINES): the lengths that run the power-of-two design of
// lines_pow2.cu, the warp design of lines_warp.cu, the mixed-radix design
// of lines_mixed.cu, the packed design of lines_packed.cu and the general
// mixed-radix design of lines_general.cu, each on one chain; every other
// length runs the direct design above on the chain it is handed.
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

// The general mixed-radix design's table (lines_general.cuh), one entry a
// length: N, the most points a thread holds (16, 20, 24, 32 or 64: the kernel's
// class), lines a CTA, then its chain of two to four passes.  Generated
// from the sweep's winners (chip_probes/k1_general_variants.py --fit).
struct GeneralLine {
  int points;
  int per_cta;
  LinesRule rule;
};
#define WGFFT_GENERAL_LINES(X) \
  X(96, 20, 21, 12, 8) X(108, 16, 18, 9, 12) X(120, 16, 17, 10, 12) X(128, 16, 16, 16, 8)       \
  X(130, 16, 15, 10, 13) X(132, 20, 15, 12, 11) X(135, 16, 15, 9, 15) X(140, 16, 14, 10, 14)    \
  X(143, 20, 14, 13, 11) X(144, 20, 14, 12, 12) X(147, 24, 13, 21, 7) X(150, 16, 13, 10, 15)    \
  X(154, 20, 13, 14, 11) X(156, 16, 13, 12, 13) X(160, 16, 12, 16, 10) X(162, 20, 12, 18, 9)    \
  X(165, 20, 12, 15, 11) X(168, 20, 12, 14, 12) X(169, 16, 12, 13, 13) X(175, 32, 11, 25, 7)    \
  X(176, 20, 11, 16, 11) X(180, 16, 11, 12, 15) X(182, 24, 11, 14, 13) X(189, 24, 10, 21, 9)    \
  X(192, 20, 10, 16, 12) X(195, 24, 10, 15, 13) X(196, 24, 10, 14, 14) X(198, 20, 10, 18, 11)   \
  X(200, 20, 10, 20, 10) X(208, 20, 9, 16, 13) X(210, 24, 9, 15, 14) X(216, 20, 9, 12, 18)      \
  X(220, 20, 9, 20, 11) X(224, 24, 9, 16, 14) X(225, 24, 9, 15, 15) X(231, 24, 8, 21, 11)       \
  X(234, 20, 8, 18, 13) X(240, 20, 8, 16, 15) X(242, 24, 8, 22, 11) X(243, 32, 8, 27, 9)        \
  X(245, 20, 8, 7, 7, 5) X(250, 32, 8, 25, 10) X(252, 20, 8, 18, 14) X(260, 20, 7, 20, 13)      \
  X(264, 32, 7, 22, 12) X(270, 20, 7, 15, 18) X(273, 24, 7, 13, 21) X(275, 32, 7, 25, 11)       \
  X(280, 20, 7, 20, 14) X(286, 24, 7, 13, 22) X(288, 20, 7, 16, 18) X(294, 24, 6, 14, 21)       \
  X(297, 32, 6, 27, 11) X(300, 20, 6, 15, 20) X(308, 24, 6, 14, 22) X(312, 24, 6, 24, 13)       \
  X(315, 24, 6, 15, 21) X(320, 20, 6, 16, 20) X(324, 24, 6, 18, 18) X(325, 32, 6, 25, 13)       \
  X(330, 24, 6, 15, 22) X(336, 24, 6, 16, 21) X(338, 32, 6, 26, 13) X(343, 20, 5, 7, 7, 7)      \
  X(350, 32, 11, 25, 14) X(351, 32, 5, 27, 13) X(352, 24, 5, 16, 22) X(363, 16, 5, 11, 11, 3)   \
  X(364, 32, 5, 14, 26) X(375, 32, 10, 25, 15) X(378, 24, 5, 18, 21) X(384, 24, 5, 16, 24)      \
  X(385, 20, 5, 11, 7, 5) X(390, 32, 5, 26, 15) X(392, 32, 5, 14, 28) X(396, 24, 5, 18, 22)     \
  X(400, 32, 5, 20, 20) X(405, 32, 5, 27, 15) X(416, 32, 4, 16, 26) X(420, 24, 4, 20, 21)       \
  X(429, 16, 4, 13, 11, 3) X(432, 32, 4, 24, 18) X(440, 24, 4, 20, 22) X(441, 32, 4, 21, 21)    \
  X(448, 32, 4, 28, 16) X(450, 32, 4, 18, 25) X(455, 24, 4, 13, 7, 5) X(462, 24, 4, 22, 21)     \
  X(468, 32, 4, 18, 26) X(480, 24, 4, 20, 24) X(484, 24, 4, 22, 22) X(486, 32, 4, 18, 27)       \
  X(490, 20, 4, 10, 7, 7) X(495, 16, 4, 11, 9, 5) X(500, 32, 4, 20, 25) X(504, 32, 4, 24, 21)   \
  X(507, 16, 8, 13, 13, 3) X(520, 32, 3, 20, 26) X(525, 32, 3, 21, 25) X(528, 24, 3, 22, 24)    \
  X(539, 16, 3, 11, 7, 7) X(540, 32, 3, 20, 27) X(546, 32, 3, 21, 26) X(550, 32, 3, 22, 25)     \
  X(560, 32, 3, 20, 28) X(567, 32, 3, 21, 27) X(572, 32, 3, 22, 26) X(576, 32, 3, 24, 24)       \
  X(585, 16, 3, 9, 13, 5) X(588, 32, 3, 28, 21) X(594, 32, 3, 27, 22) X(600, 32, 3, 24, 25)     \
  X(605, 20, 3, 11, 11, 5) X(616, 32, 3, 28, 22) X(624, 32, 3, 24, 26) X(625, 32, 3, 25, 25)    \
  X(630, 32, 3, 21, 30) X(637, 20, 3, 13, 7, 7) X(640, 32, 3, 20, 32) X(648, 32, 3, 24, 27)     \
  X(650, 32, 3, 26, 25) X(660, 32, 3, 30, 22) X(672, 32, 3, 28, 24) X(675, 32, 3, 27, 25)       \
  X(676, 32, 3, 26, 26) X(686, 24, 2, 14, 7, 7) X(693, 16, 2, 11, 9, 7) X(700, 32, 2, 28, 25)   \
  X(702, 32, 2, 27, 26) X(704, 32, 2, 32, 22) X(715, 16, 2, 11, 13, 5) X(720, 32, 2, 24, 30)    \
  X(726, 20, 2, 11, 11, 6) X(728, 32, 2, 28, 26) X(729, 32, 2, 27, 27) X(735, 20, 2, 15, 7, 7)  \
  X(750, 32, 2, 25, 30) X(756, 32, 2, 28, 27) X(768, 32, 2, 24, 32) X(770, 16, 2, 11, 10, 7)    \
  X(780, 32, 2, 30, 26) X(784, 32, 2, 28, 28) X(792, 16, 2, 9, 11, 8) X(800, 32, 2, 25, 32)     \
  X(810, 32, 2, 30, 27) X(819, 16, 2, 9, 13, 7) X(825, 16, 4, 15, 11, 5) X(832, 32, 2, 32, 26)  \
  X(840, 32, 2, 28, 30) X(845, 24, 2, 13, 13, 5) X(847, 20, 2, 11, 11, 7)                       \
  X(858, 20, 2, 13, 11, 6) X(864, 32, 2, 32, 27) X(875, 32, 4, 25, 7, 5)                        \
  X(880, 16, 2, 10, 11, 8) X(882, 16, 2, 9, 14, 7) X(891, 16, 2, 11, 9, 9)                      \
  X(896, 32, 2, 32, 28) X(900, 32, 2, 30, 30) X(910, 16, 2, 10, 13, 7) X(924, 20, 2, 12, 11, 7) \
  X(936, 16, 2, 9, 13, 8) X(945, 16, 2, 9, 15, 7) X(960, 32, 2, 32, 30)                         \
  X(968, 16, 2, 11, 11, 8) X(972, 16, 2, 12, 9, 9) X(975, 24, 2, 15, 13, 5)                     \
  X(980, 16, 2, 10, 14, 7) X(990, 16, 2, 11, 10, 9) X(1001, 16, 2, 11, 13, 7)                   \
  X(1008, 20, 2, 12, 12, 7) X(1014, 16, 2, 6, 13, 13) X(1029, 24, 3, 21, 7, 7)                  \
  X(1040, 20, 1, 13, 10, 8) X(1050, 20, 1, 15, 10, 7) X(1053, 16, 1, 9, 9, 13)                  \
  X(1056, 20, 1, 12, 11, 8) X(1078, 16, 1, 7, 11, 14) X(1080, 20, 1, 12, 10, 9)                 \
  X(1089, 24, 1, 11, 11, 9) X(1092, 16, 1, 7, 12, 13) X(1100, 24, 1, 11, 10, 10)                \
  X(1120, 20, 1, 14, 10, 8) X(1125, 16, 1, 15, 15, 5) X(1134, 16, 1, 9, 14, 9)                  \
  X(1144, 16, 1, 8, 11, 13) X(1152, 16, 1, 12, 12, 8) X(1155, 16, 1, 11, 15, 7)                 \
  X(1170, 20, 1, 13, 10, 9) X(1176, 16, 1, 7, 12, 14) X(1183, 16, 1, 7, 13, 13)                 \
  X(1188, 16, 1, 12, 11, 9) X(1200, 16, 1, 10, 10, 12) X(1210, 16, 1, 10, 11, 11)               \
  X(1215, 20, 1, 15, 9, 9) X(1225, 32, 3, 25, 7, 7) X(1232, 32, 1, 14, 11, 8)                   \
  X(1248, 16, 1, 8, 12, 13) X(1250, 32, 3, 25, 10, 5) X(1260, 20, 1, 14, 10, 9)                 \
  X(1274, 16, 1, 14, 13, 7) X(1280, 16, 1, 16, 10, 8) X(1287, 16, 1, 9, 11, 13)                 \
  X(1296, 16, 1, 9, 12, 12) X(1300, 16, 1, 10, 10, 13) X(1320, 16, 1, 11, 12, 10)               \
  X(1323, 32, 1, 21, 9, 7) X(1331, 20, 1, 11, 11, 11) X(1344, 16, 1, 8, 12, 14)                 \
  X(1350, 20, 1, 15, 10, 9) X(1365, 16, 1, 7, 13, 15) X(1372, 16, 2, 14, 14, 7)                 \
  X(1375, 32, 1, 11, 25, 5) X(1386, 16, 1, 11, 14, 9) X(1400, 16, 1, 10, 10, 14)                \
  X(1404, 16, 1, 9, 12, 13) X(1408, 20, 1, 16, 11, 8) X(1430, 16, 1, 10, 11, 13)                \
  X(1440, 16, 1, 10, 12, 12) X(1452, 16, 1, 11, 12, 11) X(1456, 16, 2, 14, 13, 8)               \
  X(1458, 20, 1, 9, 9, 18) X(1470, 16, 2, 15, 14, 7) X(1485, 16, 1, 9, 11, 15)                  \
  X(1500, 16, 1, 10, 10, 15) X(1512, 16, 1, 9, 12, 14) X(1521, 16, 1, 9, 13, 13)                \
  X(1540, 16, 1, 11, 14, 10) X(1560, 16, 1, 10, 12, 13) X(1568, 16, 2, 14, 14, 8)               \
  X(1573, 16, 1, 11, 13, 11) X(1575, 16, 2, 15, 15, 7) X(1584, 16, 1, 11, 12, 12)               \
  X(1600, 16, 1, 16, 10, 10) X(1617, 24, 2, 21, 11, 7) X(1620, 16, 1, 12, 15, 9)                \
  X(1625, 32, 1, 5, 13, 25) X(1638, 16, 1, 9, 13, 14) X(1650, 16, 1, 10, 11, 15)                \
  X(1664, 20, 1, 16, 13, 8) X(1680, 16, 1, 10, 12, 14) X(1690, 16, 1, 10, 13, 13)               \
  X(1694, 16, 1, 11, 14, 11) X(1701, 24, 1, 9, 9, 21) X(1715, 16, 1, 5, 7, 7, 7)                \
  X(1716, 16, 1, 11, 12, 13) X(1728, 16, 2, 12, 12, 12) X(1750, 32, 1, 7, 10, 25)               \
  X(1755, 16, 1, 9, 13, 15) X(1760, 16, 1, 11, 16, 10) X(1764, 16, 1, 14, 14, 9)                \
  X(1782, 20, 1, 18, 11, 9) X(1792, 20, 1, 16, 14, 8) X(1800, 16, 1, 10, 12, 15)                \
  X(1815, 16, 1, 11, 11, 15) X(1820, 16, 1, 14, 13, 10) X(1848, 20, 1, 14, 12, 11)              \
  X(1872, 16, 1, 12, 12, 13) X(1875, 32, 1, 15, 25, 5) X(1890, 16, 1, 9, 14, 15)                \
  X(1911, 24, 1, 21, 13, 7) X(1920, 16, 1, 12, 16, 10) X(1925, 32, 1, 11, 25, 7)                \
  X(1936, 20, 1, 16, 11, 11) X(1944, 24, 1, 18, 12, 9) X(1950, 16, 1, 10, 13, 15)               \
  X(1960, 16, 1, 10, 14, 14) X(1980, 16, 1, 15, 12, 11) X(2000, 24, 1, 20, 10, 10)              \
  X(2002, 20, 1, 14, 13, 11) X(2016, 16, 1, 14, 12, 12) X(2025, 24, 1, 15, 15, 9)               \
  X(2028, 16, 1, 12, 13, 13) X(2058, 24, 1, 21, 14, 7) X(2080, 16, 1, 16, 13, 10)               \
  X(2100, 16, 1, 10, 14, 15) X(2106, 20, 1, 18, 13, 9) X(2112, 16, 1, 16, 12, 11)               \
  X(2145, 16, 1, 15, 13, 11) X(2156, 16, 1, 11, 14, 14) X(2160, 16, 1, 15, 12, 12)              \
  X(2178, 24, 1, 18, 11, 11) X(2184, 16, 1, 12, 13, 14) X(2187, 32, 1, 27, 9, 9)                \
  X(2200, 24, 1, 20, 11, 10) X(2205, 24, 1, 15, 21, 7) X(2240, 16, 1, 16, 14, 10)               \
  X(2250, 20, 1, 15, 15, 10) X(2268, 20, 1, 18, 14, 9) X(2275, 32, 1, 13, 25, 7)                \
  X(2288, 16, 1, 16, 13, 11) X(2304, 20, 1, 16, 12, 12) X(2340, 16, 1, 12, 13, 15)              \
  X(2352, 16, 1, 12, 14, 14) X(2366, 16, 1, 14, 13, 13) X(2376, 20, 1, 18, 12, 11)              \
  X(2400, 20, 1, 16, 15, 10) X(2401, 16, 1, 7, 7, 7, 7) X(2420, 20, 1, 11, 11, 20)              \
  X(2430, 20, 1, 18, 15, 9) X(2450, 32, 1, 14, 25, 7) X(2457, 24, 1, 21, 13, 9)                 \
  X(2464, 16, 1, 14, 16, 11) X(2475, 16, 1, 15, 15, 11) X(2496, 16, 1, 12, 13, 16)              \
  X(2500, 32, 1, 25, 10, 10) X(2520, 16, 1, 12, 14, 15) X(2535, 16, 1, 15, 13, 13)              \
  X(2541, 24, 1, 11, 21, 11) X(2548, 16, 1, 14, 14, 13) X(2560, 24, 1, 16, 16, 10)              \
  X(2574, 20, 1, 18, 13, 11) X(2592, 24, 1, 18, 12, 12) X(2600, 20, 1, 20, 13, 10)              \
  X(2625, 32, 1, 7, 15, 25) X(2640, 16, 1, 16, 15, 11) X(2646, 32, 1, 21, 14, 9)                \
  X(2662, 24, 1, 11, 11, 22) X(2673, 32, 1, 11, 27, 9) X(2688, 16, 1, 14, 16, 12)               \
  X(2695, 24, 1, 11, 7, 7, 5) X(2700, 16, 1, 12, 15, 15) X(2704, 16, 1, 16, 13, 13)             \
  X(2730, 16, 1, 14, 15, 13) X(2744, 16, 1, 14, 14, 14) X(2750, 32, 1, 11, 25, 10)              \
  X(2772, 20, 1, 18, 14, 11) X(2800, 20, 1, 20, 14, 10) X(2808, 20, 1, 12, 13, 18)              \
  X(2816, 16, 1, 16, 16, 11) X(2835, 24, 1, 15, 21, 9) X(2860, 20, 1, 11, 13, 20)               \
  X(2880, 16, 1, 16, 15, 12) X(2904, 24, 1, 22, 12, 11) X(2912, 20, 1, 16, 14, 13)              \
  X(2916, 20, 1, 9, 18, 18) X(2925, 16, 1, 15, 15, 13) X(2940, 16, 1, 15, 14, 14)               \
  X(2970, 20, 1, 11, 15, 18) X(3003, 32, 1, 21, 13, 11) X(3024, 20, 1, 18, 14, 12)              \
  X(3025, 32, 1, 11, 11, 25) X(3042, 20, 1, 18, 13, 13) X(3080, 20, 1, 11, 14, 20)              \
  X(3087, 24, 1, 21, 21, 7) X(3120, 16, 1, 16, 15, 13) X(3125, 32, 1, 25, 25, 5)                \
  X(3136, 20, 1, 16, 14, 14) X(3146, 32, 1, 22, 13, 11) X(3150, 16, 1, 15, 15, 14)              \
  X(3159, 32, 1, 13, 27, 9) X(3168, 20, 1, 16, 18, 11) X(3185, 16, 1, 13, 7, 7, 5)              \
  X(3200, 20, 1, 16, 20, 10) X(3234, 32, 1, 21, 14, 11) X(3240, 20, 1, 12, 15, 18)              \
  X(3250, 32, 1, 13, 25, 10) X(3267, 32, 1, 11, 27, 11) X(3276, 20, 1, 14, 18, 13)              \
  X(3300, 20, 1, 15, 20, 11) X(3328, 16, 1, 16, 16, 13) X(3360, 16, 1, 15, 16, 14)              \
  X(3375, 16, 1, 15, 15, 15) X(3380, 24, 1, 20, 13, 13) X(3388, 32, 1, 22, 14, 11)              \
  X(3402, 24, 1, 18, 21, 9) X(3430, 20, 1, 10, 7, 7, 7) X(3432, 32, 1, 22, 13, 12)              \
  X(3456, 20, 1, 16, 18, 12) X(3465, 24, 1, 15, 21, 11) X(3500, 32, 1, 25, 14, 10)              \
  X(3510, 20, 1, 18, 15, 13) X(3520, 20, 1, 16, 20, 11) X(3528, 20, 1, 18, 14, 14)              \
  X(3549, 24, 1, 13, 13, 21) X(3564, 20, 1, 18, 18, 11) X(3575, 32, 1, 25, 13, 11)              \
  X(3584, 16, 1, 16, 16, 14) X(3600, 16, 1, 16, 15, 15) X(3630, 24, 1, 15, 22, 11)              \
  X(3640, 20, 1, 20, 14, 13) X(3645, 32, 1, 15, 27, 9) X(3675, 32, 1, 21, 25, 7)                \
  X(3696, 24, 1, 16, 21, 11) X(3744, 20, 1, 16, 18, 13) X(3750, 32, 1, 15, 25, 10)              \
  X(3773, 24, 1, 11, 7, 7, 7) X(3780, 20, 1, 14, 15, 18) X(3822, 24, 1, 13, 14, 21)             \
  X(3840, 16, 1, 16, 16, 15) X(3850, 32, 1, 11, 14, 25) X(3861, 32, 1, 27, 13, 11)              \
  X(3872, 24, 1, 16, 22, 11) X(3888, 20, 1, 18, 18, 12) X(3900, 24, 1, 20, 15, 13)              \
  X(3920, 20, 1, 20, 14, 14) X(3960, 20, 1, 20, 18, 11) X(3969, 24, 1, 21, 21, 9)               \
  X(3993, 16, 1, 11, 11, 11, 3) X(4000, 20, 1, 10, 20, 20) X(4004, 24, 1, 13, 14, 22)           \
  X(4032, 20, 1, 16, 18, 14) X(4050, 20, 1, 15, 18, 15) X(4056, 24, 1, 24, 13, 13)              \
  X(4095, 24, 1, 13, 15, 21) X(4116, 24, 1, 14, 14, 21) X(4125, 32, 1, 25, 15, 11)              \
  X(4158, 24, 1, 21, 18, 11) X(4160, 20, 1, 16, 20, 13) X(4200, 24, 1, 20, 15, 14)              \
  X(4212, 20, 1, 18, 18, 13) X(4224, 24, 1, 16, 22, 12) X(4225, 32, 1, 25, 13, 13)              \
  X(4235, 16, 1, 11, 11, 7, 5) X(4290, 32, 1, 22, 15, 13) X(4312, 24, 1, 14, 14, 22)            \
  X(4320, 20, 1, 16, 18, 15) X(4356, 24, 1, 18, 22, 11) X(4368, 32, 1, 21, 16, 13)              \
  X(4374, 32, 1, 27, 18, 9) X(4375, 32, 1, 25, 25, 7) X(4400, 32, 1, 20, 20, 11)                \
  X(4410, 24, 1, 14, 15, 21) X(4455, 32, 1, 27, 15, 11) X(4459, 20, 1, 13, 7, 7, 7)             \
  X(4480, 20, 1, 16, 20, 14) X(4500, 20, 1, 20, 15, 15) X(4536, 20, 1, 18, 18, 14)              \
  X(4550, 32, 1, 25, 14, 13) X(4563, 32, 1, 13, 27, 13) X(4576, 32, 1, 22, 16, 13)              \
  X(4608, 20, 1, 16, 18, 16) X(4620, 32, 1, 21, 20, 11) X(4680, 20, 1, 20, 18, 13)              \
  X(4704, 32, 1, 21, 16, 14) X(4719, 16, 1, 11, 13, 11, 3) X(4725, 24, 1, 15, 15, 21)           \
  X(4732, 32, 1, 13, 14, 26) X(4752, 24, 1, 22, 18, 12) X(4800, 20, 1, 16, 20, 15)              \
  X(4802, 20, 1, 14, 7, 7, 7) X(4840, 24, 1, 22, 20, 11) X(4851, 32, 1, 21, 21, 11)             \
  X(4860, 20, 1, 18, 18, 15) X(4875, 32, 1, 15, 25, 13) X(4900, 32, 1, 25, 14, 14)              \
  X(4914, 24, 1, 13, 18, 21) X(4928, 32, 1, 22, 16, 14) X(4950, 32, 1, 22, 15, 15)              \
  X(4992, 32, 1, 24, 16, 13) X(5000, 32, 1, 20, 25, 10) X(5005, 32, 1, 13, 11, 7, 5)            \
  X(5040, 20, 1, 18, 20, 14) X(5070, 32, 1, 15, 26, 13) X(5082, 24, 1, 22, 21, 11)              \
  X(5096, 32, 1, 14, 14, 26) X(5103, 32, 1, 21, 27, 9) X(5145, 16, 1, 15, 7, 7, 7)              \
  X(5148, 24, 1, 18, 22, 13) X(5184, 20, 1, 16, 18, 18) X(5200, 20, 1, 13, 20, 20)              \
  X(5250, 32, 1, 14, 15, 25) X(5265, 32, 1, 15, 27, 13) X(5280, 32, 1, 22, 16, 15)              \
  X(5292, 24, 1, 14, 18, 21) X(5324, 24, 1, 22, 22, 11) X(5346, 32, 1, 18, 27, 11)              \
  X(5376, 32, 1, 21, 16, 16) X(5390, 24, 1, 11, 10, 7, 7) X(5400, 20, 1, 15, 18, 20)            \
  X(5408, 32, 1, 13, 16, 26) X(5445, 24, 1, 11, 11, 9, 5) X(5460, 24, 1, 13, 20, 21)            \
  X(5488, 32, 1, 14, 28, 14) X(5500, 32, 1, 20, 25, 11) X(5544, 24, 1, 18, 22, 14)              \
  X(5600, 20, 1, 14, 20, 20) X(5616, 24, 1, 18, 24, 13) X(5625, 32, 1, 25, 15, 15)              \
  X(5632, 32, 1, 22, 16, 16) X(5670, 24, 1, 15, 18, 21) X(5720, 24, 1, 13, 20, 22)              \
  X(5733, 24, 1, 13, 21, 21) X(5760, 20, 1, 16, 18, 20) X(5775, 32, 1, 21, 25, 11)              \
  X(5808, 24, 1, 22, 22, 12) X(5824, 32, 1, 14, 16, 26) X(5832, 20, 1, 18, 18, 18)              \
  X(5850, 32, 1, 25, 18, 13) X(5880, 24, 1, 14, 20, 21) X(5915, 32, 1, 13, 13, 7, 5)            \
  X(5929, 24, 1, 11, 11, 7, 7) X(5940, 24, 1, 15, 18, 22) X(6006, 24, 1, 13, 21, 22)            \
  X(6048, 24, 1, 16, 18, 21) X(6050, 32, 1, 22, 25, 11) X(6075, 32, 1, 15, 27, 15)              \
  X(6084, 32, 1, 18, 26, 13) X(6125, 32, 1, 7, 25, 7, 5) X(6160, 24, 1, 14, 20, 22)             \
  X(6174, 24, 1, 14, 21, 21) X(6237, 32, 1, 21, 27, 11) X(6240, 24, 1, 13, 20, 24)              \
  X(6250, 32, 1, 25, 25, 10) X(6272, 32, 1, 14, 16, 28) X(6292, 24, 1, 13, 22, 22)              \
  X(6300, 24, 1, 15, 20, 21) X(6318, 32, 1, 27, 18, 13) X(6336, 24, 1, 16, 18, 22)              \
  X(6370, 32, 1, 13, 10, 7, 7) X(6400, 20, 1, 16, 20, 20) X(6435, 16, 1, 11, 13, 9, 5)          \
  X(6468, 24, 1, 14, 21, 22) X(6480, 20, 1, 18, 18, 20) X(6500, 32, 1, 20, 25, 13)              \
  X(6534, 32, 1, 22, 27, 11) X(6552, 24, 1, 13, 21, 24) X(6561, 32, 1, 27, 27, 9)               \
  X(6600, 24, 1, 15, 20, 22) X(6615, 24, 1, 15, 21, 21) X(6655, 20, 1, 11, 11, 11, 5)           \
  X(6656, 32, 1, 16, 16, 26) X(6720, 24, 1, 16, 20, 21) X(6750, 32, 1, 15, 18, 25)              \
  X(6760, 32, 1, 20, 26, 13) X(6776, 24, 1, 14, 22, 22) X(6804, 24, 1, 18, 18, 21)              \
  X(6825, 32, 1, 21, 25, 13) X(6860, 20, 1, 14, 10, 7, 7) X(6864, 24, 1, 13, 22, 24)            \
  X(6875, 32, 1, 25, 25, 11) X(6912, 24, 1, 16, 18, 24) X(6930, 24, 1, 15, 21, 22)              \
  X(7000, 32, 1, 20, 25, 14) X(7007, 16, 1, 11, 13, 7, 7) X(7020, 32, 1, 15, 18, 26)            \
  X(7040, 24, 1, 16, 20, 22) X(7056, 24, 1, 16, 21, 21) X(7098, 32, 1, 21, 26, 13)              \
  X(7128, 24, 1, 18, 22, 18) X(7150, 32, 1, 22, 25, 13) X(7168, 32, 1, 28, 16, 16)              \
  X(7200, 24, 1, 20, 20, 18) X(7260, 24, 1, 15, 22, 22) X(7280, 32, 1, 20, 26, 14)              \
  X(7290, 32, 1, 18, 27, 15) X(7350, 32, 1, 21, 25, 14) X(7371, 32, 1, 21, 27, 13)              \
  X(7392, 24, 1, 16, 21, 22) X(7425, 32, 1, 25, 27, 11) X(7488, 24, 1, 13, 24, 24)              \
  X(7500, 32, 1, 20, 25, 15) X(7546, 16, 1, 11, 14, 7, 7) X(7560, 24, 1, 21, 20, 18)            \
  X(7605, 24, 1, 13, 13, 9, 5) X(7623, 20, 1, 11, 11, 9, 7) X(7644, 32, 1, 21, 26, 14)          \
  X(7680, 24, 1, 16, 20, 24) X(7700, 32, 1, 22, 25, 14) X(7722, 32, 1, 22, 27, 13)              \
  X(7744, 24, 1, 16, 22, 22) X(7776, 24, 1, 18, 24, 18) X(7800, 32, 1, 24, 25, 13)              \
  X(7840, 32, 1, 20, 28, 14) X(7865, 16, 1, 11, 13, 11, 5) X(7875, 32, 1, 21, 25, 15)           \
  X(7920, 24, 1, 20, 22, 18) X(7938, 24, 1, 21, 21, 18) X(7986, 16, 1, 11, 11, 11, 6)           \
  X(8000, 32, 1, 20, 20, 20) X(8008, 32, 1, 22, 26, 14) X(8019, 32, 1, 11, 27, 27)              \
  X(8064, 24, 1, 16, 21, 24) X(8085, 16, 1, 11, 15, 7, 7) X(8100, 32, 1, 18, 18, 25)            \
  X(8112, 32, 1, 13, 24, 26) X(8125, 32, 1, 25, 25, 13) X(8190, 32, 1, 15, 21, 26)              \
  X(8250, 32, 1, 15, 22, 25) X(8281, 24, 1, 13, 13, 7, 7) X(8316, 24, 1, 21, 22, 18)            \
  X(8320, 32, 1, 20, 26, 16) X(8400, 24, 1, 20, 21, 20) X(8424, 32, 1, 18, 26, 18)              \
  X(8448, 24, 1, 16, 22, 24) X(8470, 24, 1, 11, 11, 10, 7) X(8505, 32, 1, 21, 27, 15)           \
  X(8580, 32, 1, 15, 22, 26) X(8624, 32, 1, 14, 22, 28) X(8640, 24, 1, 20, 24, 18)              \
  X(8712, 24, 1, 18, 22, 22) X(8736, 32, 1, 21, 26, 16) X(8748, 32, 1, 18, 18, 27)              \
  X(8750, 32, 1, 25, 25, 14) X(8775, 32, 1, 25, 27, 13) X(8800, 24, 1, 20, 20, 22)              \
  X(8820, 24, 1, 20, 21, 21) X(8910, 32, 1, 27, 22, 15) X(8918, 20, 1, 14, 13, 7, 7)            \
  X(8960, 32, 1, 20, 28, 16) X(9000, 32, 1, 18, 20, 25) X(9009, 32, 1, 11, 13, 9, 7)            \
  X(9072, 24, 1, 24, 21, 18) X(9075, 24, 1, 15, 11, 11, 5) X(9100, 32, 1, 14, 25, 26)           \
  X(9126, 32, 1, 13, 26, 27) X(9152, 32, 1, 16, 22, 26) X(9240, 24, 1, 20, 21, 22)              \
  X(9317, 24, 1, 11, 11, 11, 7) X(9360, 64, 1, 20, 26, 18) X(9375, 32, 1, 25, 25, 15)           \
  X(9408, 32, 1, 21, 28, 16) X(9438, 32, 1, 11, 13, 11, 6) X(9450, 64, 1, 21, 25, 18)           \
  X(9464, 32, 1, 26, 26, 14) X(9477, 32, 1, 13, 27, 27) X(9504, 24, 1, 24, 22, 18)              \
  X(9555, 16, 1, 15, 13, 7, 7) X(9600, 24, 1, 20, 20, 24) X(9604, 20, 1, 14, 14, 7, 7)          \
  X(9625, 32, 1, 11, 25, 7, 5) X(9680, 32, 1, 22, 22, 20) X(9702, 24, 1, 21, 22, 21)            \
  X(9720, 64, 1, 20, 27, 18) X(9750, 32, 1, 26, 25, 15) X(9800, 32, 1, 25, 28, 14)              \
  X(9801, 24, 1, 9, 9, 11, 11) X(9828, 64, 1, 26, 21, 18) X(9856, 32, 1, 22, 28, 16)            \
  X(9900, 64, 1, 22, 25, 18) X(9984, 32, 1, 24, 26, 16) X(10000, 32, 1, 20, 20, 25)             \
  X(10010, 32, 1, 11, 13, 10, 7) X(10080, 24, 1, 20, 21, 24) X(10125, 32, 1, 27, 25, 15)        \
  X(10164, 24, 1, 21, 22, 22) X(10192, 32, 1, 14, 26, 28) X(10206, 64, 1, 21, 27, 18)           \
  X(10240, 32, 1, 20, 32, 16) X(10290, 16, 1, 15, 14, 7, 7) X(10296, 64, 1, 22, 26, 18)         \
  X(10368, 24, 1, 18, 24, 24) X(10395, 32, 1, 11, 15, 9, 7) X(10400, 64, 1, 26, 20, 20)         \
  X(10500, 64, 1, 20, 21, 25) X(10530, 32, 1, 15, 26, 27) X(10560, 24, 1, 20, 22, 24)           \
  X(10584, 32, 1, 24, 21, 21) X(10647, 32, 1, 13, 13, 9, 7) X(10648, 32, 1, 22, 22, 22)         \
  X(10692, 64, 1, 22, 27, 18) X(10752, 32, 1, 16, 24, 28) X(10780, 32, 1, 11, 14, 10, 7)        \
  X(10800, 64, 1, 25, 24, 18) X(10816, 32, 1, 16, 26, 26) X(10890, 24, 1, 9, 10, 11, 11)        \
  X(10920, 64, 1, 21, 26, 20) X(10976, 32, 1, 14, 28, 28) X(11000, 64, 1, 22, 25, 20)           \
  X(11011, 32, 1, 11, 13, 11, 7) X(11025, 64, 1, 21, 25, 21) X(11088, 24, 1, 22, 24, 21)        \
  X(11200, 64, 1, 28, 20, 20) X(11232, 64, 1, 24, 26, 18) X(11250, 64, 1, 25, 25, 18)           \
  X(11264, 32, 1, 16, 22, 32) X(11340, 64, 1, 21, 27, 20) X(11375, 32, 1, 13, 25, 7, 5)         \
  X(11440, 64, 1, 22, 26, 20) X(11466, 64, 1, 21, 26, 21) X(11520, 24, 1, 24, 24, 20)           \
  X(11550, 64, 1, 22, 25, 21) X(11616, 24, 1, 22, 24, 22) X(11648, 32, 1, 28, 26, 16)           \
  X(11664, 64, 1, 24, 27, 18) X(11700, 64, 1, 25, 26, 18) X(11760, 64, 1, 21, 28, 20)           \
  X(11880, 64, 1, 22, 27, 20) X(12000, 64, 1, 25, 24, 20) X(12096, 24, 1, 21, 24, 24)           \
  X(12100, 64, 1, 25, 22, 22) X(12168, 64, 1, 26, 26, 18) X(12250, 32, 1, 25, 10, 7, 7)         \
  X(12285, 32, 1, 13, 15, 9, 7) X(12320, 64, 1, 20, 22, 28) X(12348, 64, 1, 21, 28, 21)         \
  X(12474, 64, 1, 21, 22, 27) X(12480, 64, 1, 20, 24, 26) X(12500, 64, 1, 20, 25, 25)           \
  X(12544, 32, 1, 16, 28, 28) X(12584, 64, 1, 22, 22, 26) X(12600, 64, 1, 24, 25, 21)           \
  X(12636, 64, 1, 27, 26, 18) X(12672, 24, 1, 22, 24, 24) X(12800, 64, 1, 32, 20, 20)           \
  X(12960, 64, 1, 20, 24, 27) X(13000, 64, 1, 20, 25, 26) X(13068, 64, 1, 22, 22, 27)           \
  X(13104, 64, 1, 21, 24, 26) X(13125, 64, 1, 21, 25, 25) X(13200, 64, 1, 24, 25, 22)           \
  X(13230, 64, 1, 21, 30, 21) X(13312, 32, 1, 16, 26, 32) X(13440, 64, 1, 20, 24, 28)           \
  X(13500, 64, 1, 20, 25, 27) X(13552, 64, 1, 22, 28, 22) X(13608, 64, 1, 21, 24, 27)           \
  X(13750, 64, 1, 25, 25, 22) X(13824, 24, 1, 24, 24, 24) X(13860, 64, 1, 30, 22, 21)           \
  X(14000, 64, 1, 25, 28, 20) X(14040, 64, 1, 27, 26, 20) X(14080, 64, 1, 32, 22, 20)           \
  X(14112, 64, 1, 21, 24, 28) X(14400, 64, 1, 25, 24, 24)
#define WGFFT_GENERAL_RULE(N, POINTS, PER_CTA, ...) GeneralLine{POINTS, PER_CTA, rule_of<__VA_ARGS__>(N)},
constexpr GeneralLine kGeneralLines[] = {WGFFT_GENERAL_LINES(WGFFT_GENERAL_RULE)};
#undef WGFFT_GENERAL_RULE

// The general design's entry for length n, or nullptr where its table does
// not name n (an index by length, made at the first call).
inline const GeneralLine* general_line(int n) {
  static const std::array<short, kMaxLength + 1> index = [] {
    std::array<short, kMaxLength + 1> at{};
    at.fill(-1);
    for (size_t i = 0; i < sizeof(kGeneralLines) / sizeof(kGeneralLines[0]); ++i)
      at[kGeneralLines[i].rule.n] = static_cast<short>(i);
    return at;
  }();
  return n >= 0 && n <= kMaxLength && index[n] >= 0 ? &kGeneralLines[index[n]] : nullptr;
}

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

// lines_pow2.cu, lines_warp.cu, lines_mixed.cu, lines_packed.cu,
// lines_general.cu: launch the power-of-two, the warp, the mixed-radix, the
// packed or the general design at a length its table names over `lines`
// lines; y may be x where the chain has two passes or more, and at every
// length of the packed design.  With `report`
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
cudaError_t launch_general_lines(const float2* x, float2* y, const float2* tw,
                                 const float* params, long long lines, int n, float cj,
                                 cudaStream_t stream, LinesReport* report);

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
