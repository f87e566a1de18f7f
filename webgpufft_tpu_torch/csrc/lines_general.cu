// K1's general mixed-radix design: every length of its table
// (WGFFT_GENERAL_LINES, lines.cuh), five kernel instantiations in all
// (lines_general.cuh; lines_general_16.cu, _20.cu, _24.cu, _32.cu, _64.cu).
//
// Same function as the direct design (fused_lines.cu): the natural-order
// DFT of every line of interleaved f32 (lines, N, 2) times the scale, with
// the adjoint launch (cj = -1) and y = x allowed (every chain of the table
// has two passes or more), on the chain the table names and the `cw` table
// of that chain (core/radix.py GENERAL_LINES).
//
// What held the direct design at these lengths, and what this design does
// about it:
// - too many passes: radix_chain gives every odd prime a pass of its own,
//   4 to 8 passes from 129 points.  Here each pass is a butterfly of up to
//   32 points in registers (lines_mixed.cuh's Dft, composite radices
//   included), so every length runs in the fewest passes those radices
//   allow: two, three or four, each exchange one trip through shared
//   memory and one barrier (two buffers in turn, lines_general.cuh);
// - big CTAs: the direct design sizes threads for the pass with the most
//   butterflies at 8 points a thread, one CTA an SM from about 2048
//   points.  Here a thread runs whole butterflies, one at a time, at most
//   E points a pass, the threads are sized for the chain and the lines a
//   CTA come from the length, so CTAs are small and several share an SM
//   wherever registers and shared memory allow;
// - a run-time chain with a division per butterfly and one instantiation a
//   radix set, whose widest radix set the registers of every length in it.
//   Here the chain is still a run-time value (a kernel a length, as the
//   mixed-radix design has, would be hundreds of instantiations), but each
//   pass dispatches to a compile-time body of its radix, the divisions are
//   multiply-highs by host constants, and the kernel is instantiated per
//   class of E (16, 20, 24, 32, 64 points a thread), so that the widest
//   butterfly of a length's class, not of every radix, sets its registers.
// Which chain (order included), class and lines a CTA each length takes is
// the measured sweep's (chip_probes/k1_general_variants.py, PERF.md).

#include <cuda_runtime.h>

#include "lines.cuh"
#include "lines_general.cuh"

namespace wgfft {
namespace general {

namespace {

// The plan of `chain` over n with E = points a thread and `per_cta` lines a
// CTA, its threads and its shared memory; false where the design cannot run
// it (not two to four passes of its radices that multiply to n, a class it
// does not have, too many threads for the class, or more shared memory than
// a CTA may have).
bool make_plan(int n, const int* radices, int count, int points, int per_cta, Plan* plan,
               int* threads, int* smem) {
  const int limit = max_threads(points);
  if (count < 2 || count > kMaxPasses || limit == 0 || per_cta < 1 || n < 4 ||
      n > kMaxLength)
    return false;
  long long prod = 1;
  for (int p = 0; p < count; ++p) {
    if (!takes(points, radices[p])) return false;
    prod *= radices[p];
    if (prod > n) return false;
  }
  if (prod != n) return false;
  *plan = {};
  plan->n = n;
  plan->lines = per_cta;
  plan->count = count;
  int ns = 1, t = 1, pitch = n;
  unsigned period_in = 0;
  for (int p = 0; p < count; ++p) {
    const int r = radices[p];
    const int m = n / r;
    const int need = (per_cta * m + points / r - 1) / (points / r);
    if (need > t) t = need;
    // the exchange this pass writes (none after the last): one point of
    // padding in every ns * r where r is even
    const int period = p + 1 < count && r % 2 == 0 ? ns * r : 0;
    if (period > 0 && n + (n - 1) / period > pitch) pitch = n + (n - 1) / period;
    plan->pass[p] = {r, ns, m, magic(m), magic(ns), period_in, magic(period)};
    period_in = magic(period);
    ns *= r;
  }
  plan->pitch = pitch;
  // the exchanges alternate between two buffers (a chain of two passes has
  // one exchange)
  const int buffers = count > 2 ? 2 : 1;
  const long long bytes = static_cast<long long>(buffers) * per_cta * pitch * sizeof(float2);
  if (t > limit || bytes > 227 * 1024) return false;
  *threads = t;
  *smem = static_cast<int>(bytes);
  return true;
}

}  // namespace

// Launch (or describe) `chain` over `lines` lines in the class of `points`;
// the threads a CTA into `threads` where it is not null.
cudaError_t launch(const float2* x, float2* y, const float2* tw, const float* params,
                   long long lines, int n, const int* radices, int count, int points,
                   int per_cta, float cj, cudaStream_t stream, LinesReport* report,
                   int* threads = nullptr) {
  Launch g = {x, y, tw, params, lines, cj, stream, report, {}, 0, 0};
  if (lines < 1 || !make_plan(n, radices, count, points, per_cta, &g.plan, &g.threads, &g.smem))
    return cudaErrorInvalidValue;
  if (threads != nullptr) *threads = g.threads;
  switch (points) {
    case 16: return launch_16(g);
    case 20: return launch_20(g);
    case 24: return launch_24(g);
    case 32: return launch_32(g);
    default: return launch_64(g);
  }
}

}  // namespace general

// The rule's lengths (kGeneralLines, lines.cuh): each in its class, lines a
// CTA and chain.
cudaError_t launch_general_lines(const float2* x, float2* y, const float2* tw,
                                 const float* params, long long lines, int n, float cj,
                                 cudaStream_t stream, LinesReport* report) {
  const GeneralLine* g = general_line(n);
  if (g == nullptr) return cudaErrorInvalidValue;
  return general::launch(x, y, tw, params, lines, n, g->rule.radix, g->rule.count, g->points,
                         g->per_cta, cj, stream, report);
}

}  // namespace wgfft

// The general design on any chain it can run, in the class of `points`
// (16, 20, 24, 32 or 64 points a thread at most) with `per_cta` lines a CTA,
// outside K1's rule: the variants of chip_probes/k1_general_variants.py, whose
// sweep the rule's table is fitted to.  y may be x.  With `report` not null
// nothing launches, and report[0..4] get the CTAs an SM holds, the SMs, the
// grid, the CTAs' worth of work and the threads a CTA.  Returns the
// cudaError_t: cudaErrorInvalidValue for what the design cannot run.
extern "C" int wgfft_general_lines(const void* x, void* y, const void* tw, const void* params,
                                   long long lines, int n, const int* radices, int count,
                                   int points, int per_cta, int adjoint, long long* report,
                                   void* stream) {
  wgfft::LinesReport r = {};
  int threads = 0;
  const int rc = static_cast<int>(wgfft::general::launch(
      static_cast<const float2*>(x), static_cast<float2*>(y), static_cast<const float2*>(tw),
      static_cast<const float*>(params), lines, n, radices, count, points, per_cta,
      adjoint ? -1.f : 1.f, static_cast<cudaStream_t>(stream), report != nullptr ? &r : nullptr,
      &threads));
  if (report != nullptr) {
    report[0] = r.resident;
    report[1] = r.sms;
    report[2] = r.grid;
    report[3] = r.work;
    report[4] = threads;
  }
  return rc;
}
