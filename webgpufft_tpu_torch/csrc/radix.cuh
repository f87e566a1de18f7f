// In-register radix butterflies and the Stockham pass that K1
// (fused_lines.cu) and K2 (fused_cols.cu) are both built from.
//
// A CTA computes one or more length-n DFTs ("units": lines for K1, columns
// for K2) as a chain of passes, n = r_0 * r_1 * ... * r_{P-1}, every r_p in
// {2, 3, 4, 5, 7, 8, 11, 13, 16}.  Pass p with ns = r_0 * ... * r_{p-1}, R = r_p
// and m = n / R does, for every j in [0, m) of every unit:
//
//   k     = j mod ns
//   v[r]  = in[j + r * m]                     r = 0 .. R-1
//   v[r] *= tw[ns - 1 + (r - 1) * ns + k]     r = 1 .. R-1, skipped when ns = 1
//   v     = DFT_R(v)                          in registers
//   out[(j - k) * R + k + r * ns] = v[r]
//
// which leaves natural order after the last pass (Stockham autosort).  The
// first pass reads global memory straight into registers, the last writes
// registers straight to global memory with the scale applied, and the
// passes between exchange through shared memory in place: a thread holds
// all its butterflies' points in registers across the barrier that
// separates a pass's reads from its writes.  A one-pass chain never touches
// shared memory.  Where a ring of stages (stage.cuh) has landed the units
// in shared memory already, the first pass reads them from their stage
// instead.
//
// tw is the host's table of n-th roots of unity (float64 on the host,
// rounded once to f32) gathered into the order the passes read it, n - 1
// entries in all, so the threads of a warp read neighbouring entries through
// the read-only path.  No twiddle is computed on the device.
//
// The direction is a sign s (-1 forward, +1 inverse) read with the scale
// from a two-float table: the butterflies multiply their imaginary
// constants by s, so one instantiation serves both directions.  The adjoint
// of a pass (the backward of autograd: same length and scale, opposite
// direction) is the same launch with cj = -1, see radix_chain.
//
// Cost: about 5 * log2(n) FP32 flops per point instead of the
// 8 * (n1 + n2) of two direct digit DFTs.  Tensor cores are not used: at
// full f32 accuracy a DFT-matrix product would need a three-term TF32 split
// and would still do more work than these butterflies.

#pragma once

#include <cuda_runtime.h>

namespace wgfft {

constexpr int kMaxPasses = 16;
constexpr int kMaxLength = 16384;

struct Chain {
  int count;
  int radix[kMaxPasses];
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
// a * (i * s)
__device__ __forceinline__ float2 muli(float2 a, float s) {
  return make_float2(-s * a.y, s * a.x);
}

// (cos, sin) of 2 * pi * j / R for the odd radices, j in [0, R)
static __constant__ float2 kOddRoots[3 + 5 + 7 + 11 + 13] = {
    // R = 3
    {1.0f, 0.0f}, {-0.5f, 0.866025388f}, {-0.5f, -0.866025388f},
    // R = 5
    {1.0f, 0.0f}, {0.309017003f, 0.95105654f}, {-0.809017003f, 0.587785244f},
    {-0.809017003f, -0.587785244f}, {0.309017003f, -0.95105654f},
    // R = 7
    {1.0f, 0.0f}, {0.623489797f, 0.781831503f}, {-0.222520933f, 0.974927902f},
    {-0.90096885f, 0.433883727f}, {-0.90096885f, -0.433883727f},
    {-0.222520933f, -0.974927902f}, {0.623489797f, -0.781831503f},
    // R = 11
    {1.0f, 0.0f}, {0.841253519f, 0.540640831f}, {0.415415019f, 0.909631968f},
    {-0.142314836f, 0.989821434f}, {-0.654860735f, 0.755749583f},
    {-0.959492981f, 0.281732559f}, {-0.959492981f, -0.281732559f},
    {-0.654860735f, -0.755749583f}, {-0.142314836f, -0.989821434f},
    {0.415415019f, -0.909631968f}, {0.841253519f, -0.540640831f},
    // R = 13
    {1.0f, 0.0f}, {0.885456026f, 0.46472317f}, {0.568064749f, 0.822983861f},
    {0.120536678f, 0.992708862f}, {-0.3546049f, 0.935016215f},
    {-0.748510778f, 0.663122654f}, {-0.970941842f, 0.239315659f},
    {-0.970941842f, -0.239315659f}, {-0.748510778f, -0.663122654f},
    {-0.3546049f, -0.935016215f}, {0.120536678f, -0.992708862f},
    {0.568064749f, -0.822983861f}, {0.885456026f, -0.46472317f},
};

template <int R>
__host__ __device__ constexpr int odd_offset() {
  return R == 3 ? 0 : R == 5 ? 3 : R == 7 ? 8 : R == 11 ? 15 : 26;
}

// X[q] = sum_r v[r] * exp(s * 2 * pi * i * r * q / R), in place.
template <int R>
struct Butterfly {
  // Odd prime R.  With a_k = v[k] + v[R-k] and b_k = v[k] - v[R-k]:
  //   X[q], X[R-q] = m_q +- i * s * n_q,
  //   m_q = v[0] + sum_k cos(2 pi q k / R) a_k,  n_q = sum_k sin(2 pi q k / R) b_k.
  static __device__ __forceinline__ void run(float2 (&v)[R], float s) {
    static_assert(R == 3 || R == 5 || R == 7 || R == 11 || R == 13, "unsupported radix");
    constexpr int H = (R - 1) / 2;
    constexpr int off = odd_offset<R>();
    float2 a[H + 1], b[H + 1];
    const float2 v0 = v[0];
    float2 sum = v0;
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      a[k] = cadd(v[k], v[R - k]);
      b[k] = csub(v[k], v[R - k]);
      sum = cadd(sum, a[k]);
    }
    v[0] = sum;
#pragma unroll
    for (int q = 1; q <= H; ++q) {
      float2 m = v0;
      float2 n = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 1; k <= H; ++k) {
        const float2 w = kOddRoots[off + (q * k) % R];
        m.x = fmaf(w.x, a[k].x, m.x);
        m.y = fmaf(w.x, a[k].y, m.y);
        n.x = fmaf(w.y, b[k].x, n.x);
        n.y = fmaf(w.y, b[k].y, n.y);
      }
      const float2 r = muli(n, s);
      v[q] = cadd(m, r);
      v[R - q] = csub(m, r);
    }
  }
};

template <>
struct Butterfly<2> {
  static __device__ __forceinline__ void run(float2 (&v)[2], float) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  }
};

template <>
struct Butterfly<4> {
  static __device__ __forceinline__ void run(float2 (&v)[4], float s) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = muli(csub(v[1], v[3]), s);
    v[0] = cadd(t0, t2);
    v[1] = cadd(t1, t3);
    v[2] = csub(t0, t2);
    v[3] = csub(t1, t3);
  }
};

// Three radix-2 layers: two radix-4 butterflies on the even and odd points,
// the odd half rotated by w8^q (w8 = (1 + s i) / sqrt 2), then one layer.
template <>
struct Butterfly<8> {
  static __device__ __forceinline__ void run(float2 (&v)[8], float s) {
    constexpr float h = 0.707106781f;
    float2 e[4] = {v[0], v[2], v[4], v[6]};
    float2 o[4] = {v[1], v[3], v[5], v[7]};
    Butterfly<4>::run(e, s);
    Butterfly<4>::run(o, s);
    o[1] = make_float2(h * (o[1].x - s * o[1].y), h * (s * o[1].x + o[1].y));
    o[2] = muli(o[2], s);
    o[3] = make_float2(h * (-o[3].x - s * o[3].y), h * (s * o[3].x - o[3].y));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = cadd(e[q], o[q]);
      v[q + 4] = csub(e[q], o[q]);
    }
  }
};

// 16 = 4 x 4: radix-4 butterflies on the four residue classes of r mod 4,
// G_b[d] rotated by w16^(b d) (w16 = exp(s 2 pi i / 16)), then radix-4
// butterflies across the classes: X[d + 4 c] = sum_b w4^(b c) w16^(b d) G_b[d].
template <>
struct Butterfly<16> {
  static __device__ __forceinline__ float2 rot(float2 a, float c, float si) {
    return make_float2(fmaf(a.x, c, -a.y * si), fmaf(a.x, si, a.y * c));
  }
  static __device__ __forceinline__ void run(float2 (&v)[16], float s) {
    constexpr float h = 0.707106781f, c1 = 0.923879533f, s1 = 0.382683432f;
    float2 g[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float2 t[4] = {v[b], v[b + 4], v[b + 8], v[b + 12]};
      Butterfly<4>::run(t, s);
#pragma unroll
      for (int d = 0; d < 4; ++d) g[b][d] = t[d];
    }
    g[1][1] = rot(g[1][1], c1, s * s1);   // w16^1
    g[1][2] = rot(g[1][2], h, s * h);     // w16^2
    g[1][3] = rot(g[1][3], s1, s * c1);   // w16^3
    g[2][1] = rot(g[2][1], h, s * h);     // w16^2
    g[2][2] = muli(g[2][2], s);           // w16^4
    g[2][3] = rot(g[2][3], -h, s * h);    // w16^6
    g[3][1] = rot(g[3][1], s1, s * c1);   // w16^3
    g[3][2] = rot(g[3][2], -h, s * h);    // w16^6
    g[3][3] = rot(g[3][3], -c1, -s * s1); // w16^9
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      float2 t[4] = {g[0][d], g[1][d], g[2][d], g[3][d]};
      Butterfly<4>::run(t, s);
#pragma unroll
      for (int c = 0; c < 4; ++c) v[d + 4 * c] = t[c];
    }
  }
};

// 32 = 2 x 16 (the power-of-two design of K1 only, lines_pow2.cu): radix-16
// butterflies on the even and odd points, the odd half rotated by w32^q
// (w32 = exp(s 2 pi i / 32)), then one radix-2 layer:
// X[q] = E[q] + w32^q O[q], X[q + 16] = E[q] - w32^q O[q].
template <>
struct Butterfly<32> {
  static __device__ __forceinline__ void run(float2 (&v)[32], float s) {
    constexpr float c1 = 0.980785280f, s1 = 0.195090322f;   // 2 pi / 32
    constexpr float c2 = 0.923879533f, s2 = 0.382683432f;   // 2 pi 2 / 32
    constexpr float c3 = 0.831469612f, s3 = 0.555570233f;   // 2 pi 3 / 32
    constexpr float h = 0.707106781f;
    float2 e[16], o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      e[i] = v[2 * i];
      o[i] = v[2 * i + 1];
    }
    Butterfly<16>::run(e, s);
    Butterfly<16>::run(o, s);
    using B = Butterfly<16>;
    o[1] = B::rot(o[1], c1, s * s1);
    o[2] = B::rot(o[2], c2, s * s2);
    o[3] = B::rot(o[3], c3, s * s3);
    o[4] = B::rot(o[4], h, s * h);
    o[5] = B::rot(o[5], s3, s * c3);
    o[6] = B::rot(o[6], s2, s * c2);
    o[7] = B::rot(o[7], s1, s * c1);
    o[8] = muli(o[8], s);
    o[9] = B::rot(o[9], -s1, s * c1);
    o[10] = B::rot(o[10], -s2, s * c2);
    o[11] = B::rot(o[11], -s3, s * c3);
    o[12] = B::rot(o[12], -h, s * h);
    o[13] = B::rot(o[13], -c3, s * s3);
    o[14] = B::rot(o[14], -c2, s * s2);
    o[15] = B::rot(o[15], -c1, s * s1);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      v[q] = cadd(e[q], o[q]);
      v[q + 16] = csub(e[q], o[q]);
    }
  }
};

// Butterflies one thread runs in a pass of radix R when it may hold E points.
__host__ __device__ constexpr int per_thread(int e, int radix) {
  return e / radix > 0 ? e / radix : 1;
}

// One pass over the CTA's units.  Layout tells where a point lives:
//   units()            units in this CTA
//   split(b, m, u, j)  butterfly b of the CTA -> unit u, index j in [0, m)
//   live(u)            whether unit u exists (ragged edge: dead units load
//                      zeros and store nothing)
//   global(u, pos)     offset of point pos of unit u in x and y
//   shared(u, pos)     offset of point pos of unit u in shared memory
//   kStaged            false: the first pass reads x; true: the units have
//                      landed in shared memory already (stage.cuh), and the
//                      first pass reads them at sm[landed(u, pos)]
//
// FIRST and LAST say at compile time whether this is the chain's first and
// last pass (0 or 1), or leave it to the arguments of the same name (-1).
template <int E, int R, int FIRST, int LAST, class Layout>
__device__ __forceinline__ void radix_pass(const Layout& lay, const float2* __restrict__ x,
                                           float2* __restrict__ y, float2* sm,
                                           const float2* __restrict__ tw, int n, int ns,
                                           bool first_arg, bool last_arg, float s,
                                           float scale, float cj) {
  const bool first = FIRST < 0 ? first_arg : FIRST != 0;
  const bool last = LAST < 0 ? last_arg : LAST != 0;
  constexpr int PER = per_thread(E, R);
  const int m = n / R;
  const int total = m * lay.units();
  // k = j mod ns: a mask where ns is a power of two (the staged layouts
  // only; the direct design's kernels keep the division as they were measured)
  const bool mask = Layout::kStaged && (ns & (ns - 1)) == 0;
  float2 v[PER][R];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = threadIdx.x + q * blockDim.x;
    if (b < total) {
      int u, j;
      lay.split(b, m, u, j);
      if (first) {
        if constexpr (Layout::kStaged) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            v[q][r] = sm[lay.landed(u, j + r * m)];
            v[q][r].y *= cj;
          }
        } else {
          const bool live = lay.live(u);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            v[q][r] = live ? x[lay.global(u, j + r * m)] : make_float2(0.f, 0.f);
            v[q][r].y *= cj;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) v[q][r] = sm[lay.shared(u, j + r * m)];
        const float2* t = tw + (ns - 1) + (mask ? j & (ns - 1) : j % ns);
#pragma unroll
        for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], __ldg(t + (r - 1) * ns));
      }
      Butterfly<R>::run(v[q], s);
    }
  }
  // every read of this pass is done: overwrite (a staged first pass reads
  // the stage it writes)
  if (!first || Layout::kStaged) __syncthreads();
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = threadIdx.x + q * blockDim.x;
    if (b < total) {
      int u, j;
      lay.split(b, m, u, j);  // again, rather than hold it across the barrier
      const int k = mask ? j & (ns - 1) : j % ns;
      const int j0 = (j - k) * R + k;
      if (last) {
        if (lay.live(u)) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            y[lay.global(u, j0 + r * ns)] =
                make_float2(v[q][r].x * scale, v[q][r].y * (scale * cj));
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) sm[lay.shared(u, j0 + r * ns)] = v[q][r];
      }
    }
  }
  if (!last) __syncthreads();
}

// Radix sets a kernel is instantiated for.  A kernel's register count is the
// largest over the radices it can dispatch to, so chains of 2, 4 and 8 alone
// (every power of two) get a kernel that the wide odd butterflies do not
// weigh on.
constexpr int kSetPow2 = 0;   // 2, 4, 8, 16
constexpr int kSetSmall = 1;  // and 3, 5
constexpr int kSetAll = 2;    // and 7, 11, 13

// The whole chain on the CTA's units.  params = {scale, s}.  cj is +1 for
// the transform itself and -1 for its adjoint: F^H g = conj(F conj g), so the
// adjoint conjugates on the first pass's load and the last pass's store (two
// sign flips a point, in registers) and reads the same tables.
template <int E, int SET, class Layout>
__device__ __forceinline__ void radix_chain(const Layout& lay, const float2* __restrict__ x,
                                            float2* __restrict__ y, float2* sm,
                                            const float2* __restrict__ tw,
                                            const float* __restrict__ params, int n,
                                            const Chain& chain, float cj) {
  const float scale = __ldg(params);
  const float s = __ldg(params + 1);
  int ns = 1;
  for (int p = 0; p < chain.count; ++p) {
    const int radix = chain.radix[p];
    const bool first = p == 0;
    const bool last = p == chain.count - 1;
    // The smallest kernels (powers of two, 8 points a thread) compile each
    // pass once per (first, last): without the merged load and store paths
    // the radix-16 pass needs no spill.  The larger kernels would outgrow the
    // instruction cache that way and keep one copy with run-time flags.
    constexpr bool kSplit = SET == kSetPow2 && E == 8;
#define WGFFT_RUN(R, F, L) \
  radix_pass<E, R, F, L>(lay, x, y, sm, tw, n, ns, first, last, s, scale, cj)
#define WGFFT_PASS(R)                          \
  do {                                         \
    if constexpr (!kSplit) WGFFT_RUN(R, -1, -1); \
    else if (first && last) WGFFT_RUN(R, 1, 1);  \
    else if (first) WGFFT_RUN(R, 1, 0);          \
    else if (last) WGFFT_RUN(R, 0, 1);           \
    else WGFFT_RUN(R, 0, 0);                     \
  } while (0)
    if (radix == 16) WGFFT_PASS(16);
    else if (radix == 8) WGFFT_PASS(8);
    else if (radix == 4) WGFFT_PASS(4);
    else if (radix == 2) WGFFT_PASS(2);
    else if constexpr (SET >= kSetSmall) {
      if (radix == 3) WGFFT_PASS(3);
      else if (radix == 5) WGFFT_PASS(5);
      else if constexpr (SET >= kSetAll) {
        if (radix == 7) WGFFT_PASS(7);
        else if (radix == 11) WGFFT_PASS(11);
        else WGFFT_PASS(13);
      }
    }
#undef WGFFT_PASS
#undef WGFFT_RUN
    ns *= radix;
  }
}

// ---- host side ------------------------------------------------------------

// Copy and check a chain: 1..kMaxPasses supported radices whose product is n.
inline bool make_chain(const int* radices, int count, int n, Chain* out) {
  if (count < 1 || count > kMaxPasses || n < 2 || n > kMaxLength) return false;
  long long prod = 1;
  out->count = count;
  for (int p = 0; p < kMaxPasses; ++p) out->radix[p] = 0;
  for (int p = 0; p < count; ++p) {
    const int r = radices[p];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8 && r != 11 && r != 13 &&
        r != 16)
      return false;
    out->radix[p] = r;
    prod *= r;
    if (prod > n) return false;
  }
  return prod == n;
}

// The smallest radix set that holds every radix of the chain.
inline int radix_set(const Chain& chain) {
  int set = kSetPow2;
  for (int p = 0; p < chain.count; ++p) {
    const int r = chain.radix[p];
    if (r == 7 || r == 11 || r == 13) return kSetAll;
    if (r == 3 || r == 5) set = kSetSmall;
  }
  return set;
}

// Threads a CTA needs so that, holding e points each, they cover every
// butterfly of `units` units in every pass.
inline int threads_needed(const Chain& chain, int n, int e, int units) {
  int t = 1;
  for (int p = 0; p < chain.count; ++p) {
    const int r = chain.radix[p];
    const int per = per_thread(e, r);
    const int need = (units * (n / r) + per - 1) / per;
    if (need > t) t = need;
  }
  return t;
}

}  // namespace wgfft
