// Probe: K2's fixed design (../cols_fixed.cuh) in the variants the sweep
// measures (chip_probes/k2_fill_variants.py), each a kernel of its own: a
// height, a tile of TC columns split over C CTAs of a cluster (1: none), T
// threads a CTA, MINB CTAs an SM asked for (__launch_bounds__), the passes
// (radix_chain's entries, consecutive ones fused into one butterfly) and,
// for C > 1, the last pass's radix across the cluster.  The Python table
// probes.variants.FIXED_VARIANTS lists them in this order.
//
// Stands for no Pallas kernel of its own: the kernels of K2's fixed design
// (webgpufft_tpu/core/fused_cols.py:161's counterpart), reached by name.
//
// What bounds it: bytes, 16 * H * cols * pre, as K2.
//
// C interface: wgfft_cols_fixed returns the cudaError_t of the launch,
// cudaErrorInvalidValue for a variant that does not run height h; with
// `slots` set, nothing launches: it receives how many CTAs (clusters, for
// C > 1) of the variant's kernel the device holds at once.

#include <cuda_runtime.h>

#include "cols_fixed.cuh"
// the rule's entries too (launch_cols_fixed), which cols_variants.cu's
// launches of K2's other designs link against
#include "cols_fixed.cu"

extern "C" int wgfft_cols_fixed(const void* x, void* y, const void* tw, const void* params,
                                long long pre, int h, long long cols, int variant, int adjoint,
                                int* slots, void* stream) {
  using wgfft::fixed::Pass;
  const float2* xs = static_cast<const float2*>(x);
  float2* ys = static_cast<float2*>(y);
  const float2* tws = static_cast<const float2*>(tw);
  const float* ps = static_cast<const float*>(params);
  const float cj = adjoint ? -1.f : 1.f;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pre < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
#define WGFFT_FIXED(I, H, TC, T, MINB, C, RX, ...)                                          \
  case I:                                                                                    \
    return h != H ? static_cast<int>(cudaErrorInvalidValue)                                  \
                  : static_cast<int>(wgfft::fixed::launch<H, TC, T, MINB, C, RX, __VA_ARGS__>( \
                        xs, ys, tws, ps, pre, cols, cj, st, slots))
  switch (variant) {
    WGFFT_FIXED(0, 1024, 4, 256, 4, 1, 0, Pass<16>, Pass<8>, Pass<8>);
    WGFFT_FIXED(1, 1024, 8, 512, 2, 1, 0, Pass<16>, Pass<8>, Pass<8>);
    WGFFT_FIXED(2, 1024, 4, 128, 8, 2, 8, Pass<16>, Pass<8>);
    WGFFT_FIXED(3, 1024, 8, 256, 4, 2, 8, Pass<16>, Pass<8>);
    WGFFT_FIXED(4, 1024, 8, 128, 8, 4, 8, Pass<16>, Pass<8>);
    WGFFT_FIXED(5, 1024, 16, 128, 8, 8, 8, Pass<16>, Pass<8>);
    WGFFT_FIXED(6, 2048, 2, 256, 4, 1, 0, Pass<16>, Pass<16>, Pass<8>);
    WGFFT_FIXED(7, 2048, 4, 512, 2, 1, 0, Pass<16>, Pass<16>, Pass<8>);
    WGFFT_FIXED(8, 2048, 4, 256, 4, 2, 8, Pass<16>, Pass<16>);
    WGFFT_FIXED(9, 2048, 4, 128, 8, 4, 8, Pass<16>, Pass<16>);
    WGFFT_FIXED(10, 2048, 8, 256, 4, 4, 8, Pass<16>, Pass<16>);
    WGFFT_FIXED(11, 2048, 2, 128, 8, 2, 8, Pass<16>, Pass<16>);
    WGFFT_FIXED(12, 4096, 4, 512, 2, 2, 16, Pass<16>, Pass<16>);
    WGFFT_FIXED(13, 4096, 4, 256, 4, 4, 16, Pass<16>, Pass<16>);
    WGFFT_FIXED(14, 4096, 2, 256, 4, 2, 16, Pass<16>, Pass<16>);
    WGFFT_FIXED(15, 4096, 4, 128, 8, 8, 16, Pass<16>, Pass<16>);
    WGFFT_FIXED(16, 8192, 4, 512, 2, 4, 8, Pass<16>, Pass<8>, Pass<8>);
    WGFFT_FIXED(17, 8192, 4, 256, 4, 8, 8, Pass<16>, Pass<8>, Pass<8>);
    WGFFT_FIXED(18, 8192, 2, 256, 4, 4, 8, Pass<16>, Pass<8>, Pass<8>);
    WGFFT_FIXED(19, 16384, 4, 512, 2, 8, 8, Pass<16>, Pass<16>, Pass<8>);
    WGFFT_FIXED(20, 16384, 2, 256, 4, 8, 8, Pass<16>, Pass<16>, Pass<8>);
    WGFFT_FIXED(21, 16384, 4, 512, 1, 4, 8, Pass<16>, Pass<16>, Pass<8>);
    WGFFT_FIXED(22, 16384, 8, 512, 1, 8, 8, Pass<16>, Pass<16>, Pass<8>);
    WGFFT_FIXED(23, 1352, 4, 256, 3, 1, 0, Pass<13>, Pass<13>, Pass<8>);
    WGFFT_FIXED(24, 1352, 2, 128, 6, 1, 0, Pass<13>, Pass<13>, Pass<8>);
    WGFFT_FIXED(25, 1352, 4, 256, 4, 2, 8, Pass<13>, Pass<13>);
    WGFFT_FIXED(26, 1352, 8, 256, 4, 4, 8, Pass<13>, Pass<13>);
    WGFFT_FIXED(27, 1352, 4, 128, 8, 4, 8, Pass<13>, Pass<13>);
    WGFFT_FIXED(28, 2310, 4, 448, 1, 1, 0, Pass<11>, Pass<7>, Pass<5, 3, 2>);
    WGFFT_FIXED(29, 2310, 2, 128, 5, 2, 2, Pass<11>, Pass<7>, Pass<5, 3>);
    WGFFT_FIXED(30, 2310, 1, 128, 5, 1, 0, Pass<11>, Pass<7>, Pass<5, 3, 2>);
    WGFFT_FIXED(31, 2310, 4, 256, 2, 2, 2, Pass<11>, Pass<7>, Pass<5, 3>);
    WGFFT_FIXED(32, 2310, 2, 224, 3, 1, 0, Pass<11>, Pass<7>, Pass<5, 3>, Pass<2>);
    WGFFT_FIXED(33, 2310, 2, 224, 3, 1, 0, Pass<11>, Pass<7>, Pass<5>, Pass<3>, Pass<2>);
    WGFFT_FIXED(34, 360, 16, 384, 2, 1, 0, Pass<8>, Pass<5, 3>, Pass<3>);
    WGFFT_FIXED(35, 360, 16, 384, 2, 1, 0, Pass<8>, Pass<5>, Pass<3, 3>);
    WGFFT_FIXED(36, 360, 8, 192, 4, 1, 0, Pass<8>, Pass<5, 3>, Pass<3>);
    WGFFT_FIXED(37, 360, 16, 384, 2, 1, 0, Pass<8>, Pass<5>, Pass<3>, Pass<3>);
    WGFFT_FIXED(38, 64, 16, 128, 8, 1, 0, Pass<8>, Pass<8>);
    WGFFT_FIXED(39, 128, 8, 64, 16, 1, 0, Pass<16>, Pass<8>);
    WGFFT_FIXED(40, 128, 16, 128, 8, 1, 0, Pass<16>, Pass<8>);
    WGFFT_FIXED(41, 128, 32, 256, 4, 1, 0, Pass<16>, Pass<8>);
    WGFFT_FIXED(42, 256, 8, 128, 8, 1, 0, Pass<16>, Pass<16>);
    WGFFT_FIXED(43, 256, 16, 256, 4, 1, 0, Pass<16>, Pass<16>);
    WGFFT_FIXED(44, 256, 32, 512, 2, 1, 0, Pass<16>, Pass<16>);
    WGFFT_FIXED(45, 512, 4, 128, 8, 1, 0, Pass<8>, Pass<8>, Pass<8>);
    WGFFT_FIXED(46, 512, 8, 256, 4, 1, 0, Pass<8>, Pass<8>, Pass<8>);
    WGFFT_FIXED(47, 512, 16, 512, 2, 1, 0, Pass<8>, Pass<8>, Pass<8>);
    WGFFT_FIXED(48, 2310, 1, 128, 8, 2, 2, Pass<11>, Pass<7>, Pass<5, 3>);
    WGFFT_FIXED(49, 2310, 1, 96, 8, 1, 0, Pass<11>, Pass<7>, Pass<5, 3, 2>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WGFFT_FIXED
}
