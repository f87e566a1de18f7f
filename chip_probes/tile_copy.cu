// Probe: the ceiling of K2's access pattern.  A CTA copies a tile of h rows
// by tile_floats floats of a (pre, h, lanes) f32 view, global -> registers ->
// global, 16 rows in flight a thread, 8 or 16 bytes a thread.  No arithmetic:
// what it takes is what the tile shape alone costs.

#include <cuda_runtime.h>

template <class V>  // float2 or float4
__global__ void __launch_bounds__(512)
tile_copy(const float* __restrict__ x, float* __restrict__ y, int h, long long lanes,
          int tile_floats, long long tiles) {
  constexpr int kWidth = sizeof(V) / sizeof(float);
  constexpr int kInFlight = 16;
  const long long p = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const size_t base = static_cast<size_t>(p) * h * lanes + t * tile_floats;
  const int per_row = tile_floats / kWidth;
  const int sweep = blockDim.x / per_row;  // rows covered by the CTA at once
  const int c = threadIdx.x % per_row, r0 = threadIdx.x / per_row;
  for (int r = r0; r < h; r += sweep * kInFlight) {
    V v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int row = r + u * sweep;
      if (row < h)
        v[u] = *reinterpret_cast<const V*>(x + base + static_cast<size_t>(row) * lanes + c * kWidth);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int row = r + u * sweep;
      if (row < h)
        *reinterpret_cast<V*>(y + base + static_cast<size_t>(row) * lanes + c * kWidth) = v[u];
    }
  }
}

// lanes must be a multiple of tile_floats; width is 2 or 4 floats a thread.
extern "C" int probe_tile_copy(const void* x, void* y, long long pre, int h, long long lanes,
                               int tile_floats, int width, int threads, void* stream) {
  const long long tiles = lanes / tile_floats;
  const auto grid = static_cast<unsigned>(pre * tiles);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const float*>(x);
  auto* yo = static_cast<float*>(y);
  if (width == 2) tile_copy<float2><<<grid, threads, 0, s>>>(xi, yo, h, lanes, tile_floats, tiles);
  else tile_copy<float4><<<grid, threads, 0, s>>>(xi, yo, h, lanes, tile_floats, tiles);
  return static_cast<int>(cudaGetLastError());
}
