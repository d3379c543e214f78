// K5: surface-field stages 16-18 on the detailed grid.
//
// Replaces tpu_fluid/kernels/surface_fused.py:surface_fused_pallas
// (_surface_kernel, body _surface_stages).  The TPU kernel fuses the
// inertia update, the signed field and all blur passes over x-slabs with a
// (steps+1)-row halo held in VMEM.  Here one kernel computes stages 16+17
// per cell and `steps` launches of a blur kernel ping-pong f1/f2; each
// launch streams the grid once (bandwidth-bound: 4 + 4 + 1 bytes read and
// 4 written per cell and pass, 67 MB per f32 field at 256^3).  Fusing the
// passes through shared-memory halos is later work.

#include "common.cuh"

namespace {

__device__ __forceinline__ int filled_at(const uint8_t* occ, int x, int y,
                                         int z, int gx, int gy, int gz) {
  if (x < 0 || x >= gx || y < 0 || y >= gy || z < 0 || z >= gz) return 0;
  return min(static_cast<int>(occ[(static_cast<long long>(x) * gy + y) * gz
                                  + z]), 1);
}

// Stages 16 + 17 (_surface_stages): integer inertia update, then the
// signed field f = nzi * (I / div) + (nzi - 1).
template <typename IT>
__global__ void surface_inertia_kernel(const uint8_t* __restrict__ occ,
                                       const IT* __restrict__ inertia_in,
                                       IT* __restrict__ inertia_out,
                                       float* __restrict__ f1, int gx, int gy,
                                       int gz, int inc_filled, int inc_neigh,
                                       int required_hits, int dec,
                                       int max_inertia, float div_coef) {
  const long long plane = static_cast<long long>(gy) * gz;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= gx * plane) return;
  const int z = static_cast<int>(i % gz);
  const int y = static_cast<int>((i / gz) % gy);
  const int x = static_cast<int>(i / plane);
  const int filled = min(static_cast<int>(occ[i]), 1);
  const int hits = filled_at(occ, x + 1, y, z, gx, gy, gz)
                   + filled_at(occ, x - 1, y, z, gx, gy, gz)
                   + filled_at(occ, x, y + 1, z, gx, gy, gz)
                   + filled_at(occ, x, y - 1, z, gx, gy, gz)
                   + filled_at(occ, x, y, z + 1, gx, gy, gz)
                   + filled_at(occ, x, y, z - 1, gx, gy, gz);
  const int ge = min(max(hits - (required_hits - 1), 0), 1);
  const int inc = filled * inc_filled + ge * hits * inc_neigh;
  const int nz = min(max(inc, 0), 1);
  const int inertia = static_cast<int>(inertia_in[i]);
  const int increased = inertia + inc;
  const int decreased = max(inertia - dec, 0);
  const int updated = min(decreased + nz * (increased - decreased),
                          max_inertia);
  inertia_out[i] = static_cast<IT>(updated);
  const float nzi = static_cast<float>(min(max(updated, 0), 1));
  f1[i] = nzi * (static_cast<float>(updated) / div_coef) + (nzi - 1.0f);
}

// One stage-18 pass: out = skip ? keep : c0 * src + c1 * sum_6(src), the
// neighbours added x+1, x-1, y+1, y-1, z+1, z-1 with zero outside.  `out`
// may alias `keep` (each thread reads and writes only its own cell there).
__global__ void surface_blur_kernel(const float* __restrict__ src,
                                    const float* keep,
                                    const uint8_t* __restrict__ skip,
                                    float* out, int gx, int gy, int gz,
                                    float c0, float c1) {
  const long long plane = static_cast<long long>(gy) * gz;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= gx * plane) return;
  if (skip[i] != 0) {
    out[i] = keep[i];
    return;
  }
  const int z = static_cast<int>(i % gz);
  const int y = static_cast<int>((i / gz) % gy);
  const int x = static_cast<int>(i / plane);
  float s = x + 1 < gx ? src[i + plane] : 0.0f;
  s = s + (x > 0 ? src[i - plane] : 0.0f);
  s = s + (y + 1 < gy ? src[i + gz] : 0.0f);
  s = s + (y > 0 ? src[i - gz] : 0.0f);
  s = s + (z + 1 < gz ? src[i + 1] : 0.0f);
  s = s + (z > 0 ? src[i - 1] : 0.0f);
  out[i] = c0 * src[i] + c1 * s;
}

}  // namespace

// inertia_bytes: 1 (uint8 storage) or 4 (int32).  f1/f2 receive the
// outputs; f2_in is the stale buffer carried over from the last frame.
extern "C" int tf_surface_fused(const uint8_t* occ, const void* inertia_in,
                                void* inertia_out, const float* f2_in,
                                const uint8_t* skip, float* f1, float* f2,
                                int inertia_bytes, int gx, int gy, int gz,
                                int steps, float c0, float c1, int inc_filled,
                                int inc_neigh, int required_hits, int dec,
                                int max_inertia, float div_coef,
                                void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n = static_cast<long long>(gx) * gy * gz;
  if (n == 0) return 0;
  const unsigned int blocks = tf::blocks_for(n);
  if (inertia_bytes == 1) {
    surface_inertia_kernel<uint8_t><<<blocks, tf::kThreads, 0, stream>>>(
        occ, static_cast<const uint8_t*>(inertia_in),
        static_cast<uint8_t*>(inertia_out), f1, gx, gy, gz, inc_filled,
        inc_neigh, required_hits, dec, max_inertia, div_coef);
  } else if (inertia_bytes == 4) {
    surface_inertia_kernel<int32_t><<<blocks, tf::kThreads, 0, stream>>>(
        occ, static_cast<const int32_t*>(inertia_in),
        static_cast<int32_t*>(inertia_out), f1, gx, gy, gz, inc_filled,
        inc_neigh, required_hits, dec, max_inertia, div_coef);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (steps <= 0) {
    cudaMemcpyAsync(f2, f2_in, n * sizeof(float), cudaMemcpyDeviceToDevice,
                    stream);
    return static_cast<int>(cudaGetLastError());
  }
  // pass 0: f1 -> f2 (skipped cells keep the stale f2_in); then odd passes
  // f2 -> f1 and even passes f1 -> f2, each keeping its own target
  for (int it = 0; it < steps; ++it) {
    const bool even = it % 2 == 0;
    const float* src = even ? f1 : f2;
    float* dst = even ? f2 : f1;
    const float* keep = it == 0 ? f2_in : dst;
    surface_blur_kernel<<<blocks, tf::kThreads, 0, stream>>>(
        src, keep, skip, dst, gx, gy, gz, c0, c1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
