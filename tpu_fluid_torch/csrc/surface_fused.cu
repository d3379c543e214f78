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
//
// Halo form (surface_fused_pallas with `halos`, `x0` and `global_gx`, and the
// y-chunk route of surface_fused_auto, which the card does not need): every
// buffer is the local detailed slab extended by h = steps + 1 neighbour
// planes a side, nx rows whose row 0 lies at global x xb.  Rows outside the
// global domain [0, gx) hold 0 after every stage, the robust-access zero of
// the single-device grid.  Each stage computes the rows it can still get
// right, one ring fewer a stage (the TPU kernel's lost ring), so the last
// blur pass writes exactly the interior.  Single device: h = 0, xb = 0,
// gx = nx, and every stage covers the whole grid.

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
// A stage's cells in an extended slab of nx rows: it computes the cells
// [begin, end) (whole rows); the cells [dom_begin, dom_end) lie inside the
// global domain.
struct Rows {
  int nx;
  long long begin, end, dom_begin, dom_end;

  __device__ bool in_domain(long long i) const {
    return i >= dom_begin && i < dom_end;
  }
};

// Stages 16 + 17 over the cells [r.begin, r.end); with kHalo, f1 is 0
// outside the domain (a single-device grid has no cell outside it).
template <typename IT, bool kHalo>
__global__ void surface_inertia_kernel(const uint8_t* __restrict__ occ,
                                       const IT* __restrict__ inertia_in,
                                       IT* __restrict__ inertia_out,
                                       float* __restrict__ f1, Rows r,
                                       int gy, int gz, int inc_filled,
                                       int inc_neigh, int required_hits,
                                       int dec, int max_inertia,
                                       float div_coef) {
  const int gx = r.nx;
  const long long plane = static_cast<long long>(gy) * gz;
  const long long i = r.begin
                      + blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= r.end) return;
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
  f1[i] = !kHalo || r.in_domain(i)
              ? nzi * (static_cast<float>(updated) / div_coef) + (nzi - 1.0f)
              : 0.0f;
}

// One stage-18 pass over the cells [r.begin, r.end): out = skip ? keep :
// c0 * src + c1 * sum_6(src), the neighbours added x+1, x-1, y+1, y-1, z+1,
// z-1 with zero outside the slab, and 0 outside the domain.  `out` may
// alias `keep` (each thread reads and writes only its own cell there).
template <bool kHalo>
__global__ void surface_blur_kernel(const float* __restrict__ src,
                                    const float* keep,
                                    const uint8_t* __restrict__ skip,
                                    float* out, Rows r, int gy, int gz,
                                    float c0, float c1) {
  const int gx = r.nx;
  const long long plane = static_cast<long long>(gy) * gz;
  const long long i = r.begin
                      + blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= r.end) return;
  if (kHalo && !r.in_domain(i)) {
    out[i] = 0.0f;
    return;
  }
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
// All buffers have nx rows: the slab with h halo planes a side (h = 0 on a
// single device), row 0 at global x xb of a domain gx rows wide.  The
// interior rows [h, nx - h) of the outputs are exact.
extern "C" int tf_surface_fused(const uint8_t* occ, const void* inertia_in,
                                void* inertia_out, const float* f2_in,
                                const uint8_t* skip, float* f1, float* f2,
                                int inertia_bytes, int nx, int gy, int gz,
                                int xb, int gx, int h, int steps, float c0,
                                float c1, int inc_filled, int inc_neigh,
                                int required_hits, int dec, int max_inertia,
                                float div_coef, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long plane = static_cast<long long>(gy) * gz;
  const long long n = nx * plane;
  if (n == 0) return 0;
  if (nx <= 2 * h || (h > 0 && h < steps + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // stage s of the chain (0: inertia and signed field, 1..steps: blur
  // passes) is exact on the rows [lo(s), nx - lo(s)); the last is the
  // interior
  const int dom_lo = xb < 0 ? -xb : 0;
  const int dom_hi = gx - xb < nx ? gx - xb : nx;
  auto rows = [&](int stage) {
    int lo = h - steps + stage;
    lo = lo > 0 ? lo : 0;
    return Rows{nx, lo * plane, (nx - lo) * plane, dom_lo * plane,
                dom_hi * plane};
  };
  const bool halo = h > 0 || xb != 0 || gx != nx;
  Rows r = rows(0);
  unsigned int blocks = tf::blocks_for(r.end - r.begin);
  if (inertia_bytes == 1) {
    auto kernel = halo ? surface_inertia_kernel<uint8_t, true>
                       : surface_inertia_kernel<uint8_t, false>;
    kernel<<<blocks, tf::kThreads, 0, stream>>>(
        occ, static_cast<const uint8_t*>(inertia_in),
        static_cast<uint8_t*>(inertia_out), f1, r, gy, gz, inc_filled,
        inc_neigh, required_hits, dec, max_inertia, div_coef);
  } else if (inertia_bytes == 4) {
    auto kernel = halo ? surface_inertia_kernel<int32_t, true>
                       : surface_inertia_kernel<int32_t, false>;
    kernel<<<blocks, tf::kThreads, 0, stream>>>(
        occ, static_cast<const int32_t*>(inertia_in),
        static_cast<int32_t*>(inertia_out), f1, r, gy, gz, inc_filled,
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
  auto blur = halo ? surface_blur_kernel<true> : surface_blur_kernel<false>;
  for (int it = 0; it < steps; ++it) {
    const bool even = it % 2 == 0;
    const float* src = even ? f1 : f2;
    float* dst = even ? f2 : f1;
    const float* keep = it == 0 ? f2_in : dst;
    r = rows(it + 1);
    blocks = tf::blocks_for(r.end - r.begin);
    blur<<<blocks, tf::kThreads, 0, stream>>>(src, keep, skip, dst, r, gy,
                                              gz, c0, c1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
