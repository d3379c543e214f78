// K3+K4: stage-14 particle move, with the packed table fused away and the
// stage-15 occupancy scatter taken in.
//
// Replaces tpu_fluid/kernels/pack_table.py:build_packed_table_pallas and
// build_packed_table_pallas2, the XLA row gather, and
// tpu_fluid/kernels/particle_sample.py:sample_and_move
// (_sample_update_kernel); with the occupancy it also replaces the XLA
// scatter of tpu_fluid/stages/particles.py:detailed_occupancy.  The TPU
// path first writes one 64-lane row per cell (a 128-lane z-paired row at
// 128^3) holding every velocity value a particle in that cell can touch,
// because the TPU has no fast element gather.  Here each thread reads the
// 8 nonzero taps of each component straight from the velocity field at
// edge-clamped indices -- the values the table's lanes hold -- so no table
// and no (P, 64) row buffer are ever written.
//
// Non-finite coordinates go where the JAX package on the CPU puts them.  A
// NaN coordinate's cell is 0 (XLA converts NaN to 0), and its weights on
// its own axis are 0 where a component's taps spread across that axis
// (XLA makes a select of the TPU kernel's mask product), so it moves only
// that coordinate, to NaN.  An infinite coordinate clamps to the grid's
// edge.  Every index is clamped before it is read, so every read stays
// inside the field.
//
// What bounds it: the 24 scattered 4-byte reads a particle, which land in
// L2 for grids of up to 128^3 (24 MB of velocity) and in device memory
// above, where their latency rules.  So each thread computes every axis's
// two texel coordinates (half-shifted on the component's own axis, not
// elsewhere) once, issues all 24 loads before it adds any, and reads and
// writes the positions of its block coalesced, through shared memory.
// Where it writes the occupancy, each active moved particle stores a 1 to
// the detailed cell trunc(p * res) if that cell lies inside the detailed
// grid on all three axes, and writes nothing otherwise (never a clamped
// index): stages/particles.py:detailed_occupancy.  Stores of the constant
// 1 commute, so the result does not depend on their order.  The float to
// integer conversion is 64-bit, a NaN converting to 0 and infinities and
// |p * res| >= 2^63 saturating, as in the plain version
// (ops/indexing.float_to_index), so they land where it puts them.
//
// The field in memory holds rows [xb, xb + mx) of a grid of global extent
// (gx, gy, gz).  Single device is xb = 0, mx = gx.  The local-slab form of
// domain-sharded particles (tpu_fluid/parallel/particles_domain.py:
// move_particles_local) passes a shard's slab with one edge-replicated
// plane a side, xb = x0 - 1 and mx = lx + 2: the weights still clamp to
// the global grid, the cell's memory row is clipped to [0, mx) and every x
// tap is clipped within the slab, as the TPU path's table of the extended
// slab does.  Inside the slab that is the single-device tap, bitwise.
// The kernel is specialised on kSingle, so that a single-device launch
// does no slab arithmetic (with xb = 0 and mx = gx both forms read the
// same taps) and writes the occupancy; the slab form writes none (domain
// sharding scatters after its migration).

#include "common.cuh"

namespace {

// The detailed grid the occupancy covers, and its resolution per sim cell.
struct Detailed {
  long long dx, dy, dz;
  float res;
};

template <bool kSingle>
__global__ void __launch_bounds__(tf::kThreads)
    particle_move_kernel(const float* __restrict__ vel,
                         const float* __restrict__ pos,
                         const uint8_t* __restrict__ active,
                         float* __restrict__ out, uint8_t* __restrict__ occ,
                         long long np, int xb, int mx, int gx, int gy,
                         int gz, float dt, Detailed det) {
  // the block's positions, read and written whole
  __shared__ float staged[3 * tf::kThreads];
  const long long first = blockIdx.x * static_cast<long long>(tf::kThreads);
  const int count = static_cast<int>(
      np - first < tf::kThreads ? np - first : tf::kThreads);
  for (int i = threadIdx.x; i < 3 * count; i += tf::kThreads) {
    staged[i] = pos[3 * first + i];
  }
  __syncthreads();

  const int me = threadIdx.x;
  if (me < count) {
    const long long p = first + me;
    const int dims[3] = {gx, gy, gz};
    const int rows = kSingle ? gx : mx;
    const long long n = static_cast<long long>(rows) * gy * gz;
    const int ext[3] = {rows, gy, gz};
    const int stride[3] = {gy * gz, gz, 1};
    float pd[3];
    // per axis: the own-axis fraction (texel (p - 0.5) + 0.5); the offset
    // and fraction on the other axes (texel (p - 0.5) + 0); the memory
    // offsets of the taps along each
    float f_own[3], w_oth[3][2];
    int o_oth[3], own[3][2], oth[3][2];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      pd[d] = staged[3 * me + d];
      const float top = static_cast<float>(dims[d] - 1);
      // NaN-propagating clamps, as the plain version's torch.clamp: a NaN
      // coordinate gives NaN fractions on its axis
      const float jf = tf::clamp_nan(floorf(pd[d]), 0.0f, top);
      const bool nan_axis = isnan(jf);
      const int j = nan_axis ? 0 : static_cast<int>(jf);
      // the cell in memory
      const int base = !kSingle && d == 0 ? tf::clamp_index(j - xb, mx) : j;
      const float h = pd[d] - 0.5f;
      const float t_own = tf::clamp_nan(h + 0.5f, 0.0f, top);
      f_own[d] = t_own - floorf(t_own);
      const float t_oth = tf::clamp_nan(h + 0.0f, 0.0f, top);
      const float i0 = floorf(t_oth);
      const float f = t_oth - i0;
      o_oth[d] = nan_axis ? 0 : static_cast<int>(i0 - jf);
      // the plain version's torch.where: a NaN offset matches no lane
      w_oth[d][0] = nan_axis ? 0.0f : 1.0f - f;
      w_oth[d][1] = nan_axis ? 0.0f : f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        own[d][k] = tf::clamp_index(base + k, ext[d]) * stride[d];
        oth[d][k] = tf::clamp_index(base + o_oth[d] + k, ext[d]) * stride[d];
      }
    }
    // all 24 taps: lanes (dc, k1, k2) of each component
    float tap[3][8];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a1 = c == 0 ? 1 : 0;
      const int a2 = c == 2 ? 1 : 2;
      const float* const vc = vel + c * n;
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        tap[c][l] = vc[own[c][l >> 2] + oth[a1][(l >> 1) & 1] +
                       oth[a2][l & 1]];
      }
    }
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a1 = c == 0 ? 1 : 0;
      const int a2 = c == 2 ? 1 : 2;
      // lanes (dc, d1, d2) in ascending order; along the other axes only
      // the offsets o and o+1 inside {-1, 0, 1} carry weight
      float acc = 0.0f;
#pragma unroll
      for (int dc = 0; dc <= 1; ++dc) {
        const float wc = dc ? f_own[c] : 1.0f - f_own[c];
#pragma unroll
        for (int k1 = 0; k1 <= 1; ++k1) {
          const int d1 = o_oth[a1] + k1;
          if (d1 < -1 || d1 > 1) continue;
          const float w1 = w_oth[a1][k1];
#pragma unroll
          for (int k2 = 0; k2 <= 1; ++k2) {
            const int d2 = o_oth[a2] + k2;
            if (d2 < -1 || d2 > 1) continue;
            const float w2 = w_oth[a2][k2];
            acc = acc + ((wc * w1) * w2) * tap[c][dc * 4 + k1 * 2 + k2];
          }
        }
      }
      v[c] = acc;
    }
    const bool act = active[p] != 0;
    float moved[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      moved[d] = pd[d] + (act ? v[d] * dt : 0.0f);
      staged[3 * me + d] = moved[d];
    }
    if (kSingle && act) {
      const long long ix = tf::to_index(truncf(moved[0] * det.res));
      const long long iy = tf::to_index(truncf(moved[1] * det.res));
      const long long iz = tf::to_index(truncf(moved[2] * det.res));
      if (ix >= 0 && ix < det.dx && iy >= 0 && iy < det.dy && iz >= 0 &&
          iz < det.dz) {
        occ[(ix * det.dy + iy) * det.dz + iz] = 1;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * count; i += tf::kThreads) {
    out[3 * first + i] = staged[i];
  }
}

}  // namespace

// Single device (xb = 0, mx = gx): occ is the zeroed (res gx, res gy,
// res gz) u8 occupancy to scatter the moved active particles into.  The
// slab form: occ is null.
extern "C" int tf_particle_move(const float* vel, const float* pos,
                                const uint8_t* active, float* out,
                                uint8_t* occ, long long np, int xb, int mx,
                                int gx, int gy, int gz, float dt, int res,
                                void* stream_ptr) {
  if (occ && (res < 1 || xb != 0 || mx != gx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (np == 0) return 0;
  const Detailed det{static_cast<long long>(res) * gx,
                     static_cast<long long>(res) * gy,
                     static_cast<long long>(res) * gz,
                     static_cast<float>(res)};
  const auto kernel = occ ? particle_move_kernel<true>
                          : particle_move_kernel<false>;
  kernel<<<tf::blocks_for(np), tf::kThreads, 0,
           static_cast<cudaStream_t>(stream_ptr)>>>(
      vel, pos, active, out, occ, np, xb, mx, gx, gy, gz, dt, det);
  return static_cast<int>(cudaGetLastError());
}
