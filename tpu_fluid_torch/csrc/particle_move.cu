// K3+K4: stage-14 particle move, with the packed table fused away.
//
// Replaces tpu_fluid/kernels/pack_table.py:build_packed_table_pallas and
// build_packed_table_pallas2, the XLA row gather, and
// tpu_fluid/kernels/particle_sample.py:sample_and_move
// (_sample_update_kernel).  The TPU path first writes one 64-lane row per
// cell (a 128-lane z-paired row at 128^3) holding every velocity value a
// particle in that cell can touch, because the TPU has no fast element
// gather.  Here each thread reads the 8 nonzero taps of each component
// straight from the velocity field at edge-clamped indices -- the values
// the table's lanes hold -- so no table and no (P, 64) row buffer are ever
// written.  The bound is the 24 scattered 4-byte reads per particle, which
// land in L2 for grids of up to 128^3 (24 MB of velocity).
//
// The field in memory holds rows [xb, xb + mx) of a grid of global extent
// (gx, gy, gz).  Single device is xb = 0, mx = gx.  The local-slab form of
// domain-sharded particles (tpu_fluid/parallel/particles_domain.py:
// move_particles_local) passes a shard's slab with one edge-replicated
// plane a side, xb = x0 - 1 and mx = lx + 2: the weights still clamp to
// the global grid, the cell's memory row is clipped to [0, mx) and every x
// tap is clipped within the slab, as the TPU path's table of the extended
// slab does.  Inside the slab that is the single-device tap, bitwise.
// The kernel is specialised on kSlab, so that a single-device launch does
// no slab arithmetic: with xb = 0 and mx = gx both forms read the same
// taps.

#include "common.cuh"

namespace {

template <bool kSlab>
__global__ void particle_move_kernel(const float* __restrict__ vel,
                                     const float* __restrict__ pos,
                                     const uint8_t* __restrict__ active,
                                     float* __restrict__ out, long long np,
                                     int xb, int mx, int gx, int gy, int gz,
                                     float dt) {
  const long long p = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (p >= np) return;
  const int dims[3] = {gx, gy, gz};
  const int rows = kSlab ? mx : gx;
  const long long n = static_cast<long long>(rows) * gy * gz;
  float pd[3];
  float jf[3];
  int j[3];
  for (int d = 0; d < 3; ++d) {
    pd[d] = pos[3 * p + d];
    jf[d] = tf::clampf(floorf(pd[d]), 0.0f, static_cast<float>(dims[d] - 1));
    j[d] = static_cast<int>(jf[d]);
  }
  // the cell in memory, and the extent each tap is clipped to
  const int base[3] = {kSlab ? tf::clamp_index(j[0] - xb, mx) : j[0], j[1],
                        j[2]};
  const int ext[3] = {rows, gy, gz};

  float v[3];
  for (int c = 0; c < 3; ++c) {
    const int a1 = c == 0 ? 1 : 0;
    const int a2 = c == 2 ? 1 : 2;
    // texel coordinate per axis: (p - 0.5) + 0.5 on axis c, two roundings
    int o[3];
    float f[3];
    for (int d = 0; d < 3; ++d) {
      const float h = d == c ? 0.5f : 0.0f;
      const float t = tf::clampf((pd[d] - 0.5f) + h, 0.0f,
                                 static_cast<float>(dims[d] - 1));
      const float i0 = floorf(t);
      o[d] = static_cast<int>(i0 - jf[d]);
      f[d] = t - i0;
    }
    const float* vc = vel + c * n;
    // lanes (dc, d1, d2) in ascending order; along the other axes only the
    // offsets o and o+1 inside {-1, 0, 1} carry weight
    float acc = 0.0f;
    for (int dc = 0; dc <= 1; ++dc) {
      const float wc = dc ? f[c] : 1.0f - f[c];
      for (int k1 = 0; k1 <= 1; ++k1) {
        const int d1 = o[a1] + k1;
        if (d1 < -1 || d1 > 1) continue;
        const float w1 = k1 ? f[a1] : 1.0f - f[a1];
        for (int k2 = 0; k2 <= 1; ++k2) {
          const int d2 = o[a2] + k2;
          if (d2 < -1 || d2 > 1) continue;
          const float w2 = k2 ? f[a2] : 1.0f - f[a2];
          int q[3];
          q[c] = tf::clamp_index(base[c] + dc, ext[c]);
          q[a1] = tf::clamp_index(base[a1] + d1, ext[a1]);
          q[a2] = tf::clamp_index(base[a2] + d2, ext[a2]);
          const float val = vc[(static_cast<long long>(q[0]) * gy + q[1]) * gz
                               + q[2]];
          acc = acc + ((wc * w1) * w2) * val;
        }
      }
    }
    v[c] = acc;
  }
  const bool act = active[p] != 0;
  for (int d = 0; d < 3; ++d) {
    out[3 * p + d] = pd[d] + (act ? v[d] * dt : 0.0f);
  }
}

}  // namespace

extern "C" int tf_particle_move(const float* vel, const float* pos,
                                const uint8_t* active, float* out,
                                long long np, int xb, int mx, int gx,
                                int gy, int gz, float dt, void* stream) {
  if (np == 0) return 0;
  const auto kernel = xb == 0 && mx == gx ? particle_move_kernel<false>
                                          : particle_move_kernel<true>;
  kernel<<<tf::blocks_for(np), tf::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      vel, pos, active, out, np, xb, mx, gx, gy, gz, dt);
  return static_cast<int>(cudaGetLastError());
}
