// K1: stage-07 semi-Lagrangian advection of all three MAC components, with
// its condition masks.
//
// Replaces tpu_fluid/kernels/advect.py:advect_all_pallas (kernel
// _advect_all_kernel, body _advect_comps) and takes in the condition masks
// that JAX builds before it (tpu_fluid/stages/velocity.py:
// _advect_condition): component c of cell i is advected iff i_c != 0 and
// cell i or i + e_c is WATER, a cell outside the domain not WATER.  The
// TPU kernel evaluates the trilinear sample as a masked sum over all
// (2R+1)^3 offsets of an edge-replicated slab, because Mosaic has no
// gather; every term but the 8 around the back-traced point has weight
// exactly 0 and adds +-0, so this kernel reads those 8 taps at edge-clamped
// indices and adds them in the same ascending (dx, dy, dz) order.
//
// What bounds it: memory.  A cell reads 12 velocity bytes and 1 type byte
// and writes 12 (0.125 ms at 256^3).  One thread a (component, cell)
// reading its 17 values from device memory fetched each value once for
// every block that needed it, since the 201 MB field of 256^3 does not
// stay in the 50 MB L2, and the masks were a plain pass of their own.  K1
// now marches like K6 (kernels/tiling.py grid_fused_pass, halo R): a block
// of 32 x 32 threads owns a y-z tile with an R-cell ring and walks along
// its segment of x, one plane a step.  Each step loads one x plane of the
// three components, edge-clamped as the TPU kernel's padded slab holds it,
// and its WATER flags into a ring of shared planes; the inner threads then
// compute all three components of the cell R planes behind, every face
// average and tap read from shared memory.  The face averages reach one
// plane and the taps R planes either way (the displacement is clamped to
// [-R, R - 1e-4]), so the ring holds 2R + 1 planes and the one being
// written.  Only where each value comes from changed: the arithmetic is
// the one-thread-a-cell kernel's, operation for operation.
//
// Non-finite velocities: the plain version's masked sum multiplies every
// value of the (2R+1)^3 window by its weight, and a zero weight times an
// infinity or a NaN is NaN, so there the 8 taps alone would not give its
// result.  Each march step therefore asks the whole block whether the plane
// it stored holds a non-finite value (__syncthreads_or, in place of the
// plain barrier); for the rows whose window reaches such a plane the block
// takes masked_sum, the plain version's sum over every offset.  The clamps
// keep a NaN, as torch.clamp and jnp.clip do, and a NaN displacement (a NaN
// dt) also takes masked_sum, whose weights are then all 0, as JAX's.
//
// Halo form (the x-slab multi-device step, advect_all_pallas with `halo`,
// `x0` and `global_shape`): the output is the local slab of global rows
// [x0, x0 + lx); the velocity holds global rows [xb, xb + nx), the slab
// with R neighbour planes on each side, and the types global rows
// [tb, tb + tn), the slab with one neighbour plane a side.  Coordinates,
// clamps and tap indices are global, so a tap never reads past the domain:
// the end shards give exactly the single-device rows, where the TPU kernel
// reads zero planes there and relies on their zero weights.  Single
// device: xb = tb = x0 = 0 and nx = tn = lx = gx.

#include "common.cuh"

namespace {

constexpr int kWater = 2;
constexpr int kTile = 32;  // kernels/tiling.py TILE
constexpr int kTilePlane = kTile * kTile;
// a block may opt into this much shared memory (kernels/tiling.py
// SHARED_BYTES)
constexpr int kMaxShared = 232448;

// One launch: the domain, the rows of each input in memory, the output
// rows, in segments of seg rows a block, and the ring of `slots` shared
// planes (a power of two of at least 2R + 2).
struct Advect {
  int gx, gy, gz;
  int xb, nx;  // velocity rows in memory: global [xb, xb + nx)
  int tb, tn;  // type rows in memory: global [tb, tb + tn)
  int x0, lx;  // output rows: global [x0, x0 + lx)
  int seg, r, slots;
  float dt, umin, umax;
};

int ring_slots(int r) {
  int s = 1;
  while (s < 2 * r + 2) s *= 2;
  return s;
}

// a slot: the three components of one x plane, then its WATER flags
constexpr int kSlotBytes = 3 * kTilePlane * sizeof(float) + kTilePlane;

// The plain version's weight of offset delta along one axis, JAX's
// (o == delta) * (1 - f) + (o == delta - 1) * f with each masked product a
// select, as XLA makes it: a NaN offset weighs 0.
__device__ __forceinline__ float axis_weight(float o, float f, int delta) {
  return (o == static_cast<float>(delta) ? 1.0f - f : 0.0f) +
         (o == static_cast<float>(delta - 1) ? f : 0.0f);
}

// The plain version's masked sum for component c of row q at offset
// (ox, oy, oz), fraction (fx, fy, fz): every offset of [-R, R]^3 of the
// ring, in ascending (dx, dy, dz) order.  Only for windows that hold a
// non-finite value and for a NaN displacement.
__device__ __noinline__ float masked_sum(const float* ring, int q, int mask,
                                         int me, int c, int r, float ox,
                                         float oy, float oz, float fx,
                                         float fy, float fz) {
  float acc = 0.0f;
  for (int dx = -r; dx <= r; ++dx) {
    const float wx = axis_weight(ox, fx, dx);
    const float* const px = ring + (((q + dx) & mask) * 3 + c) * kTilePlane +
                            me;
    for (int dy = -r; dy <= r; ++dy) {
      const float wxy = wx * axis_weight(oy, fy, dy);
      for (int dz = -r; dz <= r; ++dz) {
        acc = acc + (wxy * axis_weight(oz, fz, dz)) * px[dy * kTile + dz];
      }
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kTilePlane, 1)
    advect_march_kernel(const float* __restrict__ vel,
                        const uint8_t* __restrict__ types,
                        float* __restrict__ out, Advect a) {
  extern __shared__ __align__(16) unsigned char shared[];
  float* const ring = reinterpret_cast<float*>(shared);
  uint8_t* const wet = shared + a.slots * 3 * kTilePlane * sizeof(float);
  const int mask = a.slots - 1;
  const int r = a.r;
  const int tz = threadIdx.x;
  const int ty = threadIdx.y;  // one warp a row of the tile
  const int me = ty * kTile + tz;
  const int inner_w = kTile - 2 * r;
  const int y = blockIdx.y * inner_w - r + ty;
  const int z = blockIdx.x * inner_w - r + tz;
  const bool in_yz = y >= 0 && y < a.gy && z >= 0 && z < a.gz;
  const bool inner = in_yz && ty >= r && ty < kTile - r && tz >= r &&
                     tz < kTile - r;
  const int plane = a.gy * a.gz;
  const long long comp = static_cast<long long>(a.nx) * plane;
  // this column's cell, edge-clamped: what the padded slab holds there
  const int yz_clamped = tf::clamp_index(y, a.gy) * a.gz +
                         tf::clamp_index(z, a.gz);
  const int q_lo = a.x0 + blockIdx.z * a.seg;
  const int q_hi = min(q_lo + a.seg, a.x0 + a.lx);
  const int t_end = q_hi + r;

  // plane t: the velocity of row clamp(t), and WATER where row t holds a
  // type (not past the domain or the type rows); each plane is loaded one
  // march step before it is stored
  float pv[3];
  int pw;
  auto load = [&](int t) {
    const long long at =
        static_cast<long long>(tf::clamp_index(t, a.gx) - a.xb) * plane +
        yz_clamped;
    pv[0] = vel[at];
    pv[1] = vel[comp + at];
    pv[2] = vel[2 * comp + at];
    pw = in_yz && t >= 0 && t < a.gx && t >= a.tb && t < a.tb + a.tn &&
         types[static_cast<long long>(t - a.tb) * plane + y * a.gz + z] ==
             kWater;
  };
  int t = q_lo - r;
  load(t);

  const long long n_out = static_cast<long long>(a.lx) * plane;
  const int idx_yz = y * a.gz + z;
  // the last plane stored that holds a non-finite value anywhere in the tile
  int last_bad = q_lo - 2 * r - 1;
  for (; t < t_end; ++t) {
    // step t: store plane t, then compute row q = t - R from planes
    // q - R .. q + R; the slot written here last served row t - slots + R,
    // two or more steps ago
    const int s = t & mask;
    float* const sp = ring + s * 3 * kTilePlane;
    sp[me] = pv[0];
    sp[kTilePlane + me] = pv[1];
    sp[2 * kTilePlane + me] = pv[2];
    wet[s * kTilePlane + me] = static_cast<uint8_t>(pw);
    const bool bad = !(isfinite(pv[0]) && isfinite(pv[1]) && isfinite(pv[2]));
    if (t + 1 < t_end) load(t + 1);
    if (__syncthreads_or(bad)) last_bad = t;

    const int q = t - r;
    if (!inner || q < q_lo) continue;
    // the same for every thread of the block
    const bool finite_window = last_bad < q - r;
    // the x plane q + dx, component c, at tile offset (dy, dz)
    auto at = [&](int dx, int c) {
      return ring + (((q + dx) & mask) * 3 + c) * kTilePlane + me;
    };
    const uint8_t* const wq = wet + (q & mask) * kTilePlane + me;
    const bool w_i = wq[0] != 0;
    const bool cond[3] = {
        q != 0 && (w_i || wet[((q + 1) & mask) * kTilePlane + me] != 0),
        y != 0 && (w_i || wq[kTile] != 0), z != 0 && (w_i || wq[1] != 0)};
    const int idx[3] = {q, y, z};
    const int dims[3] = {a.gx, a.gy, a.gz};
    const long long o_at = static_cast<long long>(q - a.x0) * plane + idx_yz;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float old = at(0, c)[0];
      if (!cond[c]) {  // where(cond, sample, old)
        out[c * n_out + o_at] = old;
        continue;
      }
      // Face-centre velocity of component c's face: its own stored value,
      // or the 4-point average over {i_c-1, i_c} x {i_cp, i_cp+1} with edge
      // clamp, summed in the order (dc, dcp) = (-1,0), (-1,1), (0,0), (0,1).
      float vface[3];
#pragma unroll
      for (int cp = 0; cp < 3; ++cp) {
        if (cp == c) {
          vface[cp] = old;
          continue;
        }
        float acc = 0.0f;
#pragma unroll
        for (int dc = -1; dc <= 0; ++dc) {
#pragma unroll
          for (int dcp = 0; dcp <= 1; ++dcp) {
            int o[3] = {0, 0, 0};
            o[c] += dc;
            o[cp] += dcp;
            const float v = at(o[0], cp)[o[1] * kTile + o[2]];
            acc = dc == -1 && dcp == 0 ? v : acc + v;
          }
        }
        vface[cp] = 0.25f * acc;
      }

      // Clamped displacement, clamp-to-edge coordinate, offset and
      // fraction.
      float od[3], f[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float i = static_cast<float>(idx[d]);
        const float u = tf::clamp_nan(-vface[d] * a.dt, a.umin, a.umax);
        const float tt =
            tf::clamp_nan(i + u, 0.0f, static_cast<float>(dims[d] - 1));
        const float ud = tt - i;
        od[d] = floorf(ud);
        f[d] = ud - od[d];
      }
      if (!finite_window || isnan(f[0]) || isnan(f[1]) || isnan(f[2])) {
        out[c * n_out + o_at] = masked_sum(ring, q, mask, me, c, r, od[0],
                                           od[1], od[2], f[0], f[1], f[2]);
        continue;
      }
      int o[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) o[d] = static_cast<int>(od[d]);

      // The 8 nonzero terms of the masked sum, ascending in (dx, dy, dz);
      // an offset o+1 beyond +R has no term there.  Every other offset
      // lies in [-R, R], inside the ring and the tile.
      float acc = 0.0f;
#pragma unroll
      for (int ax = 0; ax <= 1; ++ax) {
        const int dx = o[0] + ax;
        if (dx > r) continue;
        const float wx = ax ? f[0] : 1.0f - f[0];
        const float* const px = at(dx, c);
#pragma unroll
        for (int ay = 0; ay <= 1; ++ay) {
          const int dy = o[1] + ay;
          if (dy > r) continue;
          const float wxy = wx * (ay ? f[1] : 1.0f - f[1]);
#pragma unroll
          for (int az = 0; az <= 1; ++az) {
            const int dz = o[2] + az;
            if (dz > r) continue;
            const float wz = az ? f[2] : 1.0f - f[2];
            acc = acc + (wxy * wz) * px[dy * kTile + dz];
          }
        }
      }
      out[c * n_out + o_at] = acc;
    }
  }
}

}  // namespace

// One launch of kernels/tiling.py grid_fused_pass(halo = r): vel holds
// global rows [xb, xb + nx) of the (3, gx, gy, gz) field, types global rows
// [tb, tb + tn) of the (gx, gy, gz) cell types; out receives the (3, lx,
// gy, gz) slab of rows [x0, x0 + lx), in segments of seg rows.
extern "C" int tf_advect_all(const float* vel, const uint8_t* types,
                             float* out, int gx, int gy, int gz, int xb,
                             int nx, int tb, int tn, int x0, int lx, int seg,
                             int r, float dt, float umin, float umax,
                             void* stream) {
  if (lx == 0) return 0;
  if (r < 1 || kTile - 2 * r < 1 || seg < 1 || gy < 1 || gz < 1 ||
      x0 < 0 || x0 + lx > gx || 3LL * nx * gy * gz >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slots = ring_slots(r);
  const int bytes = slots * kSlotBytes;
  if (bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      advect_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Advect a{gx, gy, gz, xb, nx, tb, tn, x0, lx, seg, r, slots,
                 dt, umin, umax};
  const int inner = kTile - 2 * r;
  const dim3 grid((gz + inner - 1) / inner, (gy + inner - 1) / inner,
                  (lx + seg - 1) / seg);
  advect_march_kernel<<<grid, dim3(kTile, kTile), bytes,
                        static_cast<cudaStream_t>(stream)>>>(vel, types, out,
                                                             a);
  return static_cast<int>(cudaGetLastError());
}
