// K1: stage-07 semi-Lagrangian advection of all three MAC components.
//
// Replaces tpu_fluid/kernels/advect.py:advect_all_pallas (kernel
// _advect_all_kernel, body _advect_comps).  One thread per (component,
// cell).  The TPU kernel evaluates the trilinear sample as a masked sum over
// all (2R+1)^3 offsets of an edge-replicated slab, because Mosaic has no
// gather; every term but the 8 around the back-traced point has weight
// exactly 0 and adds +-0, so this kernel reads those 8 taps at edge-clamped
// indices and adds them in the same ascending (dx, dy, dz) order.
//
// Halo form (the x-slab multi-device step, advect_all_pallas with `halo`,
// `x0` and `global_shape`): the output is the local slab of global rows
// [x0, x0 + lx); the input holds global rows [xb, xb + mx), the slab with
// R neighbour planes on each side.  Coordinates, clamps and tap indices are
// global, so a tap never reads past the domain: the end shards give exactly
// the single-device rows, where the TPU kernel reads zero planes there and
// relies on their zero weights.  Single device: x0 = xb = 0, lx = mx = gx.

#include "common.cuh"

namespace {

// The x geometry of a slab: global extent gx, output rows [x0, x0 + lx),
// memory rows [xb, xb + mx), all in global x.
struct Slab {
  int gx, x0, lx, xb, mx;
};

__device__ __forceinline__ float tap(const float* f, int x, int y, int z,
                                     const Slab& s, int gy, int gz) {
  x = tf::clamp_index(x, s.gx) - s.xb;
  y = tf::clamp_index(y, gy);
  z = tf::clamp_index(z, gz);
  return f[(static_cast<long long>(x) * gy + y) * gz + z];
}

__global__ void advect_all_kernel(const float* __restrict__ vel,
                                  const uint8_t* __restrict__ cond,
                                  float* __restrict__ out, Slab s, int gy,
                                  int gz, int r, float dt, float umin,
                                  float umax) {
  const long long plane = static_cast<long long>(gy) * gz;
  const long long n = s.lx * plane;    // output cells per component
  const long long nm = s.mx * plane;   // input cells per component
  const long long gid = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (gid >= 3 * n) return;
  const int c = static_cast<int>(gid / n);
  const long long cell = gid - c * n;
  const int z = static_cast<int>(cell % gz);
  const int y = static_cast<int>((cell / gz) % gy);
  const int x = s.x0 + static_cast<int>(cell / plane);
  const float* vc = vel + c * nm;
  const float old = vc[(x - s.xb) * plane + y * gz + z];
  if (cond[gid] == 0) {  // where(cond, sample, old)
    out[gid] = old;
    return;
  }
  const int idx[3] = {x, y, z};
  const int dims[3] = {s.gx, gy, gz};

  // Face-centre velocity of component c's face: its own stored value, or
  // the 4-point average over {i_c-1, i_c} x {i_cp, i_cp+1} with edge clamp,
  // summed in the order (dc, dcp) = (-1,0), (-1,1), (0,0), (0,1).
  float vface[3];
  for (int cp = 0; cp < 3; ++cp) {
    if (cp == c) {
      vface[cp] = old;
      continue;
    }
    const float* vp = vel + cp * nm;
    float acc = 0.0f;
    bool first = true;
    for (int dc = -1; dc <= 0; ++dc) {
      for (int dcp = 0; dcp <= 1; ++dcp) {
        int q[3] = {x, y, z};
        q[c] += dc;
        q[cp] += dcp;
        const float t = tap(vp, q[0], q[1], q[2], s, gy, gz);
        acc = first ? t : acc + t;
        first = false;
      }
    }
    vface[cp] = 0.25f * acc;
  }

  // Clamped displacement, clamp-to-edge coordinate, offset and fraction.
  int o[3];
  float f[3];
  for (int d = 0; d < 3; ++d) {
    const float i = static_cast<float>(idx[d]);
    const float u = tf::clampf(-vface[d] * dt, umin, umax);
    const float t = tf::clampf(i + u, 0.0f, static_cast<float>(dims[d] - 1));
    const float ud = t - i;
    const float od = floorf(ud);
    o[d] = static_cast<int>(od);
    f[d] = ud - od;
  }

  // The 8 nonzero terms of the masked sum, ascending in (dx, dy, dz); an
  // offset o+1 beyond +R has no term there.
  float acc = 0.0f;
  for (int ax = 0; ax <= 1; ++ax) {
    const int dx = o[0] + ax;
    if (dx > r) continue;
    const float wx = ax ? f[0] : 1.0f - f[0];
    for (int ay = 0; ay <= 1; ++ay) {
      const int dy = o[1] + ay;
      if (dy > r) continue;
      const float wxy = wx * (ay ? f[1] : 1.0f - f[1]);
      for (int az = 0; az <= 1; ++az) {
        const int dz = o[2] + az;
        if (dz > r) continue;
        const float wz = az ? f[2] : 1.0f - f[2];
        acc = acc + (wxy * wz) * tap(vc, x + dx, y + dy, z + dz, s, gy, gz);
      }
    }
  }
  out[gid] = acc;
}

}  // namespace

// vel holds global rows [xb, xb + mx) of the (3, gx, gy, gz) field; cond
// and out are the (3, lx, gy, gz) slab of rows [x0, x0 + lx).
extern "C" int tf_advect_all(const float* vel, const uint8_t* cond,
                             float* out, int gx, int gy, int gz, int x0,
                             int lx, int xb, int mx, int r, float dt,
                             float umin, float umax, void* stream) {
  const long long total = 3LL * lx * gy * gz;
  if (total == 0) return 0;
  advect_all_kernel<<<tf::blocks_for(total), tf::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      vel, cond, out, Slab{gx, x0, lx, xb, mx}, gy, gz, r, dt, umin, umax);
  return static_cast<int>(cudaGetLastError());
}
