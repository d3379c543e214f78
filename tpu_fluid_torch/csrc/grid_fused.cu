// K6: the fused sim-grid stage groups.
//
//   K6a classify_extrap_kernel     stages 02-06
//   K6b forces_solids_div_kernel   stages 08, 10 and 11 (09 is the no-op)
//   K6c project_kernel             stage 13
//
// Replaces tpu_fluid/kernels/grid_fused.py:classify_extrap_pallas,
// forces_solids_div_pallas and project_pallas (kernel bodies
// _classify_extrap_kernel, _forces_solids_div_kernel and _project_kernel,
// all built by _call).  The TPU kernels assemble x-slabs with halo rows
// in VMEM; here one thread computes one output cell and reads its
// neighbours with bounds checks.  An out-of-domain neighbour reads 0: an
// INACTIVE cell with zero velocity, occupancy and pressure, which is what
// the zero-padded slabs and _zshift give the TPU kernels.  Each expression
// keeps the kernel body's order and its 0/1 float indicators, so with
// -fmad=false a kernel rounds exactly where its plain version
// (kernels/grid_fused.py) does.
//
// All three are bound by memory traffic: per cell K6a reads about 30 u8
// and 21 f32 values and writes 13 bytes, K6b about 20 u8 and 7 f32 and
// writes 16 bytes, K6c 4 u8 and 7 f32 and writes 12 bytes.  The neighbour
// reads of one warp lie on neighbouring z and hit L1/L2, so each kernel
// streams its fields about once from HBM.
//
// Halo forms (the x-slab multi-device step: the `halos`, `x0` and
// `global_gx` arguments of the three JAX wrappers): the output is the local
// slab of global rows [x0, x0 + lx), and the inputs hold global rows
// [xb, xb + mx), the slab with its neighbour planes, 2 a side for K6a (its
// stage 05 reads new types of x +- 1, whose AIR test reads occupancy at
// x +- 2) and 1 for K6b and K6c.  Cell coordinates, the border and box SOLID
// rule, the fountain and force cells and the out-of-domain zero are all
// global, so every row equals the single-device row.  Single device:
// x0 = xb = 0 and lx = mx = gx.

#include "common.cuh"

namespace {

constexpr int kInactive = 0;
constexpr int kAir = 1;
constexpr int kWater = 2;
constexpr int kSolid = 3;

// The domain (gx, gy, gz), the output rows [x0, x0 + lx) and the input
// rows [xb, xb + mx), all in global x.
struct Grid {
  int gx, gy, gz, x0, lx, xb, mx;

  // output cells (one component)
  __device__ long long cells() const {
    return static_cast<long long>(lx) * gy * gz;
  }
  // input cells (one component)
  __device__ long long mem_cells() const {
    return static_cast<long long>(mx) * gy * gz;
  }
  __device__ bool inside(const int* p) const {
    return p[0] >= 0 && p[0] < gx && p[1] >= 0 && p[1] < gy && p[2] >= 0
           && p[2] < gz;
  }
  // index of p in the inputs
  __device__ long long at(const int* p) const {
    return (static_cast<long long>(p[0] - xb) * gy + p[1]) * gz + p[2];
  }
  // global coordinates of output cell `cell`
  __device__ void coords(long long cell, int* p) const {
    p[2] = static_cast<int>(cell % gz);
    p[1] = static_cast<int>((cell / gz) % gy);
    p[0] = x0 + static_cast<int>(cell / (static_cast<long long>(gy) * gz));
  }
};

__device__ __forceinline__ float ind(bool b) { return b ? 1.0f : 0.0f; }

__device__ __forceinline__ bool is_active(int t) {
  return t == kWater || t == kAir;
}

// The m-th neighbour of p in ops/stencil.MOVES order (+x, +y, +z, -x, -y,
// -z).
__device__ __forceinline__ void neighbour(const int* p, int m, int* q) {
  q[0] = p[0];
  q[1] = p[1];
  q[2] = p[2];
  q[m % 3] += m < 3 ? 1 : -1;
}

__device__ __forceinline__ void lower(const int* p, int c, int* q) {
  q[0] = p[0];
  q[1] = p[1];
  q[2] = p[2];
  q[c] -= 1;
}

// Type of cell p (0 outside the domain) under the code t.
__device__ __forceinline__ int type_at(const uint8_t* t, const Grid& g,
                                       const int* p) {
  return g.inside(p) ? t[g.at(p)] : kInactive;
}

// Stage 03's SOLID rule: the domain border or an end-exclusive box
// (x0, y0, z0, x1, y1, z1).
__device__ bool solid_cell(const Grid& g, const int* p, const int* boxes,
                           int nbox) {
  if (p[0] == 0 || p[0] == g.gx - 1 || p[1] == 0 || p[1] == g.gy - 1
      || p[2] == 0 || p[2] == g.gz - 1)
    return true;
  for (int b = 0; b < nbox; ++b) {
    const int* box = boxes + 6 * b;
    if (p[0] >= box[0] && p[0] < box[3] && p[1] >= box[1] && p[1] < box[4]
        && p[2] >= box[2] && p[2] < box[5])
      return true;
  }
  return false;
}

// Stages 02-03 at cell p: SOLID on the border and in the boxes, else WATER
// if occupied, else AIR with an occupied 6-neighbour, else INACTIVE;
// INACTIVE outside the domain.
__device__ int new_type(const uint8_t* occ, const Grid& g, const int* p,
                        const int* boxes, int nbox) {
  if (!g.inside(p)) return kInactive;
  if (solid_cell(g, p, boxes, nbox)) return kSolid;
  if (occ[g.at(p)] != 0) return kWater;
  for (int m = 0; m < 6; ++m) {
    int q[3];
    neighbour(p, m, q);
    if (g.inside(q) && occ[g.at(q)] != 0) return kAir;
  }
  return kInactive;
}

__global__ void classify_extrap_kernel(const uint8_t* __restrict__ occ,
                                       const uint8_t* __restrict__ old,
                                       const float* __restrict__ vel,
                                       uint8_t* __restrict__ types_out,
                                       float* __restrict__ vel_out, Grid g,
                                       const int* __restrict__ boxes,
                                       int nbox) {
  const long long n = g.cells();
  const long long nm = g.mem_cells();
  const long long cell = blockIdx.x * static_cast<long long>(blockDim.x)
                         + threadIdx.x;
  if (cell >= n) return;
  int p[3];
  g.coords(cell, p);
  const long long here = g.at(p);
  const int nt = new_type(occ, g, p, boxes, nbox);

  // 04: mean velocity of the WATER 6-neighbours under the old types,
  // count and sums accumulated in MOVES order
  float count = 0.0f;
  float vsum[3] = {0.0f, 0.0f, 0.0f};
  for (int m = 0; m < 6; ++m) {
    int q[3];
    neighbour(p, m, q);
    float w = 0.0f;
    float vw[3] = {0.0f, 0.0f, 0.0f};
    if (g.inside(q)) {
      const long long j = g.at(q);
      w = ind(old[j] == kWater);
      for (int c = 0; c < 3; ++c) vw[c] = vel[c * nm + j] * w;
    }
    count = count + w;
    for (int c = 0; c < 3; ++c) vsum[c] = vsum[c] + vw[c];
  }
  const float denom = fmaxf(count, 1.0f);

  // 05: a face is active iff the cell or its lower neighbour is WATER or
  // AIR; was/is from the old and the new types, the lower neighbour's new
  // type recomputed here
  const float was = ind(is_active(old[here]));
  const float is = ind(is_active(nt));
  for (int c = 0; c < 3; ++c) {
    const float extr = vsum[c] / denom;
    int q[3];
    lower(p, c, q);
    const float was_lo = ind(is_active(type_at(old, g, q)));
    const float is_lo = ind(is_active(new_type(occ, g, q, boxes, nbox)));
    const float was_c = fminf(was + was_lo, 1.0f);
    const float is_c = fminf(is + is_lo, 1.0f);
    const float gone = was_c * (1.0f - is_c);
    const float born = (1.0f - was_c) * is_c;
    const float v = vel[c * nm + here];
    vel_out[c * n + cell] =
        (1.0f - gone) * (born * extr + (1.0f - born) * v);
  }
  // 06: commit
  types_out[cell] = static_cast<uint8_t>(nt);
}

struct Forces {
  float dt, gravity, fountain_force, repel;
  int fx, fy, fz;
  const int* terms;    // (nterm, 4): cell x, y, z and component
  const float* kterm;  // (nterm,): dt * force, rounded to f32 once
  int nterm;
};

__device__ __forceinline__ float cell_ind(const int* p, int cx, int cy,
                                          int cz) {
  return ind(p[0] == cx) * ind(p[1] == cy) * ind(p[2] == cz);
}

// Stages 08 and 10 for component c at the in-domain cell p.
__device__ float forced_solid(const uint8_t* types, const float* vel,
                              const Grid& g, int c, const int* p,
                              const Forces& f) {
  const long long nm = g.mem_cells();
  const long long j = g.at(p);
  const int t = types[j];
  const float water = ind(t == kWater);
  int lo[3];
  lower(p, c, lo);
  float v = vel[c * nm + j];
  // 08: gravity and the fountain on wet y-faces off the y = 0 plane
  if (c == 1) {
    const float wet_y = fminf(water + ind(type_at(types, g, lo) == kWater),
                              1.0f);
    const float ynz = 1.0f - ind(p[1] == 0);
    float force = wet_y * ynz * f.gravity;
    force = force + cell_ind(p, f.fx, f.fy, f.fz) * wet_y * f.fountain_force;
    v = v + f.dt * force;
  }
  // 08: the extra cell forces, in config order
  for (int k = 0; k < f.nterm; ++k) {
    const int* term = f.terms + 4 * k;
    if (term[3] != c) continue;
    const float wet_c = fminf(water + ind(type_at(types, g, lo) == kWater),
                              1.0f);
    v = v + cell_ind(p, term[0], term[1], term[2]) * wet_c * f.kterm[k];
  }
  // 10: the min/max clamp forms of the repel rules
  const float solid = ind(t == kSolid);
  v = solid * fminf(v, -f.repel) + (1.0f - solid) * v;
  const float ls = ind(type_at(types, g, lo) == kSolid);
  v = ls * fmaxf(v, f.repel) + (1.0f - ls) * v;
  return v;
}

__global__ void forces_solids_div_kernel(const uint8_t* __restrict__ types,
                                         const float* __restrict__ vel,
                                         float* __restrict__ vel_out,
                                         float* __restrict__ div_out, Grid g,
                                         Forces f) {
  const long long n = g.cells();
  const long long cell = blockIdx.x * static_cast<long long>(blockDim.x)
                         + threadIdx.x;
  if (cell >= n) return;
  int p[3];
  g.coords(cell, p);
  float vs[3];
  for (int c = 0; c < 3; ++c) {
    vs[c] = forced_solid(types, vel, g, c, p, f);
    vel_out[c * n + cell] = vs[c];
  }
  // 11: the divergence reads the post-stage-10 velocity of the upper
  // neighbour, recomputed here; past the upper edge it is 0
  float div = 0.0f;
  for (int c = 0; c < 3; ++c) {
    int q[3] = {p[0], p[1], p[2]};
    q[c] += 1;
    const float up = g.inside(q) ? forced_solid(types, vel, g, c, q, f)
                                 : 0.0f;
    div = div + up - vs[c];
  }
  div_out[cell] = div;
}

__global__ void project_kernel(const uint8_t* __restrict__ types,
                               const float* __restrict__ pressure,
                               const float* __restrict__ vel,
                               float* __restrict__ out, Grid g,
                               float scale) {
  const long long n = g.cells();
  const long long nm = g.mem_cells();
  const long long cell = blockIdx.x * static_cast<long long>(blockDim.x)
                         + threadIdx.x;
  if (cell >= n) return;
  int p[3];
  g.coords(cell, p);
  const long long here = g.at(p);
  const int t = types[here];
  const bool water = t == kWater;
  const bool solid = t == kSolid;
  const float pc = pressure[here];
  for (int c = 0; c < 3; ++c) {
    int q[3];
    lower(p, c, q);
    bool lo_water = false;
    bool lo_solid = false;
    float plo = 0.0f;
    if (g.inside(q)) {
      const long long j = g.at(q);
      lo_water = types[j] == kWater;
      lo_solid = types[j] == kSolid;
      plo = pressure[j];
    }
    const float cond = ind(p[c] != 0 && (water || lo_water) && !solid
                           && !lo_solid);
    const float grad = pc - plo;
    out[c * n + cell] = vel[c * nm + here] - scale * (cond * grad);
  }
}

}  // namespace

// Each entry: the domain (gx, gy, gz), output rows [x0, x0 + lx), input
// rows [xb, xb + mx).
extern "C" int tf_classify_extrap(const uint8_t* occ, const uint8_t* old,
                                  const float* vel, uint8_t* types_out,
                                  float* vel_out, int gx, int gy, int gz,
                                  int x0, int lx, int xb, int mx,
                                  const int* boxes, int nbox, void* stream) {
  const Grid g{gx, gy, gz, x0, lx, xb, mx};
  const long long n = static_cast<long long>(lx) * gy * gz;
  if (n == 0) return 0;
  classify_extrap_kernel<<<tf::blocks_for(n), tf::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      occ, old, vel, types_out, vel_out, g, boxes, nbox);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tf_forces_solids_div(const uint8_t* types, const float* vel,
                                    float* vel_out, float* div_out, int gx,
                                    int gy, int gz, int x0, int lx, int xb,
                                    int mx, float dt, float gravity, int fx,
                                    int fy, int fz, float fountain_force,
                                    float repel, const int* terms,
                                    const float* kterm, int nterm,
                                    void* stream) {
  const Grid g{gx, gy, gz, x0, lx, xb, mx};
  const long long n = static_cast<long long>(lx) * gy * gz;
  if (n == 0) return 0;
  const Forces f{dt, gravity, fountain_force, repel, fx, fy, fz,
                 terms, kterm, nterm};
  forces_solids_div_kernel<<<tf::blocks_for(n), tf::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      types, vel, vel_out, div_out, g, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tf_project(const uint8_t* types, const float* pressure,
                          const float* vel, float* out, int gx, int gy,
                          int gz, int x0, int lx, int xb, int mx, float scale,
                          void* stream) {
  const Grid g{gx, gy, gz, x0, lx, xb, mx};
  const long long n = static_cast<long long>(lx) * gy * gz;
  if (n == 0) return 0;
  project_kernel<<<tf::blocks_for(n), tf::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      types, pressure, vel, out, g, scale);
  return static_cast<int>(cudaGetLastError());
}
