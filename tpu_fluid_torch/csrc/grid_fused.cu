// K6: the fused sim-grid stage groups.
//
//   K6a classify_march_kernel   stages 01-06 (01: the occupancy max-pool)
//   K6b forces_march_kernel     stages 08, 10 and 11 (09 is the no-op)
//   K6c project_march_kernel    stage 13
//
// Replaces tpu_fluid/kernels/grid_fused.py:classify_extrap_pallas,
// forces_solids_div_pallas and project_pallas (kernel bodies
// _classify_extrap_kernel, _forces_solids_div_kernel and _project_kernel,
// all built by _call); K6a also takes in the stage-01 pool
// tpu_fluid/stages/particles.py:occupancy_to_sim_grid, which JAX runs as
// XLA before its kernel.  An out-of-domain neighbour reads 0: an INACTIVE
// cell with zero velocity, occupancy and pressure, which is what the
// zero-padded slabs and _zshift give the TPU kernels.  Each expression
// keeps the kernel body's order and its 0/1 float indicators, so with
// -fmad=false a kernel rounds exactly where its plain version
// (kernels/grid_fused.py) does.
//
// What bounds them: memory.  K6a at pool 2 reads 8 occupancy bytes, 1 type
// byte and 12 velocity bytes a cell and writes 13 (about 570 MB at 256^3);
// K6b reads 13 and writes 16 bytes a cell, K6c reads 17 and writes 12.
// One thread a cell with a bounds-checked 64-bit read of every neighbour
// and 64-bit division for its coordinates recomputed K6a's new type 4
// times a cell and K6b's forced velocity 6 times, and held K6a and K6b at
// 14-20% of the bytes bound and K6c's halo form at 29% (PERF.md).  All
// three now march like K2 and K5 (kernels/tiling.py plans them): a block
// of 32 x 32 threads owns a y-z tile with a 2-cell (K6a) or 1-cell (K6b)
// halo, or none and a low ring (K6c, which reads only lower neighbours),
// and walks along its segment of x, one plane a step, every plane load
// issued kPrefetch steps before its use.  Each value another cell needs is
// computed or loaded once, by its own thread, and passed on through a
// shared-memory plane (double-buffered, with a ring of zeros that is never
// written where it lies outside the domain, so no neighbour read is
// tested) or, along x, through the thread's registers.  Index math is
// 32-bit with running offsets; the entry points refuse fields whose
// offsets do not fit.
//
// K6a, step t: load the occupancy of plane t + 1 (pooled from the pool^3
// detailed cells under each sim cell, z-contiguous), the old types and
// the velocity of plane t; compute the new type of plane t (stages 02-03)
// from the occupancy planes t - 1, t, t + 1; then stages 04-06 at plane
// t - 1, from the new and old types and the velocity of planes t - 2 .. t.
// K6b, step t: load the types of plane t + 1 and the velocity of plane t;
// compute stages 08 and 10 at plane t and write it; then the divergence of
// plane t - 1 from the forced velocity of planes t - 1 and t.
// K6c, step t: load the types, pressure and velocity of plane t and the
// ring's types and pressure; project plane t from them and from plane
// t - 1's types and pressure.
//
// Halo forms (the x-slab multi-device step: the `halos`, `x0` and
// `global_gx` arguments of the JAX wrappers): the inputs of K6a and K6b
// hold the local slab with its neighbour planes, 2 a side for K6a and 1
// for K6b, nx rows whose row 0 lies at global x xb; the output is rows
// [xs, xe) of the inputs.  K6c reads the slab and, through pointers of
// their own, the types and pressure of its left neighbour plane: it reads
// no right plane and no velocity plane.  Cell coordinates, the border and
// box SOLID rule, the fountain and force cells and the out-of-domain zero
// are all global, so every row equals the single-device row.  Single
// device: xb = 0, gx = nx and [xs, xe) = [0, nx).  The halo form of K6a
// runs at pool 1.

#include "common.cuh"

namespace {

constexpr int kInactive = 0;
constexpr int kAir = 1;
constexpr int kWater = 2;
constexpr int kSolid = 3;

constexpr int kTile = 32;  // kernels/tiling.py TILE
constexpr int kTilePlane = kTile * kTile;
// a plane in shared memory: the tile and a ring of zeros that is never
// written, so a neighbour past the tile's edge reads 0 without a test
constexpr int kPad = kTile + 2;
constexpr int kPadPlane = kPad * kPad;
// a u8 plane's bytes, rounded up to the 16 that zero_shared writes at once
constexpr int kBytePlane = (kPadPlane + 15) / 16 * 16;
// plane loads are issued this many march steps before their use, so that
// their latency overlaps the steps in between
constexpr int kPrefetch = 2;
// kernels/tiling.py CLASSIFY_HALO and FORCES_HALO
constexpr int kClassifyHalo = 2;
constexpr int kForcesHalo = 1;

long long g_launches = 0;  // kernels launched by this file, all calls

__device__ __forceinline__ float ind(bool b) { return b ? 1.0f : 0.0f; }

__device__ __forceinline__ bool is_active(int t) {
  return t == kWater || t == kAir;
}

// One launch of a march (kernels/tiling.py Pass): the inputs have nx rows
// of gy x gz cells, row 0 at global x xb of a domain gx rows wide, and the
// rows [dom_lo, dom_hi) inside it; the output rows [xs, xe) go to output
// row x - xs, in segments of seg rows.
struct March {
  int nx, gy, gz, xb, gx, dom_lo, dom_hi, xs, xe, seg;
};

// A thread's place in its block's tile, `halo` cells a side.
struct Column {
  int me;      // its cell in a shared plane
  int y, z;    // its cell in the grid (may lie outside)
  int yz;      // y * gz + z, 0 outside the grid
  bool in_yz;  // inside the grid
  bool inner;  // inside the grid and the inner tile: it writes
  int x_lo, x_hi;  // the block's output rows

  __device__ Column(const March& a, int halo) {
    const int inner_w = kTile - 2 * halo;
    const int tz = threadIdx.x;
    const int ty = threadIdx.y;  // one warp a row of the tile
    me = (ty + 1) * kPad + tz + 1;
    y = blockIdx.y * inner_w - halo + ty;
    z = blockIdx.x * inner_w - halo + tz;
    in_yz = y >= 0 && y < a.gy && z >= 0 && z < a.gz;
    inner = in_yz && ty >= halo && ty < kTile - halo && tz >= halo &&
            tz < kTile - halo;
    yz = in_yz ? y * a.gz + z : 0;
    x_lo = a.xs + blockIdx.z * a.seg;
    x_hi = min(x_lo + a.seg, a.xe);
  }
  // input row t holds this column's cell inside the domain (the domain
  // rows lie inside the input)
  __device__ bool live(const March& a, int t) const {
    return in_yz && t >= a.dom_lo && t < a.dom_hi;
  }
};

// Zero `n` bytes of shared memory, 16 at a time (n a multiple of 16); the
// caller synchronizes before the first write of a plane.
__device__ __forceinline__ void zero_shared(void* p, int n) {
  float4* q = static_cast<float4*>(p);
  for (int i = threadIdx.y * kTile + threadIdx.x; i < n / 16;
       i += kTilePlane) {
    q[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// ------------------------------------------------------------- stages 01-06
// Stage 03's SOLID rule at global (x, y, z): the domain border or an
// end-exclusive box (x0, y0, z0, x1, y1, z1).
__device__ __forceinline__ bool solid_cell(int x, int y, int z,
                                           bool yz_border, int gx,
                                           const int* boxes, int nbox) {
  if (yz_border || x == 0 || x == gx - 1) return true;
  for (int b = 0; b < nbox; ++b) {
    const int* box = boxes + 6 * b;
    if (x >= box[0] && x < box[3] && y >= box[1] && y < box[4] &&
        z >= box[2] && z < box[5])
      return true;
  }
  return false;
}

// The raw occupancy loads of one sim cell at pool KP (0: a runtime pool,
// pooled at load time): u16 pairs of the 2 x 2 x 2 detailed cells at pool
// 2, one byte at pool 1.
template <int KP>
struct Occ {
  static constexpr int kLoads = KP == 2 ? 4 : 1;
  unsigned int raw[kLoads];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) raw[i] = 0;
  }
  // at: the detailed offset of the cell's first detailed cell
  __device__ __forceinline__ void load(const uint8_t* occ, int at, int pool,
                                       int dgz, int dplane) {
    if constexpr (KP == 1) {
      raw[0] = occ[at];
    } else if constexpr (KP == 2) {
      // at is even at pool 2, and the wrapper refuses an odd occ
      const uint16_t* o = reinterpret_cast<const uint16_t*>(occ + at);
      const int row = dgz / 2, pl = dplane / 2;
      raw[0] = o[0];
      raw[1] = o[row];
      raw[2] = o[pl];
      raw[3] = o[pl + row];
    } else {
      unsigned int any = 0;
      for (int i = 0; i < pool; ++i) {
        for (int j = 0; j < pool; ++j) {
          const uint8_t* r = occ + at + i * dplane + j * dgz;
          for (int k = 0; k < pool; ++k) any |= r[k];
        }
      }
      raw[0] = any;
    }
  }
  // the pooled occupancy is nonzero: a u8 max is nonzero exactly when one
  // of its cells is
  __device__ __forceinline__ int occupied() const {
    unsigned int any = 0;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) any |= raw[i];
    return any != 0;
  }
};

template <int KP>
__global__ void __launch_bounds__(kTilePlane, 1)
    classify_march_kernel(const uint8_t* __restrict__ occ,
                          const uint8_t* __restrict__ old,
                          const float* __restrict__ vel,
                          uint8_t* __restrict__ types_out,
                          float* __restrict__ vel_out, March a, int pool,
                          const int* __restrict__ boxes, int nbox) {
  constexpr int H = kClassifyHalo;
  // occupancy of plane t + 1; new and old types and the old-WATER-weighted
  // velocity of plane t, each double-buffered: [s ^ 1] holds the plane
  // before
  __shared__ __align__(16) float vw_planes[2][3][kPadPlane];
  __shared__ __align__(16) uint8_t occ_planes[2][kBytePlane];
  __shared__ __align__(16) uint8_t nt_planes[2][kBytePlane];
  __shared__ __align__(16) uint8_t old_planes[2][kBytePlane];
  zero_shared(vw_planes, sizeof(vw_planes));
  zero_shared(occ_planes, sizeof(occ_planes));
  zero_shared(nt_planes, sizeof(nt_planes));
  zero_shared(old_planes, sizeof(old_planes));
  __syncthreads();

  const Column col(a, H);
  const int me = col.me;
  const int plane = a.gy * a.gz;
  const int n_out = (a.xe - a.xs) * plane;
  const bool yz_border = col.y == 0 || col.y == a.gy - 1 || col.z == 0 ||
                         col.z == a.gz - 1;
  // the detailed grid: pool^3 cells a sim cell
  const int p = KP > 0 ? KP : pool;
  const int dgz = p * a.gz;
  const int dplane = p * a.gy * dgz;
  const int d_yz = col.in_yz ? p * col.y * dgz + p * col.z : 0;
  const int t_begin = col.x_lo - 1;
  const int t_end = col.x_hi + 1;

  // the occupancy of row r, pooled now (the prologue's two rows)
  auto occ_now = [&](int r) {
    Occ<KP> o;
    o.clear();
    if (col.live(a, r)) o.load(occ, p * r * dplane + d_yz, p, dgz, dplane);
    return o.occupied();
  };
  // prefetched: occupancy of row t + 1, old types and velocity of row t
  Occ<KP> pocc[kPrefetch];
  int pold[kPrefetch];
  float pv[kPrefetch][3];
  int load_t = t_begin;
  int occ_at = p * (load_t + 1) * dplane + d_yz;
  int at = load_t * plane + col.yz;
  auto load = [&](Occ<KP>& o, int& ot, float* v) {
    o.clear();
    ot = 0;
    v[0] = v[1] = v[2] = 0.0f;
    if (col.live(a, load_t + 1)) o.load(occ, occ_at, p, dgz, dplane);
    if (col.live(a, load_t)) {
      ot = old[at];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = vel[c * a.nx * plane + at];
    }
    ++load_t;
    occ_at += p * dplane;
    at += plane;
  };
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) load(pocc[j], pold[j], pv[j]);

  // this column at earlier planes: occupancy of t - 1 and t; new types,
  // old types and velocity of t - 1 and t - 2 (the first output row,
  // x_lo at step x_lo + 1, reads those of x_lo - 1, which step t_begin
  // makes)
  int o_m1 = occ_now(t_begin - 1);
  int o_0 = occ_now(t_begin);
  int nt_m1 = 0, nt_m2 = 0, old_m1 = 0, old_m2 = 0;
  float v_m1[3] = {0.0f, 0.0f, 0.0f}, v_m2[3] = {0.0f, 0.0f, 0.0f};
  occ_planes[1][me] = static_cast<uint8_t>(o_0);
  __syncthreads();
  int s = 0;  // the buffers plane t writes
  int out_at = (t_begin - 1 - a.xs) * plane + col.yz;  // output row t - 1

  // unrolled by two, the prefetch slots need no moves (the runtime pool's
  // instance would spill)
#pragma unroll(KP > 0 ? 2 : 1)
  for (int t = t_begin; t < t_end; ++t) {
    const int o_p1 = pocc[0].occupied();
    const int ot = pold[0];
    const float vt[3] = {pv[0][0], pv[0][1], pv[0][2]};
#pragma unroll
    for (int j = 0; j + 1 < kPrefetch; ++j) {
      pocc[j] = pocc[j + 1];
      pold[j] = pold[j + 1];
#pragma unroll
      for (int c = 0; c < 3; ++c) pv[j][c] = pv[j + 1][c];
    }
    load(pocc[kPrefetch - 1], pold[kPrefetch - 1], pv[kPrefetch - 1]);

    // [s ^ 1]: the occupancy of plane t (the prologue wrote t_begin's),
    // the types and weighted velocity of plane t - 1
    const uint8_t* const occ_last = occ_planes[s ^ 1];
    const uint8_t* const nt_last = nt_planes[s ^ 1];
    const uint8_t* const old_last = old_planes[s ^ 1];
    occ_planes[s][me] = static_cast<uint8_t>(o_p1);

    // 02-03 at plane t: SOLID on the border and in the boxes, else WATER
    // if occupied, else AIR with an occupied 6-neighbour, else INACTIVE;
    // INACTIVE outside the domain
    int nt = kInactive;
    if (col.live(a, t)) {
      const int around = o_p1 | o_m1 | occ_last[me + kPad] |
                         occ_last[me - kPad] | occ_last[me + 1] |
                         occ_last[me - 1];
      nt = solid_cell(a.xb + t, col.y, col.z, yz_border, a.gx, boxes, nbox)
               ? kSolid
               : (o_0 != 0 ? kWater : (around != 0 ? kAir : kInactive));
    }
    nt_planes[s][me] = static_cast<uint8_t>(nt);
    old_planes[s][me] = static_cast<uint8_t>(ot);
    // the velocity weighted by the old WATER indicator, as each neighbour
    // adds it (0 outside the domain)
    const float w_t = ind(ot == kWater);
    float vw_t[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vw_t[c] = vt[c] * w_t;
      vw_planes[s][c][me] = vw_t[c];
    }

    // 04-06 at plane q = t - 1
    const int q = t - 1;
    if (col.inner && q >= col.x_lo && q < col.x_hi) {
      const float* const vw_last = vw_planes[s ^ 1][0];
      // 04: count and sums of the WATER 6-neighbours under the old types,
      // accumulated from 0 in MOVES order (+x, +y, +z, -x, -y, -z)
      const float w_m2 = ind(old_m2 == kWater);
      const int nb[4] = {me + kPad, me + 1, me - kPad, me - 1};
      float count = 0.0f;
      float vsum[3] = {0.0f, 0.0f, 0.0f};
      count = count + w_t;
#pragma unroll
      for (int c = 0; c < 3; ++c) vsum[c] = vsum[c] + vw_t[c];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        count = count + ind(old_last[nb[m]] == kWater);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          vsum[c] = vsum[c] + vw_last[c * kPadPlane + nb[m]];
        }
      }
      count = count + w_m2;
#pragma unroll
      for (int c = 0; c < 3; ++c) vsum[c] = vsum[c] + v_m2[c] * w_m2;
#pragma unroll
      for (int m = 2; m < 4; ++m) {
        count = count + ind(old_last[nb[m]] == kWater);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          vsum[c] = vsum[c] + vw_last[c * kPadPlane + nb[m]];
        }
      }
      const float denom = fmaxf(count, 1.0f);

      // 05: a face is active iff the cell or its lower neighbour is WATER
      // or AIR, under the old (was) and the new (is) types
      const float was = ind(is_active(old_m1));
      const float is = ind(is_active(nt_m1));
      const int old_lo[3] = {old_m2, old_last[me - kPad], old_last[me - 1]};
      const int nt_lo[3] = {nt_m2, nt_last[me - kPad], nt_last[me - 1]};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float was_c = fminf(was + ind(is_active(old_lo[c])), 1.0f);
        const float is_c = fminf(is + ind(is_active(nt_lo[c])), 1.0f);
        const float gone = was_c * (1.0f - is_c);
        const float born = (1.0f - was_c) * is_c;
        // born * extr, extr = vsum / denom: where born is 0 the product is
        // 0 * vsum bit for bit (denom is finite and >= 1, so the quotient
        // keeps the sign of a zero, the infinities and the NaNs of vsum),
        // and the division runs only on newly active faces
        float extr = vsum[c];
        if (born != 0.0f) extr = extr / denom;
        vel_out[c * n_out + out_at] =
            (1.0f - gone) * (born * extr + (1.0f - born) * v_m1[c]);
      }
      // 06: commit
      types_out[out_at] = static_cast<uint8_t>(nt_m1);
    }

    o_m1 = o_0;
    o_0 = o_p1;
    nt_m2 = nt_m1;
    nt_m1 = nt;
    old_m2 = old_m1;
    old_m1 = ot;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v_m2[c] = v_m1[c];
      v_m1[c] = vt[c];
    }
    out_at += plane;
    s ^= 1;
    __syncthreads();
  }
}

// ------------------------------------------------------- stages 08, 10, 11
struct Forces {
  float dt, gravity, fountain_force, repel;
  int fx, fy, fz;
  const int* terms;    // (nterm, 4): cell x, y, z and component
  const float* kterm;  // (nterm,): dt * force, rounded to f32 once
  int nterm;
};

__device__ __forceinline__ float cell_ind(int x, int y, int z, int cx,
                                          int cy, int cz) {
  return ind(x == cx) * ind(y == cy) * ind(z == cz);
}

// Stages 08 and 10 for component c at the in-domain global cell (x, y, z)
// of type t, whose lower neighbour along c has type t_lo (0 outside the
// domain), from its velocity v.
__device__ __forceinline__ float forced_solid(int c, int x, int y, int z,
                                              int t, int t_lo, float v,
                                              const Forces& f) {
  const float water = ind(t == kWater);
  // 08: gravity and the fountain on wet y-faces off the y = 0 plane
  if (c == 1) {
    const float wet_y = fminf(water + ind(t_lo == kWater), 1.0f);
    const float ynz = 1.0f - ind(y == 0);
    float force = wet_y * ynz * f.gravity;
    force = force + cell_ind(x, y, z, f.fx, f.fy, f.fz) * wet_y *
                        f.fountain_force;
    v = v + f.dt * force;
  }
  // 08: the extra cell forces, in config order
  for (int k = 0; k < f.nterm; ++k) {
    const int* term = f.terms + 4 * k;
    if (term[3] != c) continue;
    const float wet_c = fminf(water + ind(t_lo == kWater), 1.0f);
    v = v + cell_ind(x, y, z, term[0], term[1], term[2]) * wet_c *
                f.kterm[k];
  }
  // 10: the min/max clamp forms of the repel rules
  const float solid = ind(t == kSolid);
  v = solid * fminf(v, -f.repel) + (1.0f - solid) * v;
  const float ls = ind(t_lo == kSolid);
  v = ls * fmaxf(v, f.repel) + (1.0f - ls) * v;
  return v;
}

__global__ void __launch_bounds__(kTilePlane, 1)
    forces_march_kernel(const uint8_t* __restrict__ types,
                        const float* __restrict__ vel,
                        float* __restrict__ vel_out,
                        float* __restrict__ div_out, March a, Forces f) {
  constexpr int H = kForcesHalo;
  // types of plane t + 1, and the forced y and z velocity of plane t,
  // double-buffered: [s ^ 1] holds the plane before
  __shared__ __align__(16) float vs_planes[2][2][kPadPlane];
  __shared__ __align__(16) uint8_t ty_planes[2][kBytePlane];
  zero_shared(vs_planes, sizeof(vs_planes));
  zero_shared(ty_planes, sizeof(ty_planes));
  __syncthreads();

  const Column col(a, H);
  const int me = col.me;
  const int plane = a.gy * a.gz;
  const int n_out = (a.xe - a.xs) * plane;
  const int t_begin = col.x_lo;
  const int t_end = col.x_hi + 1;

  auto type_now = [&](int r) {
    return col.live(a, r) ? static_cast<int>(types[r * plane + col.yz])
                          : kInactive;
  };
  // prefetched: types of row t + 1, velocity of row t
  int pty[kPrefetch];
  float pv[kPrefetch][3];
  int load_t = t_begin;
  int at = load_t * plane + col.yz;
  auto load = [&](int& ty, float* v) {
    ty = 0;
    v[0] = v[1] = v[2] = 0.0f;
    if (col.live(a, load_t + 1)) ty = types[at + plane];
    if (col.live(a, load_t)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = vel[c * a.nx * plane + at];
    }
    ++load_t;
    at += plane;
  };
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) load(pty[j], pv[j]);

  // this column: types of planes t - 1 and t, forced velocity of t - 1
  int ty_m1 = type_now(t_begin - 1);
  int ty_0 = type_now(t_begin);
  float vs_m1[3] = {0.0f, 0.0f, 0.0f};
  ty_planes[1][me] = static_cast<uint8_t>(ty_0);
  __syncthreads();
  int s = 0;  // the buffers plane t writes
  int out_at = (t_begin - a.xs) * plane + col.yz;  // output row t

#pragma unroll 2
  for (int t = t_begin; t < t_end; ++t) {
    const int ty_p1 = pty[0];
    const float vt[3] = {pv[0][0], pv[0][1], pv[0][2]};
#pragma unroll
    for (int j = 0; j + 1 < kPrefetch; ++j) {
      pty[j] = pty[j + 1];
#pragma unroll
      for (int c = 0; c < 3; ++c) pv[j][c] = pv[j + 1][c];
    }
    load(pty[kPrefetch - 1], pv[kPrefetch - 1]);

    const uint8_t* const ty_last = ty_planes[s ^ 1];  // plane t
    ty_planes[s][me] = static_cast<uint8_t>(ty_p1);

    // 08 and 10 at plane t; 0 outside the domain, where the divergence
    // reads it
    const bool live = col.live(a, t);
    const int x = a.xb + t;
    const int ty_lo[3] = {ty_m1, ty_last[me - kPad], ty_last[me - 1]};
    float vs[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v =
          forced_solid(c, x, col.y, col.z, ty_0, ty_lo[c], vt[c], f);
      vs[c] = live ? v : 0.0f;
    }
    vs_planes[s][0][me] = vs[1];
    vs_planes[s][1][me] = vs[2];
    if (col.inner && t >= col.x_lo && t < col.x_hi) {
#pragma unroll
      for (int c = 0; c < 3; ++c) vel_out[c * n_out + out_at] = vs[c];
    }

    // 11 at plane t - 1: the divergence of the forced velocity, upper
    // neighbours in c order
    const int q = t - 1;
    if (col.inner && q >= col.x_lo && q < col.x_hi) {
      const float* const vs_last = vs_planes[s ^ 1][0];  // plane t - 1
      float div = 0.0f;
      div = div + vs[0] - vs_m1[0];
      div = div + vs_last[me + kPad] - vs_m1[1];
      div = div + vs_last[kPadPlane + me + 1] - vs_m1[2];
      div_out[out_at - plane] = div;
    }

    ty_m1 = ty_0;
    ty_0 = ty_p1;
#pragma unroll
    for (int c = 0; c < 3; ++c) vs_m1[c] = vs[c];
    out_at += plane;
    s ^= 1;
    __syncthreads();
  }
}

// --------------------------------------------------------------- stage 13
// K6c's tile: kProjectRows rows (y) of kProjectCols cells (z), one thread
// a cell, a warp 32 cells of one row (kernels/tiling.py PROJECT_ROWS and
// PROJECT_COLS).  The stage reads only lower neighbours, so a tile is its
// block's output, with a low ring below it.  At 256^3, 16 x 64 tiles ran
// 2% faster than 32 x 32 ones (PERF.md).
constexpr int kProjectCols = 64;
constexpr int kProjectRows = kTilePlane / kProjectCols;
// a shared plane: the ring row and the tile's rows, each row the ring
// cell and the tile's cells; rounded up to the 16 bytes zero_shared
// writes at once
constexpr int kProjectPitch = kProjectCols + 1;
constexpr int kProjectPlane = ((kProjectRows + 1) * kProjectPitch + 15) / 16
                              * 16;

// One plane of a K6c thread's loads: the types, pressure and velocity of
// its cell, and for the tile's first row and column the types and
// pressure of the cell below it along y and along z (the low ring).
struct ProjectPlane {
  int t, t_y, t_z;
  float p, p_y, p_z;
  float v[3];
};

// K6c, step t: the thread loads plane t + kPrefetch, puts the types and
// pressure of plane t (its cell, and the ring's) into a shared plane, and
// projects its cell of plane t from them and from its own cell of plane
// t - 1, which it carries in registers.
__global__ void __launch_bounds__(kTilePlane, 1)
    project_march_kernel(const uint8_t* __restrict__ types,
                         const float* __restrict__ pressure,
                         const float* __restrict__ vel,
                         const uint8_t* __restrict__ types_left,
                         const float* __restrict__ p_left,
                         float* __restrict__ out, March a, float scale) {
  // types and pressure of plane t, double-buffered; the ring cells of a
  // tile at y = 0 or z = 0 lie outside the domain, are never written and
  // read INACTIVE with pressure 0
  __shared__ __align__(16) float p_planes[2][kProjectPlane];
  __shared__ __align__(16) uint8_t ty_planes[2][kProjectPlane];
  zero_shared(p_planes, sizeof(p_planes));
  zero_shared(ty_planes, sizeof(ty_planes));
  __syncthreads();

  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int ty = tid / kProjectCols;
  const int tz = tid % kProjectCols;
  const int y = blockIdx.y * kProjectRows + ty;
  const int z = blockIdx.x * kProjectCols + tz;
  const bool in_yz = y < a.gy && z < a.gz;
  const int yz = in_yz ? y * a.gz + z : 0;
  const int me = (ty + 1) * kProjectPitch + tz + 1;
  const int x_lo = a.xs + blockIdx.z * a.seg;
  const int x_hi = min(x_lo + a.seg, a.xe);
  const int plane = a.gy * a.gz;
  const int n_out = (a.xe - a.xs) * plane;
  const bool ring_y = ty == 0 && in_yz && y > 0;
  const bool ring_z = tz == 0 && in_yz && z > 0;

  ProjectPlane pf[kPrefetch];
  int load_t = x_lo;
  int at = load_t * plane + yz;
  auto load = [&](ProjectPlane& q) {
    q.t = q.t_y = q.t_z = kInactive;
    q.p = q.p_y = q.p_z = 0.0f;
    q.v[0] = q.v[1] = q.v[2] = 0.0f;
    if (in_yz && load_t < x_hi) {
      q.t = types[at];
      q.p = pressure[at];
#pragma unroll
      for (int c = 0; c < 3; ++c) q.v[c] = vel[c * a.nx * plane + at];
      if (ring_y) {
        q.t_y = types[at - a.gz];
        q.p_y = pressure[at - a.gz];
      }
      if (ring_z) {
        q.t_z = types[at - 1];
        q.p_z = pressure[at - 1];
      }
    }
    ++load_t;
    at += plane;
  };
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) load(pf[j]);

  // this cell at plane x_lo - 1: the row before, or the left halo plane
  // (global x xb - 1) before the slab's first row, or outside the domain
  int t_m1 = kInactive;
  float p_m1 = 0.0f;
  if (in_yz && x_lo > 0) {
    const int j = (x_lo - 1) * plane + yz;
    t_m1 = types[j];
    p_m1 = pressure[j];
  } else if (in_yz && a.xb > 0) {
    t_m1 = types_left[yz];
    p_m1 = p_left[yz];
  }
  int s = 0;  // the buffers plane t writes
  int out_at = (x_lo - a.xs) * plane + yz;

  // unrolled by two, the prefetch slots need no moves
#pragma unroll 2
  for (int t = x_lo; t < x_hi; ++t) {
    const ProjectPlane q = pf[0];
#pragma unroll
    for (int j = 0; j + 1 < kPrefetch; ++j) pf[j] = pf[j + 1];
    load(pf[kPrefetch - 1]);

    ty_planes[s][me] = static_cast<uint8_t>(q.t);
    p_planes[s][me] = q.p;
    if (ring_y) {
      ty_planes[s][me - kProjectPitch] = static_cast<uint8_t>(q.t_y);
      p_planes[s][me - kProjectPitch] = q.p_y;
    }
    if (ring_z) {
      ty_planes[s][me - 1] = static_cast<uint8_t>(q.t_z);
      p_planes[s][me - 1] = q.p_z;
    }
    __syncthreads();

    if (in_yz) {
      const bool water = q.t == kWater;
      const bool solid = q.t == kSolid;
      const int t_lo[3] = {t_m1, ty_planes[s][me - kProjectPitch],
                           ty_planes[s][me - 1]};
      const float p_lo[3] = {p_m1, p_planes[s][me - kProjectPitch],
                             p_planes[s][me - 1]};
      const bool nonzero[3] = {a.xb + t != 0, y != 0, z != 0};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float cond = ind(nonzero[c] && (water || t_lo[c] == kWater) &&
                               !solid && t_lo[c] != kSolid);
        const float grad = q.p - p_lo[c];
        out[c * n_out + out_at] = q.v[c] - scale * (cond * grad);
      }
    }
    t_m1 = q.t;
    p_m1 = q.p;
    out_at += plane;
    s ^= 1;
  }
}

// The march geometry of an entry point's arguments, or false where the
// rows or the 32-bit offsets do not fit: the velocity's 3 components and
// the detailed occupancy's pool^3 cells a sim cell, over the rows and the
// few past them that the running offsets reach.
bool march_of(int nx, int gy, int gz, int xb, int gx, int xs, int xe,
              int seg, int pool, March* a) {
  if (nx < 1 || gy < 1 || gz < 1 || xs < 0 || xe > nx || xs >= xe ||
      seg < 1 || pool < 1 || pool > 64) {
    return false;
  }
  const long long cells = (nx + 2LL * kPrefetch + 4) * gy * gz;
  const long long limit = 1LL << 31;
  if (3 * cells >= limit ||
      cells * pool * pool * pool >= limit) {
    return false;
  }
  a->nx = nx;
  a->gy = gy;
  a->gz = gz;
  a->xb = xb;
  a->gx = gx;
  a->dom_lo = xb < 0 ? -xb : 0;
  a->dom_hi = gx - xb < nx ? gx - xb : nx;
  a->xs = xs;
  a->xe = xe;
  a->seg = seg;
  return true;
}

dim3 march_grid(const March& a, int halo) {
  const int inner = kTile - 2 * halo;
  return dim3((a.gz + inner - 1) / inner, (a.gy + inner - 1) / inner,
              (a.xe - a.xs + a.seg - 1) / a.seg);
}

}  // namespace

// K6a, one launch of kernels/tiling.py grid_fused_pass(halo = 2): occ is
// the occupancy at `pool` times the sim grid on every axis ((pool nx,
// pool gy, pool gz) u8), old and vel the sim-grid fields of nx rows, row 0
// at global x xb of a domain gx rows wide; types_out and vel_out receive
// the rows [xs, xe), in segments of seg rows.
extern "C" int tf_classify_extrap(const uint8_t* occ, const uint8_t* old,
                                  const float* vel, uint8_t* types_out,
                                  float* vel_out, int nx, int gy, int gz,
                                  int xb, int gx, int xs, int xe, int seg,
                                  int pool, const int* boxes, int nbox,
                                  void* stream_ptr) {
  March a;
  if (!march_of(nx, gy, gz, xb, gx, xs, xe, seg, pool, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid = march_grid(a, kClassifyHalo);
  const dim3 block(kTile, kTile);
  if (pool == 1) {
    classify_march_kernel<1><<<grid, block, 0, stream>>>(
        occ, old, vel, types_out, vel_out, a, pool, boxes, nbox);
  } else if (pool == 2) {
    classify_march_kernel<2><<<grid, block, 0, stream>>>(
        occ, old, vel, types_out, vel_out, a, pool, boxes, nbox);
  } else {
    classify_march_kernel<0><<<grid, block, 0, stream>>>(
        occ, old, vel, types_out, vel_out, a, pool, boxes, nbox);
  }
  ++g_launches;
  return static_cast<int>(cudaGetLastError());
}

// K6b, one launch of kernels/tiling.py grid_fused_pass(halo = 1): types
// and vel of nx rows, row 0 at global x xb of a domain gx rows wide;
// vel_out and div_out receive the rows [xs, xe), in segments of seg rows.
extern "C" int tf_forces_solids_div(const uint8_t* types, const float* vel,
                                    float* vel_out, float* div_out, int nx,
                                    int gy, int gz, int xb, int gx, int xs,
                                    int xe, int seg, float dt, float gravity,
                                    int fx, int fy, int fz,
                                    float fountain_force, float repel,
                                    const int* terms, const float* kterm,
                                    int nterm, void* stream_ptr) {
  March a;
  if (!march_of(nx, gy, gz, xb, gx, xs, xe, seg, 1, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Forces f{dt, gravity, fountain_force, repel, fx, fy, fz,
                 terms, kterm, nterm};
  forces_march_kernel<<<march_grid(a, kForcesHalo), dim3(kTile, kTile), 0,
                        static_cast<cudaStream_t>(stream_ptr)>>>(
      types, vel, vel_out, div_out, a, f);
  ++g_launches;
  return static_cast<int>(cudaGetLastError());
}

// K6c, one launch of kernels/tiling.py project_pass: types, pressure and
// vel of nx rows, row 0 at global x xb of a domain gx rows wide, all of
// them inside it; types_left and p_left hold global row xb - 1 and are
// read only where xb > 0; out receives the nx rows, in segments of seg
// rows.
extern "C" int tf_project(const uint8_t* types, const float* pressure,
                          const float* vel, const uint8_t* types_left,
                          const float* p_left, float* out, int nx, int gy,
                          int gz, int xb, int gx, int seg, float scale,
                          void* stream) {
  March a;
  if (xb < 0 || xb > gx - nx ||
      (xb > 0 && (types_left == nullptr || p_left == nullptr)) ||
      !march_of(nx, gy, gz, xb, gx, 0, nx, seg, 1, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((gz + kProjectCols - 1) / kProjectCols,
                  (gy + kProjectRows - 1) / kProjectRows,
                  (nx + seg - 1) / seg);
  project_march_kernel<<<grid, dim3(kTile, kTile), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      types, pressure, vel, types_left, p_left, out, a, scale);
  ++g_launches;
  return static_cast<int>(cudaGetLastError());
}

// Kernels launched by this file's entry points so far.
extern "C" long long tf_grid_fused_launches() { return g_launches; }
