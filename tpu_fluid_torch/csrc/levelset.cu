// The level-set surface field (surface/levelset.py) on the detailed grid:
// the chamfer distance to the nearest occupied cell, the clamp to the
// signed field, and the smoothing passes, in one march that keeps every
// intermediate on chip and runs it only on the boxes that water reaches.
//
// Replaces no TPU kernel: the JAX package computes the level set in XLA
// (tpu_fluid/surface/levelset.py), and the port's plain version runs it as
// ~450 PyTorch passes over the grid at 4 sweeps and 2 smoothing passes,
// each a fresh tensor.  What bounds it on the card: the bytes, if it is
// one pass.  The function must read the u8 occupancy and the sim cell
// types once and write f1 and f2 once, 9 bytes a detailed cell, against
// about 18 float operations a cell a sweep and 9 a smoothing pass.
//
// The arithmetic, bitwise the plain version's (built with -fmad=false):
// - phi = 0 where occupied, else kBig; a sweep is
//     phi' = min(phi, min over the 26 neighbours n of fl(phi_n + w_n))
//   with w_n the f32 rounding of 1, sqrt 2 or sqrt 3 (face, edge, corner).
//   min is exact and needs no order on these finite non-negative values,
//   and fl(a + w) is monotone in a, so fl(min(a, b) + w) = min(fl(a + w),
//   fl(b + w)): each weight class takes its min first and adds its weight
//   once.  A neighbour outside the grid gives kBig + w > kBig >= phi and
//   never wins, so positions outside the grid hold kBig.  The in-plane
//   minima of a plane (its 4 face neighbours F and 4 diagonal neighbours E
//   in y-z) serve three planes: for the plane q - 1 between q - 2 and q,
//     faces   min(phi[q-2], phi[q], F[q-1])            + 1
//     edges   min(E[q-1], F[q-2], F[q])                + sqrt 2
//     corners min(E[q-2], E[q])                        + sqrt 3
//   about 18 operations a cell a sweep where the plain passes take 52.
// - f = iso - min(phi, sweeps + 1), then each smoothing pass
//     nsum = ((((((0 + x+1) + y+1) + z+1) + x-1) + y-1) + z-1)
//   in MOVES order with 0 outside the grid, f' = (f + nsum) * f32(1 / 7)
//   (ops/stencil.div_const's product), and a cell under a SOLID sim cell
//   (parent = cell / r, read from the types by index) keeps f.
//
// The march (levelset_march_kernel): a block of 32 x 32 threads owns a
// y-z tile, one cell a thread, with a ring of R = sweeps + smooth cells
// (kMaxHalo at most), and marches along its box's x segment, one plane a
// step, with one __syncthreads() a step.  Each level keeps its newest
// plane in a double-buffered shared plane with a never-written pad ring,
// so no neighbour read is tested.  Sweep j is computed two planes behind
// sweep j - 1, from the in-plane minima of sweep j - 1's plane written the
// step before; the clamp follows sweep `sweeps` at its plane; smoothing
// pass k runs one plane behind pass k - 1, as K5's blur passes do.  Each
// level loses one ring of the tile and only the inner (32 - 2R)^2 cells
// are written, into f1 and f2 both, from registers.
//
// Only the boxes that water reaches run the chamfer.  A box is its march's
// inner tile times a segment of seg rows; it is live if an occupied cell
// lies within Chebyshev distance R of it.  A sweep moves a distance at
// most one cell along each axis, so every cell with no occupied cell within
// `sweeps` holds kBig after the sweeps: a dead box and its smoothing ring
// all hold iso - min(kBig, sweeps + 1) before the smoothing.  Two kernels
// flag the boxes on the device, with no host sync, reading the occupancy
// once: levelset_live_scan_kernel ORs, for each detailed plane and y tile,
// the bits of the z tiles whose widened box holds an occupied cell (and
// those near a SOLID parent); levelset_live_flag_kernel ORs those over
// each box's widened segment into its flag, counts the live boxes and
// resets the march's counter.  The march's blocks, one an SM, take the
// boxes in turn from that counter in box order, so that the boxes marched
// at once lie side by side and their writes meet in the L2 (taking the
// live boxes first, from a list, made the march 17-37% slower at 512^3);
// a block runs one kind of box at a time, so no warp diverges between
// them:
// - a live box marches everything;
// - a dead box marches the smoothing alone on the constant, reading no
//   occupancy, which keeps the SOLID parents and the zero outside the grid
//   exact;
// - a dead box whose smoothing ring lies inside the grid with no SOLID
//   parent (flag 2) is the constant's smoothing at an interior cell
//   everywhere, each pass adding six copies of its value in the same
//   order: its cells are written with that value, no march.
// With `band` given (the counting form, under tracing) the march counts
// the cells whose phi ends at most `sweeps` (plain band_cells), a partial
// sum a block and one atomic each; dead boxes hold none.
//
// What the march costs on the card: instruction issue on the live boxes
// (about 300 instructions a position a step at 4 sweeps and 2 passes), and
// the writes of f1 and f2, 80-byte runs along z a box row.
//
// Coordinates come from the box index and threadIdx.  Shared memory above
// 48 KB is opted into with cudaFuncSetAttribute; every error is returned
// to the wrapper (kernels/levelset.py), which raises.

#include "common.cuh"

namespace {

constexpr int kTile = 32;  // kernels/tiling.py TILE
constexpr int kPad = kTile + 2;
constexpr int kPadPlane = kPad * kPad;
constexpr int kMaxHalo = 8;  // kernels/levelset.py MAX_HALO
constexpr int kMaxWords = 4;  // mask words a row of z tiles: 128 tiles
constexpr int kScanThreads = 256;
constexpr int kFlagThreads = 1024;
constexpr float kBig = 1e6f;  // surface/levelset.py _BIG
constexpr uint8_t kSolid = 3;  // CellType.SOLID

long long g_launches = 0;  // kernels launched by this file, all calls

struct Params {
  const uint8_t* occ;    // detailed occupancy (nx, gy, gz)
  const uint8_t* types;  // sim cell types (nx / r, gy / r, gz / r)
  float* f1;
  float* f2;  // null: f1 only
  int nx, gy, gz, r;
  int ring;   // sweeps + smooth: the rings a live box's march loses
  int inner;  // kTile - 2 ring: a box's cells along y and z
  int tiles_z, tiles_y, seg, total;
  int words;  // ceil(tiles_z / 32): the scan's mask words a y tile
  float iso, clamp, band_max, w2, w3, c7;
};

// floor(a / b) for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// A box: its tile's first position (y0, z0), ring included, which may lie
// before the grid, and its rows [x_lo, x_hi).
struct Box {
  int y0, z0, x_lo, x_hi;
};

// Box b: inner tile (b % tiles_z, b / tiles_z % tiles_y) times segment
// b / (tiles_z tiles_y) of seg rows.
__device__ __forceinline__ Box box_of(const Params& a, int b) {
  const int rest = b / a.tiles_z;
  const int x_lo = rest / a.tiles_y * a.seg;
  return Box{(rest % a.tiles_y) * a.inner - a.ring,
             (b % a.tiles_z) * a.inner - a.ring, x_lo,
             min(x_lo + a.seg, a.nx)};
}

// The z tiles t (of tiles_z) whose range [t inner, t inner + inner),
// widened by `ring` cells a side, meets the cells [lo, hi], as bits of the
// words masks[0 ..), OR-ed in.
__device__ __forceinline__ void or_tiles(unsigned int* masks, int lo, int hi,
                                         int ring, int inner, int tiles_z) {
  const int t_lo = max(floor_div(lo - ring, inner), 0);
  const int t_hi = min(floor_div(hi + ring, inner), tiles_z - 1);
  for (int t = t_lo; t <= t_hi; ++t) {
    atomicOr(masks + (t >> 5), 1u << (t & 31));
  }
}

// One block a detailed plane x and y tile ty: live_masks[x][ty] the z tiles
// whose box, widened by `ring` cells along y and z, holds an occupied cell
// of plane x; where x is the first detailed plane of sim plane px = x / r,
// solid_masks[px][ty] the z tiles whose box, widened by `smooth` cells
// along y and z, holds a cell under a SOLID sim cell of plane px.  Each
// warp reads a row along z, a lane 16 cells at a time where `vec` (gz a
// multiple of 16, occ 16-byte aligned), else one.
__global__ void __launch_bounds__(kScanThreads)
    levelset_live_scan_kernel(const Params a, int smooth, int vec,
                              unsigned int* __restrict__ live_masks,
                              unsigned int* __restrict__ solid_masks) {
  extern __shared__ float smem[];
  unsigned int* const live = reinterpret_cast<unsigned int*>(smem);
  unsigned int* const solid = live + a.words;
  const int ty = blockIdx.x;
  const int x = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kScanThreads / 32;
  if (threadIdx.x < 2 * a.words) live[threadIdx.x] = 0;
  __syncthreads();
  const int y0 = ty * a.inner;
  const int y1 = min(y0 + a.inner, a.gy);
  const int ye = min(y1 + a.ring, a.gy);
  for (int y = max(y0 - a.ring, 0) + warp; y < ye; y += kWarps) {
    const uint8_t* row = a.occ + (static_cast<long long>(x) * a.gy + y) * a.gz;
    if (vec) {
      for (int z = 16 * lane; z < a.gz; z += 16 * 32) {
        const uint4 c = *reinterpret_cast<const uint4*>(row + z);
        if ((c.x | c.y | c.z | c.w) == 0) continue;
        const unsigned int w[4] = {c.x, c.y, c.z, c.w};
        int lo = 16, hi = -1;
        for (int i = 0; i < 16; ++i) {
          if ((w[i >> 2] >> (8 * (i & 3))) & 0xffu) {
            lo = min(lo, i);
            hi = i;
          }
        }
        or_tiles(live, z + lo, z + hi, a.ring, a.inner, a.tiles_z);
      }
    } else {
      for (int z = lane; z < a.gz; z += 32) {
        if (row[z]) or_tiles(live, z, z, a.ring, a.inner, a.tiles_z);
      }
    }
  }
  if (x % a.r == 0) {
    const int gyt = a.gy / a.r, gzt = a.gz / a.r;
    const int px = x / a.r;
    const int pye = min(floor_div(y1 + smooth - 1, a.r) + 1, gyt);
    for (int py = max(floor_div(y0 - smooth, a.r), 0) + warp; py < pye;
         py += kWarps) {
      const uint8_t* row =
          a.types + (static_cast<long long>(px) * gyt + py) * gzt;
      for (int pz = lane; pz < gzt; pz += 32) {
        if (row[pz] == kSolid) {
          or_tiles(solid, pz * a.r, pz * a.r + a.r - 1, smooth, a.inner,
                   a.tiles_z);
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < a.words) {
    const long long at =
        (static_cast<long long>(x) * a.tiles_y + ty) * a.words + threadIdx.x;
    live_masks[at] = live[threadIdx.x];
  } else if (x % a.r == 0 && threadIdx.x < 2 * a.words) {
    const int w = threadIdx.x - a.words;
    solid_masks[(static_cast<long long>(x / a.r) * a.tiles_y + ty) *
                    a.words + w] = solid[w];
  }
}

// One block: flags[b] of each box, from the scan's masks over its
// segment's planes widened along x (by `ring`, and by `smooth` for the
// SOLID parents): 1 if an occupied cell lies within `ring` cells of the
// box, else 2 if the box with its `smooth`-cell ring lies inside the grid
// with no cell under a SOLID sim cell, else 0.  Then flags[total] = the
// live boxes and flags[total + 1] = 0, the counter from which the march's
// blocks take the boxes.
__global__ void __launch_bounds__(kFlagThreads)
    levelset_live_flag_kernel(const Params a, int smooth,
                              const unsigned int* __restrict__ live_masks,
                              const unsigned int* __restrict__ solid_masks,
                              int* __restrict__ flags) {
  const int tid = threadIdx.x;
  const int segments = (a.nx + a.seg - 1) / a.seg;
  const int items = segments * a.tiles_y * a.words;
  int n_live = 0;  // this thread's
  for (int it = tid; it < items; it += kFlagThreads) {
    const int w = it % a.words;
    const int ty = it / a.words % a.tiles_y;
    const int x0 = it / a.words / a.tiles_y * a.seg;
    const int x1 = min(x0 + a.seg, a.nx);
    unsigned int live = 0, solid = 0;
    const int xe = min(x1 + a.ring, a.nx);
    for (int x = max(x0 - a.ring, 0); x < xe; ++x) {
      live |= live_masks[(static_cast<long long>(x) * a.tiles_y + ty) *
                             a.words + w];
    }
    const int y0 = ty * a.inner;
    const int y1 = min(y0 + a.inner, a.gy);
    const bool inside = x0 - smooth >= 0 && x1 + smooth <= a.nx &&
                        y0 - smooth >= 0 && y1 + smooth <= a.gy;
    if (inside) {
      const int pxe = (x1 + smooth - 1) / a.r + 1;
      for (int px = (x0 - smooth) / a.r; px < pxe; ++px) {
        solid |= solid_masks[(static_cast<long long>(px) * a.tiles_y + ty) *
                                 a.words + w];
      }
    }
    const int base = (x0 / a.seg * a.tiles_y + ty) * a.tiles_z;
    for (int j = 0; j < 32 && 32 * w + j < a.tiles_z; ++j) {
      const int tz = 32 * w + j;
      const int z0 = tz * a.inner;
      const int z1 = min(z0 + a.inner, a.gz);
      const bool plain = inside && z0 - smooth >= 0 && z1 + smooth <= a.gz &&
                         !((solid >> j) & 1u);
      n_live += (live >> j) & 1u;
      flags[base + tz] = (live >> j) & 1u ? 1 : (plain ? 2 : 0);
    }
  }
  // the block's sum of n_live
  extern __shared__ float smem[];
  int* const sums = reinterpret_cast<int*>(smem);
  sums[tid] = n_live;
  __syncthreads();
  for (int d = kFlagThreads / 2; d > 0; d >>= 1) {
    if (tid < d) sums[tid] += sums[tid + d];
    __syncthreads();
  }
  if (tid == 0) {
    flags[a.total] = sums[0];
    flags[a.total + 1] = 0;
  }
}

// The march of one box: S chamfer sweeps from the occupancy (kOcc; else
// phi = kBig everywhere, the dead box), the clamp, M smoothing passes; f1
// and f2 written at the box's inner cells.  smem holds [2][S + M][kPadPlane]
// planes: chamfer levels 0 .. S - 1, then smoothing levels 0 .. M - 1 (level
// 0 the clamped field), each the source of the level after it.  A block may
// march several boxes in turn: a box's first steps read what the box before
// left in the planes, and only into positions outside its x trapezoid or
// outside the grid along x, whose values are replaced (kBig, 0) or never
// written.  `count`, where given, gathers the band's cells.
template <int S, int M, bool kOcc>
__device__ __forceinline__ void march_box(const Params& a, const Box box,
                                          float* smem, unsigned int* count) {
  constexpr int kLevels = S + M;
  constexpr int kS = S > 0 ? S : 1;
  constexpr int R = S + M;      // rings, and planes along x, this march loses
  constexpr int D = 2 * S + M;  // planes the output lies behind the input
  const int tz = threadIdx.x;
  const int ty = threadIdx.y;  // one warp a row of the tile
  const int me = (ty + 1) * kPad + tz + 1;
  const int y = box.y0 + ty;
  const int z = box.z0 + tz;
  const bool in_yz = y >= 0 && y < a.gy && z >= 0 && z < a.gz;
  const bool inner = in_yz && ty >= a.ring && ty < kTile - a.ring &&
                     tz >= a.ring && tz < kTile - a.ring;
  const long long plane = static_cast<long long>(a.gy) * a.gz;
  const long long yz = in_yz ? static_cast<long long>(y) * a.gz + z : 0;
  const int gzt = a.gz / a.r;
  const long long pplane = static_cast<long long>(a.gy / a.r) * gzt;
  const long long pyz =
      in_yz ? static_cast<long long>(y / a.r) * gzt + z / a.r : 0;
  const int t_begin = max(box.x_lo - R, 0);
  const int t_end = box.x_hi + D;

  // chamfer level L's own values at planes q, q - 1, q - 2 (q: the plane
  // written to shared memory last step) and its in-plane minima at q - 1,
  // q - 2; kBig before the grid
  float v[kS], v1[kS], v2[kS], f_1[kS], f_2[kS], e_1[kS], e_2[kS];
#pragma unroll
  for (int L = 0; L < kS; ++L) {
    v[L] = v1[L] = v2[L] = f_1[L] = f_2[L] = e_1[L] = e_2[L] = kBig;
  }
  // smoothing level k's value this step (nv) and at the two planes before
  // (h1, h2); 0 before the grid
  float h1[M + 1], h2[M + 1], nv[M + 1];
#pragma unroll
  for (int k = 0; k <= M; ++k) h1[k] = h2[k] = 0.0f;
  unsigned int sk = 0;  // skip of smoothing level 0's plane t - 2S - b in bit b

  // the occupancy of plane t and the skip of plane t - 2S, loaded a step
  // ahead; the skip's plane as (plane / r, plane % r) by steps
  int occ_next = 0, skip_next = 0;
  int lp = t_begin - 2 * S;
  int lpx = max(lp, 0) / a.r;
  int lpr = max(lp, 0) - lpx * a.r;
  long long occ_at = t_begin * plane + yz;
  auto load = [&](int t) {
    occ_next = 0;
    skip_next = 0;
    if (in_yz) {
      if (kOcc && t < a.nx) occ_next = a.occ[occ_at];
      if (M > 0 && lp >= 0 && lp < a.nx) {
        skip_next = a.types[lpx * pplane + pyz] == kSolid;
      }
    }
    occ_at += plane;
    if (lp >= 0 && ++lpr == a.r) {
      lpr = 0;
      ++lpx;
    }
    ++lp;
  };
  load(t_begin);
  long long out_at = (t_begin - D) * plane + yz;
  const float* last = smem;
  float* next = smem + kLevels * kPadPlane;
  for (int t = t_begin; t < t_end; ++t) {
    const int occ_now = occ_next;
    const unsigned int skip_now = skip_next;
    load(t + 1);
    // chamfer level S at plane t - 2S: levels in descending order, so each
    // reads its source level's values of the step before
    float phi = kBig;
    if constexpr (S > 0) {
#pragma unroll
      for (int L = S - 1; L >= 0; --L) {
        const int q = t - 1 - 2 * L;  // source level L's plane in `last`
        const float* lv = last + L * kPadPlane;
        float fq = fminf(fminf(lv[me - kPad], lv[me + kPad]),
                         fminf(lv[me - 1], lv[me + 1]));
        float eq = fminf(fminf(lv[me - kPad - 1], lv[me - kPad + 1]),
                         fminf(lv[me + kPad - 1], lv[me + kPad + 1]));
        if (q < 0 || q >= a.nx) {
          fq = kBig;
          eq = kBig;
        }
        const float face = fminf(fminf(v2[L], v[L]), f_1[L]);
        const float edge = fminf(fminf(e_1[L], f_2[L]), fq);
        const float corner = fminf(e_2[L], eq);
        float n = fminf(fminf(v1[L], face + 1.0f),
                        fminf(edge + a.w2, corner + a.w3));
        const int p = q - 1;  // level L + 1's plane
        n = in_yz && p >= 0 && p < a.nx ? n : kBig;
        f_2[L] = f_1[L];
        f_1[L] = fq;
        e_2[L] = e_1[L];
        e_1[L] = eq;
        if (L + 1 < S) {
          next[(L + 1) * kPadPlane + me] = n;
          v2[L + 1] = v1[L + 1];
          v1[L + 1] = v[L + 1];
          v[L + 1] = n;
        } else {
          phi = n;
        }
      }
    }
    // chamfer level 0 at plane t
    const float phi0 = kOcc && in_yz && t < a.nx && occ_now != 0 ? 0.0f : kBig;
    if constexpr (S > 0) {
      next[me] = phi0;
      v2[0] = v1[0];
      v1[0] = v[0];
      v[0] = phi0;
    } else {
      phi = phi0;
    }
    // smoothing level 0, the clamped field, at plane t - 2S
    const int p0 = t - 2 * S;
    const bool row0 = p0 >= 0 && p0 < a.nx;
    if (count && inner && p0 >= box.x_lo && p0 < box.x_hi &&
        phi <= a.band_max) {
      ++*count;
    }
    nv[0] = in_yz && row0 ? a.iso - fminf(phi, a.clamp) : 0.0f;
    if (M > 0) next[S * kPadPlane + me] = nv[0];
    sk = (sk << 1) | skip_now;
    // smoothing pass k at plane t - 2S - k
#pragma unroll
    for (int k = 1; k <= M; ++k) {
      const int p = p0 - k;
      const float* lv = last + (S + k - 1) * kPadPlane;
      float s = 0.0f + nv[k - 1];  // x+1: level k - 1 this step
      s = s + lv[me + kPad];       // y+1
      s = s + lv[me + 1];          // z+1
      s = s + h2[k - 1];           // x-1
      s = s + lv[me - kPad];       // y-1
      s = s + lv[me - 1];          // z-1
      const float c = h1[k - 1];
      const float res = (sk >> k) & 1u ? c : (c + s) * a.c7;
      nv[k] = in_yz && p >= 0 && p < a.nx ? res : 0.0f;
      if (k < M) next[(S + k) * kPadPlane + me] = nv[k];
    }
    const int po = t - D;
    if (inner && po >= box.x_lo && po < box.x_hi) {
      a.f1[out_at] = nv[M];
      if (a.f2) a.f2[out_at] = nv[M];
    }
    out_at += plane;
#pragma unroll
    for (int k = 0; k <= M; ++k) {
      h2[k] = h1[k];
      h1[k] = nv[k];
    }
    __syncthreads();
    const float* const swap = next;
    next = const_cast<float*>(last);
    last = swap;
  }
}

// A dead box whose smoothing ring lies inside the grid with no SOLID
// parent: every cell is the constant's smoothing at an interior cell.
template <int M>
__device__ __forceinline__ void fill_box(const Params& a, const Box box) {
  float g = a.iso - fminf(kBig, a.clamp);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    float s = 0.0f + g;
    s = s + g;
    s = s + g;
    s = s + g;
    s = s + g;
    s = s + g;
    g = (g + s) * a.c7;
  }
  const int ty = threadIdx.y, tz = threadIdx.x;
  const int y = box.y0 + a.ring + ty;
  const int z = box.z0 + a.ring + tz;
  if (ty >= a.inner || tz >= a.inner || y >= a.gy || z >= a.gz) return;
  const long long plane = static_cast<long long>(a.gy) * a.gz;
  long long at = box.x_lo * plane + static_cast<long long>(y) * a.gz + z;
  for (int x = box.x_lo; x < box.x_hi; ++x, at += plane) {
    a.f1[at] = g;
    if (a.f2) a.f2[at] = g;
  }
}

// Every box, taken in turn by each block in box order, so that the boxes
// marched at once lie side by side.
template <int S, int M>
__global__ void __launch_bounds__(kTile * kTile, 1)
    levelset_march_kernel(const Params a, int* __restrict__ scratch,
                          unsigned long long* __restrict__ band) {
  // [2][S + M][kPadPlane] planes, then the box slot, then the band's sums
  extern __shared__ float smem[];
  constexpr int kPlanes = 2 * (S + M) * kPadPlane;
  int* const slot = reinterpret_cast<int*>(smem + kPlanes);
  unsigned int* const sums = reinterpret_cast<unsigned int*>(slot + 1);
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < kPlanes; i += kTile * kTile) smem[i] = 0.0f;
  const int* const flags = scratch;
  int* const next_box = scratch + a.total + 1;
  unsigned int count = 0;
  for (;;) {
    __syncthreads();  // the slot read, and the planes written, by all
    if (tid == 0) *slot = atomicAdd(next_box, 1);
    __syncthreads();
    const int b = *slot;
    if (b >= a.total) break;
    const int flag = flags[b];
    const Box box = box_of(a, b);
    if (flag & 1) {
      march_box<S, M, true>(a, box, smem, band ? &count : nullptr);
    } else if (flag & 2) {
      fill_box<M>(a, box);
    } else {
      march_box<0, M, false>(a, box, smem, nullptr);
    }
  }
  if (band) {
    sums[tid] = count;
    __syncthreads();
    for (int d = kTile * kTile / 2; d > 0; d >>= 1) {
      if (tid < d) sums[tid] += sums[tid + d];
      __syncthreads();
    }
    if (tid == 0 && sums[0]) {
      atomicAdd(band, static_cast<unsigned long long>(sums[0]));
    }
  }
}

struct MarchArgs {
  Params a;
  int* scratch;
  unsigned long long* band;
  int blocks;
  cudaStream_t stream;
};

template <int S, int M>
cudaError_t launch_march(const MarchArgs& m) {
  auto kernel = levelset_march_kernel<S, M>;
  const size_t bytes =
      (2 * (S + M) * kPadPlane + 1 + kTile * kTile) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<m.blocks, dim3(kTile, kTile), bytes, m.stream>>>(m.a, m.scratch,
                                                           m.band);
  ++g_launches;
  return cudaGetLastError();
}

// The instance of (sweeps, smooth), sweeps + smooth <= kMaxHalo.
template <int S, int M = 0>
cudaError_t dispatch_smooth(int smooth, const MarchArgs& m) {
  if constexpr (S + M > kMaxHalo) {
    return cudaErrorInvalidValue;
  } else {
    if (smooth == M) return launch_march<S, M>(m);
    return dispatch_smooth<S, M + 1>(smooth, m);
  }
}

template <int S = 0>
cudaError_t dispatch(int sweeps, int smooth, const MarchArgs& m) {
  if constexpr (S > kMaxHalo) {
    return cudaErrorInvalidValue;
  } else {
    if (sweeps == S) return dispatch_smooth<S>(smooth, m);
    return dispatch<S + 1>(sweeps, smooth, m);
  }
}

// The box geometry (kernels/levelset.py Plan); false where the arguments
// are out of range.
bool make_params(int nx, int gy, int gz, int r, int sweeps, int smooth,
                 int seg, Params* a) {
  if (nx < 1 || gy < 1 || gz < 1 || r < 1 || nx % r || gy % r || gz % r ||
      sweeps < 0 || smooth < 0 || sweeps + smooth > kMaxHalo || seg < 1) {
    return false;
  }
  a->nx = nx;
  a->gy = gy;
  a->gz = gz;
  a->r = r;
  a->ring = sweeps + smooth;
  a->inner = kTile - 2 * a->ring;
  a->tiles_z = (gz + a->inner - 1) / a->inner;
  a->tiles_y = (gy + a->inner - 1) / a->inner;
  a->seg = seg;
  const long long total =
      static_cast<long long>(a->tiles_z) * a->tiles_y * ((nx + seg - 1) / seg);
  a->words = (a->tiles_z + 31) / 32;
  if (total > (1 << 30) || a->words > kMaxWords) return false;
  a->total = static_cast<int>(total);
  return true;
}

// The scan's masks in scratch, after the flags, the live count and the
// counter: live_masks [nx][tiles_y][words], then solid_masks
// [nx / r][tiles_y][words].
unsigned int* live_masks(int* scratch, const Params& a) {
  return reinterpret_cast<unsigned int*>(scratch + a.total + 2);
}

unsigned int* solid_masks(int* scratch, const Params& a) {
  return live_masks(scratch, a) +
         static_cast<long long>(a.nx) * a.tiles_y * a.words;
}

}  // namespace

// The boxes' flags of a level set of `sweeps` chamfer sweeps and `smooth`
// smoothing passes on the (nx, gy, gz) detailed grid (r detailed cells a
// sim cell along each axis), in segments of seg rows, into scratch
// (kernels/levelset.py scratch_ints): the flags, the live count, the
// march's box counter, then the scan's masks.
extern "C" int tf_levelset_live(const uint8_t* occ, const uint8_t* types,
                                int* scratch, int nx, int gy, int gz, int r,
                                int sweeps, int smooth, int seg,
                                void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Params a = {};
  if (!make_params(nx, gy, gz, r, sweeps, smooth, seg, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.occ = occ;
  a.types = types;
  const int vec = gz % 16 == 0 && reinterpret_cast<uintptr_t>(occ) % 16 == 0;
  levelset_live_scan_kernel<<<dim3(a.tiles_y, nx), kScanThreads,
                              2 * a.words * sizeof(unsigned int), stream>>>(
      a, smooth, vec, live_masks(scratch, a), solid_masks(scratch, a));
  ++g_launches;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  levelset_live_flag_kernel<<<1, kFlagThreads, kFlagThreads * sizeof(int),
                              stream>>>(a, smooth, live_masks(scratch, a),
                                        solid_masks(scratch, a), scratch);
  ++g_launches;
  return static_cast<int>(cudaGetLastError());
}

// The field over the boxes tf_levelset_live flagged in scratch, written
// into f1 and, where f2 is not null, f2; `blocks` blocks take the boxes in
// turn.  iso, w2 (sqrt 2), w3 (sqrt 3) and c7 (1 / 7) are the plain
// version's f32 constants.  With band given, the cells of the band (phi
// at most sweeps) are added to *band.
extern "C" int tf_levelset_march(const uint8_t* occ, const uint8_t* types,
                                 int* scratch, float* f1, float* f2,
                                 unsigned long long* band, int nx, int gy,
                                 int gz, int r, int sweeps, int smooth,
                                 int seg, float iso, float w2, float w3,
                                 float c7, int blocks, void* stream_ptr) {
  MarchArgs m = {};
  if (!make_params(nx, gy, gz, r, sweeps, smooth, seg, &m.a) || blocks < 1 ||
      f1 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  m.a.occ = occ;
  m.a.types = types;
  m.a.f1 = f1;
  m.a.f2 = f2;
  m.a.iso = iso;
  m.a.clamp = static_cast<float>(sweeps + 1);
  m.a.band_max = static_cast<float>(sweeps);
  m.a.w2 = w2;
  m.a.w3 = w3;
  m.a.c7 = c7;
  m.scratch = scratch;
  m.band = band;
  m.blocks = blocks;
  m.stream = static_cast<cudaStream_t>(stream_ptr);
  return static_cast<int>(dispatch(sweeps, smooth, m));
}

// Kernels launched by tf_levelset_live and tf_levelset_march so far.
extern "C" long long tf_levelset_launches() { return g_launches; }
