// K5: surface-field stages 16-18 on the detailed grid.
//
// Replaces tpu_fluid/kernels/surface_fused.py:surface_fused_pallas
// (_surface_kernel, body _surface_stages), and covers surface_fused_2d and
// the y-chunk route of surface_fused_auto.  Stage 16 updates the inertia
// in int32 from the occupancy of the cell and its 6 neighbours; stage 17
// makes the signed field f = nzi * (I / div) + (nzi - 1); stage 18 runs
// `steps` blur passes f' = c0 * f + c1 * (x+1, x-1, y+1, y-1, z+1, z-1
// neighbours, 0 outside), where a cell under a SOLID parent keeps the
// value of the buffer the pass writes into: pass 0 keeps f2_in, pass 1 the
// stage-17 field, pass t the output of pass t - 2.
//
// What bounds it: memory.  The function reads occ, inertia, f2_in and the
// skip mask once and writes inertia, f1 and f2 once: 16 bytes a cell with
// u8 inertia, against 8 flops a cell a blur pass.  The TPU kernel fuses all
// of it over x-slabs with steps + 1 halo rows in VMEM, for exactly that
// traffic; one launch per stage, as this file had it, moved about 59 bytes
// a cell.  Here one launch does all of it for up to 8 blur passes (each
// further launch, blur passes only, adds 8 bytes a cell read and written:
// the f1, f2 pair): a block of 32 x 32 threads owns a y-z tile with an
// h = steps + 1 cell halo (kernels/tiling.py plans it) and marches along
// its segment of x, one plane a step.  Level 0 (stages
// 16+17) is computed one plane behind the newest occupancy plane, and blur
// pass j one plane behind pass j - 1, each from the shared-memory plane of
// the level before it (written last step, for the y/z neighbours) and this
// column's registers (x+1 from this step, the cell itself and x-1 from the
// last two).  A level's own value lives two more steps in registers, for
// the skip rule two levels on.  Each level loses one ring of the tile; only
// the inner (32 - 2h)^2 cells of the last level are written, and each x
// segment starts and ends h planes beyond its rows.  The halos' re-reads
// come mostly from the L2.  On the card the march is bound by instruction
// issue, not memory: each step's plane loads are issued kPrefetch steps
// ahead, so their latency does not sit between two barriers; every position
// computes every level without a branch; and the shared planes have a zero
// ring, so no neighbour read is tested.
//
// Halo form (surface_fused_pallas with `halos`, `x0` and `global_gx`): the
// buffers are the local detailed slab extended by h neighbour planes a
// side, nx rows whose row 0 lies at global x xb; rows outside the global
// domain [0, gx) read 0 after every stage, the robust-access zero of the
// single-device grid, and the last launch writes only the interior rows
// [h, nx - h) (a launch before it, the rows the next one reads).  Single
// device: h = 0, xb = 0, gx = nx.
//
// Coordinates come from the launch grid and threadIdx.  Built with
// -fmad=false, so each a*b+c rounds twice, as the plain version does.

#include "common.cuh"

namespace {

constexpr int kTile = 32;  // kernels/tiling.py TILE
constexpr int kTilePlane = kTile * kTile;
// a plane in shared memory: the tile and a ring of zeros that is never
// written, so a neighbour past the tile's edge reads 0 without a test
constexpr int kPad = kTile + 2;
constexpr int kPadPlane = kPad * kPad;
constexpr int kMaxSteps = 8;  // kernels/tiling.py MAX_LEVELS
// plane loads are issued this many march steps before their use, so that
// their latency overlaps the steps in between
constexpr int kPrefetch = 2;

long long g_launches = 0;  // kernels launched by this file, all calls

struct Params {
  int nx, gy, gz;
  int dom_lo, dom_hi;  // slab rows inside the global domain
  int xs, xe, seg, out_x0;
  float c0, c1;
  int inc_filled, inc_neigh, required_hits, dec, max_inertia;
  float div_coef;
};

// STEPS blur passes after level 0, on the output rows [xs, xe).  Level 0
// is stages 16 + 17 from occ, inertia_in and f2_in (f1_in unused), or, with
// kBlur, f1_in itself (occ and inertia unused): a further launch continues
// the blur from the (f1, f2) pair of the one before it.
template <typename IT, int STEPS, bool kBlur>
__global__ void __launch_bounds__(kTilePlane, 1)
    surface_march_kernel(const uint8_t* __restrict__ occ,
                         const IT* __restrict__ inertia_in,
                         IT* __restrict__ inertia_out,
                         const float* __restrict__ f1_in,
                         const float* __restrict__ f2_in,
                         const uint8_t* __restrict__ skip,
                         float* __restrict__ f1, float* __restrict__ f2,
                         Params a) {
  constexpr int H = STEPS + 1;
  constexpr int kInner = kTile - 2 * H;
  // [2][STEPS][kPadPlane] floats (levels 0 .. STEPS-1), then
  // [2][kPadPlane] filled flags
  extern __shared__ float smem[];
  uint8_t* const filled_planes =
      reinterpret_cast<uint8_t*>(smem + 2 * STEPS * kPadPlane);
  const int tz = threadIdx.x;
  const int ty = threadIdx.y;  // one warp a row of the tile
  const int me = (ty + 1) * kPad + tz + 1;
  const int y = blockIdx.y * kInner - H + ty;
  const int z = blockIdx.x * kInner - H + tz;
  const bool in_yz = y >= 0 && y < a.gy && z >= 0 && z < a.gz;
  const bool inner = in_yz && ty >= H && ty < kTile - H && tz >= H &&
                     tz < kTile - H;
  for (int i = ty * kTile + tz; i < 2 * STEPS * kPadPlane; i += kTilePlane) {
    smem[i] = 0.0f;
  }
  for (int i = ty * kTile + tz; i < 2 * kPadPlane; i += kTilePlane) {
    filled_planes[i] = 0;
  }
  __syncthreads();
  const long long plane = static_cast<long long>(a.gy) * a.gz;
  const long long yz = in_yz ? static_cast<long long>(y) * a.gz + z : 0;
  const int x_lo = a.xs + blockIdx.z * a.seg;
  const int x_hi = min(x_lo + a.seg, a.xe);
  const int t_begin = max(x_lo - H, 0);
  const int t_end = x_hi + H;
  const int t_load = min(t_end, a.nx);  // planes from here on read as 0

  // this column at earlier planes: filled at t-1, t-2; inertia_in (or
  // f1_in) at t-1; f2_in at t-1, t-2; skip at plane t - b in bit b; level
  // L at planes t-2-L (h1) and t-3-L (h2)
  int o1 = 0, o2 = 0, in1 = 0;
  float e1 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  unsigned int sk = 0;
  float h1[STEPS + 1], h2[STEPS + 1], nv[STEPS + 1];
#pragma unroll
  for (int j = 0; j <= STEPS; ++j) {
    h1[j] = 0.0f;
    h2[j] = 0.0f;
  }
  // occ, inertia_in (or f1_in), f2_in and skip of planes
  // t .. t + kPrefetch - 1; offsets of this column in the plane loaded
  // next and in the output rows of planes t - 1 (inertia) and t - H (f1,
  // f2)
  int pocc[kPrefetch], pin[kPrefetch], pskip[kPrefetch];
  float pf1[kPrefetch], pf2[kPrefetch];
  int load_t = t_begin;
  long long load_at = load_t * plane + yz;
  long long inertia_at = (t_begin - 1 - a.out_x0) * plane + yz;
  long long f_at = (t_begin - H - a.out_x0) * plane + yz;
  auto load = [&](int& o, int& in, float& e, float& g, int& sv) {
    o = 0;
    in = 0;
    e = 0.0f;
    g = 0.0f;
    sv = 0;
    if (load_t < t_load && in_yz) {
      if constexpr (kBlur) {
        e = f1_in[load_at];
      } else {
        o = occ[load_at];
        in = static_cast<int>(inertia_in[load_at]);
      }
      g = f2_in[load_at];
      sv = skip[load_at];
    }
    ++load_t;
    load_at += plane;
  };
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    load(pocc[j], pin[j], pf1[j], pf2[j], pskip[j]);
  }
  const uint8_t* fl_last = filled_planes;
  uint8_t* fl_next = filled_planes + kPadPlane;
  const float* lv_last = smem;
  float* lv_next = smem + STEPS * kPadPlane;
#pragma unroll 2
  for (int t = t_begin; t < t_end; ++t) {
    const int f0 = min(pocc[0], 1);
    const int in0 = pin[0];
    const float e0 = pf1[0];
    const float g0 = pf2[0];
    const unsigned int s0 = pskip[0] != 0;
#pragma unroll
    for (int j = 0; j + 1 < kPrefetch; ++j) {
      pocc[j] = pocc[j + 1];
      pin[j] = pin[j + 1];
      pf1[j] = pf1[j + 1];
      pf2[j] = pf2[j + 1];
      pskip[j] = pskip[j + 1];
    }
    load(pocc[kPrefetch - 1], pin[kPrefetch - 1], pf1[kPrefetch - 1],
         pf2[kPrefetch - 1], pskip[kPrefetch - 1]);
    sk = (sk << 1) | s0;
    if constexpr (!kBlur) fl_next[me] = static_cast<uint8_t>(f0);

    // every position computes every level without a branch; a result is
    // right only where the level before it was right on all six
    // neighbours, and 0 outside the domain and the grid
    // level 0 at plane t - 1: stages 16 + 17, or f1_in
    {
      const int p = t - 1;
      float f;
      if constexpr (kBlur) {
        f = e1;
      } else {
        const int hits = f0 + o2 + fl_last[me + kPad] + fl_last[me - kPad] +
                         fl_last[me + 1] + fl_last[me - 1];
        const int ge = min(max(hits - (a.required_hits - 1), 0), 1);
        const int inc = o1 * a.inc_filled + ge * hits * a.inc_neigh;
        const int nz = min(max(inc, 0), 1);
        const int increased = in1 + inc;
        const int decreased = max(in1 - a.dec, 0);
        const int updated = min(decreased + nz * (increased - decreased),
                                a.max_inertia);
        if (inner && p >= x_lo && p < x_hi) {
          inertia_out[inertia_at] = static_cast<IT>(updated);
        }
        const float nzi = static_cast<float>(min(max(updated, 0), 1));
        f = nzi * (static_cast<float>(updated) / a.div_coef) + (nzi - 1.0f);
      }
      nv[0] = in_yz && p >= a.dom_lo && p < a.dom_hi ? f : 0.0f;
      if (STEPS > 0) lv_next[me] = nv[0];
    }
    // blur pass j - 1 (level j) at plane t - 1 - j
#pragma unroll
    for (int j = 1; j <= STEPS; ++j) {
      const int p = t - 1 - j;
      const float* const lv = lv_last + (j - 1) * kPadPlane;
      float s = nv[j - 1];  // x+1
      s = s + h2[j - 1];    // x-1
      s = s + lv[me + kPad];
      s = s + lv[me - kPad];
      s = s + lv[me + 1];
      s = s + lv[me - 1];
      const float blurred = a.c0 * h1[j - 1] + a.c1 * s;
      const float keep = j == 1 ? g2 : h2[j >= 2 ? j - 2 : 0];
      const float r = (sk >> (j + 1)) & 1u ? keep : blurred;
      nv[j] = in_yz && p >= a.dom_lo && p < a.dom_hi ? r : 0.0f;
      if (j < STEPS) lv_next[j * kPadPlane + me] = nv[j];
    }
    // f1 and f2 at plane t - H: the last level and the one before it
    const int q = t - H;
    if (inner && q >= x_lo && q < x_hi) {
      const float last = nv[STEPS];
      const float prev = STEPS == 0 ? g1 : h1[STEPS > 0 ? STEPS - 1 : 0];
      f1[f_at] = STEPS % 2 == 0 ? last : prev;
      f2[f_at] = STEPS % 2 == 0 ? prev : last;
    }
    inertia_at += plane;
    f_at += plane;
#pragma unroll
    for (int j = 0; j <= STEPS; ++j) {
      h2[j] = h1[j];
      h1[j] = nv[j];
    }
    o2 = o1;
    o1 = f0;
    in1 = in0;
    e1 = e0;
    g2 = g1;
    g1 = g0;
    __syncthreads();
    const uint8_t* const fl_swap = fl_next;
    fl_next = const_cast<uint8_t*>(fl_last);
    fl_last = fl_swap;
    const float* const lv_swap = lv_next;
    lv_next = const_cast<float*>(lv_last);
    lv_last = lv_swap;
  }
}

template <typename IT, int STEPS, bool kBlur>
cudaError_t launch(const uint8_t* occ, const void* inertia_in,
                   void* inertia_out, const float* f1_in, const float* f2_in,
                   const uint8_t* skip, float* f1, float* f2,
                   const Params& a, cudaStream_t stream) {
  auto kernel = surface_march_kernel<IT, STEPS, kBlur>;
  const size_t bytes = 2 * STEPS * kPadPlane * sizeof(float) +
                       2 * kPadPlane * sizeof(uint8_t);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  constexpr int kInner = kTile - 2 * (STEPS + 1);
  const dim3 grid((a.gz + kInner - 1) / kInner, (a.gy + kInner - 1) / kInner,
                  (a.xe - a.xs + a.seg - 1) / a.seg);
  kernel<<<grid, dim3(kTile, kTile), bytes, stream>>>(
      occ, static_cast<const IT*>(inertia_in), static_cast<IT*>(inertia_out),
      f1_in, f2_in, skip, f1, f2, a);
  ++g_launches;
  return cudaGetLastError();
}

template <typename IT, bool kBlur>
cudaError_t launch_steps(int steps, const uint8_t* occ,
                         const void* inertia_in, void* inertia_out,
                         const float* f1_in, const float* f2_in,
                         const uint8_t* skip, float* f1, float* f2,
                         const Params& a, cudaStream_t stream) {
#define TF_SURFACE(S)                                                      \
  case S:                                                                  \
    return launch<IT, S, kBlur>(occ, inertia_in, inertia_out, f1_in, f2_in, \
                                skip, f1, f2, a, stream);
  switch (steps) {
    TF_SURFACE(0)
    TF_SURFACE(1)
    TF_SURFACE(2)
    TF_SURFACE(3)
    TF_SURFACE(4)
    TF_SURFACE(5)
    TF_SURFACE(6)
    TF_SURFACE(7)
    TF_SURFACE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef TF_SURFACE
}

}  // namespace

// One launch of kernels/tiling.py surface_plan.  The inputs have nx rows,
// row 0 at global x xb of a domain gx rows wide (single device: xb = 0,
// gx = nx); the outputs hold the rows [xs, xe), in segments of seg rows.
// f1_in null: stages 16-18 with `steps` <= 8 blur passes, from occ,
// inertia_in (inertia_bytes: 1 for uint8 storage, 4 for int32) and f2_in,
// inertia_out written.  f1_in given: 1 <= steps <= 8 more blur passes on
// the pair (f1_in, f2_in) that such a launch wrote, occ and the inertia
// unused.
extern "C" int tf_surface_fused(const uint8_t* occ, const void* inertia_in,
                                void* inertia_out, const float* f1_in,
                                const float* f2_in, const uint8_t* skip,
                                float* f1, float* f2, int inertia_bytes,
                                int nx, int gy, int gz, int xb, int gx,
                                int xs, int xe, int seg, int steps, float c0,
                                float c1, int inc_filled, int inc_neigh,
                                int required_hits, int dec, int max_inertia,
                                float div_coef, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (gy < 1 || gz < 1 || xs < 0 || xe > nx || xs >= xe || seg < 1 ||
      steps < (f1_in != nullptr ? 1 : 0) || steps > kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params a;
  a.nx = nx;
  a.gy = gy;
  a.gz = gz;
  a.dom_lo = xb < 0 ? -xb : 0;
  a.dom_hi = gx - xb < nx ? gx - xb : nx;
  a.xs = xs;
  a.xe = xe;
  a.seg = seg;
  a.out_x0 = xs;
  a.c0 = c0;
  a.c1 = c1;
  a.inc_filled = inc_filled;
  a.inc_neigh = inc_neigh;
  a.required_hits = required_hits;
  a.dec = dec;
  a.max_inertia = max_inertia;
  a.div_coef = div_coef;
  cudaError_t err;
  if (f1_in != nullptr) {
    err = launch_steps<uint8_t, true>(steps, occ, inertia_in, inertia_out,
                                      f1_in, f2_in, skip, f1, f2, a, stream);
  } else if (inertia_bytes == 1) {
    err = launch_steps<uint8_t, false>(steps, occ, inertia_in, inertia_out,
                                       f1_in, f2_in, skip, f1, f2, a, stream);
  } else if (inertia_bytes == 4) {
    err = launch_steps<int32_t, false>(steps, occ, inertia_in, inertia_out,
                                       f1_in, f2_in, skip, f1, f2, a, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Kernels launched by tf_surface_fused so far.
extern "C" long long tf_surface_launches() { return g_launches; }
