// K2: Jacobi pressure sweeps on the water-masked pressure q.
//
// Replaces tpu_fluid/kernels/jacobi.py:_whole_grid_jacobi (kernel
// _whole_grid_kernel), the slab branch _one_pass, and the sharded
// jacobi_sweeps_sharded.  One sweep is
//     q' = rd * (q[x+1] + q[x-1] + q[y+1] + q[y-1] + q[z+1] + q[z-1]) + c2e
// with a literal 0.0f added for each neighbour outside the grid (skipping
// the add would change the bits of a -0.0 sum), rd decoded from the u8 aii
// code exactly as _decode_rd does, and c2e = where(rd > 0, c2, q0) folded
// once a solve by K2f (csrc/jacobi_fold.cu) before the sweeps.  Built with
// -fmad=false: rd * s + c2e rounds twice, as the plain version does, and
// the two agree bitwise.
//
// What bounds it: 7 flops a cell a sweep against 13 bytes a cell a sweep
// if every sweep streams q, c2e and the code through device memory, as
// one launch per sweep did (199 launches a solve; at 256^3 the 218 MB
// working set is four times the L2).  Both TPU kernels keep the sweeps of
// a call on chip, and so do both routes here:
//
// - Whole grid (jacobi_whole_kernel): where the grid fits one block of up
//   to 1024 threads (kernels/tiling.py whole_grid_parts: each (y, z)
//   column cut into at most 12-row chunks, two copies of q in shared
//   memory; e.g. 20^3), each thread keeps its chunk of a column in
//   registers, with its rd and c2e, and all n sweeps run in one launch
//   with one __syncthreads() a sweep: each sweep stores the chunk to shared
//   memory (double-buffered) and reads the y/z neighbours and the rows
//   past the chunk's ends back.  The TPU's _whole_grid_kernel, taken
//   literally, on one SM: its bound there is the SM's shared-memory and
//   issue rate, not device memory.
// - Blocked (jacobi_march_kernel): temporal blocking for larger grids.  A
//   block of 32 x 32 threads owns a 32 x 64-cell y-z tile, two z cells a
//   thread, with a K-cell halo (kernels/tiling.py plans it), for up to
//   K = 4 sweeps a launch (tiling.BLOCKED_K: at 1024 threads a block, two
//   cells fill the 64 registers a thread).  The block marches along its
//   segment of x, one plane a step.  Sweep s computes plane t - s at step
//   t, from sweep s - 1's planes t - s + 1 (this step), t - s (the
//   shared-memory plane written last step, for its y neighbours; the z
//   neighbours come from the pair's registers and the next lanes' by warp
//   shuffles) and t - s - 1 (a register).  Each sweep loses one ring of the
//   tile, so only the inner cells of sweep K are written; each x segment
//   starts K planes early and ends K planes late.  A pass reads q, c2e and
//   the code once and writes q once: 13 bytes a cell for K sweeps, plus the
//   halos' re-reads, which come mostly from the L2.  The sharded pass
//   (tf_jacobi_march on an extended slab, rows [h - kk + done, nx - h + kk
//   - done) after `done` sweeps) is that kernel, one block a box, ceil(kk
//   / 4) launches a pass.
// - Listed (tf_jacobi_blocked, the single-device solve): the same march
//   body on the boxes of a device-built list.  A sweep leaves a cell with
//   code 0 at 0 * sum + c2e, which is c2e bit for bit while the sum is
//   finite and c2e is not -0.0; so from the first sweep on a box with no
//   cell of code > 0 holds c2e whatever its neighbours hold, and only the
//   boxes that hold water with a non-solid neighbour change.  Once a solve
//   jacobi_live_scan_kernel writes c2e into both ping-pong buffers and
//   flags each box (an inner tile of the K = 4 geometry times a segment of
//   kernels/tiling.py live_segment_rows rows) that holds such a cell, and
//   jacobi_live_list_kernel compacts the flags into a list, in box order,
//   and its count.  Every pass (the remainder pass of fewer sweeps too, on
//   the same boxes: its tile keeps 4 rings, of which it needs fewer)
//   launches one block an SM, and each block marches the listed boxes
//   blockIdx.x, blockIdx.x + gridDim.x, ...; a live box reads c2e from the
//   dead boxes around it, as the dense march would find there.  The guard
//   (tiling.py live_boxes): the sums stay finite while every iterate stays
//   below 2^128 / 6, and for K2f's inputs |q| <= |q0| + n max|c2e| within
//   rounding (code counts every neighbour whose q can be non-zero, and q0
//   is c2e where the code is 0); where a c2e, or a q0 where the code is >
//   0, is not finite or exceeds 2^100 in magnitude, a cell with code 0 has
//   c2e = -0.0, or a solve has 2^20 sweeps or more, the list holds every
//   box, and the result is the dense march's, bitwise.  What bounds it:
//   the live boxes; with every box live a pass costs no more rounds x
//   planes than the dense launch (live_segment_rows), and the list costs a
//   read of the codes and c2e and, in the dead boxes, the two fills: 13
//   bytes a dead cell, 5 a live one, once a solve.
//
// What bounds the march on the card is instruction issue, not memory (the
// SASS of a one-cell K = 4 step was about 130 instructions a thread for 28
// flops): each step's plane loads are issued a step ahead, so their
// latency does not sit between two barriers; every position computes every
// sweep without a branch; the shared planes have zero rows, so no y
// neighbour read is tested; rd comes from a 256-entry table of the code;
// and a level costs a warp 6 shared-memory wavefronts and 2 shuffles for
// 64 cells, where a cell a thread took 10 wavefronts for 32.
//
// The march's coordinates come from its box and threadIdx; no cell index
// is divided (the list scan divides each run of 4 cells' number twice).
// Shared memory above 48 KB is opted into with cudaFuncSetAttribute; any
// error is returned to the wrapper, which raises.

#include "common.cuh"

namespace {

constexpr int kTile = 32;                // kernels/tiling.py TILE
constexpr int kWholeThreads = 1024;      // kernels/tiling.py WHOLE_THREADS
constexpr int kWholeMaxChunk = 12;       // kernels/tiling.py WHOLE_MAX_CHUNK
// the march: kernels/tiling.py BLOCKED_K, PAIR_TILE_Z
constexpr int kMaxLevels = 4;
constexpr int kPairZ = 2 * kTile;
// a plane in shared memory: the tile and a row of zeros above and below it
// that is never written, so a y neighbour past the tile reads 0 untested
constexpr int kPairPlane = (kTile + 2) * kPairZ;

long long g_launches = 0;  // kernels launched by this file, all calls

// _decode_rd: widen the code, then where(code > 0, 1 / max(code, 1), 0)
__device__ __forceinline__ float decode_rd(uint8_t code) {
  const float codef = static_cast<float>(static_cast<int>(code));
  return codef > 0.0f ? 1.0f / fmaxf(codef, 1.0f) : 0.0f;
}

// All n_iters sweeps in one block: thread (part, yz) owns the rows
// [part * chunk, part * chunk + chunk) of column yz in registers, with
// their rd and c2e; shared memory holds two copies of q, each plane with a
// ring of zeros around it that is never written, so the y and z neighbours
// are read without a test.  The launch has parts * gy * gz threads.
template <int kMaxChunk>
__global__ void __launch_bounds__(kWholeThreads, 1)
    jacobi_whole_kernel(const float* __restrict__ q0,
                        const uint8_t* __restrict__ code,
                        const float* __restrict__ c2e,
                        float* __restrict__ out, int gx, int gy, int gz,
                        int chunk, int n_iters) {
  extern __shared__ float smem[];
  const int plane = gy * gz;
  const int pz = gz + 2;
  const int pplane = (gy + 2) * pz;
  const int n = gx * pplane;
  const int part = threadIdx.x / plane;  // once a solve
  const int yz = threadIdx.x - part * plane;
  const int y = yz / gz;
  const int z = yz - y * gz;
  const int x0 = part * chunk;
  const int rows = min(chunk, gx - x0);
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) smem[i] = 0.0f;
  float q[kMaxChunk], rd[kMaxChunk], ce[kMaxChunk];
#pragma unroll
  for (int j = 0; j < kMaxChunk; ++j) {
    q[j] = 0.0f;
    rd[j] = 0.0f;
    ce[j] = 0.0f;
    if (j < rows) {
      const int i = (x0 + j) * plane + yz;
      q[j] = q0[i];
      rd[j] = decode_rd(code[i]);
      ce[j] = c2e[i];
    }
  }
  const int base = x0 * pplane + (y + 1) * pz + z + 1;
  __syncthreads();
  for (int s = 0; s < n_iters; ++s) {
    float* const buf = smem + (s & 1) * n;
#pragma unroll
    for (int j = 0; j < kMaxChunk; ++j) {
      if (j < rows) buf[base + j * pplane] = q[j];
    }
    __syncthreads();
    // q[x - 1] before this sweep; the row past the chunk's end
    float left = x0 > 0 ? buf[base - pplane] : 0.0f;
    const float right = x0 + rows < gx ? buf[base + rows * pplane] : 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxChunk; ++j) {
      if (j < rows) {
        const int i = base + j * pplane;
        const float old = q[j];
        float sum = j + 1 < rows ? q[j + 1 < kMaxChunk ? j + 1 : j] : right;
        sum = sum + left;
        sum = sum + buf[i + pz];
        sum = sum + buf[i - pz];
        sum = sum + buf[i + 1];
        sum = sum + buf[i - 1];
        q[j] = rd[j] * sum + ce[j];
        left = old;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxChunk; ++j) {
    if (j < rows) out[(x0 + j) * plane + yz] = q[j];
  }
}

// A box of the march: the tile's first position (y0, z0), which may lie
// before the grid, and the output rows [x_lo, x_hi).
struct Box {
  int y0, z0, x_lo, x_hi;
};

// The march body: K sweeps of one box, one 32 x 64 tile, two z cells a
// thread; writes the box's rows to out row p - out_x0, the cells of the
// tile but its kRing >= K outer rings.  smem holds the [2][K][kPairPlane]
// sweep planes (a zero row above and below the tile, which no step writes),
// then rd_of.  A block may march several boxes in turn: a box's first steps
// read what the box before left in the planes, and only into positions
// outside its x trapezoid or before the grid, which are not written.
template <int K, int kRing>
__device__ __forceinline__ void march_box(const float* __restrict__ q,
                                          const uint8_t* __restrict__ code,
                                          const float* __restrict__ c2e,
                                          float* __restrict__ out, int nx,
                                          int gy, int gz, int out_x0,
                                          const Box box, float* smem,
                                          const float* rd_of) {
  const int tx = threadIdx.x;  // the lane: cells z = 2 tx and 2 tx + 1
  const int ty = threadIdx.y;
  const int me = (ty + 1) * kPairZ + 2 * tx;
  const int y = box.y0 + ty;
  const int za = box.z0 + 2 * tx;
  const bool in_y = y >= 0 && y < gy;
  const bool in_a = in_y && za >= 0 && za < gz;
  const bool in_b = in_y && za + 1 >= 0 && za + 1 < gz;
  const bool inner_y = ty >= kRing && ty < kTile - kRing;
  const bool inner_a =
      in_a && inner_y && 2 * tx >= kRing && 2 * tx < kPairZ - kRing;
  const bool inner_b =
      in_b && inner_y && 2 * tx + 1 >= kRing && 2 * tx + 1 < kPairZ - kRing;
  const long long plane = static_cast<long long>(gy) * gz;
  // cell a's offset in a plane (cell b's is the next); only read where the
  // cell lies in the grid
  const long long yz = in_y ? static_cast<long long>(y) * gz + za : 0;
  const int x_lo = box.x_lo;
  const int x_hi = box.x_hi;
  const int t_begin = max(x_lo - K, 0);
  const int t_end = x_hi + K;
  const int t_load = min(t_end, nx);

  float h1a[K], h2a[K], h1b[K], h2b[K];
  float rda[K + 1], cea[K + 1], rdb[K + 1], ceb[K + 1];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    h1a[s] = h2a[s] = h1b[s] = h2b[s] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s <= K; ++s) {
    rda[s] = cea[s] = rdb[s] = ceb[s] = 0.0f;
  }
  // q, code and c2e of both cells at plane t + 1, loaded a step ahead
  float pqa = 0.0f, pqb = 0.0f, pca = 0.0f, pcb = 0.0f;
  int pda = 0, pdb = 0;
  int load_t = t_begin;
  long long load_at = load_t * plane + yz;
  long long out_at = (t_begin - K - out_x0) * plane + yz;
  auto load = [&]() {
    const bool live = load_t < t_load;
    pqa = pqb = pca = pcb = 0.0f;
    pda = pdb = 0;
    if (live && in_a) {
      pqa = q[load_at];
      pda = code[load_at];
      pca = c2e[load_at];
    }
    if (live && in_b) {
      pqb = q[load_at + 1];
      pdb = code[load_at + 1];
      pcb = c2e[load_at + 1];
    }
    ++load_t;
    load_at += plane;
  };
  load();
  const float* last = smem;
  float* next = smem + K * kPairPlane;
  for (int t = t_begin; t < t_end; ++t) {
#pragma unroll
    for (int s = K; s > 0; --s) {
      rda[s] = rda[s - 1];
      cea[s] = cea[s - 1];
      rdb[s] = rdb[s - 1];
      ceb[s] = ceb[s - 1];
    }
    float va = pqa, vb = pqb;  // sweep 0 (the input) at plane t
    const int cda = pda, cdb = pdb;
    cea[0] = pca;
    ceb[0] = pcb;
    load();  // the next plane's loads go out before this plane's table reads
    rda[0] = rd_of[cda];
    rdb[0] = rd_of[cdb];
    *reinterpret_cast<float2*>(next + me) = make_float2(va, vb);
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      const float* lv = last + (s - 1) * kPairPlane;  // sweep s-1, t-s
      const float2 up = *reinterpret_cast<const float2*>(lv + me + kPairZ);
      const float2 dn = *reinterpret_cast<const float2*>(lv + me - kPairZ);
      // sweep s-1 at plane t-s of the cells left of a and right of b
      const float left = __shfl_up_sync(0xffffffffu, h1b[s - 1], 1);
      const float right = __shfl_down_sync(0xffffffffu, h1a[s - 1], 1);
      float sa = va;          // x+1: sweep s-1 at plane t-s+1, this step
      sa = sa + h2a[s - 1];   // x-1
      sa = sa + up.x;
      sa = sa + dn.x;
      sa = sa + h1b[s - 1];   // z+1
      sa = sa + left;         // z-1
      float sb = vb;
      sb = sb + h2b[s - 1];
      sb = sb + up.y;
      sb = sb + dn.y;
      sb = sb + right;
      sb = sb + h1a[s - 1];
      const bool row = t - s >= 0 && t - s < nx;
      const float wa = row && in_a ? rda[s] * sa + cea[s] : 0.0f;
      const float wb = row && in_b ? rdb[s] * sb + ceb[s] : 0.0f;
      h2a[s - 1] = h1a[s - 1];
      h1a[s - 1] = va;
      h2b[s - 1] = h1b[s - 1];
      h1b[s - 1] = vb;
      va = wa;
      vb = wb;
      if (s < K) {
        *reinterpret_cast<float2*>(next + s * kPairPlane + me) =
            make_float2(wa, wb);
      }
    }
    const int p = t - K;  // va, vb: sweep K at plane p
    if (p >= x_lo && p < x_hi) {
      if (inner_a) out[out_at] = va;
      if (inner_b) out[out_at + 1] = vb;
    }
    out_at += plane;
    __syncthreads();
    const float* const swap = next;
    next = const_cast<float*>(last);
    last = swap;
  }
}

// Where a block of jacobi_march_kernel finds its boxes: those numbered
// first(), first() + step(), ... below end(), each box at(i).

// The dense launch: one box a block, from the block's index (the tiles of
// K rings; segment blockIdx.z of seg rows of [xs, xe)).
template <int K>
struct BlockBoxes {
  static constexpr int kRing = K;
  int xs, xe, seg;
  __device__ int first() const { return 0; }
  __device__ int end() const { return 1; }
  __device__ int step() const { return 1; }
  __device__ Box at(int) const {
    const int x_lo = xs + static_cast<int>(blockIdx.z) * seg;
    return Box{static_cast<int>(blockIdx.y) * (kTile - 2 * K) - K,
               static_cast<int>(blockIdx.x) * (kPairZ - 2 * K) - K, x_lo,
               min(x_lo + seg, xe)};
  }
};

// The listed launch: the boxes list[0 .. *count) over the launch's blocks;
// box b is the inner tile (b % tiles_z, b / tiles_z % tiles_y) of the
// kMaxLevels-ring geometry times segment b / (tiles_z tiles_y) of seg rows
// of [0, nx).
struct ListedBoxes {
  static constexpr int kRing = kMaxLevels;
  const int* list;
  const int* count;
  int tiles_z, tiles_y, seg, nx;
  __device__ int first() const { return static_cast<int>(blockIdx.x); }
  __device__ int end() const { return *count; }
  __device__ int step() const { return static_cast<int>(gridDim.x); }
  __device__ Box at(int i) const {
    const int b = list[i];
    const int rest = b / tiles_z;
    const int x_lo = rest / tiles_y * seg;
    return Box{(rest % tiles_y) * (kTile - 2 * kRing) - kRing,
               (b % tiles_z) * (kPairZ - 2 * kRing) - kRing, x_lo,
               min(x_lo + seg, nx)};
  }
};

// K sweeps of each box of `boxes` of an nx-row field, 32 x 32 threads.
template <int K, class Boxes>
__global__ void __launch_bounds__(kTile * kTile, 1)
    jacobi_march_kernel(const float* __restrict__ q,
                        const uint8_t* __restrict__ code,
                        const float* __restrict__ c2e,
                        float* __restrict__ out, int nx, int gy, int gz,
                        int out_x0, const Boxes boxes) {
  const int end = boxes.end();
  if (boxes.first() >= end) return;
  // [2][K][kPairPlane] sweep planes, then rd by code value [256]
  extern __shared__ float smem[];
  float* const rd_of = smem + 2 * K * kPairPlane;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < 2 * K * kPairPlane; i += kTile * kTile) {
    smem[i] = 0.0f;
  }
  for (int i = tid; i < 256; i += kTile * kTile) {
    rd_of[i] = decode_rd(static_cast<uint8_t>(i));
  }
  __syncthreads();
  for (int i = boxes.first(); i < end; i += boxes.step()) {
    march_box<K, Boxes::kRing>(q, code, c2e, out, nx, gy, gz, out_x0,
                               boxes.at(i), smem, rd_of);
  }
}

// The listed geometry and guard: kernels/tiling.py LIVE_LIMIT,
// LIVE_MAX_SWEEPS.
constexpr int kLiveInnerY = kTile - 2 * kMaxLevels;
constexpr int kLiveInnerZ = kPairZ - 2 * kMaxLevels;
constexpr float kLiveLimit = 1.2676506002282294e30f;  // 2^100
constexpr int kLiveMaxSweeps = 1 << 20;
constexpr int kScanThreads = 512;

// v cells along z from p (V of them, 16-byte aligned where V is 4)
template <int V>
__device__ __forceinline__ void load_cells(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_cells(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// The codes of V cells, one a byte (4-byte aligned where V is 4).
template <int V>
__device__ __forceinline__ uint32_t load_codes(const uint8_t* p) {
  if constexpr (V == 4) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    return *p;
  }
}

__device__ __forceinline__ bool past_limit(float v) {
  return !(fabsf(v) <= kLiveLimit);  // NaN too
}

// One box, all threads of the block: `rows` rows (x, y) of `items` runs of
// V cells along z from z0.  Returns its flag (jacobi_live_scan_kernel).
template <int V>
__device__ __forceinline__ int scan_box(const float* __restrict__ q0,
                                        const uint8_t* __restrict__ code,
                                        const float* __restrict__ c2e,
                                        float* __restrict__ fill_a,
                                        float* __restrict__ fill_b, int gy,
                                        int gz, int x0, int y0, int z0,
                                        int ny, int rows, int items) {
  const int n = rows * items;
  const auto at = [&](int it) {
    const int row = it / items;
    const int dx = row / ny;
    return (static_cast<long long>(x0 + dx) * gy + y0 + (row - dx * ny)) *
               gz + z0 + (it - row * items) * V;
  };
  bool live = false;
#pragma unroll 4
  for (int it = threadIdx.x; it < n; it += kScanThreads) {
    live |= load_codes<V>(code + at(it)) != 0;
  }
  live = __syncthreads_or(live);
  bool inexact = false;
#pragma unroll 4
  for (int it = threadIdx.x; it < n; it += kScanThreads) {
    const long long i = at(it);
    float c[V];
    load_cells<V>(c2e + i, c);
    if (!live) {  // every code of the box is 0
#pragma unroll
      for (int v = 0; v < V; ++v) {
        inexact |= past_limit(c[v]) || __float_as_uint(c[v]) == 0x80000000u;
      }
      if (fill_a) store_cells<V>(fill_a + i, c);
      if (fill_b) store_cells<V>(fill_b + i, c);
    } else {
      const uint32_t d = load_codes<V>(code + i);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool open = (d >> (8 * v)) & 0xffu;
        inexact |= past_limit(c[v]) ||
                   (open ? past_limit(q0[i + v])
                         : __float_as_uint(c[v]) == 0x80000000u);
      }
    }
  }
  inexact = __syncthreads_or(inexact);
  return (live ? 1 : 0) | (inexact ? 2 : 0);
}

// One block a box b (ListedBoxes' numbering): flags[b] = 1 if a cell of
// the box has code > 0, | 2 if a c2e of the box is not finite or exceeds
// kLiveLimit in magnitude, a cell with code 0 has c2e = -0.0, or a cell
// with code > 0 has such a q0 (where the code is 0, K2f's q0 is c2e).  A
// box with no cell of code > 0 has its c2e written to fill_a and fill_b
// where they are not null; a live box is written by every pass.  It reads
// the codes, then c2e (and q0 where the code is > 0) 4 cells a load where
// `vec` (gz a multiple of 4, the pointers 16-byte aligned).
__global__ void __launch_bounds__(kScanThreads)
    jacobi_live_scan_kernel(const float* __restrict__ q0,
                            const uint8_t* __restrict__ code,
                            const float* __restrict__ c2e,
                            float* __restrict__ fill_a,
                            float* __restrict__ fill_b, int nx, int gy,
                            int gz, int tiles_z, int tiles_y, int seg,
                            int vec, int* __restrict__ flags) {
  const int b = blockIdx.x;
  const int rest = b / tiles_z;
  const int z0 = (b % tiles_z) * kLiveInnerZ;
  const int y0 = (rest % tiles_y) * kLiveInnerY;
  const int x0 = rest / tiles_y * seg;
  const int ny = min(kLiveInnerY, gy - y0);
  const int rows = min(seg, nx - x0) * ny;
  const int nz = min(kLiveInnerZ, gz - z0);
  const int flag =
      vec ? scan_box<4>(q0, code, c2e, fill_a, fill_b, gy, gz, x0, y0, z0,
                        ny, rows, nz / 4)
          : scan_box<1>(q0, code, c2e, fill_a, fill_b, gy, gz, x0, y0, z0,
                        ny, rows, nz);
  if (threadIdx.x == 0) flags[b] = flag;
}

// One block of 1024 threads: list[0 .. n) the boxes whose flag has bit 0,
// in order, and list[total] = n; every box where a flag has bit 1 or the
// solve has kLiveMaxSweeps sweeps or more.
__global__ void __launch_bounds__(1024)
    jacobi_live_list_kernel(const int* __restrict__ flags, int total,
                            int n_iters, int* __restrict__ list) {
  __shared__ int warp_sums[32];
  bool inexact = n_iters >= kLiveMaxSweeps;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    inexact |= (flags[i] & 2) != 0;
  }
  const bool all = __syncthreads_or(inexact);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int base = 0;  // boxes listed before this chunk, the same in each thread
  for (int c = 0; c < total; c += blockDim.x) {
    const int i = c + threadIdx.x;
    const bool live = i < total && (all || (flags[i] & 1) != 0);
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_sums[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warps' counts
      int v = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      warp_sums[lane] = v;
    }
    __syncthreads();
    if (live) {
      list[base + (warp ? warp_sums[warp - 1] : 0) +
           __popc(ballot & ((1u << lane) - 1u))] = i;
    }
    base += warp_sums[31];
    __syncthreads();
  }
  if (threadIdx.x == 0) list[total] = base;
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

template <int K, class Boxes>
cudaError_t launch_march(const float* q, const uint8_t* code,
                         const float* c2e, float* out, int nx, int gy,
                         int gz, int out_x0, const Boxes& boxes, dim3 grid,
                         cudaStream_t stream) {
  auto kernel = jacobi_march_kernel<K, Boxes>;
  const size_t bytes = (2 * K * kPairPlane + 256) * sizeof(float);
  const cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, dim3(kTile, kTile), bytes, stream>>>(q, code, c2e, out, nx,
                                                      gy, gz, out_x0, boxes);
  ++g_launches;
  return cudaGetLastError();
}

// The dense launch: one block a box of the K-ring tiles.
template <int K>
cudaError_t launch_dense(const float* q, const uint8_t* code,
                         const float* c2e, float* out, int nx, int gy,
                         int gz, int xs, int xe, int seg, int out_x0,
                         cudaStream_t stream) {
  constexpr int kInnerY = kTile - 2 * K;
  constexpr int kInnerZ = kPairZ - 2 * K;
  const dim3 grid((gz + kInnerZ - 1) / kInnerZ, (gy + kInnerY - 1) / kInnerY,
                  (xe - xs + seg - 1) / seg);
  return launch_march<K>(q, code, c2e, out, nx, gy, gz, out_x0,
                         BlockBoxes<K>{xs, xe, seg}, grid, stream);
}

cudaError_t launch_march_k(int k, const float* q, const uint8_t* code,
                           const float* c2e, float* out, int nx, int gy,
                           int gz, int xs, int xe, int seg, int out_x0,
                           cudaStream_t stream) {
#define TF_MARCH(K)                                                        \
  case K:                                                                  \
    return launch_dense<K>(q, code, c2e, out, nx, gy, gz, xs, xe, seg,     \
                           out_x0, stream);
  switch (k) {
    TF_MARCH(1)
    TF_MARCH(2)
    TF_MARCH(3)
    TF_MARCH(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef TF_MARCH
}

// The listed launch: `blocks` blocks over the listed boxes.
cudaError_t launch_listed_k(int k, const float* q, const uint8_t* code,
                            const float* c2e, float* out, int nx, int gy,
                            int gz, const ListedBoxes& boxes, int blocks,
                            cudaStream_t stream) {
#define TF_LISTED(K)                                                       \
  case K:                                                                  \
    return launch_march<K>(q, code, c2e, out, nx, gy, gz, 0, boxes,        \
                           dim3(blocks), stream);
  switch (k) {
    TF_LISTED(1)
    TF_LISTED(2)
    TF_LISTED(3)
    TF_LISTED(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef TF_LISTED
}

// The listed boxes of an (nx, gy, gz) solve in segments of seg rows, their
// list and count in scratch.
ListedBoxes listed_boxes(const int* scratch, int nx, int gy, int gz,
                         int seg) {
  const int tiles_z = (gz + kLiveInnerZ - 1) / kLiveInnerZ;
  const int tiles_y = (gy + kLiveInnerY - 1) / kLiveInnerY;
  const int total = tiles_z * tiles_y * ((nx + seg - 1) / seg);
  return ListedBoxes{scratch, scratch + total, tiles_z, tiles_y, seg, nx};
}

}  // namespace

// All n_iters >= 1 sweeps from q0 in one launch (the one-block route):
// `parts` threads a (y, z) column, each with ceil(gx / parts) <= 12 rows
// (kernels/tiling.py whole_grid_parts).
extern "C" int tf_jacobi_whole(const float* q0, const uint8_t* code,
                               const float* c2e, float* out, int gx, int gy,
                               int gz, int parts, int n_iters,
                               void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int plane = gy * gz;
  if (gx < 1 || plane < 1 || parts < 1 || parts > gx ||
      parts * plane > kWholeThreads || n_iters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunk = (gx + parts - 1) / parts;
  if (chunk > kWholeMaxChunk || (parts - 1) * chunk >= gx) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = jacobi_whole_kernel<kWholeMaxChunk>;
  const size_t bytes =
      2 * static_cast<size_t>(gx) * (gy + 2) * (gz + 2) * sizeof(float);
  const cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, parts * plane, bytes, stream>>>(q0, code, c2e, out, gx, gy,
                                              gz, chunk, n_iters);
  ++g_launches;
  return static_cast<int>(cudaGetLastError());
}

// One blocked pass of k <= 4 sweeps (kernels/tiling.py Pass): rows [xs, xe)
// of the nx-row input q to out row p - out_x0, in segments of seg rows.
extern "C" int tf_jacobi_march(const float* q, const uint8_t* code,
                               const float* c2e, float* out, int nx, int gy,
                               int gz, int xs, int xe, int seg, int out_x0,
                               int k, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (k < 1 || k > kMaxLevels || xs < 0 || xe > nx || xs >= xe ||
      seg < 1 || out_x0 > xs || gy < 1 || gz < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_march_k(k, q, code, c2e, out, nx, gy, gz,
                                         xs, xe, seg, out_x0, stream));
}

// The live boxes of a single-device solve of n_iters sweeps in segments of
// seg rows (kernels/tiling.py live_boxes), in scratch's 2 * boxes + 1
// ints: the list, its count, then the flags.  c2e is written into fill_a
// and fill_b where they are not null.
extern "C" int tf_jacobi_live(const float* q0, const uint8_t* code,
                              const float* c2e, float* fill_a,
                              float* fill_b, int* scratch, int nx, int gy,
                              int gz, int seg, int n_iters,
                              void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nx < 1 || gy < 1 || gz < 1 || seg < 1 || n_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ListedBoxes boxes = listed_boxes(scratch, nx, gy, gz, seg);
  const int total = static_cast<int>(boxes.count - boxes.list);
  int* const flags = scratch + total + 1;
  if (fill_b == fill_a) fill_b = nullptr;
  const uintptr_t wide = reinterpret_cast<uintptr_t>(q0) |
                         reinterpret_cast<uintptr_t>(c2e) |
                         reinterpret_cast<uintptr_t>(fill_a) |
                         reinterpret_cast<uintptr_t>(fill_b);
  const int vec = gz % 4 == 0 && wide % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(code) % 4 == 0;
  jacobi_live_scan_kernel<<<total, kScanThreads, 0, stream>>>(
      q0, code, c2e, fill_a, fill_b, nx, gy, gz, boxes.tiles_z,
      boxes.tiles_y, seg, vec, flags);
  ++g_launches;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  jacobi_live_list_kernel<<<1, 1024, 0, stream>>>(flags, total, n_iters,
                                                  scratch);
  ++g_launches;
  return static_cast<int>(cudaGetLastError());
}

// A single-device solve on the blocked route (kernels/tiling.py
// jacobi_plan, listed): the live boxes (tf_jacobi_live, which fills out
// and tmp with c2e), then n_iters / k passes of k sweeps and a pass of the
// remaining n_iters % k, each `blocks` blocks over the listed boxes; the
// last pass writes `out`, `tmp` takes the other half of the ping-pong.
extern "C" int tf_jacobi_blocked(const float* q0, const uint8_t* code,
                                 const float* c2e, float* out, float* tmp,
                                 int* scratch, int nx, int gy, int gz,
                                 int n_iters, int k, int seg, int blocks,
                                 void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_iters < 1 || k < 1 || k > kMaxLevels || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = tf_jacobi_live(q0, code, c2e, out, tmp, scratch, nx, gy, gz,
                           seg, n_iters, stream_ptr);
  if (err != 0) return err;
  const ListedBoxes boxes = listed_boxes(scratch, nx, gy, gz, seg);
  const int full = n_iters / k;
  const int passes = full + (n_iters % k ? 1 : 0);
  const float* src = q0;
  for (int i = 0; i < passes; ++i) {
    float* dst = (passes - 1 - i) % 2 == 0 ? out : tmp;
    err = static_cast<int>(launch_listed_k(i == full ? n_iters % k : k, src,
                                           code, c2e, dst, nx, gy, gz, boxes,
                                           blocks, stream));
    if (err != 0) return err;
    src = dst;
  }
  return 0;
}

// Kernels launched by tf_jacobi_whole, tf_jacobi_march, tf_jacobi_live and
// tf_jacobi_blocked so far.
extern "C" long long tf_jacobi_launches() { return g_launches; }
