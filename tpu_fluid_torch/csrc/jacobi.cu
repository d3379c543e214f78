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
//   - done) after `done` sweeps) is the same kernel, ceil(kk / 4) launches
//   a pass.
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
// Coordinates come from the launch grid and threadIdx; no cell index is
// divided.  Shared memory above 48 KB is opted into with
// cudaFuncSetAttribute; any error is returned to the wrapper, which raises.

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

// K sweeps of the rows [xs, xe) of an nx-row field, one 32 x 64 tile and
// one x segment a block, two z cells a thread; writes rows [x_lo, x_hi)
// to out row p - out_x0.
template <int K>
__global__ void __launch_bounds__(kTile * kTile, 1)
    jacobi_march_kernel(const float* __restrict__ q,
                        const uint8_t* __restrict__ code,
                        const float* __restrict__ c2e,
                        float* __restrict__ out, int nx, int gy, int gz,
                        int xs, int xe, int seg, int out_x0) {
  // [2][K][kPairPlane] sweep planes (a zero row above and below the
  // tile), then rd by code value [256]
  extern __shared__ float smem[];
  float* const rd_of = smem + 2 * K * kPairPlane;
  constexpr int kInnerY = kTile - 2 * K;
  constexpr int kInnerZ = kPairZ - 2 * K;
  const int tx = threadIdx.x;  // the lane: cells z = 2 tx and 2 tx + 1
  const int ty = threadIdx.y;
  const int me = (ty + 1) * kPairZ + 2 * tx;
  const int y = blockIdx.y * kInnerY - K + ty;
  const int za = blockIdx.x * kInnerZ - K + 2 * tx;
  const bool in_y = y >= 0 && y < gy;
  const bool in_a = in_y && za >= 0 && za < gz;
  const bool in_b = in_y && za + 1 >= 0 && za + 1 < gz;
  const bool inner_y = ty >= K && ty < kTile - K;
  const bool inner_a = in_a && inner_y && 2 * tx >= K && 2 * tx < kPairZ - K;
  const bool inner_b =
      in_b && inner_y && 2 * tx + 1 >= K && 2 * tx + 1 < kPairZ - K;
  for (int i = ty * kTile + tx; i < 2 * K * kPairPlane; i += kTile * kTile) {
    smem[i] = 0.0f;
  }
  for (int i = ty * kTile + tx; i < 256; i += kTile * kTile) {
    rd_of[i] = decode_rd(static_cast<uint8_t>(i));
  }
  __syncthreads();
  const long long plane = static_cast<long long>(gy) * gz;
  // cell a's offset in a plane (cell b's is the next); only read where the
  // cell lies in the grid
  const long long yz = in_y ? static_cast<long long>(y) * gz + za : 0;
  const int x_lo = xs + blockIdx.z * seg;
  const int x_hi = min(x_lo + seg, xe);
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

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

template <int K>
cudaError_t launch_march(const float* q, const uint8_t* code,
                         const float* c2e, float* out, int nx, int gy,
                         int gz, int xs, int xe, int seg, int out_x0,
                         cudaStream_t stream) {
  auto kernel = jacobi_march_kernel<K>;
  const size_t bytes = (2 * K * kPairPlane + 256) * sizeof(float);
  const cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  constexpr int kInnerY = kTile - 2 * K;
  constexpr int kInnerZ = kPairZ - 2 * K;
  const dim3 grid((gz + kInnerZ - 1) / kInnerZ, (gy + kInnerY - 1) / kInnerY,
                  (xe - xs + seg - 1) / seg);
  kernel<<<grid, dim3(kTile, kTile), bytes, stream>>>(
      q, code, c2e, out, nx, gy, gz, xs, xe, seg, out_x0);
  ++g_launches;
  return cudaGetLastError();
}

cudaError_t launch_march_k(int k, const float* q, const uint8_t* code,
                           const float* c2e, float* out, int nx, int gy,
                           int gz, int xs, int xe, int seg, int out_x0,
                           cudaStream_t stream) {
#define TF_MARCH(K)                                                        \
  case K:                                                                  \
    return launch_march<K>(q, code, c2e, out, nx, gy, gz, xs, xe, seg,     \
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

// A single-device solve on the blocked route (kernels/tiling.py
// jacobi_plan): n_iters / k passes of k sweeps, then a pass of the
// remaining n_iters % k, each one launch over all nx rows in segments of
// seg_k (seg_rem) rows; the last writes `out`, `tmp` takes the other half
// of the ping-pong.
extern "C" int tf_jacobi_blocked(const float* q0, const uint8_t* code,
                                 const float* c2e, float* out, float* tmp,
                                 int nx, int gy, int gz, int n_iters, int k,
                                 int seg_k, int seg_rem, void* stream_ptr) {
  if (n_iters < 1 || k < 1 || k > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int full = n_iters / k;
  const int passes = full + (n_iters % k ? 1 : 0);
  const float* src = q0;
  for (int i = 0; i < passes; ++i) {
    float* dst = (passes - 1 - i) % 2 == 0 ? out : tmp;
    const bool rest = i == full;
    const int err = tf_jacobi_march(src, code, c2e, dst, nx, gy, gz, 0, nx,
                                    rest ? seg_rem : seg_k, 0,
                                    rest ? n_iters % k : k, stream_ptr);
    if (err != 0) return err;
    src = dst;
  }
  return 0;
}

// Kernels launched by tf_jacobi_whole and tf_jacobi_march so far.
extern "C" long long tf_jacobi_launches() { return g_launches; }
