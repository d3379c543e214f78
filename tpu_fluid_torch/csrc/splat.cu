// The facade's z-buffered splat: particle sprites and surface-lattice
// samples resolved into an (H, W, 3) u8 image by a depth kernel and a
// colour kernel, between a fill and a composite pass.
//
// Replaces no Pallas kernel.  The JAX package draws this frame with XLA
// scatters inside one jitted frame (tpu_fluid/render/splat.py:215-223: a
// scatter-min of depth, then a scatter-max of packed colour, once a sample
// pass).  The port has no jitted frame: its plain version
// (render/splat.py) expands 3 surface lattices into sample tensors (a
// chain of f64 elementwise ops for the fused multiply-adds, a nonzero
// compaction a lattice) and dispatches 32 sample passes -- the lattices
// and the footprint offsets of the sprites -- each twice, every pass a
// dozen eager elementwise ops on 1M-element tensors and a scatter_reduce,
// whose float amin loops a compare-and-swap under contention.
//
// What bounds it.  Bytes first: the function needs the positions and
// active flags (13 bytes a particle), the mesh (36 bytes of vertices and
// 12 of normal a triangle slot, its validity and the refinement's ids)
// read once and the image written (3 bytes a pixel): some 26 MB at 1M
// particles, 400,000 slots and 1400^2, 0.008 ms at 3.35 TB/s.  This design
// moves more: both kernels read the inputs, and two w*h int32 buffers are
// filled, read and written.  Then atomic contention: 1M particles land on
// the few hundred thousand pixels their cube covers, and 6.63M lattice
// samples on the surface's.  The design:
//  - one thread a particle projects it once, in registers (the plain
//    version's per-pass tensors of px, py, bounds and indices are never
//    written), and walks its sprite footprint itself; the footprint is the
//    wrapper's table of offsets {(dx, dy) : dx^2 + dy^2 <= rmax^2}, ordered
//    by distance from the centre, so the walk stops at the first offset
//    outside the sprite's radius (every later one is outside too);
//  - one thread a lattice sample, in the same launch as the particles,
//    each lattice pass its own run of blocks (up to kMaxLattice of them):
//    the pass's table gives the slot's triangle (its ids, or the slot
//    itself) and whether it is sampled, and the thread computes its
//    barycentric point, the projection and the triangle's shaded colour in
//    registers (some 40 flops against the 25 bytes a sample the plain
//    lattice tensors held), so no sample is ever written to memory;
//  - a read before each atomic: the depth minimum and the colour maximum
//    only ever move one way, so a sample whose value the buffer already
//    beats (or equals) changes nothing and skips its atomic.  A stale read
//    is never wrong: it can only be larger (depth) or smaller (colour) than
//    the buffer is now, which sends the sample to the atomic.
//
// Why atomicMin on the bit pattern is exactly the plain version's amin.
// A sample reaches the depth buffer only if it is valid, which includes
// being in front of the camera: its depth w > 1e-6, so it is positive (or
// +inf).  The buffer starts at INF_DEPTH (3.4e38) and only ever holds such
// depths.  For non-negative floats (+inf included; no NaN reaches it) the
// order of the values is the order of their bit patterns as signed 32-bit
// integers, so atomicMin on the bits is the float minimum.  A sample the
// plain version does not admit scatters INF_DEPTH (depth) or 0 (colour)
// onto pixel 0, which changes nothing there; here it is simply skipped.
// Both reductions are order-independent (a minimum, and a maximum of
// integer words), so the image is the plain version's bit for bit in any
// order of the atomics.
//
// Arithmetic, in the plain version's order with -fmad=false (no a*b+c
// contraction, see kernels/build.py): a lattice point is the barycentric
// (a, b, c) / S, each weight the float of the double quotient (numpy's
// float32 of Python's i / S), combined as b0 * v0, then fmaf(b1, v1, .)
// and fmaf(b2, v2, .) (render/splat.py:_lattice_points; ops/rounding.fma
// is the plain version's correctly rounded fused multiply-add); the
// triangle's colour is dot = n0 * l0, then fmaf over n1 l1 and n2 l2,
// lam = max(-dot, 0) with a NaN kept (torch.clamp), fmaf(lam, diffuse,
// ambient) a channel; the projection adds its four terms
// pairwise, ((x m0 + y m1) + (z m2 + m3)), divides by w (IEEE), and maps
// ndc * 0.5 + 0.5 times the viewport; the sprite size chain is
// min(base / max(w, 1e-6), max_size), then 0.5 * size * scale clamped to
// [0, radius], then r = max(r_px, 0.5), r2 = r * r; an offset is lit where
// dx^2 + dy^2 <= r2 (the centre always); the pixel is
// float_to_index(floor(px + dx)) -- a NaN to 0, beyond the int32 range
// saturated -- inside [0, w) x [0, h).  A sample wins its pixel where
// depth <= buf * (1 + tol), the factor rounded to float as PyTorch's
// tensor-scalar product rounds it, and writes its packed colour
// (clamp(c * 255, 0, 255), NaN as 0, truncated; r << 16 | g << 8 | b, and
// the hit bit 30) by atomicMax.
//
// The counting instantiation (kCount) adds, a kernel, the samples tested
// against the buffer and those that reached an atomic (and, in the colour
// kernel, the winners; in the depth kernel, the lattice samples generated
// from a selected valid triangle, which the plain passes hold); the main
// path never launches it.

#include <cstring>

#include "common.cuh"

namespace {

long long g_launches = 0;  // kernels launched by this file, all calls

constexpr int kHit = 1 << 30;

// Lattice passes a frame takes: the surface's base lattice and its two
// finer ones (render/splat.py:surface_tables).
constexpr int kMaxLattice = 3;

// Counters of the counting instantiation.
enum Count {
  kDepthTested,
  kDepthAtomics,
  kColorTested,
  kColorWon,
  kColorAtomics,
  kLatticeSamples
};

// A lattice pass: `slots` triangle slots, each sampled at the `samples` =
// (subdiv + 1)(subdiv + 2) / 2 points of its barycentric lattice; thread
// i of the pass takes sample i % samples of slot i / samples.
struct Lattice {
  const long long* ids;  // the slot's triangle; null: slot k is triangle k
  const uint8_t* valid;  // (slots,): the slot is sampled
  long long n;           // slots * samples
  int subdiv;
  int samples;
};

struct Frame {
  // particles
  const float* pos;
  const uint8_t* active;
  long long np;
  const float* mvp;  // (4, 4) row-major
  const int* offsets;  // (n_offsets, 2): the footprint, nearest first
  int n_offsets;
  float base, max_size, scale, radius;
  int scaled;  // 1: r_px = clamp(0.5 * size * scale, 0, radius); 0: radius
  float color[3];  // every particle's
  // the mesh: tris (T, 3, 3), normals (T, 3); the lattice passes over
  // it: pass s has the blocks [lblock[s], lblock[s + 1]) after the
  // particles'
  const float* tris;
  const float* normals;
  Lattice lattice[kMaxLattice];
  long long lblock[kMaxLattice + 1];
  int n_lattice;
  // the surface's shading: the unit light direction, ambient, diffuse
  float light[3], ambient[3], diffuse[3];
  // the viewport
  int width, height;
  float factor;  // (1 + tol) rounded to float
};

// float_to_index(x, int32) of a floored value: a NaN to 0, saturated
// beyond the range
__device__ __forceinline__ int to_index32(float x) {
  if (isnan(x)) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x < -2147483648.0f) return -2147483647 - 1;
  return static_cast<int>(x);
}

// The pixel of (x, y), or -1 where it lies off the viewport.
__device__ __forceinline__ long long pixel(float x, float y, int w, int h) {
  const int xi = to_index32(floorf(x));
  const int yi = to_index32(floorf(y));
  if (xi < 0 || xi >= w || yi < 0 || yi >= h) return -1;
  return static_cast<long long>(yi) * w + xi;
}

// torch.clamp(x, min=lo) and (x, max=hi): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

// A channel of the packed colour: clamp(c * 255, 0, 255), NaN as 0, to
// int32 by truncation.
__device__ __forceinline__ int channel(float c) {
  const float v = tf::clamp_nan(c * 255.0f, 0.0f, 255.0f);
  return isnan(v) ? 0 : static_cast<int>(v);
}

__device__ __forceinline__ int pack(float r, float g, float b) {
  return (channel(r) << 16) | (channel(g) << 8) | channel(b) | kHit;
}

// A point projected as render/splat.py:project does it: its pixel
// coordinates, its view depth w, whether it is in front (w > 1e-6), and
// max(w, 1e-6).
struct Projected {
  float px, py, d, wc;
  bool front;
};

__device__ __forceinline__ Projected project(const Frame& f, float x,
                                             float y, float z) {
  const float* m = f.mvp;
  float clip[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    clip[i] = (x * __ldg(m + 4 * i) + y * __ldg(m + 4 * i + 1)) +
              (z * __ldg(m + 4 * i + 2) + __ldg(m + 4 * i + 3));
  }
  Projected q;
  q.d = clip[3];
  q.front = q.d > 1e-6f;
  q.wc = clamp_min(q.d, 1e-6f);
  q.px = (clip[0] / q.wc * 0.5f + 0.5f) * static_cast<float>(f.width);
  q.py = (clip[1] / q.wc * 0.5f + 0.5f) * static_cast<float>(f.height);
  return q;
}

// A particle projected, and its squared sprite radius.
struct Particle {
  Projected q;
  float r2;
};

__device__ __forceinline__ Particle project_particle(const Frame& f,
                                                     long long p) {
  Particle pt;
  pt.q = project(f, f.pos[3 * p], f.pos[3 * p + 1], f.pos[3 * p + 2]);
  const float wc = pt.q.wc;
  float r_px = f.radius;
  if (f.scaled) {
    const float size = clamp_max(f.base / wc, f.max_size);
    r_px = tf::clamp_nan(0.5f * size * f.scale, 0.0f, f.radius);
  }
  const float r = clamp_min(r_px, 0.5f);
  pt.r2 = r * r;
  return pt;
}

// Sample s of a triangle's lattice of subdivision S: the barycentric
// weights (a, b, S - a - b) / S of render/splat.py:_bary_lattice, a-major.
__device__ __forceinline__ void bary_weights(int s, int S, float w[3]) {
  int a = 0, start = 0;
  while (s >= start + S + 1 - a) {
    start += S + 1 - a;
    ++a;
  }
  const int b = s - start;
  const double q = static_cast<double>(S);
  w[0] = static_cast<float>(static_cast<double>(a) / q);
  w[1] = static_cast<float>(static_cast<double>(b) / q);
  w[2] = static_cast<float>(static_cast<double>(S - a - b) / q);
}

// Each sample of the frame, as (pixel, depth, packed colour): a particle's
// lit footprint offsets, or one lattice sample.  `visit` returns nothing.
// Returns whether the thread generated a lattice sample of a selected
// valid triangle.
template <typename Visit>
__device__ __forceinline__ bool for_samples(const Frame& f, long long pblocks,
                                            Visit visit) {
  const long long b = blockIdx.x;
  if (b < pblocks) {
    const long long p = b * tf::kThreads + threadIdx.x;
    if (p >= f.np || !f.active[p]) return false;
    const Particle pt = project_particle(f, p);
    const Projected& q = pt.q;
    if (!q.front) return false;
    const int word = pack(f.color[0], f.color[1], f.color[2]);
    for (int k = 0; k < f.n_offsets; ++k) {
      const int dx = __ldg(f.offsets + 2 * k);
      const int dy = __ldg(f.offsets + 2 * k + 1);
      const bool centre = dx == 0 && dy == 0;
      // nearest first: the first offset outside the sprite ends the walk
      if (!centre && !(static_cast<float>(dx * dx + dy * dy) <= pt.r2)) {
        break;
      }
      const long long idx =
          centre ? pixel(q.px, q.py, f.width, f.height)
                 : pixel(q.px + static_cast<float>(dx),
                         q.py + static_cast<float>(dy), f.width, f.height);
      if (idx >= 0) visit(idx, q.d, word);
    }
    return false;
  }
  // the block's pass, chosen by constant indices (no local copy)
  const long long lb = b - pblocks;
  Lattice l = f.lattice[0];
  long long first = 0;
#pragma unroll
  for (int s = 1; s < kMaxLattice; ++s) {
    if (s < f.n_lattice && lb >= f.lblock[s]) {
      l = f.lattice[s];
      first = f.lblock[s];
    }
  }
  const long long i = (lb - first) * tf::kThreads + threadIdx.x;
  if (i >= l.n) return false;
  // the pass's size is the block's, so the branch is uniform
  long long slot;
  int s;
  if (l.n <= 0xffffffffLL) {
    const unsigned int u = static_cast<unsigned int>(i);
    const unsigned int q = u / static_cast<unsigned int>(l.samples);
    slot = q;
    s = static_cast<int>(u - q * static_cast<unsigned int>(l.samples));
  } else {
    slot = i / l.samples;
    s = static_cast<int>(i - slot * l.samples);
  }
  if (!l.valid[slot]) return false;
  const long long tri = l.ids ? __ldg(l.ids + slot) : slot;
  float w[3];
  bary_weights(s, l.subdiv, w);
  const float* v = f.tris + 9 * tri;
  float pt[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    pt[d] = w[0] * __ldg(v + d);
    pt[d] = fmaf(w[1], __ldg(v + 3 + d), pt[d]);
    pt[d] = fmaf(w[2], __ldg(v + 6 + d), pt[d]);
  }
  const Projected q = project(f, pt[0], pt[1], pt[2]);
  if (!q.front) return true;
  const long long idx = pixel(q.px, q.py, f.width, f.height);
  if (idx < 0) return true;
  // the triangle's flat shade: ambient + max(0, dot(-L, N)) * diffuse
  const float* n = f.normals + 3 * tri;
  float dot = __ldg(n) * f.light[0];
  dot = fmaf(__ldg(n + 1), f.light[1], dot);
  dot = fmaf(__ldg(n + 2), f.light[2], dot);
  const float lam = clamp_min(-dot, 0.0f);
  visit(idx, q.d,
        pack(fmaf(lam, f.diffuse[0], f.ambient[0]),
             fmaf(lam, f.diffuse[1], f.ambient[1]),
             fmaf(lam, f.diffuse[2], f.ambient[2])));
  return true;
}

// Adds a thread's counts to the counters, one atomic a warp.
__device__ __forceinline__ void add_count(unsigned long long* counts,
                                          int which, unsigned long long n) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) n += __shfl_down_sync(0xffffffffu, n, s);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(counts + which, n);
}

template <bool kCount>
__global__ void __launch_bounds__(tf::kThreads)
    depth_kernel(Frame f, long long pblocks, int* __restrict__ depth,
                 unsigned long long* counts) {
  unsigned long long tested = 0, atomics = 0;
  const bool lattice = for_samples(f, pblocks, [&](long long idx, float d,
                                                   int) {
    const int bits = __float_as_int(d);
    if (kCount) ++tested;
    if (__ldcg(depth + idx) > bits) {
      atomicMin(depth + idx, bits);
      if (kCount) ++atomics;
    }
  });
  if (kCount) {
    add_count(counts, kDepthTested, tested);
    add_count(counts, kDepthAtomics, atomics);
    add_count(counts, kLatticeSamples, lattice ? 1 : 0);
  }
}

template <bool kCount>
__global__ void __launch_bounds__(tf::kThreads)
    color_kernel(Frame f, long long pblocks, const int* __restrict__ depth,
                 int* __restrict__ color, unsigned long long* counts) {
  unsigned long long tested = 0, won = 0, atomics = 0;
  for_samples(f, pblocks, [&](long long idx, float d, int word) {
    if (kCount) ++tested;
    if (!(d <= __int_as_float(depth[idx]) * f.factor)) return;
    if (kCount) ++won;
    if (__ldcg(color + idx) < word) {
      atomicMax(color + idx, word);
      if (kCount) ++atomics;
    }
  });
  if (kCount) {
    add_count(counts, kColorTested, tested);
    add_count(counts, kColorWon, won);
    add_count(counts, kColorAtomics, atomics);
  }
}

__global__ void __launch_bounds__(tf::kThreads)
    fill_kernel(int* __restrict__ depth, int* __restrict__ color,
                long long n, int inf_bits) {
  const long long i = blockIdx.x * static_cast<long long>(tf::kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  depth[i] = inf_bits;
  color[i] = 0;
}

// The hit pixels' unpacked colour, the background elsewhere.
__global__ void __launch_bounds__(tf::kThreads)
    composite_kernel(const int* __restrict__ color,
                     uint8_t* __restrict__ image, long long n, uchar3 bg) {
  const long long i = blockIdx.x * static_cast<long long>(tf::kThreads) +
                      threadIdx.x;
  if (i >= n) return;
  const int c = color[i];
  const bool hit = (c >> 30) & 1;
  image[3 * i] = hit ? static_cast<uint8_t>((c >> 16) & 0xFF) : bg.x;
  image[3 * i + 1] = hit ? static_cast<uint8_t>((c >> 8) & 0xFF) : bg.y;
  image[3 * i + 2] = hit ? static_cast<uint8_t>(c & 0xFF) : bg.z;
}

}  // namespace

// One frame: depth and color are w*h int32 scratch buffers, image the
// (h, w, 3) u8 output.  tris (T, 3, 3) and normals (T, 3) are the mesh;
// lattice, in host memory, holds n_lattice rows of 4 (the ids pointer, 0
// for slot k = triangle k; the validity pointer; slots; subdiv), one a
// lattice pass; light, ambient (a*) and diffuse (d*) shade it.  counts
// null launches the main path's kernels; else the counting instantiation,
// adding into counts[0..5] (depth tested, depth atomics, colour tested,
// colour won, colour atomics, lattice samples).
extern "C" int tf_splat(const float* pos, const uint8_t* active,
                        long long np, const float* mvp, const int* offsets,
                        int n_offsets, float base, float max_size,
                        float scale, float radius, int scaled, float pr,
                        float pg, float pb, const float* tris,
                        const float* normals, const long long* lattice,
                        int n_lattice, float lx, float ly, float lz,
                        float ar, float ag, float ab, float dr, float dg,
                        float db, int width, int height, float factor,
                        float inf_depth, int bg_r, int bg_g, int bg_b,
                        int* depth, int* color, uint8_t* image,
                        unsigned long long* counts, void* stream_ptr) {
  if (width < 1 || height < 1 || np < 0 || n_offsets < 0 ||
      n_lattice < 0 || n_lattice > kMaxLattice ||
      (n_lattice > 0 && (!tris || !normals))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n = static_cast<long long>(width) * height;
  Frame f{};
  f.pos = pos;
  f.active = active;
  f.np = np;
  f.mvp = mvp;
  f.offsets = offsets;
  f.n_offsets = n_offsets;
  f.base = base;
  f.max_size = max_size;
  f.scale = scale;
  f.radius = radius;
  f.scaled = scaled;
  f.color[0] = pr;
  f.color[1] = pg;
  f.color[2] = pb;
  f.tris = tris;
  f.normals = normals;
  f.n_lattice = n_lattice;
  f.light[0] = lx;
  f.light[1] = ly;
  f.light[2] = lz;
  f.ambient[0] = ar;
  f.ambient[1] = ag;
  f.ambient[2] = ab;
  f.diffuse[0] = dr;
  f.diffuse[1] = dg;
  f.diffuse[2] = db;
  f.width = width;
  f.height = height;
  f.factor = factor;
  for (int s = 0; s < n_lattice; ++s) {
    const long long* row = lattice + 4 * s;
    const long long slots = row[2];
    const long long subdiv = row[3];
    // a slot's samples, (subdiv + 1)(subdiv + 2) / 2, fit an int up to
    // subdiv 65534
    if (!row[1] || slots < 0 || subdiv < 1 || subdiv > 65534) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int samples = static_cast<int>((subdiv + 1) * (subdiv + 2) / 2);
    f.lattice[s] = Lattice{reinterpret_cast<const long long*>(row[0]),
                           reinterpret_cast<const uint8_t*>(row[1]),
                           slots * samples, static_cast<int>(subdiv),
                           samples};
    f.lblock[s + 1] = f.lblock[s] + tf::blocks_for(slots * samples);
  }
  int inf_bits;
  std::memcpy(&inf_bits, &inf_depth, sizeof inf_bits);
  fill_kernel<<<tf::blocks_for(n), tf::kThreads, 0, stream>>>(
      depth, color, n, inf_bits);
  ++g_launches;
  const long long pblocks = tf::blocks_for(np);
  const long long blocks = pblocks + f.lblock[n_lattice];
  if (blocks > 0) {
    const auto depth_k = counts ? depth_kernel<true> : depth_kernel<false>;
    const auto color_k = counts ? color_kernel<true> : color_kernel<false>;
    depth_k<<<static_cast<unsigned int>(blocks), tf::kThreads, 0, stream>>>(
        f, pblocks, depth, counts);
    color_k<<<static_cast<unsigned int>(blocks), tf::kThreads, 0, stream>>>(
        f, pblocks, depth, color, counts);
    g_launches += 2;
  }
  const uchar3 bg = make_uchar3(static_cast<unsigned char>(bg_r),
                                static_cast<unsigned char>(bg_g),
                                static_cast<unsigned char>(bg_b));
  composite_kernel<<<tf::blocks_for(n), tf::kThreads, 0, stream>>>(
      color, image, n, bg);
  ++g_launches;
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long tf_splat_launches() { return g_launches; }
