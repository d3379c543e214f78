// K2f: the pressure solve's inputs, folded in one pass over the grid.
//
// Replaces no TPU kernel: the JAX package leaves this fold to XLA
// (tpu_fluid/stages/pressure.py jacobi_stats and poisson_solve), and plain
// PyTorch takes about 75 elementwise passes over the grid for it.  Its
// plain version is kernels/jacobi.py jacobi_fold_plain; the x-slab route
// runs it on the slab extended by one halo plane of the types.
// Per cell, with the six neighbours of the Jacobi stencil and a neighbour
// outside the grid counted as neither SOLID nor WATER:
//     rhs   = div * scale
//     aii   = neighbours that are not SOLID
//     n_air = neighbours that are neither SOLID nor WATER
//     c2    = (n_air * boundary - rhs) / max(aii, 1)
//     code  = WATER and aii > 0 ? aii : 0          (u8)
//     q0    = WATER ? boundary : 0
//     c2e   = code > 0 ? c2 : q0
// and q0, code and c2e are written.  Built with -fmad=false and IEEE
// division, each step rounds as its PyTorch op does, and the result equals
// kernels/jacobi.py jacobi_fold_plain bitwise; the counts are small
// integers, exact in f32, so their order is free.  Cell type codes:
// core/types.py (WATER = 2, SOLID = 3).
//
// What bounds it: bytes.  It reads the u8 types and the f32 div and writes
// q0, c2e (f32) and the u8 code: 14 bytes a cell, 235 MB at 256^3, 0.070
// ms at 3.35 TB/s, against a few integer compares and 5 float operations a
// cell.  A block of 32 x 8 threads covers 32 z by 8 y cells of 4
// consecutive x planes, one column of 4 cells a thread: a warp's loads and
// stores are 32 consecutive cells of one row, and the column's own types
// and its x neighbours (6 rows for 4 cells) stay in registers.  The y and
// z neighbours' types are read through the read-only path; the rows above
// and below and the lanes beside are the same cache lines the block's
// other warps read, so the types come from device memory about once.
// Coordinates come from the launch grid; no cell index is divided.

#include "common.cuh"

namespace {

constexpr int kZ = 32;   // threads along z, one cell each
constexpr int kY = 8;    // threads along y
constexpr int kX = 4;    // cells along x a thread
// core/types.py CellType
constexpr int kWater = 2;
constexpr int kSolid = 3;
// what a neighbour outside the grid reads as: neither SOLID nor WATER
constexpr int kOutside = 0;

long long g_launches = 0;  // kernels launched by this file, all calls

__global__ void __launch_bounds__(kZ * kY)
    jacobi_fold_kernel(const uint8_t* __restrict__ types,
                       const float* __restrict__ div, float scale,
                       float boundary, float* __restrict__ q0,
                       uint8_t* __restrict__ code, float* __restrict__ c2e,
                       int gx, int gy, int gz) {
  const int z = blockIdx.x * kZ + threadIdx.x;
  const int y = blockIdx.y * kY + threadIdx.y;
  const int x0 = blockIdx.z * kX;
  if (z >= gz || y >= gy) return;
  const long long plane = static_cast<long long>(gy) * gz;
  const long long at0 = x0 * plane + static_cast<long long>(y) * gz + z;
  // the column's types at rows x0 - 1 .. x0 + kX
  int col[kX + 2];
#pragma unroll
  for (int j = 0; j < kX + 2; ++j) {
    const int x = x0 - 1 + j;
    col[j] = x >= 0 && x < gx ? types[at0 + (j - 1) * plane] : kOutside;
  }
#pragma unroll
  for (int j = 0; j < kX; ++j) {
    if (x0 + j >= gx) break;
    const long long i = at0 + j * plane;
    const int nb[6] = {col[j + 2], col[j],
                       y + 1 < gy ? types[i + gz] : kOutside,
                       y > 0 ? types[i - gz] : kOutside,
                       z + 1 < gz ? types[i + 1] : kOutside,
                       z > 0 ? types[i - 1] : kOutside};
    int aii = 0, n_air = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      aii += nb[k] != kSolid;
      n_air += nb[k] != kSolid && nb[k] != kWater;
    }
    const float rhs = div[i] * scale;
    const float c2 = (static_cast<float>(n_air) * boundary - rhs) /
                     fmaxf(static_cast<float>(aii), 1.0f);
    const bool water = col[j + 1] == kWater;
    const int cd = water && aii > 0 ? aii : 0;
    const float q = water ? boundary : 0.0f;
    q0[i] = q;
    code[i] = static_cast<uint8_t>(cd);
    c2e[i] = cd > 0 ? c2 : q;
  }
}

}  // namespace

// The fold of a gx x gy x gz grid in one launch.
extern "C" int tf_jacobi_fold(const uint8_t* types, const float* div,
                              float scale, float boundary, float* q0,
                              uint8_t* code, float* c2e, int gx, int gy,
                              int gz, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long planes = (static_cast<long long>(gx) + kX - 1) / kX;
  if (gx < 1 || gy < 1 || gz < 1 || planes > 65535 ||
      (gy + kY - 1) / kY > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((gz + kZ - 1) / kZ, (gy + kY - 1) / kY,
                  static_cast<unsigned int>(planes));
  jacobi_fold_kernel<<<grid, dim3(kZ, kY), 0, stream>>>(
      types, div, scale, boundary, q0, code, c2e, gx, gy, gz);
  ++g_launches;
  return static_cast<int>(cudaGetLastError());
}

// Kernels launched by tf_jacobi_fold so far.
extern "C" long long tf_jacobi_fold_launches() { return g_launches; }
