// K2: Jacobi pressure sweeps on the water-masked pressure q.
//
// Replaces tpu_fluid/kernels/jacobi.py:_whole_grid_jacobi (kernel
// _whole_grid_kernel).  One sweep is
//     q' = rd * (q[x+1] + q[x-1] + q[y+1] + q[y-1] + q[z+1] + q[z-1]) + c2e
// with zero outside the grid, rd decoded from the u8 aii code exactly as
// _decode_rd does, and c2e = where(rd > 0, c2, q0) folded once.  The TPU
// kernel keeps the whole grid in VMEM for all sweeps; here one launch per
// sweep ping-pongs two buffers, one thread per cell.  At 128^3 the two q
// buffers, c2e (8 MB each) and the code (2 MB) stay inside the 50 MB L2.
//
// Sharded form (jacobi_sweeps_sharded, its _one_pass halo branch and
// _halo_blocks): tf_jacobi_pass runs kk sweeps on an x-slab extended by h >=
// kk neighbour planes on each side (zero planes with code 0 past the
// domain, which stay 0: the single-device zero pad).  Sweep s computes only
// the rows [h - kk + s, nx - h + kk - s), the TPU kernel's trapezoid, so the
// last sweep writes exactly the interior and no sweep reads a row that the
// one before it left stale.  The ghost rows cost (kk - 1) / lx extra work a
// sweep on average.

#include "common.cuh"

namespace {

__global__ void jacobi_fold_kernel(const float* __restrict__ q,
                                   const uint8_t* __restrict__ code,
                                   const float* __restrict__ c2,
                                   float* __restrict__ c2e, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= n) return;
  c2e[i] = code[i] > 0 ? c2[i] : q[i];
}

// One sweep over the cells [begin, end) (whole rows) of a gx-row field.
__global__ void jacobi_sweep_kernel(const float* __restrict__ q,
                                    const uint8_t* __restrict__ code,
                                    const float* __restrict__ c2e,
                                    float* __restrict__ out, int gx, int gy,
                                    int gz, long long begin, long long end) {
  const long long plane = static_cast<long long>(gy) * gz;
  const long long i = begin
                      + blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= end) return;
  const int z = static_cast<int>(i % gz);
  const int y = static_cast<int>((i / gz) % gy);
  const int x = static_cast<int>(i / plane);
  float s = x + 1 < gx ? q[i + plane] : 0.0f;
  s = s + (x > 0 ? q[i - plane] : 0.0f);
  s = s + (y + 1 < gy ? q[i + gz] : 0.0f);
  s = s + (y > 0 ? q[i - gz] : 0.0f);
  s = s + (z + 1 < gz ? q[i + 1] : 0.0f);
  s = s + (z > 0 ? q[i - 1] : 0.0f);
  // _decode_rd: widen the code, then where(code > 0, 1 / max(code, 1), 0)
  const float codef = static_cast<float>(static_cast<int>(code[i]));
  const float rd = codef > 0.0f ? 1.0f / fmaxf(codef, 1.0f) : 0.0f;
  out[i] = rd * s + c2e[i];
}

}  // namespace

// n_iters sweeps from q0; the last sweep writes `out`, `tmp` takes the
// other half of the ping-pong, `c2e` receives the folded constant.
extern "C" int tf_jacobi_sweeps(const float* q0, const uint8_t* code,
                                const float* c2, float* c2e, float* out,
                                float* tmp, int gx, int gy, int gz,
                                int n_iters, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n = static_cast<long long>(gx) * gy * gz;
  if (n == 0) return 0;
  if (n_iters <= 0) {
    cudaMemcpyAsync(out, q0, n * sizeof(float), cudaMemcpyDeviceToDevice,
                    stream);
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned int blocks = tf::blocks_for(n);
  jacobi_fold_kernel<<<blocks, tf::kThreads, 0, stream>>>(q0, code, c2, c2e,
                                                          n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* src = q0;
  for (int s = 0; s < n_iters; ++s) {
    float* dst = ((n_iters - 1 - s) % 2 == 0) ? out : tmp;
    jacobi_sweep_kernel<<<blocks, tf::kThreads, 0, stream>>>(
        src, code, c2e, dst, gx, gy, gz, 0, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

// kk sweeps on the extended slab q (nx = lx + 2h rows, c2e folded over the
// same rows); the last sweep writes the interior rows [h, nx - h) of `out`,
// `tmp` takes the other half of the ping-pong.  Rows of `out` outside the
// interior are left undefined.
extern "C" int tf_jacobi_pass(const float* q, const uint8_t* code,
                              const float* c2e, float* out, float* tmp,
                              int nx, int gy, int gz, int h, int kk,
                              void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long plane = static_cast<long long>(gy) * gz;
  if (kk < 1 || kk > h || nx <= 2 * h) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (plane == 0) return 0;
  const float* src = q;
  for (int s = 1; s <= kk; ++s) {
    const int lo = h - kk + s;
    const int hi = nx - lo;
    float* dst = ((kk - s) % 2 == 0) ? out : tmp;
    jacobi_sweep_kernel<<<tf::blocks_for((hi - lo) * plane), tf::kThreads, 0,
                          stream>>>(src, code, c2e, dst, nx, gy, gz,
                                    lo * plane, hi * plane);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}
