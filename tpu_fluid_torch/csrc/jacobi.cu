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

__global__ void jacobi_sweep_kernel(const float* __restrict__ q,
                                    const uint8_t* __restrict__ code,
                                    const float* __restrict__ c2e,
                                    float* __restrict__ out, int gx, int gy,
                                    int gz) {
  const long long plane = static_cast<long long>(gy) * gz;
  const long long n = gx * plane;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= n) return;
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
        src, code, c2e, dst, gx, gy, gz);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}
