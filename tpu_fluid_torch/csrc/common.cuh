// Helpers shared by the port's kernels.  Built with -fmad=false (see
// kernels/build.py): every a*b+c below rounds twice, as the plain PyTorch
// versions do.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tf {

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// jnp.clip / torch.clamp on finite values: min(max(x, lo), hi)
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// torch.clamp and jnp.clip on any value: a NaN stays NaN, where fminf and
// fmaxf would return a bound
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : clampf(x, lo, hi);
}

// ops/indexing.float_to_index: a NaN converts to 0; the conversion
// saturates beyond the 64-bit range
__device__ __forceinline__ long long to_index(float x) {
  return isnan(x) ? 0 : static_cast<long long>(x);
}

}  // namespace tf
