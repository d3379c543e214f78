#include <cuda_runtime.h>

extern "C" const char* tf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
