// The message of a cudaError_t returned by one of the library's entry points,
// so the Python wrappers can raise with CUDA's own words.

#include <cuda_runtime.h>

extern "C" const char* dasmtl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
