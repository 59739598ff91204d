// The CUDA runtime's message for an error code, for the Python wrappers'
// exceptions (every C entry of the library returns cudaGetLastError()).
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
