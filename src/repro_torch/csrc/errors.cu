// The message for a C entry's error code, for the Python wrappers'
// exceptions: every C entry returns cudaGetLastError(), or, for a failed
// tensor-map encode, hopper::kEncodeError plus the CUDA driver API's
// CUresult.
#include <cstdio>
#include <cuda_runtime.h>

#include "hopper.cuh"

extern "C" const char* repro_error_string(int err) {
  if (err >= hopper::kEncodeError) {
    static char msg[96];
    std::snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed: CUresult %d",
                  err - hopper::kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
