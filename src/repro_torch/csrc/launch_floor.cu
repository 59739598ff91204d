// An empty kernel: replaces no TPU kernel. chip_smoke.py times its launch
// under the same harness as the kernel rows (``[timing] launch floor``), so
// that a row whose bound lies under the cost of a launch can be read
// against that cost.
#include <cuda_runtime.h>

extern "C" __global__ void empty_kernel() {}

// one launch of one warp on `stream`
extern "C" int repro_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
