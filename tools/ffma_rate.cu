// The f32 FMA rate the card sustains on the CUDA cores for the float-x
// tile's shape of work: each thread an 8 x 8 outer product a k, operands in
// registers (no loads), one CTA an SM on all 132 SMs, 4, 8, 12 or 16 warps a
// CTA. It is the ceiling the float-x tile (src/repro_torch/csrc/
// event_gemm.cuh), whose step adds 128 shared-memory loads to 2048 FMAs a
// thread, is measured against (PERF.md §6).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/ffma_rate tools/ffma_rate.cu
//   build/ffma_rate
#include <cstdio>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(512, 1) ffma_rate(float* out, int iters) {
  float acc[8][8];
  float a[8], b[8];
  for (int i = 0; i < 8; ++i) {
    a[i] = threadIdx.x * 1e-3f + i;
    b[i] = i * 0.5f;
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      b[k % 8] += 1e-7f;   // keeps the products from being hoisted
    }
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int sms = 0, khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * sms * 512);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 2000;
  for (int threads = 128; threads <= 512; threads += 128) {
    ffma_rate<<<sms, threads>>>(out, 10);   // warm-up
    cudaEventRecord(e0);
    ffma_rate<<<sms, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    const double flop = 2.0 * sms * threads * double(iters) * 32 * 64;
    const double peak = 2.0 * 128 * sms * (khz * 1e3);   // 128 FMA lanes an SM
    printf("[ffma_rate] %d warps an SM: %.3f ms, %.2f TFLOP/s, %.1f %% of %.1f TFLOP/s "
           "(128 FMA a clock an SM at %d MHz) (%s)\n",
           threads / 32, ms, flop / (ms * 1e-3) / 1e12, 100.0 * flop / (ms * 1e-3) / peak,
           peak / 1e12, khz / 1000, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
