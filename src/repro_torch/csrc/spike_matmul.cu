// Event-driven spike matmul, dense skip — replaces the Pallas kernel
// repro/kernels/spike_matmul/spike_matmul.py::spike_matmul_pallas
// (skip="dense", int8 x or packed_in words): out = x @ w in f32, with every
// 128x128 (m, k) block whose vld_cnt is zero neither loaded nor multiplied.
// A packed x (int32 words of 32 spikes) is expanded in shared memory by
// event_gemm.cuh's packed loader and reads 1/8 of the int8 bytes.
//
// Bound on the H100: at the ResNet shortcut shapes (K = 64..256) the
// product is short, so the f32 output write (4*M*N bytes) and the int8 x
// read weigh against the operations at the 67 TFLOP/s non-tensor f32
// rate; chip_smoke.py reports which term binds at each shape. The design
// shares fused_pe's register-tiled loop (event_gemm.cuh) and writes each
// 8-wide output row of a thread as two 16-byte stores.
#include <cstdint>
#include <cuda_runtime.h>

#include "event_gemm.cuh"

using namespace repro;

template <bool PackedX>
__global__ void __launch_bounds__(kThreads)
spike_matmul_kernel(const void* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ vld, float* __restrict__ out,
                    int kp, int np) {
  __shared__ GemmSmem sm;
  const int row_blk = blockIdx.y, col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
  event_gemm_tile<PackedX>(x, w, vld, kp, np, row_blk, col0, sm, acc);

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int row = row_blk * kTile + ty * kSub + i;
    float* op = out + static_cast<size_t>(row) * np + col0 + tx * kSub;
    *reinterpret_cast<float4*>(op) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(op + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// x [mp, kp] int8 or, with packed_x, [mp, kp/32] int32 words; w [kp, np]
// f32, vld [mp/128, kp/128] int32 -> out [mp, np] f32.
extern "C" int repro_spike_matmul(const void* x, const float* w, const int* vld,
                                  float* out, int mp, int kp, int np,
                                  int packed_x, cudaStream_t stream) {
  if (mp > 0 && np > 0) {
    const dim3 grid(np / kTile, mp / kTile);
    if (packed_x)
      spike_matmul_kernel<true><<<grid, kThreads, 0, stream>>>(x, w, vld, out, kp, np);
    else
      spike_matmul_kernel<false><<<grid, kThreads, 0, stream>>>(x, w, vld, out, kp, np);
  }
  return static_cast<int>(cudaGetLastError());
}
