// Event-driven spike matmul — replaces two Pallas kernels of
// repro/kernels/spike_matmul/spike_matmul.py: spike_matmul_pallas
// (skip="dense") and spike_matmul_gated_pallas (skip="gated" and
// "two_level"), for int8 x or packed_in words: out = x @ w in f32. The
// dense skip leaves out every (128-row, bk-column) block of x whose vld_cnt
// is zero; the gated walk visits only the compacted list kmap[row block,
// 0 .. nact) of non-silent blocks (core/events.py::compact_kmap); the
// two-level walk also leaves out every 32-column stripe whose occ bit is
// clear. The three give the same bits (event_gemm.cuh says why). A packed
// x (int32 words of 32 spikes) is expanded in shared memory by
// event_gemm.cuh's packed loader and reads 1/8 of the int8 bytes.
//
// Bound on the H100: at the ResNet shortcut shapes (K = 64..256) the
// product is short, so the f32 output write (4*M*N bytes) and the int8 x
// read weigh against the operations at the 67 TFLOP/s non-tensor f32
// rate; chip_smoke.py reports which term binds at each shape. The design
// shares fused_pe's register-tiled loop (event_gemm.cuh) and writes each
// 8-wide output row of a thread as two 16-byte stores. The autotuner may
// tile N 256 wide; the CTA tile stays 128 wide (N is padded to 256), as a
// matmul emits no per-tile metadata.
#include <cstdint>
#include <cuda_runtime.h>

#include "event_gemm.cuh"

using namespace repro;

template <int XKind, int Skip>
__global__ void __launch_bounds__(kThreads)
spike_matmul_kernel(const void* __restrict__ x, const float* __restrict__ w, Route route,
                    float* __restrict__ out, int kp, int np) {
  __shared__ GemmSmem sm;
  const int row_blk = blockIdx.y, col0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
  event_gemm_tile<XKind, Skip>(x, w, route, kp, np, row_blk, col0, sm, acc);

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int row = row_blk * kTile + ty * kSub + i;
    float* op = out + static_cast<size_t>(row) * np + col0 + tx * kSub;
    *reinterpret_cast<float4*>(op) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(op + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

namespace {

template <int XKind, int Skip>
void launch(const void* x, const float* w, const Route& route, float* out, int mp,
            int kp, int np, cudaStream_t stream) {
  const dim3 grid(np / kTile, mp / kTile);
  spike_matmul_kernel<XKind, Skip><<<grid, kThreads, 0, stream>>>(x, w, route, out, kp, np);
}

}  // namespace

// x [mp, kp] int8 or, with packed_x, [mp, kp/32] int32 words; w [kp, np]
// f32 -> out [mp, np] f32. skip selects the route: kDense reads vld
// [mp/128, kp/bk]; kGated reads nact [mp/128] and kmap [mp/128, kp/bk];
// kTwoLevel also occ [mp/128, kp/bk]. Pointers a route does not read may
// be null.
extern "C" int repro_spike_matmul(const void* x, const float* w, const int* vld,
                                  const int* nact, const int* kmap, const int* occ,
                                  float* out, int mp, int kp, int np, int bk,
                                  int packed_x, int skip, cudaStream_t stream) {
  if (mp > 0 && np > 0) {
    const Route route{vld, nact, kmap, occ, bk};
    using Launch = decltype(&launch<kXInt8, kDense>);
    static const Launch table[2][3] = {
        {&launch<kXInt8, kDense>, &launch<kXInt8, kGated>, &launch<kXInt8, kTwoLevel>},
        {&launch<kXPacked, kDense>, &launch<kXPacked, kGated>, &launch<kXPacked, kTwoLevel>}};
    if (skip < kDense || skip > kTwoLevel) return static_cast<int>(cudaErrorInvalidValue);
    table[packed_x ? 1 : 0][skip](x, w, route, out, mp, kp, np, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
