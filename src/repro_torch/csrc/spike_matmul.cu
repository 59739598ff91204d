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
// matmul emits no per-tile metadata. A launch of at most kDecodeRows live
// rows on the dense skip (the LM's wo at a decode tick or a prefill chunk)
// takes the decode route (decode_gemm.cuh): 16-column CTAs over the live
// rows, the f32 weight streamed once through a cp.async ring, the same
// sums; the rows past the live ones are written as zeros, as the tile
// route's zero rows of x give.
#include <cstdint>
#include <cuda_runtime.h>

#include "decode_gemm.cuh"
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

// the decode route: each consumer thread writes its TR x TC outputs
// (DecodeGemm's rows and columns), then the CTA zeroes its columns of the
// rows up to mp
template <int XKind, int RM>
__global__ void __launch_bounds__(kDecodeThreads, 1)
spike_matmul_decode_kernel(const void* __restrict__ x, const float* __restrict__ w,
                           Route route, float* __restrict__ out, int mp, int kp, int np,
                           int m_valid) {
  using G = DecodeGemm<XKind, RM>;
  extern __shared__ __align__(16) unsigned char dsm[];
  constexpr int kRows = 16 * RM;
  const int col0 = blockIdx.x * kDecodeCols;
  const int tid = threadIdx.x;
  G gemm{dsm, x, w, kp, np, col0, m_valid, 0};
  gemm.start(route.vld, route.bk);
  float acc[G::kTR][G::kTC];
  gemm.run(acc, [] {});
  if (tid < G::kConsumers) {
    const int c = tid % G::kColGroups, rg = tid / G::kColGroups;
#pragma unroll
    for (int i = 0; i < G::kTR; ++i) {
      *reinterpret_cast<float2*>(out + static_cast<size_t>(rg + G::kRowGroups * i) * np +
                                 col0 + G::kTC * c) = make_float2(acc[i][0], acc[i][1]);
    }
  }
  for (int i = tid; i < (mp - kRows) * (kDecodeCols / 4); i += kDecodeThreads) {
    const int row = kRows + i / (kDecodeCols / 4), p = i % (kDecodeCols / 4);
    *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * np + col0 + 4 * p) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

namespace {

using Launch = void (*)(const void*, const float*, const Route&, float*, int, int, int,
                        int, cudaStream_t);

template <int XKind, int Skip>
void launch(const void* x, const float* w, const Route& route, float* out, int mp,
            int kp, int np, int, cudaStream_t stream) {
  const dim3 grid(np / kTile, mp / kTile);
  spike_matmul_kernel<XKind, Skip><<<grid, kThreads, 0, stream>>>(x, w, route, out, kp, np);
}

template <int XKind, int RM>
void launch_decode(const void* x, const float* w, const Route& route, float* out, int mp,
                   int kp, int np, int m_valid, cudaStream_t stream) {
  const auto kernel = spike_matmul_decode_kernel<XKind, RM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDecodeMaxSmem);
  (void)attr;  // a refusal shows as the launch's own error
  launch_decode_kernel(kernel, np, decode_smem_bytes<XKind, RM>(kp), stream, x, w, route,
                       out, mp, kp, np, m_valid);
}

}  // namespace

// x [mp, kp] int8 or, with packed_x, [mp, kp/32] int32 words; w [kp, np]
// f32 -> out [mp, np] f32. skip selects the route: kDense reads vld
// [mp/128, kp/bk]; kGated reads nact [mp/128] and kmap [mp/128, kp/bk];
// kTwoLevel also occ [mp/128, kp/bk]. Pointers a route does not read may
// be null. route kRouteDecode (decode_gemm.cuh) takes the dense skip and
// m_valid <= kDecodeRows live rows: x needs only those rows, mp is the
// padded output's (a multiple of 128), and vld may be null (every block
// kept); the tile route ignores m_valid.
extern "C" int repro_spike_matmul(const void* x, const float* w, const int* vld,
                                  const int* nact, const int* kmap, const int* occ,
                                  float* out, int mp, int kp, int np, int bk,
                                  int packed_x, int skip, int route, int m_valid,
                                  cudaStream_t stream) {
  const bool decode = route == kRouteDecode;
  if (skip < kDense || skip > kTwoLevel || (route != kRouteTile && !decode) ||
      (decode && (skip != kDense || m_valid < 0 || m_valid > kDecodeRows ||
                  m_valid > mp || np % kDecodeCols)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mp > 0 && np > 0) {
    const Route r{vld, nact, kmap, occ, bk};
    static const Launch table[2][3] = {
        {&launch<kXInt8, kDense>, &launch<kXInt8, kGated>, &launch<kXInt8, kTwoLevel>},
        {&launch<kXPacked, kDense>, &launch<kXPacked, kGated>, &launch<kXPacked, kTwoLevel>}};
    static const Launch decode_table[2][2] = {
        {&launch_decode<kXInt8, 1>, &launch_decode<kXInt8, 4>},
        {&launch_decode<kXPacked, 1>, &launch_decode<kXPacked, 4>}};
    const Launch fn = decode ? decode_table[packed_x ? 1 : 0][m_valid <= 16 ? 0 : 1]
                             : table[packed_x ? 1 : 0][skip];
    fn(x, w, r, out, mp, kp, np, m_valid, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
