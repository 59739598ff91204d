// Fused PE layer: the float-x tile's launches (fused_pe.cuh,
// event_gemm.cuh) of a dense f32 or bf16 activation x, the LM's
// ops.dense_lif projections, with the emitted current or without. They live
// in a source of their own so that nvcc compiles them in parallel with the
// other variants.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "fused_pe.cuh"

namespace repro {

namespace {

template <int XKind, bool EmitCurrent>
int float_launch(FloatTileArgs& a, const void* x, const float* w, cudaStream_t stream) {
  const auto kernel = fused_pe_float_kernel<XKind, EmitCurrent>;
  static int resident = 0;   // CTAs of this instance one SM holds at once
  static int sms = 0;
  if (resident == 0) {
    int dev = 0;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFloatSmem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kFloatThreads,
                                                          kFloatSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  int err = hopper::encode_2d(&a.wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, a.np, a.kp,
                              4ull * a.np, kFloatCols, kStep, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0 && a.m > 0)   // with no rows the walk loads nothing
    err = XKind == kXF32
              ? hopper::encode_2d(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, a.kp, a.m,
                                  4ull * a.kp, kStep, kFloatRows, CU_TENSOR_MAP_SWIZZLE_128B)
              : hopper::encode_2d(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, a.kp, a.m,
                                  2ull * a.kp, kStep, kFloatRows, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return err;
  // ceil(cost / 2) CTAs, one full tile's cost each, at most the card's
  // resident ones (ops.py::float_tile_plan)
  const long long half_tiles = (float_cost(a.grid, a.grid.full + a.grid.ntiles) + 1) / 2;
  const int grid = static_cast<int>(half_tiles < sms * resident ? half_tiles : sms * resident);
  kernel<<<grid, kFloatThreads, kFloatSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int launch_float_tile(int x_kind, bool emit, FloatTileArgs& a, const void* x, const float* w,
                      cudaStream_t stream) {
  if (x_kind == kXF32)
    return emit ? float_launch<kXF32, true>(a, x, w, stream)
                : float_launch<kXF32, false>(a, x, w, stream);
  return emit ? float_launch<kXBF16, true>(a, x, w, stream)
              : float_launch<kXBF16, false>(a, x, w, stream);
}

}  // namespace repro
