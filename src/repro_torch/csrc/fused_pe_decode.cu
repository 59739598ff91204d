// Fused PE layer: the decode route's launches (fused_pe.cuh,
// decode_gemm.cuh) of a dense f32 or bf16 activation x, the LM's
// ops.dense_lif projections, at both row tiles. They live in a source of
// their own so that nvcc compiles them in parallel with the other
// variants.
#include <cuda_runtime.h>

#include "fused_pe.cuh"

namespace repro {

Launch pick_decode_float(int x_kind, int m_valid) {
  return x_kind == kXF32 ? pick_decode<kXF32>(m_valid) : pick_decode<kXBF16>(m_valid);
}

}  // namespace repro
