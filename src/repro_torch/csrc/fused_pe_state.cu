// Fused PE layer: the stateful launches (WithState, the reference's
// with_state of T > 1) of an int8 x, every route, with or without the
// emitted current. They live in a source of their own so that nvcc
// compiles them in parallel with the other variants; the kernel is in
// fused_pe.cuh.
#include <cuda_runtime.h>

#include "fused_pe.cuh"

namespace repro {

Launch pick_state_int8(bool emit, int skip) {
  return emit ? pick_skip<kXInt8, true, true>(skip)
              : pick_skip<kXInt8, false, true>(skip);
}

}  // namespace repro
