// Fused PE layer: the stateful launches (WithState) of a bit-packed x,
// every route, with or without the emitted current. They live in a source
// of their own so that nvcc compiles them in parallel with the other
// variants; the kernel is in fused_pe.cuh.
#include <cuda_runtime.h>

#include "fused_pe.cuh"

namespace repro {

Launch pick_state_packed(bool emit, int skip) {
  return emit ? pick_skip<kXPacked, true, true>(skip)
              : pick_skip<kXPacked, false, true>(skip);
}

}  // namespace repro
