// QKFormer token attention — replaces the Pallas kernel
// repro/kernels/qk_attention/qk_attention.py::qk_attention_pallas (batched
// by qk_attention_fused): per token row, mask = rowsum(q) >= threshold, and
// out = mask * k. q, k and out are [rows, d] row-major, all f32 or all int8
// spikes (the template type); the batch and token axes are flattened into
// rows by the wrapper.
//
// One warp per row: the lanes stride over d summing q (exactly, for spike
// values), a shuffle tree finishes the row sum, and the lanes stride again
// writing mask * k. The output only selects k's values (a multiply by 0 or
// 1, as the plain version computes it), so it is bit-equal to the plain
// version.
//
// Bound on the H100: bytes, reading q and k once and writing out once
// (3 * rows * d elements) at 3.35 TB/s; the adds are one per q element.
// Consecutive lanes touch consecutive elements, so every access of a warp
// is coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads)
qk_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    T* __restrict__ out, long long rows, int d, float threshold) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;
  Acc s = 0;
  for (int c = lane; c < d; c += 32) s += static_cast<Acc>(q[base + c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const bool on = static_cast<float>(s) >= threshold;
  for (int c = lane; c < d; c += 32) {
    if constexpr (sizeof(T) == 4) {
      out[base + c] = __fmul_rn(on ? 1.f : 0.f, k[base + c]);
    } else {
      out[base + c] = static_cast<T>((on ? 1 : 0) * k[base + c]);
    }
  }
}

}  // namespace

// dtype 0: f32 q, k, out; dtype 1: int8 q, k, out.
extern "C" int repro_qk_attention(const void* q, const void* k, void* out,
                                  long long rows, int d, float threshold, int dtype,
                                  cudaStream_t stream) {
  if (rows > 0 && d > 0) {
    const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
    if (dtype == 0)
      qk_attention_kernel<float, float><<<blocks, kThreads, 0, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<float*>(out), rows, d, threshold);
    else if (dtype == 1)
      qk_attention_kernel<int8_t, int><<<blocks, kThreads, 0, stream>>>(
          static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
          static_cast<int8_t*>(out), rows, d, threshold);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
