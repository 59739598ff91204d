// Unpack bit-packed spikes — replaces the Pallas kernel
// repro/kernels/packed/packed.py::unpack_spikes_pallas.
//
// words [n_words] int32 -> out [n_words * 32] int8 0/1, bit j of word i
// landing on byte 32i + j. On the packed [mp, kp/32] layout that is the
// padded [mp, kp] dense map; the wrapper slices the logical extent.
//
// Each thread writes one 16-byte chunk (half a word) with one vector
// store: four bits at a time are spread to four bytes by one multiply,
// (b * 0x00204081) & 0x01010101, whose partial products never overlap.
//
// Bound on the H100: 1/8 byte read and one byte written per spike
// position, so device-memory bandwidth (3.35 TB/s) binds; the stores are
// 16 bytes a thread, neighbouring threads on neighbouring addresses.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned spread4(unsigned b) {
  return ((b & 0xfu) * 0x00204081u) & 0x01010101u;
}

}  // namespace

extern "C" __global__ void unpack_spikes_kernel(const int* __restrict__ words,
                                                uint4* __restrict__ out,
                                                long long chunks) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < chunks; i += stride) {
    const unsigned h = static_cast<unsigned>(words[i >> 1]) >> ((i & 1) * 16);
    out[i] = make_uint4(spread4(h), spread4(h >> 4), spread4(h >> 8), spread4(h >> 12));
  }
}

// words [n_words] int32 -> out [n_words * 32] int8 (16-byte aligned).
extern "C" int repro_unpack_spikes(const int* words, int8_t* out,
                                   long long n_words, cudaStream_t stream) {
  const long long chunks = 2 * n_words;
  if (chunks > 0) {
    const int threads = 256;
    long long blocks = (chunks + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;  // 32 resident blocks per SM
    unpack_spikes_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        words, reinterpret_cast<uint4*>(out), chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
