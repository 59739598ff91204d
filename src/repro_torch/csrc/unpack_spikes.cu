// Unpack bit-packed spikes — replaces the Pallas kernel
// repro/kernels/packed/packed.py::unpack_spikes_pallas (its `dtype`
// argument included).
//
// words [nb, mp, wpr] int32 (bit j of word c = column 32c + j, bit 31 the
// sign bit; mp >= m rows, wpr * 32 >= k columns) -> out [nb, m, k], the
// logical extent, contiguous, as int8, bf16 or f32 0/1. Padded rows and
// word columns are never read; nothing past the extent is written.
//
// Bound on the H100: bytes. The words the extent needs (ceil(k / 32) a
// row) read, and m * k * sizeof(out) written, at 3.35 TB/s; one or two
// integer operations a spike.
//
// Design (``kernels/packed/ops.py::unpack_plan`` gives G, its CPU twin of
// the lane map is ``kernels/packed/ref.py::unpack_lanes_twin``): where k
// is a multiple of 32 and out is 16-byte aligned, the rows are cut into
// segments of G columns (G = 128, 64 or 32, the largest that divides k),
// which follow one another in the output without a gap. A warp takes a
// unit of 4096 spikes (32 x 128 / G segments) on a persistent grid of
// CTAs of two warps (a small map, such as the head's 512 units, then
// spreads over every SM; 64-, 128- and 256-thread CTAs timed alike): each
// lane loads its segments' words (one 16-byte load a segment at G = 128,
// 8 bytes at 64, 4 at 32) and puts them in the warp's 512 bytes of shared
// memory, where they form the unit's bit stream in output order. Then
// lane L writes the unit's 16-byte chunks L, L + 32, ... (8 int8, 16 bf16
// or 32 f32 stores a lane, all in flight, each warp store 512 contiguous
// bytes), each from 16, 8 or 4 bits of the stream: bits to bytes by a
// multiply whose partial products never meet, to bf16 and f32 ones by
// shifts and a multiply by the value of 1.0. A unit past the last segment
// stores only its whole chunks (the extent is whole segments, and a
// segment whole chunks). A ragged k (k % 32 != 0) or a misaligned out
// takes the general path of the same kernel (G = 0): element by element,
// a grid-stride walk over the extent.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnitWords = 128;     // a warp's unit: 4096 spikes
constexpr int kWarps = kThreads / 32;

// four bits -> four bytes 0/1: bit b moves to bit 8b; the partial
// products of the multiply never overlap
__device__ __forceinline__ unsigned spread4(unsigned b) {
  return ((b & 0xfu) * 0x00204081u) & 0x01010101u;
}

// two bits -> two 16-bit lanes 0/1
__device__ __forceinline__ unsigned spread2(unsigned b) {
  return (b & 1u) | ((b & 2u) << 15);
}

template <typename Out>
struct Kind;

// 16 int8 spikes from 16 bits
template <>
struct Kind<int8_t> {
  static constexpr int kPerChunk = 16;
  static __device__ __forceinline__ uint4 chunk(unsigned bits) {
    return make_uint4(spread4(bits), spread4(bits >> 4), spread4(bits >> 8),
                      spread4(bits >> 12));
  }
  static __device__ __forceinline__ int8_t one(unsigned bit) {
    return static_cast<int8_t>(bit);
  }
};

// 8 bf16 spikes (0x3f80 is 1.0) from 8 bits
template <>
struct Kind<uint16_t> {
  static constexpr int kPerChunk = 8;
  static __device__ __forceinline__ uint4 chunk(unsigned bits) {
    return make_uint4(spread2(bits) * 0x3f80u, spread2(bits >> 2) * 0x3f80u,
                      spread2(bits >> 4) * 0x3f80u, spread2(bits >> 6) * 0x3f80u);
  }
  static __device__ __forceinline__ uint16_t one(unsigned bit) {
    return static_cast<uint16_t>(bit * 0x3f80u);
  }
};

// 4 f32 spikes (0x3f800000 is 1.0) from 4 bits
template <>
struct Kind<float> {
  static constexpr int kPerChunk = 4;
  static __device__ __forceinline__ uint4 chunk(unsigned bits) {
    return make_uint4((bits & 1u) * 0x3f800000u, ((bits >> 1) & 1u) * 0x3f800000u,
                      ((bits >> 2) & 1u) * 0x3f800000u, ((bits >> 3) & 1u) * 0x3f800000u);
  }
  static __device__ __forceinline__ float one(unsigned bit) {
    return __uint_as_float(bit * 0x3f800000u);
  }
};

}  // namespace

// G: columns a segment (128, 64 or 32), or 0 for the general path
template <typename Out, int G>
__global__ void __launch_bounds__(kThreads)
unpack_spikes_kernel(const int* __restrict__ words, Out* __restrict__ out, int m, int k,
                     int mp, int wpr, long long n_seg, long long n_out) {
  using KO = Kind<Out>;
  if constexpr (G == 0) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
         e < n_out; e += stride) {
      const long long row = e / k;
      const int col = static_cast<int>(e - row * k);
      const long long item = row / m;
      const int r = static_cast<int>(row - item * m);
      const unsigned w = static_cast<unsigned>(
          __ldg(words + (item * mp + r) * wpr + col / 32));
      out[e] = KO::one((w >> (col % 32)) & 1u);
    }
  } else {
    constexpr int kSegWords = G / 32;                 // words a segment
    constexpr int kLoads = kUnitWords / 32 / kSegWords;   // segments a lane a unit
    constexpr int kChunks = 32 * kUnitWords / KO::kPerChunk / 32;   // stores a lane
    __shared__ unsigned stream_s[kWarps][kUnitWords];
    unsigned* stream = stream_s[threadIdx.x / 32];
    const int lane = threadIdx.x % 32;
    // segments, rows and units are counted in 32 bits (the C entry takes
    // this path only below 2^31 segments), so the divisions stay short
    const unsigned seg_row = static_cast<unsigned>(k / G);   // segments a row
    const unsigned segs = static_cast<unsigned>(n_seg);
    const unsigned n_units = (segs + 32 * kLoads - 1) / (32 * kLoads);
    const unsigned warps = gridDim.x * kWarps;
    for (unsigned u = blockIdx.x * kWarps + threadIdx.x / 32; u < n_units; u += warps) {
      const unsigned s0 = u * 32 * kLoads;            // the unit's first segment
      unsigned w[kLoads][kSegWords];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {              // every load before any use
        const unsigned s = s0 + lane + 32 * i;
#pragma unroll
        for (int j = 0; j < kSegWords; ++j) w[i][j] = 0u;
        if (s < segs) {
          const unsigned row = s / seg_row;
          const unsigned seg = s - row * seg_row;
          const unsigned item = row / static_cast<unsigned>(m);
          const unsigned r = row - item * static_cast<unsigned>(m);
          const int* src = words + (static_cast<size_t>(item) * mp + r) * wpr + seg * kSegWords;
          if constexpr (kSegWords == 4) {
            const int4 x = __ldg(reinterpret_cast<const int4*>(src));
            w[i][0] = x.x;
            w[i][1] = x.y;
            w[i][2] = x.z;
            w[i][3] = x.w;
          } else if constexpr (kSegWords == 2) {
            const int2 x = __ldg(reinterpret_cast<const int2*>(src));
            w[i][0] = x.x;
            w[i][1] = x.y;
          } else {
            w[i][0] = __ldg(src);
          }
        }
      }
      __syncwarp();                                   // the last unit's reads done
#pragma unroll
      for (int i = 0; i < kLoads; ++i)
#pragma unroll
        for (int j = 0; j < kSegWords; ++j) stream[(lane + 32 * i) * kSegWords + j] = w[i][j];
      __syncwarp();
      const long long e0 = static_cast<long long>(s0) * G;   // the unit's first element
      uint4* dst = reinterpret_cast<uint4*>(out + e0);
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int c = q * 32 + lane;                  // chunk of the unit
        const int bit = c * KO::kPerChunk;            // its first bit
        if (e0 + bit >= n_out) break;                 // past the extent
        const unsigned bits = stream[bit / 32] >> (bit % 32);
        dst[c] = KO::chunk(bits);
      }
    }
  }
}

namespace {

template <typename Out, int G>
int launch(const int* words, void* out, int m, int k, int mp, int wpr, long long n_seg,
           long long n_out, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, unpack_spikes_kernel<Out, G>,
                                                kThreads, 0);
  const long long units = (n_out + 32 * kUnitWords - 1) / (32 * kUnitWords);
  const long long work = G == 0 ? (n_out + kThreads - 1) / kThreads
                                : (units + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(work < cap ? work : cap);
  if (grid > 0)
    unpack_spikes_kernel<Out, G><<<grid, kThreads, 0, stream>>>(
        words, static_cast<Out*>(out), m, k, mp, wpr, n_seg, n_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename Out>
int by_g(int g, const int* words, void* out, int m, int k, int mp, int wpr, long long n_seg,
         long long n_out, cudaStream_t stream) {
  switch (g) {
    case 0:
      return launch<Out, 0>(words, out, m, k, mp, wpr, n_seg, n_out, stream);
    case 32:
      return launch<Out, 32>(words, out, m, k, mp, wpr, n_seg, n_out, stream);
    case 64:
      return launch<Out, 64>(words, out, m, k, mp, wpr, n_seg, n_out, stream);
    case 128:
      return launch<Out, 128>(words, out, m, k, mp, wpr, n_seg, n_out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// words [nb, mp, wpr] int32 (contiguous) -> out [nb, m, k] (contiguous) in
// kind 0 int8, 1 bf16, 2 f32; g is ``unpack_plan``'s segment (128, 64 or 32
// dividing k, with out 16-byte aligned and words aligned to a segment's
// words) or 0 for the general path.
extern "C" int repro_unpack_spikes(const int* words, void* out, int nb, int m, int k,
                                   int mp, int wpr, int g, int kind, cudaStream_t stream) {
  if (m > mp || k > 32 * wpr || (g != 0 && k % g != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_out = static_cast<long long>(nb) * m * k;
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  const long long n_seg = g == 0 ? 0 : n_out / g;
  if (n_seg >= (1LL << 31)) g = 0;                    // past 32-bit segment counts
  switch (kind) {
    case 0:
      return by_g<int8_t>(g, words, out, m, k, mp, wpr, n_seg, n_out, stream);
    case 1:
      return by_g<uint16_t>(g, words, out, m, k, mp, wpr, n_seg, n_out, stream);
    case 2:
      return by_g<float>(g, words, out, m, k, mp, wpr, n_seg, n_out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
