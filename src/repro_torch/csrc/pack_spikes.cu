// Bit-pack a spike map — replaces the Pallas kernel
// repro/kernels/packed/packed.py::pack_spikes_pallas.
//
// x [nb, m, k] int8 spikes (nonzero == event) -> per batch item b
//   words [mp, kp/32] int32: bit j of word c = column 32c + j (bit 31 is
//         the sign bit), rows >= m and columns >= k zero
//   vld   [mp/128, kp/128] int32: spikes per 128x128 block (popcount)
//   occ   [mp/128, kp/128] int32: bit c set iff word column c of the block
//         holds a nonzero word in any row
// with mp, kp the 128-padded extents, all in one pass over x.
//
// Bound on the H100: one byte read per spike position and 1/8 byte
// written, a few operations each, so device-memory bandwidth (3.35 TB/s)
// binds; the design keeps enough 16-byte loads in flight to reach it.
//
// The work: a CTA takes a unit of G 128-row blocks by one 128-column
// block of one item at a time (a persistent grid sized to the card). The
// unit's rows are cut into "segments" of 16 columns, one per lane, vw of
// them a row (``kernels/packed/ops.py::pack_plan``: 2, 4 or 8, so that
// k = 64 gives 4 and a warp covers 8 rows with no lane on the padding),
// and G = 16 / vw, so a unit is 2048 segments: each of the 256 threads
// issues its 8 independent 16-byte loads before it uses any (32 KB in
// flight a CTA). A lane turns its 16 bytes into 16 bits (__vcmpne4, then a
// multiply that gathers four bytes' flags into four bits); the two lanes
// of a word join their halves with one shuffle, and the first lane of a
// row gathers its four words with three more and stores them as one
// int4. Segments past k, and rows past m, load nothing and give zero
// bits, so the padded words are written as zeros without reading x. The
// row block a thread counts at its i-th load is i / (vw / 2) for every
// thread, so the leaders add their words' popcounts and OR their
// occupancy bits in registers, a warp reduces them (__reduce_*_sync), and
// one atomic a warp and block adds them in shared memory; the counts are
// exact integers and occ an OR, so the bits do not depend on the order. A
// ragged k (k % 16 != 0) or a misaligned x takes the same map with a
// byte loop in place of the 16-byte load.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;      // independent loads a thread before use
// at most 64 registers a thread: 4 CTAs an SM, so the 512 units of the
// stem's T = 1 map (262144 x 64) are resident in one wave
constexpr int kCtasPerSm = 4;

// four bytes -> four bits, bit b set iff byte b is nonzero: __vcmpne4
// sets a byte to 0xff where it is nonzero; the multiply moves bit 0 of
// byte b (position 8b) to position 24 + b, and no two partial products
// meet (the twin is ``kernels/packed/ref.py::gather16_twin``)
__device__ __forceinline__ unsigned gather4(unsigned q) {
  return ((__vcmpne4(q, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned gather16(const int4& v) {
  return gather4(static_cast<unsigned>(v.x)) |
         gather4(static_cast<unsigned>(v.y)) << 4 |
         gather4(static_cast<unsigned>(v.z)) << 8 |
         gather4(static_cast<unsigned>(v.w)) << 12;
}

}  // namespace

template <bool kVector, int kVw>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
pack_spikes_kernel(const int8_t* __restrict__ x, int* __restrict__ words,
                   int* __restrict__ vld, int* __restrict__ occ, int nb,
                   int m, int k, int mp, int kp) {
  constexpr int kG = 16 / kVw;              // row blocks a unit
  constexpr int kShift = kVw == 2 ? 1 : kVw == 4 ? 2 : 3;
  __shared__ unsigned cnt_s[kG], occ_s[kG];
  if (threadIdx.x < kG) cnt_s[threadIdx.x] = occ_s[threadIdx.x] = 0u;
  __syncthreads();
  const int nbc = kp / kTile, wpr = kp / 32, rbs = mp / kTile;
  const int rgs = (rbs + kG - 1) / kG;
  const int lane = threadIdx.x % 32;
  for (int unit = blockIdx.x; unit < nb * rgs * nbc; unit += gridDim.x) {
    const int cq = unit % nbc, rg = unit / nbc % rgs, item = unit / nbc / rgs;
    const int8_t* xb = x + static_cast<size_t>(item) * m * k + cq * kTile;
    int* wb = words + static_cast<size_t>(item) * mp * wpr + 4 * cq;
    const int row0 = rg * kG * kTile;
    unsigned half[kUnroll];
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {     // every load before any use
      const int s = u * kThreads + threadIdx.x;
      const int row = row0 + (s >> kShift);
      const int col = (s & (kVw - 1)) * 16;
      const bool live = row < m && cq * kTile + col < k;
      const int8_t* src = xb + static_cast<size_t>(row) * k + col;
      if constexpr (kVector) {
        v[u] = live ? __ldg(reinterpret_cast<const int4*>(src))
                    : make_int4(0, 0, 0, 0);
      } else {
        unsigned h = 0u;
        if (live)
          for (int b = 0; b < 16 && cq * kTile + col + b < k; ++b)
            h |= static_cast<unsigned>(src[b] != 0) << b;
        half[u] = h;
      }
    }
    unsigned count[kG], bits[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) count[g] = bits[g] = 0u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = u * kThreads + threadIdx.x;
      const int row = row0 + (s >> kShift);
      unsigned h;
      if constexpr (kVector) h = gather16(v[u]);
      else h = half[u];
      const unsigned w0 = h | __shfl_down_sync(0xffffffffu, h, 1) << 16;
      unsigned w1 = __shfl_down_sync(0xffffffffu, w0, 2);
      unsigned w2 = __shfl_down_sync(0xffffffffu, w0, 4);
      unsigned w3 = __shfl_down_sync(0xffffffffu, w0, 6);
      if (kVw < 8) w2 = w3 = 0u;            // a row of 2 or 4 segments: the
      if (kVw < 4) w1 = 0u;                 // rest of its block is padding
      if ((s & (kVw - 1)) == 0 && row < mp) {
        *reinterpret_cast<int4*>(wb + static_cast<size_t>(row) * wpr) =
            make_int4(static_cast<int>(w0), static_cast<int>(w1),
                      static_cast<int>(w2), static_cast<int>(w3));
        const int g = u / (kVw / 2);        // the row block of this load
        count[g] += __popc(w0) + __popc(w1) + __popc(w2) + __popc(w3);
        bits[g] |= static_cast<unsigned>(w0 != 0u) |
                   static_cast<unsigned>(w1 != 0u) << 1 |
                   static_cast<unsigned>(w2 != 0u) << 2 |
                   static_cast<unsigned>(w3 != 0u) << 3;
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const unsigned c = __reduce_add_sync(0xffffffffu, count[g]);
      const unsigned o = __reduce_or_sync(0xffffffffu, bits[g]);
      if (lane == 0 && (c | o)) {
        atomicAdd(&cnt_s[g], c);
        atomicOr(&occ_s[g], o);
      }
    }
    __syncthreads();
    if (threadIdx.x < kG) {
      const int rb = rg * kG + threadIdx.x;
      if (rb < rbs) {
        const size_t cell = (static_cast<size_t>(item) * rbs + rb) * nbc + cq;
        vld[cell] = static_cast<int>(cnt_s[threadIdx.x]);
        occ[cell] = static_cast<int>(occ_s[threadIdx.x]);
      }
      cnt_s[threadIdx.x] = occ_s[threadIdx.x] = 0u;
    }
    __syncthreads();
  }
}

namespace {

template <bool kVector, int kVw>
int launch_pack(const int8_t* x, int* words, int* vld, int* occ, int nb,
                int m, int k, int mp, int kp, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pack_spikes_kernel<kVector, kVw>, kThreads, 0);
  const int rgs = (mp / kTile + 16 / kVw - 1) / (16 / kVw);
  const long long units = static_cast<long long>(nb) * rgs * (kp / kTile);
  const int grid = units < sms * per_sm ? static_cast<int>(units) : sms * per_sm;
  if (grid > 0)
    pack_spikes_kernel<kVector, kVw><<<grid, kThreads, 0, stream>>>(
        x, words, vld, occ, nb, m, k, mp, kp);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVector>
int launch_vw(const int8_t* x, int* words, int* vld, int* occ, int nb, int m,
              int k, int mp, int kp, int vw, cudaStream_t stream) {
  switch (vw) {
    case 2:
      return launch_pack<kVector, 2>(x, words, vld, occ, nb, m, k, mp, kp, stream);
    case 4:
      return launch_pack<kVector, 4>(x, words, vld, occ, nb, m, k, mp, kp, stream);
    case 8:
      return launch_pack<kVector, 8>(x, words, vld, occ, nb, m, k, mp, kp, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x [nb, m, k] int8 (contiguous) -> words [nb, mp, kp/32], vld and occ
// [nb, mp/128, kp/128] int32; mp and kp are m and k rounded up to 128;
// vw is ``pack_plan``'s segments a row of a block (2, 4 or 8); vector != 0
// takes the 16-byte loads (k % 16 == 0 and x 16-byte aligned), else the
// byte loop.
extern "C" int repro_pack_spikes(const int8_t* x, int* words, int* vld,
                                 int* occ, int nb, int m, int k, int mp,
                                 int kp, int vw, int vector,
                                 cudaStream_t stream) {
  if (nb <= 0 || mp <= 0 || kp <= 0) return static_cast<int>(cudaGetLastError());
  return vector ? launch_vw<true>(x, words, vld, occ, nb, m, k, mp, kp, vw,
                                  stream)
                : launch_vw<false>(x, words, vld, occ, nb, m, k, mp, kp, vw,
                                   stream);
}
