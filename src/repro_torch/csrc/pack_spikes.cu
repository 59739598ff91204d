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
// One CTA per 128x128 block, 8 warps. A warp reads 32 consecutive columns
// of one row, one byte per lane, and __ballot_sync of (x != 0) is that
// row's word; each warp adds its words' __popc and ORs their occupancy
// bits, and one thread reduces the 8 warps' sums for the block's maps.
// The kernel reads the unpadded x and treats everything past (m, k) as
// zero, so no padded copy of x is made.
//
// Bound on the H100: one byte read per spike position and 1/8 byte
// written, a few operations each, so device-memory bandwidth (3.35 TB/s)
// binds. Each warp load is one full 32-byte sector. Wider loads (16 bytes
// a lane, then assembling words from four ballots) are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kWordsPerRow = kTile / 32;  // words of one block row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads)
pack_spikes_kernel(const int8_t* __restrict__ x, int* __restrict__ words,
                   int* __restrict__ vld, int* __restrict__ occ, int m, int k,
                   int mp, int kp) {
  const int col_blk = blockIdx.x, row_blk = blockIdx.y, item = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wpr = kp / 32;
  const int8_t* xb = x + static_cast<size_t>(item) * m * k;
  int* wb = words + static_cast<size_t>(item) * mp * wpr;
  int count = 0;
  unsigned bits = 0;
#pragma unroll 4
  for (int i = warp; i < kTile * kWordsPerRow; i += kWarps) {
    const int row = row_blk * kTile + i / kWordsPerRow;
    const int c = i % kWordsPerRow;
    const int col = col_blk * kTile + c * 32 + lane;
    const bool on = row < m && col < k && xb[static_cast<size_t>(row) * k + col] != 0;
    const unsigned word = __ballot_sync(0xffffffffu, on);
    if (lane == 0) wb[static_cast<size_t>(row) * wpr + col_blk * kWordsPerRow + c] = static_cast<int>(word);
    count += __popc(word);
    bits |= static_cast<unsigned>(word != 0u) << c;
  }
  __shared__ int warp_count[kWarps];
  __shared__ unsigned warp_bits[kWarps];
  if (lane == 0) {
    warp_count[warp] = count;
    warp_bits[warp] = bits;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    unsigned any = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      total += warp_count[i];
      any |= warp_bits[i];
    }
    const size_t cell = (static_cast<size_t>(item) * (mp / kTile) + row_blk) * (kp / kTile) + col_blk;
    vld[cell] = total;
    occ[cell] = static_cast<int>(any);
  }
}

// x [nb, m, k] int8 (contiguous) -> words [nb, mp, kp/32], vld and occ
// [nb, mp/128, kp/128] int32; mp and kp are m and k rounded up to 128.
extern "C" int repro_pack_spikes(const int8_t* x, int* words, int* vld,
                                 int* occ, int nb, int m, int k, int mp,
                                 int kp, cudaStream_t stream) {
  if (nb > 0 && mp > 0 && kp > 0) {
    const dim3 grid(kp / kTile, mp / kTile, nb);
    pack_spikes_kernel<<<grid, kThreads, 0, stream>>>(x, words, vld, occ, m,
                                                      k, mp, kp);
  }
  return static_cast<int>(cudaGetLastError());
}
