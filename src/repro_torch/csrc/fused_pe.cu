// Fused PE layer, stateless variant — replaces the Pallas kernel
// repro/kernels/fused_pe/fused_pe.py::fused_pe_pallas (bias, residual,
// whole-row Q mask, emit_vld, emit_current; T=1, no state) under its three
// byte-skip strategies, skip="dense", "gated" and "two_level" (the routes
// of event_gemm.cuh, which give the same bits), with every spike operand
// and the output dense (int8) or bit-packed (int32 words of 32 spikes, the
// packed_in / packed_q / packed_residual / packed_out flags).
//
// Per 128x128 output tile, in one pass: the event-gated f32 product
// x @ w (event_gemm.cuh), then in registers
//   cur   = (acc + bias) + residual          (the reference's order)
//   spike = cur >= v_th                      (T=1: v = cur, no state)
//   spike &= rowsum(q[row]) >= qk_threshold  (QKFormer write-back mask)
//   spike &= row < m_valid && col < n_valid  (padding never fires)
// and the tile's spike count is written as the next layer's vld_cnt. The
// count map tiles the output on (128, bn): bn = 128 is one CTA's tile; the
// autotuner may ask for bn = 256, and then the two CTAs of a 128x256 tile
// add their counts into one zeroed entry with an integer atomicAdd (exact
// in any order). The f32 pre-activation never reaches device memory,
// except in the emit_current variant (EmitCurrent, the training forward):
// there each thread also writes the f32 current of its outputs inside the
// valid extent to a [m_valid, n_valid] buffer, the residual the backward
// differentiates from; the spikes are the same compare on that same value.
//
// The packed forms read and write 1/8 of the int8 bytes and never widen a
// spike map in device memory: packed x is expanded to 0/1 floats in shared
// memory (event_gemm.cuh); a packed Q row sum is __popc over the row's
// words; a packed residual (the identity shortcut) is the thread's 8 bits
// of one word, added as 0.f/1.f where the f32 residual is; a packed output
// word is the 8-bit rows of four neighbouring threads, combined with
// __shfl_xor_sync and stored by one of them. The f32 sums are the same as
// the int8 path's, so both give the same spikes.
//
// Bound on the H100: the kernel runs the dense f32 product over every
// 128x128 block the route does not skip, 2*128*128*Np operations per
// block, so the 67 TFLOP/s f32 rate outside the tensor cores bounds it
// (parity with the reference rules out TF32). The data needs less: one add
// per spike and output column, a quarter to a half of that at the main
// path's spike rates, and a layer with N < 128 (resblock 1, N = 64)
// computes a half-empty tile. A packed patch matrix pads each 3x3 tap's
// channels to whole 128-wide blocks, so at C = 64 its K is twice the int8
// one (1152, not 576): the padding is zeros the block skip cannot see, and
// the stripe skip (two_level) can, where an occ map comes with x. The
// design keeps 64 accumulators per thread in registers and stages x and w
// through 32 KB of shared memory so each loaded value feeds 8 FMAs; the
// skip removes both the loads and the FMAs of a silent block. wgmma, TMA,
// a multi-stage pipeline and a narrower tile for N = 64 are later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "event_gemm.cuh"

using namespace repro;

// the flags argument of repro_fused_pe, one bit per packed operand
constexpr int kPackedX = 1, kPackedQ = 2, kPackedResidual = 4, kPackedOut = 8;

template <bool PackedX, bool EmitCurrent, int Skip>
__global__ void __launch_bounds__(kThreads)
fused_pe_kernel(const void* __restrict__ x, const float* __restrict__ w,
                Route route, const float* __restrict__ bias,
                const void* __restrict__ residual, const void* __restrict__ q,
                int dq, void* __restrict__ spikes, int* __restrict__ vld_next,
                float* __restrict__ current,
                int kp, int np, int bn, int m_valid, int n_valid, float v_th,
                float qk_threshold, int flags) {
  __shared__ GemmSmem sm;
  __shared__ float row_gate[kTile];
  __shared__ int warp_count[kThreads / 32];
  const int row_blk = blockIdx.y, col0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const bool packed_q = flags & kPackedQ, packed_res = flags & kPackedResidual;
  const bool packed_out = flags & kPackedOut;

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
  event_gemm_tile<PackedX, Skip>(x, w, route, kp, np, row_blk, col0, sm, acc);

  if (q != nullptr) {  // one warp per row: integer row sum of Q spikes
    for (int r = warp; r < kTile; r += kThreads / 32) {
      const size_t row = static_cast<size_t>(row_blk) * kTile + r;
      int s = 0;
      if (packed_q) {  // dq words per row: the row sum is a popcount
        const int* qr = static_cast<const int*>(q) + row * dq;
        for (int c = lane; c < dq; c += 32) s += __popc(static_cast<unsigned>(qr[c]));
      } else {         // dq int8 spikes per row
        const int8_t* qr = static_cast<const int8_t*>(q) + row * dq;
        for (int c = lane * 16; c < dq; c += 32 * 16) {
          const int4 v = *reinterpret_cast<const int4*>(qr + c);
          const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
          for (int i = 0; i < 16; ++i) s += e[i];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) row_gate[r] = static_cast<float>(s) >= qk_threshold ? 1.f : 0.f;
    }
    __syncthreads();
  }

  const int c0 = col0 + tx * kSub;
  const int words_per_row = np / 32;
  float b[kSub];
#pragma unroll
  for (int j = 0; j < kSub; ++j) b[j] = 0.f;
  if (bias != nullptr) {
    const float4 b0 = *reinterpret_cast<const float4*>(bias + c0);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + c0 + 4);
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
  }
  int count = 0;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int rl = ty * kSub + i;
    const int row = row_blk * kTile + rl;
    float r[kSub] = {};
    if (residual != nullptr && packed_res) {  // this thread's 8 bits of a word
      const unsigned word = static_cast<unsigned>(static_cast<const int*>(residual)[
          static_cast<size_t>(row) * words_per_row + c0 / 32]);
      const unsigned bits = (word >> (c0 % 32)) & 0xffu;
#pragma unroll
      for (int j = 0; j < kSub; ++j) r[j] = ((bits >> j) & 1u) ? 1.f : 0.f;
    } else if (residual != nullptr) {
      const float* rp = static_cast<const float*>(residual) + static_cast<size_t>(row) * np + c0;
      const float4 r0 = *reinterpret_cast<const float4*>(rp);
      const float4 r1 = *reinterpret_cast<const float4*>(rp + 4);
      r[0] = r0.x; r[1] = r0.y; r[2] = r0.z; r[3] = r0.w;
      r[4] = r1.x; r[5] = r1.y; r[6] = r1.z; r[7] = r1.w;
    }
    const bool row_on = row < m_valid && (q == nullptr || row_gate[rl] != 0.f);
    uint64_t bytes = 0;
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      float cur = acc[i][j];
      if (bias != nullptr) cur = __fadd_rn(cur, b[j]);
      if (residual != nullptr) cur = __fadd_rn(cur, r[j]);
      if constexpr (EmitCurrent) {
        if (row < m_valid && c0 + j < n_valid)
          current[static_cast<size_t>(row) * n_valid + c0 + j] = cur;
      }
      const bool s = row_on && (c0 + j) < n_valid && cur >= v_th;
      count += s;
      bytes |= static_cast<uint64_t>(s) << (8 * j);
      bits |= static_cast<unsigned>(s) << j;
    }
    if (packed_out) {
      // lanes 4g..4g+3 hold columns 32g'..32g'+31 of one row (tx = 4g'..),
      // each 8 of them: shift each byte into place and OR the four
      unsigned word = bits << (8 * (tx % 4));
      word |= __shfl_xor_sync(0xffffffffu, word, 1);
      word |= __shfl_xor_sync(0xffffffffu, word, 2);
      if (tx % 4 == 0)
        static_cast<int*>(spikes)[static_cast<size_t>(row) * words_per_row + c0 / 32] =
            static_cast<int>(word);
    } else {
      *reinterpret_cast<uint64_t*>(static_cast<int8_t*>(spikes) +
                                   static_cast<size_t>(row) * np + c0) = bytes;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) total += warp_count[i];
    int* dst = vld_next + row_blk * (np / bn) + col0 / bn;
    if (bn == kTile)
      *dst = total;
    else
      atomicAdd(dst, total);  // the CTAs of a wide tile; integer, exact
  }
}

namespace {

template <bool PackedX, bool EmitCurrent, int Skip>
void launch(const void* x, const float* w, const Route& route, const float* bias,
            const void* residual, const void* q, int dq, void* spikes,
            int* vld_next, float* current, int mp, int kp, int np, int bn,
            int m_valid, int n_valid, float v_th, float qk_threshold, int flags,
            cudaStream_t stream) {
  const dim3 grid(np / kTile, mp / kTile);
  fused_pe_kernel<PackedX, EmitCurrent, Skip><<<grid, kThreads, 0, stream>>>(
      x, w, route, bias, residual, q, dq, spikes, vld_next, current, kp, np, bn,
      m_valid, n_valid, v_th, qk_threshold, flags);
}

using Launch = decltype(&launch<false, false, kDense>);

template <bool PackedX, bool EmitCurrent>
constexpr Launch pick(int skip) {
  return skip == kDense ? &launch<PackedX, EmitCurrent, kDense>
         : skip == kGated ? &launch<PackedX, EmitCurrent, kGated>
                          : &launch<PackedX, EmitCurrent, kTwoLevel>;
}

}  // namespace

// x [mp, kp] int8 or [mp, kp/32] int32 words (flags & kPackedX), w [kp, np]
// f32. The route (skip, see event_gemm.cuh): kDense reads vld [mp/128,
// kp/bk]; kGated nact [mp/128] and kmap [mp/128, kp/bk]; kTwoLevel also
// occ [mp/128, kp/bk]. May be null: bias [np] f32; residual [mp, np] f32 or
// [mp, np/32] words (kPackedResidual); q [mp, dq] int8 (dq a multiple of
// 128) or [mp, dq] words (kPackedQ, dq words per row); current [m_valid,
// n_valid] f32 (the emit_current variant). Writes spikes [mp, np] int8 or
// [mp, np/32] words (kPackedOut), vld_next [mp/128, np/bn] int32 (zeroed
// by the caller when bn > 128) and, when current is not null, the current.
extern "C" int repro_fused_pe(const void* x, const float* w, const int* vld,
                              const int* nact, const int* kmap, const int* occ,
                              const float* bias, const void* residual,
                              const void* q, int dq, void* spikes,
                              int* vld_next, float* current, int mp, int kp,
                              int np, int bk, int bn, int m_valid, int n_valid,
                              float v_th, float qk_threshold, int flags, int skip,
                              cudaStream_t stream) {
  if (skip < kDense || skip > kTwoLevel || (bn != kTile && bn != 2 * kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mp > 0 && np > 0) {
    const bool packed_x = flags & kPackedX, emit = current != nullptr;
    const Launch fn = packed_x ? (emit ? pick<true, true>(skip) : pick<true, false>(skip))
                               : (emit ? pick<false, true>(skip) : pick<false, false>(skip));
    const Route route{vld, nact, kmap, occ, bk};
    fn(x, w, route, bias, residual, q, dq, spikes, vld_next, current, mp, kp, np, bn,
       m_valid, n_valid, v_th, qk_threshold, flags, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
