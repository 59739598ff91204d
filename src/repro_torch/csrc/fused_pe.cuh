// Fused PE layer — replaces the Pallas kernel
// repro/kernels/fused_pe/fused_pe.py::fused_pe_pallas (bias, residual,
// whole-row or head-blocked Q mask, emit_vld, emit_current, and the LIF
// state of T > 1, with_state) under its three byte-skip strategies,
// skip="dense", "gated" and "two_level" (the routes of event_gemm.cuh,
// which give the same bits), with every spike operand and the output dense
// (int8) or bit-packed (int32 words of 32 spikes, the packed_in / packed_q
// / packed_residual / packed_out flags). x may also be a dense f32 or bf16
// activation (the LM's ops.dense_lif projections of the residual stream):
// the same tile product over the f32 widening, on the dense route with an
// all-ones vld map (a float operand has no silent blocks to skip); a float
// x takes no LIF state (the LM runs T = 1).
//
// Per 128x128 output tile, in one pass: the event-gated f32 product
// x @ w (event_gemm.cuh), then in registers
//   cur   = (acc + bias) + residual          (the reference's order)
//   v     = cur                              (T=1: no state)
//   v     = tau * v_prev * (1 - s_prev) + cur  (WithState, each op rounded)
//   fire  = v >= v_th
//   v_next = v * (1 - fire) or v - v_th * fire   (WithState: hard / soft)
//   spike = fire & gate(row, col)            (QKFormer write-back mask)
//   spike &= row < m_valid && col < n_valid  (padding never fires)
// v_next and the reset come from the pre-mask, pre-padding fire, as in
// the reference (its reset precedes the mask and the padding). The state
// lives at the valid extent: v_prev [m_valid, n_valid] f32 and s_prev
// [m_valid, n_valid] int8 are read, and v_next [m_valid, n_valid] f32
// written, only inside it (zeros stand in past it, where nothing fires),
// so the wrapper pads none of the three. Each operation of the state
// update is rounded on its own (__fmul_rn / __fadd_rn: nvcc would contract
// tau * v_prev * (1 - s_prev) + cur into an FMA, one rounding fewer than
// the reference's, and move v by an ulp at v_th).
//
// The gate is rowsum(q[row]) >= qk_threshold for the whole-row mask; with
// heads (head_dim dh > 0, h * dh == n_valid) column c belongs to head
// c / dh and its gate is rowsum(q[row, head*dh : (head+1)*dh]) >=
// qk_threshold (an int8 q sums its head's values; a packed q popcounts its
// head's lanes, the words ANDed with the lanes' mask, which is
// core/events.py::head_lane_masks formed from the column arithmetic). A
// tile may hold several heads (dh < 128) or cut one (dh not dividing
// 128), so the gates of every (row, head) the tile touches are computed
// once into shared memory, in the GEMM tiles' space, after the product.
// The tile's spike count is written as the next layer's vld_cnt. The
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
// skip removes both the loads and the FMAs of a silent block. A dense
// activation x is a full f32 product, 2*M*K*N operations; at the LM's
// decode (M = a few to a few dozen slots, padded to the 128-row tile) the
// padded rows multiply zeros, and the grid is only N/128 CTAs a row block,
// so the f32 weight stream and the padding bound it. The LIF state adds
// 9 bytes an output element (v_prev and v_next f32, s_prev int8), read and
// written once at the valid extent, against the 2 K operations of its
// product. A dense activation x of at most kDecodeRows live rows without
// residual, state or emitted current (the LM's projections at its decode
// ticks and prefill chunks) takes the decode route instead
// (fused_pe_decode_kernel, decode_gemm.cuh): 16-column CTAs over the live
// rows only, the same sums and the same epilogue. wgmma, TMA and a tile
// for N = 64 are later work.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "decode_gemm.cuh"
#include "event_gemm.cuh"

namespace repro {

// the flags argument of repro_fused_pe: one bit per packed operand, then
// the dtype of a dense activation x (neither bit: int8 spikes)
constexpr int kPackedX = 1, kPackedQ = 2, kPackedResidual = 4, kPackedOut = 8;
constexpr int kF32X = 16, kBF16X = 32;
// the reset of the LIF state (WithState): set, soft (v - v_th); clear, hard
constexpr int kSoftReset = 64;

// the (row, head) gates of one tile: at most 128 / dh + 2 heads, stored as
// bytes over the GEMM tiles once the product is done
constexpr int kMaxGateBytes = static_cast<int>(sizeof(GemmSmem));

// The QK row sum of row `row` over q's columns [lo, hi): one warp, the
// lanes striding the int8 values (16 at a time where the range is
// 16-aligned) or the words (each word ANDed with the lanes of [lo, hi) it
// holds). Lane 0 returns the sum.
__device__ __forceinline__ int qk_row_sum(const void* __restrict__ q, int dq,
                                          bool packed_q, size_t row, int lo,
                                          int hi, int lane) {
  int s = 0;
  if (packed_q) {  // dq words per row
    const int* qr = static_cast<const int*>(q) + row * dq;
    for (int wd = lo / 32 + lane; wd * 32 < hi; wd += 32) {
      const int b0 = max(lo - wd * 32, 0), b1 = min(hi - wd * 32, 32);
      const unsigned lanes = (b1 - b0 == 32 ? 0xffffffffu : ((1u << (b1 - b0)) - 1u)) << b0;
      s += __popc(static_cast<unsigned>(qr[wd]) & lanes);
    }
  } else if ((lo | hi) % 16 == 0) {  // int8 spikes, 16-byte aligned range
    const int8_t* qr = static_cast<const int8_t*>(q) + row * dq;
    for (int c = lo + lane * 16; c < hi; c += 32 * 16) {
      const int4 v = *reinterpret_cast<const int4*>(qr + c);
      const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int i = 0; i < 16; ++i) s += e[i];
    }
  } else {                           // int8 spikes, a ragged head
    const int8_t* qr = static_cast<const int8_t*>(q) + row * dq;
    for (int c = lo + lane; c < hi; c += 32) s += qr[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// Lane s (0..3) of a quarter-warp's share of the QK sum of row `row` over
// q's columns [lo, hi): every fourth 16-value piece (int8, 16-aligned),
// value (ragged int8) or word (packed, ANDed with the lanes of [lo, hi) it
// holds). The four lanes' shares add up to qk_row_sum's; eight pairs a warp
// load at once.
__device__ __forceinline__ int qk_quarter_sum(const void* __restrict__ q, int dq,
                                              bool packed_q, size_t row, int lo,
                                              int hi, int s) {
  int sum = 0;
  if (packed_q) {
    const int* qr = static_cast<const int*>(q) + row * dq;
    for (int wd = lo / 32 + s; wd * 32 < hi; wd += 4) {
      const int b0 = max(lo - wd * 32, 0), b1 = min(hi - wd * 32, 32);
      const unsigned lanes = (b1 - b0 == 32 ? 0xffffffffu : ((1u << (b1 - b0)) - 1u)) << b0;
      sum += __popc(static_cast<unsigned>(qr[wd]) & lanes);
    }
  } else if ((lo | hi) % 16 == 0) {
    const int8_t* qr = static_cast<const int8_t*>(q) + row * dq;
    for (int c = lo + 16 * s; c < hi; c += 64) {
      const int4 v = *reinterpret_cast<const int4*>(qr + c);
      const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int i = 0; i < 16; ++i) sum += e[i];
    }
  } else {
    const int8_t* qr = static_cast<const int8_t*>(q) + row * dq;
    for (int c = lo + s; c < hi; c += 4) sum += qr[c];
  }
  return sum;
}

template <int XKind, bool EmitCurrent, int Skip, bool WithState>
__global__ void __launch_bounds__(kThreads)
fused_pe_kernel(const void* __restrict__ x, const float* __restrict__ w,
                Route route, const float* __restrict__ bias,
                const void* __restrict__ residual, const void* __restrict__ q,
                int dq, void* __restrict__ spikes, int* __restrict__ vld_next,
                float* __restrict__ current, const float* __restrict__ v_prev,
                const int8_t* __restrict__ s_prev, float* __restrict__ v_next,
                int kp, int np, int bn, int m_valid, int n_valid, float v_th,
                float qk_threshold, float tau, int head_dim, int flags) {
  __shared__ GemmSmem sm;
  __shared__ int warp_count[kThreads / 32];
  const int row_blk = blockIdx.y, col0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const bool packed_q = flags & kPackedQ, packed_res = flags & kPackedResidual;
  const bool packed_out = flags & kPackedOut;
  const bool soft_reset = flags & kSoftReset;

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
  event_gemm_tile<XKind, Skip>(x, w, route, kp, np, row_blk, col0, sm, acc);

  const int c0 = col0 + tx * kSub;
  // the heads this tile touches: [h_first, h_first + n_heads); the whole-row
  // mask is one "head" over all of q's columns
  int h_first = 0, n_heads = 1;
  if (head_dim > 0) {
    const int c_end = min(col0 + kTile, n_valid);  // columns past it never fire
    h_first = col0 / head_dim;
    n_heads = c_end > col0 ? (c_end - 1) / head_dim - h_first + 1 : 0;
  }
  // this thread's columns -> their gate slot (-1: past n_valid)
  int gate_of[kSub];
#pragma unroll
  for (int j = 0; j < kSub; ++j)
    gate_of[j] = (c0 + j >= n_valid) ? -1 : head_dim > 0 ? (c0 + j) / head_dim - h_first : 0;
  unsigned char* gate = reinterpret_cast<unsigned char*>(&sm);  // [kTile][n_heads]
  if (q != nullptr) {  // one warp per (row, head): integer row sums of Q spikes
    const int q_cols = packed_q ? dq * 32 : dq;
    for (int g = warp; g < kTile * n_heads; g += kThreads / 32) {
      const int r = g / n_heads, hh = h_first + g % n_heads;
      const int lo = head_dim > 0 ? hh * head_dim : 0;
      const int hi = head_dim > 0 ? lo + head_dim : q_cols;
      const size_t row = static_cast<size_t>(row_blk) * kTile + r;
      const int s = qk_row_sum(q, dq, packed_q, row, lo, hi, lane);
      if (lane == 0) gate[g] = static_cast<float>(s) >= qk_threshold ? 1 : 0;
    }
    __syncthreads();
  }

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
    const bool row_on = row < m_valid;
    uint64_t bytes = 0;
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      float cur = acc[i][j];
      if (bias != nullptr) cur = __fadd_rn(cur, b[j]);
      if (residual != nullptr) cur = __fadd_rn(cur, r[j]);
      const bool valid = row_on && c0 + j < n_valid;
      const size_t at = static_cast<size_t>(row) * n_valid + c0 + j;
      if constexpr (EmitCurrent) {
        if (valid) current[at] = cur;
      }
      float v = cur;
      if constexpr (WithState) {
        float vp = 0.f, sp = 0.f;
        if (valid) {
          vp = v_prev[at];
          sp = static_cast<float>(s_prev[at]);
        }
        v = __fadd_rn(__fmul_rn(__fmul_rn(tau, vp), __fsub_rn(1.f, sp)), cur);
      }
      // the layer's own spike, before the QK gate and the padding mask
      const bool fire = v >= v_th;
      if constexpr (WithState) {
        const float f = fire ? 1.f : 0.f;
        if (valid)
          v_next[at] = soft_reset ? __fsub_rn(v, __fmul_rn(v_th, f))
                                  : __fmul_rn(v, __fsub_rn(1.f, f));
      }
      const bool on = row_on && gate_of[j] >= 0 &&
                      (q == nullptr || gate[rl * n_heads + gate_of[j]] != 0);
      const bool s = on && fire;
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

// The decode route of the same layer (decode_gemm.cuh), for a dense f32 or
// bf16 activation x without residual, state or emitted current (the LM's
// projections): one CTA owns kDecodeCols output columns over the live
// rows, consumer thread (c, rg) the TR rows by TC columns DecodeGemm
// names. The QK gates of the (row, head) pairs the CTA touches are summed
// by the warps the ring leaves idle (or, at 64 rows, by every warp while
// the first chunks are in flight); the epilogue is the tile kernel's
// without state, output by output, in the consumers. The rows past 16 RM, up to the padded mp, are
// written as zeros (spikes, or the 16-bit half of each packed word this
// CTA's columns fill: the low half holds the lower 16 columns). The CTAs of
// one (128, bn) count tile add their spike counts, and an arrival, with
// one integer atomicAdd (exact in any order) into the tile's slot of a
// count scratch that every launch leaves zero (one a stream, kept by the
// caller), and the last CTA of the tile writes vld_next: no zero-filled
// vld_next, so no second kernel a launch. (A thread block
// cluster of a tile's 8 CTAs, summing through distributed shared memory,
// would need no scratch, but 8 CTAs of one SM each do not fit a GPC in one
// wave: it was slower on the H100.)
constexpr int kMaxDecodeHeads = kDecodeCols + 2;  // head_dim 1: 16 + 2

template <int XKind, int RM>
__global__ void __launch_bounds__(kDecodeThreads, 1)
fused_pe_decode_kernel(const void* __restrict__ x, const float* __restrict__ w,
                       Route route, const float* __restrict__ bias,
                       const void* __restrict__ q, int dq, void* __restrict__ spikes,
                       int* __restrict__ vld_next, int* __restrict__ counts, int mp,
                       int kp, int np, int bn, int m_valid, int n_valid, float v_th,
                       float qk_threshold, int head_dim, int flags) {
  static_assert(XKind == kXF32 || XKind == kXBF16, "a dense activation x");
  using G = DecodeGemm<XKind, RM>;
  constexpr int kTR = G::kTR, kTC = G::kTC, kRows = 16 * RM;
  constexpr int kWarps = kDecodeThreads / 32;
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ unsigned char gate[kDecodeRows * kMaxDecodeHeads];
  __shared__ int warp_count[kWarps];
  const int col0 = blockIdx.x * kDecodeCols;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool packed_q = flags & kPackedQ, packed_out = flags & kPackedOut;

  G gemm{dsm, x, w, kp, np, col0, m_valid, 0};
  gemm.start(route.vld, route.bk);

  // the heads this CTA touches (the whole-row mask: one over all of q)
  int h_first = 0, n_heads = 1;
  if (head_dim > 0) {
    const int c_end = min(col0 + kDecodeCols, n_valid);
    h_first = col0 / head_dim;
    n_heads = c_end > col0 ? (c_end - 1) / head_dim - h_first + 1 : 0;
  }
  // the gates, a quarter-warp per (live row, head), eight pairs a warp at
  // once: by the warps the ring leaves idle, while it runs, or else by
  // every warp while it fills
  auto gates = [&](int first, int warps) {
    if (q == nullptr) return;
    const int q_cols = packed_q ? dq * 32 : dq;
    const int pairs = m_valid * n_heads;
    for (int g = 8 * first + lane / 4; g - lane / 4 < pairs; g += 8 * warps) {
      int sum = 0;
      if (g < pairs) {
        const int r = g / n_heads, hh = h_first + g % n_heads;
        const int lo = head_dim > 0 ? hh * head_dim : 0;
        const int hi = head_dim > 0 ? lo + head_dim : q_cols;
        sum = qk_quarter_sum(q, dq, packed_q, static_cast<size_t>(r), lo, hi, lane % 4);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (lane % 4 == 0 && g < pairs)
        gate[g] = static_cast<float>(sum) >= qk_threshold ? 1 : 0;
    }
  };
  constexpr int kIdleFirst = G::kConsumers / 32;
  constexpr int kIdle = (kDecodeThreads - kProducers) / 32 - kIdleFirst;
  if constexpr (!G::kIdleWarps) gates(warp, kWarps);

  float acc[kTR][kTC];
  gemm.run(acc, [&] { gates(warp - kIdleFirst, kIdle); });

  const int words_per_row = np / 32;
  uint16_t* halves = static_cast<uint16_t*>(spikes);  // the packed words' halves
  const int half_at = 2 * (col0 / 32) + (col0 % 32) / 16;
  int count = 0;
  if (tid < G::kConsumers) {
    const int c = tid % G::kColGroups, rg = tid / G::kColGroups;
    const int c0 = col0 + kTC * c;
    int gate_of[kTC];
    float b[kTC];
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      gate_of[j] = (c0 + j >= n_valid) ? -1 : head_dim > 0 ? (c0 + j) / head_dim - h_first : 0;
      b[j] = bias != nullptr ? bias[c0 + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int row = rg + G::kRowGroups * i;
      const bool row_on = row < m_valid;
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        float cur = acc[i][j];
        if (bias != nullptr) cur = __fadd_rn(cur, b[j]);
        const bool fire = cur >= v_th;
        const bool on = row_on && gate_of[j] >= 0 &&
                        (q == nullptr || gate[row * n_heads + gate_of[j]] != 0);
        bits |= static_cast<unsigned>(on && fire) << j;
      }
      count += __popc(bits);
      if (packed_out) {  // the kColGroups lanes of this row, in lane order
        unsigned half = bits << (kTC * c);
#pragma unroll
        for (int off = 1; off < G::kColGroups; off <<= 1)
          half |= __shfl_xor_sync(0xffffffffu, half, off);
        if (c == 0)
          halves[2 * static_cast<size_t>(row) * words_per_row + half_at] =
              static_cast<uint16_t>(half);
      } else {  // one byte a column
        unsigned bytes = 0;
#pragma unroll
        for (int j = 0; j < kTC; ++j) bytes |= ((bits >> j) & 1u) << (8 * j);
        *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(spikes) +
                                     static_cast<size_t>(row) * np + c0) =
            static_cast<uint16_t>(bytes);
      }
    }
  }
  // the padded rows past this CTA's rows: no spike
  if (packed_out) {
    for (int row = kRows + tid; row < mp; row += kDecodeThreads)
      halves[2 * static_cast<size_t>(row) * words_per_row + half_at] = 0;
  } else {
    for (int i = tid; i < (mp - kRows) * (kDecodeCols / 4); i += kDecodeThreads) {
      const int row = kRows + i / (kDecodeCols / 4), p = i % (kDecodeCols / 4);
      *reinterpret_cast<int*>(static_cast<int8_t*>(spikes) + static_cast<size_t>(row) * np +
                              col0 + 4 * p) = 0;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) total += warp_count[v];
    // the (128, bn) count tile's CTAs add count << 8 | 1 into its slot of
    // the count scratch (at most 64 x 256 spikes and 16 CTAs a tile): the
    // one that finds the other CTAs' arrivals there writes the sum to
    // vld_next (row block 0; the padded row blocks hold none) and leaves
    // the slot zero for the stream's next launch
    int* slot = counts + col0 / bn;
    const int seen = atomicAdd(slot, total << 8 | 1);
    if ((seen & 0xff) == bn / kDecodeCols - 1) {
      vld_next[col0 / bn] = (seen >> 8) + total;
      *slot = 0;
      for (int rb = 1; rb < mp / kTile; ++rb) vld_next[rb * (np / bn) + col0 / bn] = 0;
    }
  }
}

// the state operands of one launch (all null without state), and the
// decode route's count scratch
struct State {
  const float* v_prev;
  const int8_t* s_prev;
  float* v_next;
  float tau;
  int* counts;
};

template <int XKind, bool EmitCurrent, int Skip, bool WithState>
void launch(const void* x, const float* w, const Route& route, const float* bias,
            const void* residual, const void* q, int dq, void* spikes,
            int* vld_next, float* current, const State& st, int mp, int kp,
            int np, int bn, int m_valid, int n_valid, float v_th,
            float qk_threshold, int head_dim, int flags, cudaStream_t stream) {
  const dim3 grid(np / kTile, mp / kTile);
  fused_pe_kernel<XKind, EmitCurrent, Skip, WithState><<<grid, kThreads, 0, stream>>>(
      x, w, route, bias, residual, q, dq, spikes, vld_next, current, st.v_prev,
      st.s_prev, st.v_next, kp, np, bn, m_valid, n_valid, v_th, qk_threshold,
      st.tau, head_dim, flags);
}

// the decode route's launch (route.vld may be null: every chunk kept; the
// C entry refuses a residual, a state and the current on this route)
template <int XKind, int RM>
void launch_decode(const void* x, const float* w, const Route& route, const float* bias,
                   const void*, const void* q, int dq, void* spikes, int* vld_next,
                   float*, const State& st, int mp, int kp, int np, int bn, int m_valid,
                   int n_valid, float v_th, float qk_threshold, int head_dim, int flags,
                   cudaStream_t stream) {
  const auto kernel = fused_pe_decode_kernel<XKind, RM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDecodeMaxSmem);
  (void)attr;  // a refusal shows as the launch's own error
  launch_decode_kernel(kernel, np, decode_smem_bytes<XKind, RM>(kp), stream, x, w, route,
                       bias, q, dq, spikes, vld_next, st.counts, mp, kp, np, bn, m_valid,
                       n_valid, v_th, qk_threshold, head_dim, flags);
}

using Launch = decltype(&launch<kXInt8, false, kDense, false>);

template <int XKind, bool EmitCurrent, bool WithState>
constexpr Launch pick_skip(int skip) {
  return skip == kDense ? &launch<XKind, EmitCurrent, kDense, WithState>
         : skip == kGated ? &launch<XKind, EmitCurrent, kGated, WithState>
                          : &launch<XKind, EmitCurrent, kTwoLevel, WithState>;
}

// the decode route at the row tile that covers m_valid: 16 rows, or 64
template <int XKind>
constexpr Launch pick_decode(int m_valid) {
  return m_valid <= 16 ? &launch_decode<XKind, 1> : &launch_decode<XKind, 4>;
}

// a launch's variant set: a spike x's (emit_current or not) on the tile
// route's skip, or a float x's on the decode route; each set is
// instantiated in a source of its own, so that the nvcc processes, all
// started together, build them in parallel: the int8 stateless launches
// and the float x tile ones in fused_pe.cu, and
Launch pick_decode_float(int x_kind, int m_valid);   // fused_pe_decode.cu
Launch pick_packed(bool emit, int skip);             // fused_pe_packed.cu
Launch pick_state_int8(bool emit, int skip);         // fused_pe_state.cu
Launch pick_state_packed(bool emit, int skip);       // fused_pe_state_packed.cu

}  // namespace repro
