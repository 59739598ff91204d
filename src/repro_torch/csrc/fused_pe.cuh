// Fused PE layer — replaces the Pallas kernel
// repro/kernels/fused_pe/fused_pe.py::fused_pe_pallas (bias, residual,
// whole-row or head-blocked Q mask, emit_vld, emit_current, and the LIF
// state of T > 1, with_state) under its three byte-skip strategies,
// skip="dense", "gated" and "two_level" (the routes of event_gemm.cuh,
// which give the same bits), with every spike operand and the output dense
// (int8) or bit-packed (int32 words of 32 spikes, the packed_in / packed_q
// / packed_residual / packed_out flags). x may also be a dense f32 or bf16
// activation (the LM's ops.dense_lif projections of the residual stream):
// its own kernel (fused_pe_float_kernel below, on the float-x tile of
// event_gemm.cuh), read at its own rows on the dense skip, with no vld map
// (a float operand has no silent blocks to skip) or with a given one; a
// float x takes no LIF state (the LM runs T = 1).
//
// Per output tile (128 x 128 for a spike x, 64 x 256 for a float x), in one
// pass: the event-gated f32 product x @ w (event_wgmma.cuh for a spike x,
// event_gemm.cuh for a float x; see "The product" below), then (in
// registers for a float x, in shared memory for a spike x)
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
// spike map in device memory: packed x becomes bf16 0/1 fragments in
// registers (event_wgmma.cuh); a packed Q row sum is __popc over the row's
// words; a packed residual (the identity shortcut) is the thread's 8 bits
// of one word, added as 0.f/1.f where the f32 residual is; a packed output
// word is the 8-bit rows of four neighbouring threads, combined with
// __shfl_xor_sync and stored by one of them. The f32 sums are the same as
// the int8 path's, so both give the same spikes.
//
// The product. A spike x (int8, or packed words: every launch of the SNN
// CNNs, forward and training, stateless or with the LIF state, under each
// skip) takes the tensor-core tile of event_wgmma.cuh: w split exactly into
// three bf16 terms (the wrapper's ws operand, made once a weight), each
// 32-deep k step's three products of exact bf16 terms into a fresh f32
// tile joined to the sum with one rounded add, restaged into shared
// memory. A dense f32 or bf16 activation x (the LM's projections) takes
// event_gemm.cuh's float-x tile: one IEEE fmaf chain over k ascending a
// current (kernels/chain.py::fma_chain), bit-equal to its decode route,
// through a TMA ring on a persistent grid that fills the card; the sums stay
// in registers, bias and residual added output by output
// (fused_pe_float_kernel).
//
// A spike x's epilogue, in shared memory (kEpi*: over the wgmma ring once
// the product is done). The LIF state (v_prev, s_prev) of the CTA's tile
// is requested with cp.async before the sums are restaged, so that its
// loads overlap the restage: the tile runs one CTA an SM (its ring and
// epilogue take 218 KB), so nothing else hides them, and the state read
// row by row, behind the recheck's calls, cost more than the product at
// res1 (PERF.md). Then each thread, for its 8 x 8 outputs, adds bias and
// residual (the residual of its 8 rows requested before any is used) to
// the sums in place, the currents, writes the membrane potentials in the
// state's place, and marks in a bitmap every valid output whose potential
// lies within kRecheckBand of v_th; the warps then recheck the marked
// outputs (below), writing their currents and potentials in place; and the
// per-row epilogue (threshold, reset, QK gate, packed output, vld_next)
// reads both from shared memory.
//
// The near-threshold recheck. The tensor cores' sum is as close to the
// exact one as the scalar tile's ascending f32 chain is (each within about
// 1e-5 at K = 4608 on the H100), but it is another rounding, and whether a
// spike fires is decided on it: a membrane potential within that of v_th
// may fall on the other side. A spiking network's gradient is not
// continuous in those decisions (a flipped QK q spike gates a whole token
// row), so the KD step, whose reference sums in the scalar tile's order,
// moved by 5e-2 of its stem conv's gradient (the gate is 1e-3) with no
// recheck. So for every marked output (kRecheckBand = 2^-15: the gap
// between the two sums measured at most 5.2e-6 on the main paths' operands
// and 1.14e-5 on random ones at K = 4608, on the H100) a warp forms its
// product again as the scalar tile's chain, fmaf over k in ascending order
// (event_wgmma.cuh: sequential_sum), and the current, the potential, the
// spike, v_next and the emitted current are all that sum's. Outside the
// band the two sums give the same spike. A stateful launch carries the
// same gap in v_prev, the tensor cores' sums of the steps before: the T =
// 4 KD step moved by 2.8e-2 of a gradient leaf with the recheck of the
// step's own sum alone. So where the wrapper passes the train's earlier
// steps (History: their x and residual operands, views of the train's one
// padded copy; the state began at zeros), the recheck replays them through
// the scalar tile's sums and the same LIF update to the state they
// carried, and the output is decided on it, where the exact sum's
// potential still lies within the band. That state is written to v_used
// (v_prev elsewhere) when the caller asks: the check of the spikes against
// the emitted current and the backward's recomputed step read it. No
// operand is written. Each marked output needs one chain a step (its own
// and, replayed, each earlier one's); the eight warps share the chains of
// up to kRecheckChains at a time, each chain walking K once with the lanes
// loading x two chunks ahead and gathering the nonzero x's weights while
// one lane adds, and then one thread an output combines its chains. About
// 5e-5 of a layer's outputs lie in the band on the main paths (chip_smoke
// prints the count within 1e-4 of v_th a launch).
//
// Bound on the H100: for a spike x, three bf16 products of the data's work
// (3 * 2 * nnz(x) * N at 989 TFLOP/s) or the bytes, whichever is larger;
// the tile computes every step the route keeps densely (a quarter to a
// half of it is spikes at the main path's rates), N = 64 (res1) half-fills
// the 128-wide tile, and each CTA streams its w terms from the L2 (6 bytes
// a weight), which with the joins between the wgmmas holds it above that
// bound (event_wgmma.cuh). A packed patch matrix pads each 3x3 tap's
// channels to whole 128-wide blocks, so at C = 64 its K is twice the int8
// one (1152, not 576): the padding is zeros the block skip cannot see, and
// the stripe skip (two_level) can, where an occ map comes with x. A dense
// activation x is a full f32 product, 2*M*K*N operations at the 67 TFLOP/s
// f32 rate outside the tensor cores (its fixed chain rules out TF32 and a
// bf16 split); event_gemm.cuh says what holds its tile above that. The
// LIF state adds 9 bytes an output element (v_prev and v_next f32, s_prev
// int8), read and written once at the valid extent. A dense activation x
// of at most kDecodeRows live rows without residual, state or emitted
// current (the LM's projections at its decode ticks and prefill chunks)
// takes the decode route instead (fused_pe_decode_kernel, decode_gemm.cuh):
// 16-column CTAs over the live rows only, the same sums and the same
// epilogue. A spike-x tile for N = 64 is later work.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "decode_gemm.cuh"
#include "event_gemm.cuh"
#include "event_wgmma.cuh"

namespace repro {

// the flags argument of repro_fused_pe: one bit per packed operand, then
// the dtype of a dense activation x (neither bit: int8 spikes)
constexpr int kPackedX = 1, kPackedQ = 2, kPackedResidual = 4, kPackedOut = 8;
constexpr int kF32X = 16, kBF16X = 32;
// the reset of the LIF state (WithState): set, soft (v - v_th); clear, hard
constexpr int kSoftReset = 64;

// the (row, head) gates of a spike x's tile: at most 128 / dh + 2 heads,
// stored as bytes over the chains' scratch once the product and the
// recheck are done with them (the float-x tile has room of its own for any
// dh, kFloatGateBytes)
constexpr int kMaxGateBytes = 32 * 1024;

// a spike x (int8, or packed words) takes the tensor-core product
template <int XKind>
constexpr bool kSpikeX = XKind == kXInt8 || XKind == kXPacked;

// A spike x's epilogue in shared memory, over the wgmma ring once the
// product is done (byte offsets): the currents, [kTile][kRestagePitch] f32
// (the restaged sums, then with bias and residual); the LIF state, v_prev
// f32 and s_prev int8 [kTile][kTile] each, requested before the restage so
// that their loads overlap it; the near-threshold map, one bit an output,
// and the recheck's index of it and its sums; the warps' chain scratch,
// which the gate bytes take after the recheck.
constexpr int kEpiVPrev = kRestageBytes;
constexpr int kEpiSPrev = kEpiVPrev + kTile * kTile * 4;
constexpr int kEpiNear = kEpiSPrev + kTile * kTile;
constexpr int kEpiBase = kEpiNear + kTile * kTile / 8;
constexpr int kRecheckChains = 256;  // the recheck's chains a round
constexpr int kEpiSums = kEpiBase + (kTile * kTile / 32 + 4) * 4;
constexpr int kEpiChain = kEpiSums + kRecheckChains * 4;
constexpr int kEpiBytes = kEpiChain + kThreads / 32 * kChainFloats * 4;
constexpr int kSpikeSmemBytes =
    (kEpiBytes > kWStages * kWStageBytes ? kEpiBytes : kWStages * kWStageBytes) + 1024;
static_assert(kMaxGateBytes <= kThreads / 32 * kChainFloats * 4,
              "the gate bytes fit the chains' scratch");
static_assert(kSpikeSmemBytes <= 227 * 1024, "a CTA's shared memory on the H100");

// this thread's 8 values (columns 8 tx ..) of row rl of an f32 tile of
// `pitch` floats a row; lanes with tx % 8 >= 4 move their upper four first,
// so that a quarter-warp's float4 accesses do not conflict on the banks
__device__ __forceinline__ void tile_get8(const float* t, int pitch, int rl, int tx,
                                          float (&v)[kSub]) {
  const float* src = t + rl * pitch + tx * kSub;
  const bool swap = (tx >> 2) & 1;
  const float4 u = *reinterpret_cast<const float4*>(src + (swap ? 4 : 0));
  const float4 z = *reinterpret_cast<const float4*>(src + (swap ? 0 : 4));
  const float4 lo = swap ? z : u, hi = swap ? u : z;
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void tile_put8(float* t, int pitch, int rl, int tx,
                                          const float (&v)[kSub]) {
  float* dst = t + rl * pitch + tx * kSub;
  const bool swap = (tx >> 2) & 1;
  const float4 lo = make_float4(v[0], v[1], v[2], v[3]), hi = make_float4(v[4], v[5], v[6], v[7]);
  *reinterpret_cast<float4*>(dst + (swap ? 4 : 0)) = swap ? hi : lo;
  *reinterpret_cast<float4*>(dst + (swap ? 0 : 4)) = swap ? lo : hi;
}

// The earlier timesteps of a stateful launch's train, which its
// near-threshold recheck replays (the state began at zeros): steps x and
// residual operands, each laid out as this launch's, `x_step` and
// `residual_step` bytes apart; steps 0 without them.
struct History {
  const void* x;
  const void* residual;
  long long x_step, residual_step;
  int steps;
};

// residual[row, col] of an f32 [mp, np] or packed [mp, np/32] operand
__device__ __forceinline__ float residual_at(const void* r, bool packed, int row, int col,
                                             int np) {
  if (packed)
    return ((static_cast<const unsigned*>(r)[static_cast<size_t>(row) * (np / 32) + col / 32] >>
             (col % 32)) & 1u) ? 1.f : 0.f;
  return static_cast<const float*>(r)[static_cast<size_t>(row) * np + col];
}

// The scalar tile's sum of output (row, col) of x (this step's, or an
// earlier one's) for the near-threshold recheck (fused_pe_kernel), in a
// function of its own: one copy in the kernel. Every lane of the warp
// calls it and gets the result.
template <int XKind>
__device__ __noinline__ float recheck_sum(const void* __restrict__ x,
                                          const float* __restrict__ w, int kp, int np, int row,
                                          int col, int lane, float* scratch) {
  return sequential_sum<XKind>(x, w, kp, np, row, col, lane, scratch);
}

// The marked output of index i in the near-threshold map's order (base[wd]
// of them in the words before wd): its (row, column) in the tile.
__device__ __forceinline__ int2 near_item(const unsigned* near_map, const int* base, int i) {
  int lo = 0, hi = kTile * kTile / 32 - 1;  // the last word whose base is <= i
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (base[mid] <= i)
      lo = mid;
    else
      hi = mid - 1;
  }
  unsigned bits = near_map[lo];
  for (int k = i - base[lo]; k > 0; --k) bits &= bits - 1u;
  return make_int2(lo / (kTile / 32), lo % (kTile / 32) * 32 + __ffs(bits) - 1);
}

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
                const uint16_t* __restrict__ ws, Route route, History hist,
                const float* __restrict__ bias,
                const void* __restrict__ residual, const void* __restrict__ q,
                int dq, void* __restrict__ spikes, int* __restrict__ vld_next,
                float* __restrict__ current, const float* __restrict__ v_prev,
                const int8_t* __restrict__ s_prev, float* __restrict__ v_next,
                float* __restrict__ v_used, int kp, int np, int bn, int m_valid,
                int n_valid, float v_th, float qk_threshold, float tau, int head_dim,
                int flags) {
  static_assert(kSpikeX<XKind>, "a float x takes fused_pe_float_kernel");
  __shared__ int warp_count[kThreads / 32];
  const int row_blk = blockIdx.y, col0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const bool packed_q = flags & kPackedQ, packed_res = flags & kPackedResidual;
  const bool packed_out = flags & kPackedOut;
  const bool soft_reset = flags & kSoftReset;
  const int c0 = col0 + tx * kSub;
  const int words_per_row = np / 32;
  // output (row, c0 ..) lies at row * n_valid + c0 in the state and the
  // current; its 8 move 16 bytes at a time where all lie in the valid
  // extent and the bases are aligned
  auto whole_row = [&](int row) {
    const bool aligned =
        (reinterpret_cast<uintptr_t>(v_prev) | reinterpret_cast<uintptr_t>(v_next) |
         reinterpret_cast<uintptr_t>(current) | reinterpret_cast<uintptr_t>(v_used)) % 16 ==
            0 &&
        reinterpret_cast<uintptr_t>(s_prev) % 8 == 0;
    return aligned && row < m_valid && c0 + kSub <= n_valid &&
           (static_cast<size_t>(row) * n_valid + c0) % kSub == 0;
  };
  // this thread's 8 values of row `row` into dst [m_valid, n_valid] (the
  // current, v_next, the state decided on), inside the valid extent
  auto store_row = [&](float* dst, int row, const float (&vals)[kSub]) {
    const size_t at0 = static_cast<size_t>(row) * n_valid + c0;
    if (whole_row(row)) {
      *reinterpret_cast<float4*>(dst + at0) = make_float4(vals[0], vals[1], vals[2], vals[3]);
      *reinterpret_cast<float4*>(dst + at0 + 4) = make_float4(vals[4], vals[5], vals[6], vals[7]);
    } else {
#pragma unroll
      for (int j = 0; j < kSub; ++j)
        if (row < m_valid && c0 + j < n_valid) dst[at0 + j] = vals[j];
    }
  };

  // The product on the tensor cores (event_wgmma.cuh), whose sums become
  // the currents in shared memory, each within kRecheckBand of v_th formed
  // again on the scalar chain ("The near-threshold recheck" above). Then the
  // gate bytes reuse shared memory the product no longer needs.
  unsigned char* gate;
  extern __shared__ uint8_t fused_pe_wgmma_smem[];
  uint8_t* smem = wgmma_smem(fused_pe_wgmma_smem);  // the epilogue's (kEpi* offsets)
  float* cur_tile = reinterpret_cast<float*>(smem);  // the currents [kTile][kRestagePitch]
  float* vp_tile = reinterpret_cast<float*>(smem + kEpiVPrev);  // with the state: v_prev
  int8_t* sp_tile = reinterpret_cast<int8_t*>(smem + kEpiSPrev);  // and s_prev [kTile][kTile]
  {
    float sum[64];
    event_wgmma_tile<XKind, Skip>(x, ws, route, kp, np, row_blk, col0, smem, sum);
    unsigned* near_map = reinterpret_cast<unsigned*>(smem + kEpiNear);
    for (int i = tid; i < kTile * kTile / 32; i += kThreads) near_map[i] = 0u;
    if constexpr (WithState) {
      // this thread's 8 x 8 of the state, requested now and read after the
      // restage; zeros past the valid extent, where none fires
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int rl = ty * kSub + i, row = row_blk * kTile + rl;
        const size_t at0 = static_cast<size_t>(row) * n_valid + c0;
        float* dv = vp_tile + rl * kTile + tx * kSub;
        int8_t* ds = sp_tile + rl * kTile + tx * kSub;
        if (whole_row(row)) {
          hopper::cp_async16(hopper::smem_u32(dv), v_prev + at0, true);
          hopper::cp_async16(hopper::smem_u32(dv + 4), v_prev + at0 + 4, true);
          hopper::cp_async4(hopper::smem_u32(ds), s_prev + at0, true);
          hopper::cp_async4(hopper::smem_u32(ds + 4), s_prev + at0 + 4, true);
        } else {
#pragma unroll
          for (int j = 0; j < kSub; ++j) {
            const bool valid = row < m_valid && c0 + j < n_valid;
            dv[j] = valid ? v_prev[at0 + j] : 0.f;
            ds[j] = valid ? s_prev[at0 + j] : static_cast<int8_t>(0);
          }
        }
      }
      hopper::cp_async_commit();
    }
    restage_sum(sum, cur_tile);
  }

  float b[kSub];
#pragma unroll
  for (int j = 0; j < kSub; ++j) b[j] = 0.f;
  if (bias != nullptr) {
    const float4 b0 = *reinterpret_cast<const float4*>(bias + c0);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + c0 + 4);
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
  }
  {
    unsigned* near_map = reinterpret_cast<unsigned*>(smem + kEpiNear);  // [kTile][kTile / 32]
    if constexpr (WithState) hopper::cp_async_wait<0>();  // this thread's own state
    // the currents in fused_pe_ref's order ((sum + bias) + residual), in
    // place, and the map of the valid outputs whose membrane potential lies
    // within kRecheckBand of v_th; the residual of all 8 rows is requested
    // before any is used
    float rr[kSub][kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const size_t row = static_cast<size_t>(row_blk) * kTile + ty * kSub + i;
#pragma unroll
      for (int j = 0; j < kSub; ++j) rr[i][j] = 0.f;
      if (residual != nullptr && packed_res) {  // this thread's 8 bits of a word
        const unsigned word = static_cast<unsigned>(
            static_cast<const int*>(residual)[row * words_per_row + c0 / 32]);
#pragma unroll
        for (int j = 0; j < kSub; ++j) rr[i][j] = ((word >> (c0 % 32 + j)) & 1u) ? 1.f : 0.f;
      } else if (residual != nullptr) {
        const float* rp = static_cast<const float*>(residual) + row * np + c0;
        const float4 r0 = *reinterpret_cast<const float4*>(rp);
        const float4 r1 = *reinterpret_cast<const float4*>(rp + 4);
        rr[i][0] = r0.x; rr[i][1] = r0.y; rr[i][2] = r0.z; rr[i][3] = r0.w;
        rr[i][4] = r1.x; rr[i][5] = r1.y; rr[i][6] = r1.z; rr[i][7] = r1.w;
      }
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int rl = ty * kSub + i;
      const int row = row_blk * kTile + rl;
      const bool row_on = row < m_valid;
      float cv[kSub], vps[kSub] = {}, sps[kSub] = {}, pot[kSub];
      tile_get8(cur_tile, kRestagePitch, rl, tx, cv);
      if constexpr (WithState) {
        tile_get8(vp_tile, kTile, rl, tx, vps);
        const uint2 s8 = *reinterpret_cast<const uint2*>(sp_tile + rl * kTile + tx * kSub);
#pragma unroll
        for (int j = 0; j < kSub; ++j)
          sps[j] = static_cast<float>(static_cast<int8_t>((j < 4 ? s8.x : s8.y) >> (8 * (j % 4))));
      }
      unsigned near = 0u;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (bias != nullptr) cv[j] = __fadd_rn(cv[j], b[j]);
        if (residual != nullptr) cv[j] = __fadd_rn(cv[j], rr[i][j]);
        pot[j] = cv[j];
        if constexpr (WithState)
          pot[j] = __fadd_rn(__fmul_rn(__fmul_rn(tau, vps[j]), __fsub_rn(1.f, sps[j])), cv[j]);
        if (row_on && c0 + j < n_valid && fabsf(pot[j] - v_th) < kRecheckBand) near |= 1u << j;
      }
      tile_put8(cur_tile, kRestagePitch, rl, tx, cv);
      if constexpr (WithState) {
        // the membrane potential takes the state's place; the state decided
        // on goes out now (the recheck rewrites those it replays)
        tile_put8(vp_tile, kTile, rl, tx, pot);
        if (v_used != nullptr) store_row(v_used, row, vps);
      }
      if (near != 0u) atomicOr(near_map + rl * (kTile / 32) + tx / 4, near << (8 * (tx % 4)));
    }
    __syncthreads();
    // the recheck: each marked output's sum formed again as the scalar
    // tile's chain, and with earlier steps theirs too, one chain a warp,
    // the warps sharing the chains of a round of outputs (indexed in the
    // map's order: base[wd] of them in the words before wd); then one
    // thread an output takes its current from its chain and, where the
    // exact sum's potential still lies within the band, its state from the
    // earlier steps' chains, replayed from zeros
    constexpr int kWords = kTile * kTile / 32;
    int* base = reinterpret_cast<int*>(smem + kEpiBase);  // [kWords + 1]
    float* sums = reinterpret_cast<float*>(smem + kEpiSums);
    float* scratch = reinterpret_cast<float*>(smem + kEpiChain) + warp * kChainFloats;
    if (warp == 0) {
      constexpr int kPer = kWords / 32;
      int n = 0;
#pragma unroll
      for (int q = 0; q < kPer; ++q) n += __popc(near_map[kPer * lane + q]);
      int at = n;  // inclusive prefix over the lanes, then exclusive
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, at, off);
        if (lane >= off) at += t;
      }
      if (lane == 31) base[kWords] = at;
      at -= n;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        base[kPer * lane + q] = at;
        at += __popc(near_map[kPer * lane + q]);
      }
    }
    __syncthreads();
    const int items = base[kWords];
    const int chains = WithState ? hist.steps + 1 : 1;  // an output's: one a step
    const int round = max(1, kRecheckChains / chains);
    for (int r0 = 0; r0 < items; r0 += round) {
      const int n = min(round, items - r0);
      for (int u = warp; u < n * chains; u += kThreads / 32) {
        const int2 at = near_item(near_map, base, r0 + u / chains);
        const int st = u % chains;  // chains - 1: this step; else an earlier one
        const void* xs =
            st == chains - 1 ? x : static_cast<const char*>(hist.x) + st * hist.x_step;
        const float sum = recheck_sum<XKind>(xs, w, kp, np, row_blk * kTile + at.x,
                                             col0 + at.y, lane, scratch);
        if (lane == 0) sums[u] = sum;
      }
      __syncthreads();
      for (int i = tid; i < n; i += kThreads) {
        const int2 at = near_item(near_map, base, r0 + i);
        const int rl = at.x, cl = at.y, row = row_blk * kTile + rl, col = col0 + cl;
        const float* chain = sums + i * chains;
        float cur = chain[chains - 1];
        if (bias != nullptr) cur = __fadd_rn(cur, bias[col]);
        if (residual != nullptr)
          cur = __fadd_rn(cur, residual_at(residual, packed_res, row, col, np));
        if constexpr (WithState) {
          const size_t at = static_cast<size_t>(row) * n_valid + col;
          const float sp = s_prev[at];
          float vp = v_prev[at];
          float v = __fadd_rn(__fmul_rn(__fmul_rn(tau, vp), __fsub_rn(1.f, sp)), cur);
          if (chains > 1 && fabsf(v - v_th) < kRecheckBand) {
            float vv = 0.f, ss = 0.f;
            for (int h = 0; h < chains - 1; ++h) {
              float c = chain[h];
              if (bias != nullptr) c = __fadd_rn(c, bias[col]);
              if (residual != nullptr)
                c = __fadd_rn(c, residual_at(static_cast<const char*>(hist.residual) +
                                                 h * hist.residual_step,
                                             packed_res, row, col, np));
              const float vh =
                  __fadd_rn(__fmul_rn(__fmul_rn(tau, vv), __fsub_rn(1.f, ss)), c);
              const float f = vh >= v_th ? 1.f : 0.f;
              vv = soft_reset ? __fsub_rn(vh, __fmul_rn(v_th, f))
                              : __fmul_rn(vh, __fsub_rn(1.f, f));
              ss = f;
            }
            vp = vv;
            v = __fadd_rn(__fmul_rn(__fmul_rn(tau, vp), __fsub_rn(1.f, sp)), cur);
            if (v_used != nullptr) v_used[at] = vp;
          }
          vp_tile[rl * kTile + cl] = v;
        }
        cur_tile[rl * kRestagePitch + cl] = cur;
      }
      __syncthreads();
    }
    __syncthreads();
    gate = smem + kEpiChain;
  }

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
  // gate: [kTile][n_heads]
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

  int count = 0;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int rl = ty * kSub + i;
    const int row = row_blk * kTile + rl;
    const bool row_on = row < m_valid;
    // this row's currents and membrane potentials, from shared memory
    // (with the state, the potential in the state's place)
    float cur_in[kSub], pot[kSub];
    tile_get8(cur_tile, kRestagePitch, rl, tx, cur_in);
    if constexpr (WithState) tile_get8(vp_tile, kTile, rl, tx, pot);
    if constexpr (!WithState) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) pot[j] = cur_in[j];
    }
    float v_out[kSub];
    uint64_t bytes = 0;
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const float v = pot[j];
      // the layer's own spike, before the QK gate and the padding mask
      const bool fire = v >= v_th;
      if constexpr (WithState) {
        const float f = fire ? 1.f : 0.f;
        v_out[j] = soft_reset ? __fsub_rn(v, __fmul_rn(v_th, f))
                              : __fmul_rn(v, __fsub_rn(1.f, f));
      }
      const bool on = row_on && gate_of[j] >= 0 &&
                      (q == nullptr || gate[rl * n_heads + gate_of[j]] != 0);
      const bool s = on && fire;
      count += s;
      bytes |= static_cast<uint64_t>(s) << (8 * j);
      bits |= static_cast<unsigned>(s) << j;
    }
    // the emitted current and v_next, inside the valid extent
    if constexpr (EmitCurrent) store_row(current, row, cur_in);
    if constexpr (WithState) store_row(v_next, row, v_out);
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

// The tile of a dense f32 or bf16 activation x (the float-x tile,
// event_gemm.cuh): a persistent CTA walks its run of 64 x 256 tiles, its
// producer warp keeping the TMA ring filled across them. For each tile
// the 8 consumer warps sum the QK gates of the (row, head) pairs it
// touches into shared memory (one quarter-warp a pair, eight a warp at
// once) while the ring fills, run the product, and then the epilogue of
// the tile kernel without state, in registers: thread (ty, tx) of warp
// (wm, wn) holds rows 16 wm + 2 i + ty and columns 128 wn + 64 q + 4 tx + e
// (a thin tile: rows 2 i + ty, columns 32 warp + 2 tx + e), adds bias and
// residual (the reference's order), thresholds, gates and masks, writes the
// emitted current at the valid extent, its spikes (bytes, or bits of a
// packed word joined across the word's lanes by __shfl_xor_sync), and adds
// each warp's spike count into vld_next (zeroed by the caller) with one
// integer atomicAdd, exact in any order. A tile in the last row of tiles
// also writes the spikes of the rows past it (past a thin tile's 16), up
// to mp, as zeros.
struct FloatTileArgs {
  CUtensorMap wmap;        // w [kp, np] f32: boxes of 32 rows by 256 columns
  CUtensorMap xmap;        // x [m, kp]: boxes of 64 rows by 32 values, swizzled
  const int* vld;          // x's count map [mp / 128, kp / bk], or null
  const float* bias;       // [np] or null
  const void* residual;    // [mp, np] f32, [mp, np / 32] words, or null
  const void* q;           // [>= m, dq] int8 or words, or null
  void* spikes;            // [mp, np] int8 or [mp, np / 32] words
  int* vld_next;           // [mp / 128, np / bn], zeroed
  float* current;          // [m, n_valid] or null
  FloatGrid grid;
  int m, kp, np, mp, bk, bn, n_valid, dq, head_dim, flags;
  float v_th, qk_threshold;
};

// the consumer warps' own barrier (named barrier 1: warps 0-7, not the
// producer warp)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

template <int XKind, bool EmitCurrent>
__global__ void __launch_bounds__(kFloatThreads, 1)
fused_pe_float_kernel(const __grid_constant__ FloatTileArgs a) {
  extern __shared__ unsigned char float_smem_raw[];
  unsigned char* const smem = wgmma_smem(float_smem_raw);   // 1024-byte aligned
  unsigned char* const gate = smem + kFloatGates;           // [kFloatRows][n_heads]
  // slot s's full barrier (the producer's TMA bytes) at 8 s, its empty one
  // (the 8 consumer warps' arrivals) at 8 (kFloatStages + s)
  const uint32_t bars = hopper::smem_u32(smem + kFloatBars);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2, ty = lane / 16, tx = lane % 16;
  const bool packed_q = a.flags & kPackedQ, packed_res = a.flags & kPackedResidual;
  const bool packed_out = a.flags & kPackedOut;
  const int words_per_row = a.np / 32;
  const FloatGrid& g = a.grid;

  const int G = static_cast<int>(gridDim.x), c = static_cast<int>(blockIdx.x);
  const long long cost = float_cost(g, g.full + g.ntiles);
  const int t_begin = float_first(g, cost * c / G);
  const int t_end = float_first(g, cost * (c + 1) / G);
  if (t_begin >= t_end) return;

  if (tid == 0) {
    for (int s = 0; s < kFloatStages; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      hopper::mbar_init(bars + 8 * (kFloatStages + s), kThreads / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kThreads / 32) {
    // the producer warp (one lane): every step of the CTA's run, across
    // its tiles, into slot p % kFloatStages by two TMA loads, once the 8
    // consumer warps have released the slot's step before
    if (lane != 0) return;
    constexpr uint32_t kXBoxBytes = kFloatRows * kStep * (XKind == kXF32 ? 4 : 2);
    int p = 0;
    for (int t = t_begin; t < t_end; ++t) {
      const int row0 = (t / g.ntiles) * kFloatRows, col0 = (t % g.ntiles) * kFloatCols;
      FloatWalk pw;
      pw.begin(a.vld, row0 / kTile, a.bk, a.kp, a.m);
      for (int k0 = pw.next(); k0 >= 0; k0 = pw.next(), ++p) {
        const int s = p % kFloatStages, use = p / kFloatStages;
        if (use > 0) hopper::mbar_wait(bars + 8 * (kFloatStages + s), (use - 1) & 1);
        const uint32_t bar = bars + 8 * s;
        const uint32_t st = hopper::smem_u32(smem + s * kFloatStage);
        hopper::mbar_expect_tx(bar, kFloatWBytes + kXBoxBytes);
        hopper::tma_load_2d(st, &a.wmap, bar, col0, k0);
        hopper::tma_load_2d(st + kFloatWBytes, &a.xmap, bar, k0, row0);
      }
    }
    return;
  }

  int p = 0;   // the run's steps consumed
  for (int t = t_begin; t < t_end; ++t) {
    const int row0 = (t / g.ntiles) * kFloatRows, col0 = (t % g.ntiles) * kFloatCols;
    const int row_blk = row0 / kTile;

    // the heads this tile touches: [h_first, h_first + n_heads); the
    // whole-row mask is one "head" over all of q's columns
    int h_first = 0, n_heads = 1;
    if (a.head_dim > 0) {
      const int c_end = min(col0 + kFloatCols, a.n_valid);   // columns past it never fire
      h_first = col0 / a.head_dim;
      n_heads = c_end > col0 ? (c_end - 1) / a.head_dim - h_first + 1 : 0;
    }
    consumers_sync();   // the previous tile's epilogue is done with the gates
    if (a.q != nullptr) {   // gate[r * n_heads + h]: rows past m never fire
      const int q_cols = packed_q ? a.dq * 32 : a.dq;
      const int pairs = kFloatRows * n_heads;
      for (int pr = 8 * warp + lane / 4; pr - lane / 4 < pairs; pr += 8 * (kThreads / 32)) {
        const int r = pr / max(n_heads, 1), hh = h_first + pr % max(n_heads, 1);
        const bool live = pr < pairs && row0 + r < a.m;
        int sum = 0;
        if (live) {
          const int lo = a.head_dim > 0 ? hh * a.head_dim : 0;
          const int hi = a.head_dim > 0 ? lo + a.head_dim : q_cols;
          sum = qk_quarter_sum(a.q, a.dq, packed_q, static_cast<size_t>(row0 + r), lo, hi,
                               lane % 4);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (lane % 4 == 0 && pr < pairs)
          gate[pr] = live && static_cast<float>(sum) >= a.qk_threshold ? 1 : 0;
      }
    }
    consumers_sync();

    FloatWalk cw;
    cw.begin(a.vld, row_blk, a.bk, a.kp, a.m);
    int steps = 0;
    while (cw.next() >= 0) ++steps;
    // a tile of at most 16 live rows takes the thin mapping (every warp on
    // rows 0 .. 15, 32 columns each), any other the full one (warp wm, wn
    // on rows 16 wm .., columns 128 wn ..); a warp whose rows or columns
    // all lie past the operands' runs no FMA
    const bool thin = a.m - row0 <= 16;
    const int cw0 = thin ? col0 + 32 * warp : col0 + 128 * wn;   // the warp's columns
    const bool busy = cw0 < a.np && (thin || row0 + 16 * wm < a.m);
    float acc[kSub][kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
    for (int i = 0; i < steps; ++i, ++p) {
      const int s = p % kFloatStages;
      hopper::mbar_wait(bars + 8 * s, (p / kFloatStages) & 1);   // this step landed
      if (busy) {
        if (thin)
          float_fmas_thin<XKind>(smem + s * kFloatStage, warp, ty, tx, acc);
        else
          float_fmas<XKind>(smem + s * kFloatStage, wm, wn, ty, tx, acc);
      }
      __syncwarp();   // the warp is done with the slot: release it
      if (lane == 0) hopper::mbar_arrive(bars + 8 * (kFloatStages + s));
    }

    // the epilogue, NC columns c0 .. c0 + NC - 1 of tile row rl at a time
    // (the full mapping's 4, the thin one's 2; the word of 32 columns lies
    // in 32 / NC lanes of one row, tx's low bits)
    int count = 0;
    const bool cur_vec = (reinterpret_cast<uintptr_t>(a.current) % 16 == 0) &&
                         a.n_valid % 4 == 0;
    auto group = [&](auto nc, int rl, int c0, const float* sums) {
      constexpr int NC = decltype(nc)::value;
      const int row = row0 + rl;
      const bool row_on = row < a.m;
      float cur[NC], r[NC] = {};
      if (a.residual != nullptr && row_on) {
        if (packed_res) {   // this thread's NC bits of a word
          const unsigned word = static_cast<unsigned>(static_cast<const int*>(
              a.residual)[static_cast<size_t>(row) * words_per_row + c0 / 32]);
#pragma unroll
          for (int e = 0; e < NC; ++e) r[e] = ((word >> (c0 % 32 + e)) & 1u) ? 1.f : 0.f;
        } else {
          const float* rp = static_cast<const float*>(a.residual) +
                            static_cast<size_t>(row) * a.np + c0;
#pragma unroll
          for (int e = 0; e < NC; ++e) r[e] = rp[e];
        }
      }
      unsigned bits = 0;
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        cur[e] = sums[e];
        if (a.bias != nullptr) cur[e] = __fadd_rn(cur[e], a.bias[c0 + e]);
        if (a.residual != nullptr) cur[e] = __fadd_rn(cur[e], r[e]);
        const int gs = c0 + e >= a.n_valid ? -1
                       : a.head_dim > 0   ? (c0 + e) / a.head_dim - h_first
                                          : 0;
        const bool on = row_on && gs >= 0 && (a.q == nullptr || gate[rl * n_heads + gs] != 0);
        bits |= static_cast<unsigned>(on && cur[e] >= a.v_th) << e;
      }
      count += __popc(bits);
      if constexpr (EmitCurrent) {   // the current, inside the valid extent
        if (row_on) {
          float* dst = a.current + static_cast<size_t>(row) * a.n_valid + c0;
          bool whole = false;
          if constexpr (NC == 4) {
            whole = cur_vec && c0 + 4 <= a.n_valid;
            if (whole)
              *reinterpret_cast<float4*>(dst) = make_float4(cur[0], cur[1], cur[2], cur[3]);
          }
          if (!whole) {
#pragma unroll
            for (int e = 0; e < NC; ++e)
              if (c0 + e < a.n_valid) dst[e] = cur[e];
          }
        }
      }
      if (packed_out) {
        // shift each lane's NC bits into place and OR the word's lanes
        unsigned word = bits << (c0 % 32);
#pragma unroll
        for (int off = 1; off < 32 / NC; off <<= 1) word |= __shfl_xor_sync(0xffffffffu, word, off);
        if (c0 % 32 == 0)
          static_cast<int*>(a.spikes)[static_cast<size_t>(row) * words_per_row + c0 / 32] =
              static_cast<int>(word);
      } else {
        unsigned bytes = 0;
#pragma unroll
        for (int e = 0; e < NC; ++e) bytes |= ((bits >> e) & 1u) << (8 * e);
        int8_t* dst = static_cast<int8_t*>(a.spikes) + static_cast<size_t>(row) * a.np + c0;
        if constexpr (NC == 4)
          *reinterpret_cast<unsigned*>(dst) = bytes;
        else
          *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(bytes);
      }
    };
    if (cw0 < a.np) {
      if (thin) {
#pragma unroll
        for (int i = 0; i < kSub; ++i)
          group(std::integral_constant<int, 2>{}, 2 * i + ty, cw0 + 2 * tx, acc[i]);
      } else {
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            group(std::integral_constant<int, 4>{}, 16 * wm + 2 * i + ty, cw0 + 64 * q + 4 * tx,
                  &acc[i][4 * q]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
      if (lane == 0 && count != 0)
        atomicAdd(a.vld_next + row_blk * (a.np / a.bn) + cw0 / a.bn, count);
    }
    // the rows past the last row of tiles (and past a thin tile's 16), up
    // to mp: no spike
    if (t / g.ntiles == g.mtiles - 1) {
      const int r0 = thin ? row0 + 16 : row0 + kFloatRows, cols = min(kFloatCols, a.np - col0);
      if (packed_out) {
        const int words = cols / 32;
        for (int i = tid; i < (a.mp - r0) * words; i += kThreads)
          static_cast<int*>(a.spikes)[static_cast<size_t>(r0 + i / words) * words_per_row +
                                      col0 / 32 + i % words] = 0;
      } else {
        const int units = cols / 16;
        for (int i = tid; i < (a.mp - r0) * units; i += kThreads)
          *reinterpret_cast<uint4*>(static_cast<int8_t*>(a.spikes) +
                                    static_cast<size_t>(r0 + i / units) * a.np + col0 +
                                    16 * (i % units)) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
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

// the state operands of one launch (all null without state; v_used, the
// state its spikes were decided on, may be null), the decode route's count
// scratch, and the earlier steps a stateful launch's recheck replays
struct State {
  const float* v_prev;
  const int8_t* s_prev;
  float* v_next;
  float* v_used;
  float tau;
  int* counts;
  History hist;
};

template <int XKind, bool EmitCurrent, int Skip, bool WithState>
void launch(const void* x, const float* w, const uint16_t* ws, const Route& route,
            const float* bias, const void* residual, const void* q, int dq, void* spikes,
            int* vld_next, float* current, const State& st, int mp, int kp,
            int np, int bn, int m_valid, int n_valid, float v_th,
            float qk_threshold, int head_dim, int flags, cudaStream_t stream) {
  const auto kernel = fused_pe_kernel<XKind, EmitCurrent, Skip, WithState>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSpikeSmemBytes);
  (void)attr;  // a refusal shows as the launch's own error
  const dim3 grid(np / kTile, mp / kTile);
  kernel<<<grid, kThreads, kSpikeSmemBytes, stream>>>(
      x, w, ws, route, st.hist, bias, residual, q, dq, spikes, vld_next, current, st.v_prev,
      st.s_prev, st.v_next, st.v_used, kp, np, bn, m_valid, n_valid, v_th, qk_threshold,
      st.tau, head_dim, flags);
}

// the decode route's launch (route.vld may be null: every chunk kept; the
// C entry refuses a residual, a state and the current on this route)
template <int XKind, int RM>
void launch_decode(const void* x, const float* w, const uint16_t*, const Route& route,
                   const float* bias, const void*, const void* q, int dq, void* spikes,
                   int* vld_next, float*, const State& st, int mp, int kp, int np, int bn,
                   int m_valid, int n_valid, float v_th, float qk_threshold, int head_dim,
                   int flags, cudaStream_t stream) {
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
// in fused_pe.cu, and
Launch pick_decode_float(int x_kind, int m_valid);   // fused_pe_decode.cu
Launch pick_packed(bool emit, int skip);             // fused_pe_packed.cu
Launch pick_state_int8(bool emit, int skip);         // fused_pe_state.cu
Launch pick_state_packed(bool emit, int skip);       // fused_pe_state_packed.cu
// and the float-x tile's launch (fused_pe_float.cu): the maps encoded, the
// persistent grid; 0, a CUDA error, or hopper::kEncodeError + a CUresult
int launch_float_tile(int x_kind, bool emit, FloatTileArgs& a, const void* x, const float* w,
                      cudaStream_t stream);

}  // namespace repro
