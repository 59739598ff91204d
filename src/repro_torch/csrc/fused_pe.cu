// Fused PE layer: the C entry, and the stateless tile-route launches of an
// int8 or a dense float x (the kernel, its design and its bound are
// described in fused_pe.cuh; the other variants are instantiated in
// fused_pe_decode.cu, fused_pe_packed.cu, fused_pe_state.cu and
// fused_pe_state_packed.cu).
#include <cstdint>
#include <cuda_runtime.h>

#include "fused_pe.cuh"

using namespace repro;

namespace {

// the launch of one variant: the tile route on skip, or (a float x only)
// the decode route at the row tile that covers m_valid
Launch pick(int x_kind, bool emit, bool state, int skip, bool decode, int m_valid) {
  if (x_kind == kXPacked) return state ? pick_state_packed(emit, skip) : pick_packed(emit, skip);
  if (state) return pick_state_int8(emit, skip);
  if (decode) return pick_decode_float(x_kind, m_valid);
  if (x_kind == kXF32)
    return emit ? &launch<kXF32, true, kDense, false> : &launch<kXF32, false, kDense, false>;
  if (x_kind == kXBF16)
    return emit ? &launch<kXBF16, true, kDense, false> : &launch<kXBF16, false, kDense, false>;
  return emit ? pick_skip<kXInt8, true, false>(skip) : pick_skip<kXInt8, false, false>(skip);
}

}  // namespace

// x [mp, kp] int8 (no dtype flag), f32 (kF32X) or bf16 (kBF16X), or
// [mp, kp/32] int32 words (kPackedX); w [kp, np] f32. The route (skip, see
// event_gemm.cuh): kDense reads vld [mp/128, kp/bk]; kGated nact [mp/128]
// and kmap [mp/128, kp/bk]; kTwoLevel also occ [mp/128, kp/bk]; a float x
// takes kDense only. May be null: bias [np] f32; residual [mp, np] f32 or
// [mp, np/32] words (kPackedResidual); q [mp, dq] int8 (dq a multiple of
// 128) or [mp, dq] words (kPackedQ, dq words per row); current [m_valid,
// n_valid] f32 (the emit_current variant); the LIF state (a spike x
// only, all three or none): v_prev [m_valid, n_valid] f32, s_prev
// [m_valid, n_valid] int8 and v_next [m_valid, n_valid] f32 out, decayed
// by tau and reset hard, or soft with kSoftReset. head_dim > 0 makes the q
// mask head-blocked (heads of head_dim columns, head_dim * heads ==
// n_valid, q at least n_valid columns wide); 0 keeps the whole-row mask.
// Writes spikes [mp, np] int8 or [mp, np/32] words (kPackedOut), vld_next
// [mp/128, np/bn] int32 (zeroed by the caller when bn > 128) and, when
// current is not null, the current.
//
// route kRouteDecode (decode_gemm.cuh) takes a float x on the dense skip,
// m_valid <= kDecodeRows, no residual, no state and no current: x and q
// need only their first m_valid rows (mp is the padded output's rows, a
// multiple of 128), vld may be null (every block kept), vld_next needs no
// zeroing, and counts is the stream's count scratch, np / bn int32 that
// are zero (and left zero).
extern "C" int repro_fused_pe(const void* x, const float* w, const int* vld,
                              const int* nact, const int* kmap, const int* occ,
                              const float* bias, const void* residual,
                              const void* q, int dq, void* spikes,
                              int* vld_next, float* current,
                              const float* v_prev, const int8_t* s_prev,
                              float* v_next, int mp, int kp, int np, int bk,
                              int bn, int m_valid, int n_valid, float v_th,
                              float qk_threshold, float tau, int head_dim,
                              int flags, int skip, int route, int* counts,
                              cudaStream_t stream) {
  const int x_kind = (flags & kPackedX) ? kXPacked
                     : (flags & kF32X)  ? kXF32
                     : (flags & kBF16X) ? kXBF16
                                        : kXInt8;
  const bool float_x = x_kind == kXF32 || x_kind == kXBF16;
  const bool state = v_prev != nullptr;
  const bool decode = route == kRouteDecode;
  if (skip < kDense || skip > kTwoLevel || (bn != kTile && bn != 2 * kTile) ||
      (float_x && (skip != kDense || state)) || head_dim < 0 ||
      state != (s_prev != nullptr) || state != (v_next != nullptr) ||
      (head_dim > 0 && (kTile / head_dim + 2) * kTile > kMaxGateBytes) ||
      (route != kRouteTile && !decode) ||
      (decode && (!float_x || residual != nullptr || current != nullptr ||
                  m_valid < 0 || m_valid > kDecodeRows || m_valid > mp ||
                  np % kDecodeCols || counts == nullptr)) ||
      (!decode && vld == nullptr && skip == kDense))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mp > 0 && np > 0) {
    const Launch fn = pick(x_kind, current != nullptr, state, skip, decode, m_valid);
    const Route r{vld, nact, kmap, occ, bk};
    const State st{v_prev, s_prev, v_next, tau, counts};
    fn(x, w, r, bias, residual, q, dq, spikes, vld_next, current, st, mp, kp, np,
       bn, m_valid, n_valid, v_th, qk_threshold, head_dim, flags, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
