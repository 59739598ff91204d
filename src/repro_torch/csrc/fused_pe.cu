// Fused PE layer: the C entry, and the stateless tile-route launches of an
// int8 x (the kernels, their design and their bounds are described in
// fused_pe.cuh and event_gemm.cuh; the other variants are instantiated in
// fused_pe_float.cu, fused_pe_decode.cu, fused_pe_packed.cu,
// fused_pe_state.cu and fused_pe_state_packed.cu).
#include <cstdint>
#include <cuda_runtime.h>

#include "fused_pe.cuh"

using namespace repro;

namespace {

// the launch of one variant of a spike x on the tile route's skip, or of a
// float x on the decode route at the row tile that covers m_valid
Launch pick(int x_kind, bool emit, bool state, int skip, int m_valid) {
  if (x_kind == kXPacked) return state ? pick_state_packed(emit, skip) : pick_packed(emit, skip);
  if (state) return pick_state_int8(emit, skip);
  if (x_kind == kXF32 || x_kind == kXBF16) return pick_decode_float(x_kind, m_valid);
  return emit ? pick_skip<kXInt8, true, false>(skip) : pick_skip<kXInt8, false, false>(skip);
}

}  // namespace

// x [mp, kp] int8 (no dtype flag), or [mp, kp/32] int32 words
// (kPackedX), or f32 (kF32X) or bf16 (kBF16X) [>= m_valid, kp] (only its
// first m_valid rows are read); w [kp, np] f32, and for a spike x (int8 or
// words) ws [3, kp, np] bf16, w's exact split into three terms
// (event_wgmma.cuh), 16-byte aligned, which its tile reads in w's stead
// (a float x's may be null). The route (skip, see event_gemm.cuh): kDense
// reads vld [mp/128, kp/bk] (a float x's may be null: every block kept);
// kGated nact [mp/128] and kmap [mp/128, kp/bk]; kTwoLevel also occ
// [mp/128, kp/bk]; a float x takes kDense only. May be null: bias [np]
// f32; residual [mp, np] f32 or
// [mp, np/32] words (kPackedResidual); q [mp, dq] int8 (dq a multiple of
// 128) or [mp, dq] words (kPackedQ, dq words per row); current [m_valid,
// n_valid] f32 (the emit_current variant); the LIF state (a spike x
// only, all three or none): v_prev [m_valid, n_valid] f32, s_prev
// [m_valid, n_valid] int8 and v_next [m_valid, n_valid] f32 out, decayed
// by tau and reset hard, or soft with kSoftReset. head_dim > 0 makes the q
// mask head-blocked (heads of head_dim columns, head_dim * heads ==
// n_valid, q at least n_valid columns wide); 0 keeps the whole-row mask.
// Writes spikes [mp, np] int8 or [mp, np/32] words (kPackedOut), vld_next
// [mp/128, np/bn] int32 (zeroed by the caller when bn > 128 or x is a float
// x, whose tile adds its counts) and, when current is not null, the
// current. On the tile route a float x's q needs only its first m_valid
// rows, and its x, w, spikes, bias and residual are 16-byte aligned.
//
// route kRouteDecode (decode_gemm.cuh) takes a float x on the dense skip,
// m_valid <= kDecodeRows, no residual, no state and no current: x and q
// need only their first m_valid rows (mp is the padded output's rows, a
// multiple of 128), vld may be null (every block kept), vld_next needs no
// zeroing, and counts is the stream's count scratch, np / bn int32 that
// are zero (and left zero).
//
// A stateful launch of step t of a train whose state began at zeros may
// pass its earlier steps (hist_steps = t): x_hist holds steps 0 .. t-1 of
// x and r_hist of the residual (when the launch has one), each in this
// launch's layout, x_hist_step and r_hist_step bytes apart; the
// near-threshold recheck replays them (fused_pe.cuh) into the state its
// spikes are decided on. 0 and null without. v_used [m_valid, n_valid] f32
// (may be null; only with the state) receives that state: v_prev, but
// where the recheck replayed the earlier steps. No input is written.
extern "C" int repro_fused_pe(const void* x, const float* w, const void* ws, const int* vld,
                              const int* nact, const int* kmap, const int* occ,
                              const float* bias, const void* residual,
                              const void* q, int dq, void* spikes,
                              int* vld_next, float* current,
                              const float* v_prev, const int8_t* s_prev,
                              float* v_next, int mp, int kp, int np, int bk,
                              int bn, int m_valid, int n_valid, float v_th,
                              float qk_threshold, float tau, int head_dim,
                              int flags, int skip, int route, int* counts,
                              const void* x_hist, const void* r_hist,
                              long long x_hist_step, long long r_hist_step,
                              int hist_steps, float* v_used, cudaStream_t stream) {
  const int x_kind = (flags & kPackedX) ? kXPacked
                     : (flags & kF32X)  ? kXF32
                     : (flags & kBF16X) ? kXBF16
                                        : kXInt8;
  const bool float_x = x_kind == kXF32 || x_kind == kXBF16;
  // a spike x's tile reads w's three bf16 terms
  const bool split_ok = float_x || (ws != nullptr && reinterpret_cast<uintptr_t>(ws) % 16 == 0);
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
      (!decode && !float_x && vld == nullptr && skip == kDense) || !split_ok ||
      hist_steps < 0 ||
      (hist_steps > 0 && (!state || float_x || x_hist == nullptr ||
                          (residual != nullptr && r_hist == nullptr))) ||
      (v_used != nullptr && !state))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mp > 0 && np > 0 && float_x && !decode) {   // the float-x tile
    const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    if (m_valid < 0 || m_valid > mp || mp % kTile || np % kTile || kp % bk || !a16(x) || !a16(w) ||
        !a16(spikes) || !a16(bias) || !a16(residual))
      return static_cast<int>(cudaErrorInvalidValue);
    FloatTileArgs a{};
    a.vld = vld;
    a.bias = bias;
    a.residual = residual;
    a.q = q;
    a.spikes = spikes;
    a.vld_next = vld_next;
    a.current = current;
    a.grid = float_grid(m_valid, np);
    a.m = m_valid;
    a.kp = kp;
    a.np = np;
    a.mp = mp;
    a.bk = bk;
    a.bn = bn;
    a.n_valid = n_valid;
    a.dq = dq;
    a.head_dim = head_dim;
    a.flags = flags;
    a.v_th = v_th;
    a.qk_threshold = qk_threshold;
    return launch_float_tile(x_kind, current != nullptr, a, x, w, stream);
  }
  if (mp > 0 && np > 0) {
    const Launch fn = pick(x_kind, current != nullptr, state, skip, m_valid);
    const Route r{vld, nact, kmap, occ, bk};
    const State st{v_prev, s_prev, v_next, v_used, tau, counts,
                   History{x_hist, r_hist, x_hist_step, r_hist_step, hist_steps}};
    fn(x, w, static_cast<const uint16_t*>(ws), r, bias, residual, q, dq, spikes, vld_next,
       current, st, mp, kp, np, bn, m_valid, n_valid, v_th, qk_threshold, head_dim, flags,
       stream);
  }
  return static_cast<int>(cudaGetLastError());
}
