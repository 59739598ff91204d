// Event-gated tile product shared by fused_pe.cuh and spike_matmul.cu — the
// Hopper counterpart of repro/kernels/gating.py::accum_tile, for the three
// byte-skip strategies of the reference (kernels/spike_matmul/ops.py
// SKIP_MODES):
//
//   kDense    — walk every k block of the row and skip the ones whose
//               vld_cnt is zero (spike_matmul_pallas, fused_pe skip="dense");
//   kGated    — walk only the compacted list kmap[row_blk, 0 .. nact) of
//               the non-silent k blocks (core/events.py::compact_kmap;
//               spike_matmul_gated_pallas, fused_pe skip="gated");
//   kTwoLevel — kGated, and inside each block skip every 32-deep k step
//               whose bit of the word-occupancy bitmap occ is clear (a
//               silent 32-column stripe; skip="two_level").
//
// One CTA owns one 128-row x 128-column output tile. The metadata grid is
// 128 rows by bk columns of k, bk 128 or 256 (the autotuner may tile a
// layer's output 256 wide, and the next layer's k then inherits that
// grid), so the skip is uniform across the CTA (no divergence). 256
// threads, each accumulating an 8x8 sub-tile in registers in IEEE f32 (no
// tensor cores: parity with the plain version rules out TF32). K is walked
// in 32-deep steps through shared memory: w arrives as f32 (four float4
// per thread); x (the XKind) as int8 spikes (16 bytes per thread,
// converted to f32 on the store), as int32 words of 32 spikes (kXPacked: a
// 32-deep step needs exactly one word per tile row, so threads 0..127 each
// load their row's word and store its 32 bits as 0.f/1.f), or as dense
// activations, f32 (kXF32, four float4 per thread) or bf16 (kXBF16, two
// 16-byte loads of 8 values per thread; a bf16 value is the top half of
// its f32, so the widening is a 16-bit shift and exact). Every kind lands
// in the same f32 shared tile and the FMAs run over k in the same order,
// so a packed operand gives the same f32 sums as the int8 one (its zero
// pad columns add exact zeros), and a bf16 operand the same sums as its
// f32 widening (the reference's x.astype(f32) @ w).
//
// The three strategies give the same bits. kmap lists the non-silent
// blocks in ascending order, so kGated meets the same k values in the same
// order as kDense. A 32-deep step is one packed word per row, i.e. one occ
// bit, so kTwoLevel leaves out only steps whose x values are all zero: the
// FMAs it skips would have added 0 * w, an exact zero, wherever w is
// finite, and the remaining FMAs keep their order. On the card the dense
// skip already elides a silent block's loads (a TPU grid step still
// streams it), so the gated walk saves the per-block vld reads and branch,
// and the stripe skip saves a quarter or an eighth of a block's loads and
// FMAs per clear bit.
//
// The caller guarantees: x is [Mp, Kp] int8, f32 or bf16, or [Mp, Kp/32]
// int32 row-major, w is [Kp, Np] f32 row-major, the maps are [Mp/128, Kp/bk]
// int32 (nact [Mp/128]), Mp/Kp/Np are multiples of 128 and Kp of bk, and
// the base pointers are 16-byte aligned.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kTile = 128;     // CTA tile edge == metadata block rows
constexpr int kStep = 32;      // K depth staged through shared memory
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kSub = 8;        // 8 x 8 outputs per thread

// the skip strategies (the skip argument of the C entries)
constexpr int kDense = 0, kGated = 1, kTwoLevel = 2;
// the x operand kinds: spikes (int8, packed words) or dense activations
constexpr int kXInt8 = 0, kXPacked = 1, kXF32 = 2, kXBF16 = 3;

struct GemmSmem {
  float a[kStep][kTile];  // x tile, transposed: a[k][m]
  float b[kStep][kTile];  // w tile: b[k][n]
};

// The metadata one launch routes on: vld for kDense; nact, kmap (and occ
// for kTwoLevel) for the gated walks; bk the k width of one block.
struct Route {
  const int* vld;
  const int* nact;
  const int* kmap;
  const int* occ;
  int bk;
};

// acc += x[row_blk tile, k0 : k0 + 32] @ w[k0 : k0 + 32, col0 : col0 + 128]
template <int XKind>
__device__ __forceinline__ void gemm_step(
    const void* __restrict__ x, const float* __restrict__ w, int kp, int np,
    size_t row0, int col0, int k0, GemmSmem& sm, float (&acc)[kSub][kSub]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int a_row = tid >> 1, a_col = (tid & 1) * 16;  // 16 values a thread
  if constexpr (XKind == kXPacked) {
    if (tid < kTile) {  // one word per row: bit b is column k0 + b
      const int* xw = static_cast<const int*>(x);
      const unsigned word = static_cast<unsigned>(xw[(row0 + tid) * (kp / 32) + k0 / 32]);
#pragma unroll
      for (int b = 0; b < kStep; ++b) sm.a[b][tid] = ((word >> b) & 1u) ? 1.f : 0.f;
    }
  } else if constexpr (XKind == kXF32) {
    const float* xr = static_cast<const float*>(x) + (row0 + a_row) * kp + k0 + a_col;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 f = *reinterpret_cast<const float4*>(xr + 4 * v);
      sm.a[a_col + 4 * v][a_row] = f.x;
      sm.a[a_col + 4 * v + 1][a_row] = f.y;
      sm.a[a_col + 4 * v + 2][a_row] = f.z;
      sm.a[a_col + 4 * v + 3][a_row] = f.w;
    }
  } else if constexpr (XKind == kXBF16) {
    const uint16_t* xr = static_cast<const uint16_t*>(x) + (row0 + a_row) * kp + k0 + a_col;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + 8 * v);
      const unsigned h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // two bf16 a word, the low one first
        sm.a[a_col + 8 * v + 2 * i][a_row] = __uint_as_float(h[i] << 16);
        sm.a[a_col + 8 * v + 2 * i + 1][a_row] = __uint_as_float(h[i] & 0xffff0000u);
      }
    }
  } else {
    const int8_t* xt = static_cast<const int8_t*>(x);
    const int4 v = *reinterpret_cast<const int4*>(xt + (row0 + a_row) * kp + k0 + a_col);
    const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 16; ++i) sm.a[a_col + i][a_row] = static_cast<float>(e[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * kThreads;  // 1024 float4 per stage
    const int r = idx / (kTile / 4), c = (idx % (kTile / 4)) * 4;
    *reinterpret_cast<float4*>(&sm.b[r][c]) =
        *reinterpret_cast<const float4*>(w + static_cast<size_t>(k0 + r) * np + col0 + c);
  }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kStep; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[kk][ty * kSub]);
    const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[kk][ty * kSub + 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[kk][tx * kSub]);
    const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[kk][tx * kSub + 4]);
    const float a[kSub] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[kSub] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
  __syncthreads();
}

// acc += x[row_blk tile, k] @ w[k, col0 : col0 + 128] over the k blocks
// (and, for kTwoLevel, the 32-column stripes) the route keeps. A skipped
// block or stripe is neither loaded nor multiplied: its x entries are all
// zero, so skipping it is exact.
template <int XKind, int Skip>
__device__ __forceinline__ void event_gemm_tile(
    const void* __restrict__ x, const float* __restrict__ w, const Route& route,
    int kp, int np, int row_blk, int col0, GemmSmem& sm, float (&acc)[kSub][kSub]) {
  const int bk = route.bk;
  const int gk = kp / bk;
  const size_t row0 = static_cast<size_t>(row_blk) * kTile;
  if constexpr (Skip == kDense) {
    for (int kb = 0; kb < gk; ++kb) {
      if (route.vld[row_blk * gk + kb] == 0) continue;  // event skip (uniform)
      for (int ks = 0; ks < bk; ks += kStep)
        gemm_step<XKind>(x, w, kp, np, row0, col0, kb * bk + ks, sm, acc);
    }
  } else {
    const int nact = route.nact[row_blk];
    for (int s = 0; s < nact; ++s) {  // the compacted non-silent blocks
      const int kb = route.kmap[row_blk * gk + s];
      unsigned bits = 0xffffffffu;
      if constexpr (Skip == kTwoLevel) bits = static_cast<unsigned>(route.occ[row_blk * gk + kb]);
      for (int ks = 0; ks < bk; ks += kStep) {
        if (!((bits >> (ks / kStep)) & 1u)) continue;  // silent stripe (uniform)
        gemm_step<XKind>(x, w, kp, np, row0, col0, kb * bk + ks, sm, acc);
      }
    }
  }
}

}  // namespace repro
