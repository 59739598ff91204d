// The event-gated product's shared vocabulary (the CTA tile, the skips,
// the x kinds, the route metadata), and the float-x tile: the product of
// the fused PE (fused_pe.cuh) for a dense f32 or bf16 activation x, the
// LM's projections of its residual stream (ops.dense_lif; the training
// step's wq and grouped wk, and every launch of more than kDecodeRows rows
// or with a residual or the emitted current). A fused PE launch of a
// spike x takes the tensor-core tile of event_wgmma.cuh, the spike matmul
// (K3 and K4) its own tile (spike_matmul.cu), and a float x of at most
// kDecodeRows rows without residual or current the decode route
// (decode_gemm.cuh). The skips of a spike x's product:
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
// The metadata grid is 128 rows by bk columns of k, bk 128 or 256. A float
// x takes the dense skip, on a vld map or, without one, every block.
//
// The float-x tile. The arithmetic is fixed: every output is one IEEE f32
// fmaf chain from +0 over k ascending (kernels/chain.py::fma_chain, the
// decode route's sums bit for bit), a bf16 x widened exactly (a bf16 is the
// top half of its f32: a 16-bit shift), so a bf16 x gives its f32
// widening's sums. No TF32, no bf16 split on the tensor cores, no split-K:
// each is another rounding. A skipped block adds fmaf(0, w, s) = s (the sum
// never becomes -0), and so do the zero rows and columns past the
// operands' extents.
//
// Bound on the H100: 2 M K N operations at the 67 TFLOP/s f32 rate outside
// the tensor cores (the LM step's [1032, 2048] @ [2048, 2048]: 0.129 ms)
// against about 34 MB of operands and outputs (0.010 ms). What holds a
// SIMT product below that rate is the instruction slots and shared-memory
// reads around the FMAs, the latency a barrier exposes, and a grid that
// leaves SMs idle: the 128 x 128 tile that came before ran the step's 1032
// rows padded to 1152 as 144 CTAs on 132 SMs, two waves, the second 16
// CTAs of 8 live rows each. The design:
//
// - Operands at their own rows. x [m, kp] (kp: w's rows, a multiple of bk)
//   is read in place through a TMA map of m rows: rows past m arrive as
//   zeros, and a warp whose rows all lie past m runs no FMA. w [kp, np]
//   is read in place; columns past np arrive as zeros.
// - Tiles of 64 rows by 256 columns, 8 consumer warps (2 a scheduler; 8 x
//   16 outputs a thread on 4 warps was twice as slow): warp 2 wm + wn owns
//   rows 16 wm .. 16 wm + 15 and columns 128 wn .. 128 wn + 127; lane (ty,
//   tx) = (lane / 16, lane % 16) the 8 rows 16 wm + 2 i + ty and the 8 columns
//   128 wn + 64 q + 4 tx + e (i < 8, q < 2, e < 4). A k reads 2 float4s of
//   w (16 lanes on consecutive float4s: no bank conflict) for 64 FMAs;
//   x is read along k, a float4 (f32) or 8 bytes (bf16) of a row for 4 k,
//   the warp's two rows in distinct banks, so 8 rows cost 8 loads each 4 k.
// - Pipeline. k is walked in 32-deep steps through a ring of kFloatStages
//   slots filled by TMA. A ninth warp, the producer (kFloatThreads), walks
//   the CTA's steps across its tiles and issues each step's two boxes on
//   the slot's full mbarrier (w: 32 rows by 256 columns, 32 KB, unswizzled;
//   x: 64 rows by 32 values, the 128-byte swizzle for f32 (128-byte rows)
//   and the 64-byte one for bf16 (64-byte rows), so that the two rows of a
//   warp's load fall in distinct banks), once the slot's empty mbarrier
//   shows that the 8 consumer warps released its step before. No CTA
//   barrier a step: each consumer warp waits for its step's bytes and
//   releases the slot alone. (One CTA barrier a step, with thread 0 as the
//   producer, was slower on the H100, and so was a step whose 4-k groups
//   were looped rather than unrolled: PERF.md §6.)
// - A thin tile. A tile of at most 16 live rows (the last row of tiles:
//   the LM step's 8 x 129 rows leave 8) puts every warp on its first 16
//   rows, 32 columns a warp (float_fmas_thin: 8 x 2 outputs a thread), so
//   its FMAs spread over the four schedulers; on the full mapping it would
//   run on warps 0-1 alone, and two such tiles took 1.4 full tiles' time
//   on the H100.
// - A grid that fills the card, one CTA an SM (the ring takes 160 KB):
//   persistent, min(SMs x resident CTAs, ceil(cost / 2)) CTAs, where a
//   tile costs 2 halves, or 1 when it is thin (a quarter of a full tile's
//   FMAs, fewer to a load). CTA c takes the tiles, n fastest, whose
//   cumulative cost starts in [C c / G, C (c + 1) / G) (float_first); the
//   ring runs across its tiles' boundaries. The twin is
//   kernels/fused_pe/ops.py::float_tile_plan and float_tile_runs: at the
//   LM step's 1032 rows, 128 full tiles and 8 thin ones make 132 CTAs, one
//   full tile or two thin ones each, one wave.
// - ptxas (-Xptxas -v, sm_90a): 168 registers a thread, no spill; the
//   dynamic shared memory kFloatSmem (181,440 bytes), one CTA (9 warps)
//   an SM.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace repro {

constexpr int kTile = 128;     // the metadata blocks' rows; the spike-x tile's edge
constexpr int kStep = 32;      // K depth of one step
constexpr int kThreads = 256;  // a fused PE CTA
constexpr int kSub = 8;        // 8 x 8 outputs per thread

// the skip strategies (the skip argument of the C entries)
constexpr int kDense = 0, kGated = 1, kTwoLevel = 2;
// the x operand kinds: spikes (int8, packed words) or dense activations
constexpr int kXInt8 = 0, kXPacked = 1, kXF32 = 2, kXBF16 = 3;

// The metadata one launch routes on: vld for kDense; nact, kmap (and occ
// for kTwoLevel) for the gated walks; bk the k width of one block.
struct Route {
  const int* vld;
  const int* nact;
  const int* kmap;
  const int* occ;
  int bk;
};

// ------------------------------------------------------------ float-x tile
constexpr int kFloatRows = 64;                          // rows of a tile
constexpr int kFloatCols = 256;                         // columns of a tile
constexpr int kFloatStages = 4;                         // the TMA ring's slots
constexpr int kFloatWBytes = kStep * kFloatCols * 4;    // a step's w: 32 KB
constexpr int kFloatXBytes = kFloatRows * kStep * 4;    // a step's f32 x: 8 KB
constexpr int kFloatStage = kFloatWBytes + kFloatXBytes;
// the (row, head) gates of a tile: at most kFloatCols / dh + 2 heads a row
constexpr int kFloatGateBytes = kFloatRows * (kFloatCols + 2);
constexpr int kFloatGates = kFloatStages * kFloatStage;   // byte offsets
constexpr int kFloatBars = kFloatGates + (kFloatGateBytes + 7) / 8 * 8;
// two mbarriers a slot (its bytes landed; its step released), and 1024
// bytes to align the ring (the x boxes' swizzle phase is their address's
// own)
constexpr int kFloatSmem = kFloatBars + 16 * kFloatStages + 1024;
// the consumer warps (kThreads) and one producer warp
constexpr int kFloatThreads = kThreads + 32;
static_assert(kFloatStage % 1024 == 0, "each slot's x box stays 1024-byte aligned");
static_assert(kFloatSmem <= 227 * 1024, "a CTA's shared memory on the H100");

// The tiles of a float-x launch: mtiles x ntiles, n fastest; the first
// `full` cost 2 halves each, those of the last row `tail` each.
struct FloatGrid {
  int mtiles, ntiles, full, tail;
};

__host__ __device__ inline long long float_cost(const FloatGrid& g, int t) {
  return t <= g.full ? 2ll * t : 2ll * g.full + static_cast<long long>(g.tail) * (t - g.full);
}

// the first tile whose cumulative cost (before it) reaches c
__host__ __device__ inline int float_first(const FloatGrid& g, long long c) {
  if (c <= 2ll * g.full) return static_cast<int>((c + 1) / 2);
  return g.full + static_cast<int>((c - 2ll * g.full + g.tail - 1) / g.tail);
}

__host__ __device__ inline FloatGrid float_grid(int m, int np) {
  FloatGrid g;
  g.mtiles = m > kFloatRows ? (m + kFloatRows - 1) / kFloatRows : 1;
  g.ntiles = (np + kFloatCols - 1) / kFloatCols;
  g.full = (g.mtiles - 1) * g.ntiles;
  g.tail = m - (g.mtiles - 1) * kFloatRows > 16 ? 2 : 1;   // thin: at most 16 live rows
  return g;
}

// The 32-deep steps of one row block in ascending k: every step of each
// block that vld keeps (all of them without a map); none when x has no
// rows. next() gives a step's first column, then -1.
struct FloatWalk {
  const int* vld;   // the row block's entries, or null
  int bk, gk, kb, j;

  __device__ __forceinline__ void begin(const int* map, int row_blk, int bk_, int kp, int m) {
    bk = bk_;
    gk = kp / bk_;
    vld = map == nullptr ? nullptr : map + row_blk * gk;
    kb = m > 0 ? 0 : gk;
    j = 0;
  }

  __device__ __forceinline__ int next() {
    while (kb < gk && vld != nullptr && j == 0 && vld[kb] == 0) ++kb;
    if (kb >= gk) return -1;
    const int k0 = kb * bk + j * kStep;
    if (++j == bk / kStep) {
      j = 0;
      ++kb;
    }
    return k0;
  }
};

// acc += the landed step's x (rows 16 wm + 2 i + ty) @ w (columns 128 wn +
// 64 q + 4 tx + e), k ascending. `st` is the step's slot: w [32][256] f32,
// then x [64][32] f32 (128-byte swizzle: 16-byte chunk c of row r at chunk
// c ^ (r % 8)) or bf16 (64-byte swizzle: chunk c of row r at c ^ (r / 2 %
// 4)).
template <int XKind>
__device__ __forceinline__ void float_fmas(const unsigned char* __restrict__ st, int wm, int wn,
                                           int ty, int tx, float (&acc)[kSub][kSub]) {
  static_assert(XKind == kXF32 || XKind == kXBF16, "the float-x tile takes a float x");
  const float* B = reinterpret_cast<const float*>(st) + 128 * wn + 4 * tx;
  const unsigned char* xr = st + kFloatWBytes;
#pragma unroll
  for (int g = 0; g < kStep / 4; ++g) {   // 4 k a group
    float a[kSub][4];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      if constexpr (XKind == kXF32) {
        // row 16 wm + 2 i + ty: r % 8 = 2 (i % 4) + ty, so chunk g lies at
        // (g ^ 2 (i % 4)) ^ ty, 16 bytes right of it for an even one and
        // left for an odd one when ty is 1
        const int c = g ^ (2 * (i & 3));
        const int d = (c & 1) ? -16 * ty : 16 * ty;
        const float4 v = *reinterpret_cast<const float4*>(xr + (16 * wm + ty) * 128 + 256 * i +
                                                          16 * c + d);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      } else {
        // row 16 wm + 2 i + ty: r / 2 % 4 = i % 4; k 4 g .. 4 g + 3 are the
        // half g % 2 of chunk g / 2, two bf16 a word, the low one first
        const uint2 u = *reinterpret_cast<const uint2*>(
            xr + (16 * wm + ty) * 64 + 128 * i + 16 * ((g >> 1) ^ (i & 3)) + 8 * (g & 1));
        a[i][0] = __uint_as_float(u.x << 16);
        a[i][1] = __uint_as_float(u.x & 0xffff0000u);
        a[i][2] = __uint_as_float(u.y << 16);
        a[i][3] = __uint_as_float(u.y & 0xffff0000u);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* b = B + (4 * g + kk) * kFloatCols;
      const float4 b0 = *reinterpret_cast<const float4*>(b);
      const float4 b1 = *reinterpret_cast<const float4*>(b + 64);
      const float bv[kSub] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(a[i][kk], bv[j], acc[i][j]);
    }
  }
}

// The thin mapping of a tile with at most 16 live rows (the last row of
// tiles, where the LM step's 8 x 129 rows leave 8): all eight warps on rows
// 0 .. 15, warp w on columns 32 w .. 32 w + 31, lane (ty, tx) on rows
// 2 i + ty and columns 32 w + 2 tx + e (e < 2), so the tile's FMAs spread
// over every scheduler. acc[i][e] += x @ w over the landed step, k
// ascending; x is read as float_fmas reads it (wm = 0), w two columns a k.
template <int XKind>
__device__ __forceinline__ void float_fmas_thin(const unsigned char* __restrict__ st, int warp,
                                                int ty, int tx, float (&acc)[kSub][kSub]) {
  const float* B = reinterpret_cast<const float*>(st) + 32 * warp + 2 * tx;
  const unsigned char* xr = st + kFloatWBytes;
#pragma unroll
  for (int g = 0; g < kStep / 4; ++g) {
    float a[kSub][4];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      if constexpr (XKind == kXF32) {
        const int c = g ^ (2 * (i & 3));
        const int d = (c & 1) ? -16 * ty : 16 * ty;
        const float4 v = *reinterpret_cast<const float4*>(xr + ty * 128 + 256 * i + 16 * c + d);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(xr + ty * 64 + 128 * i +
                                                        16 * ((g >> 1) ^ (i & 3)) + 8 * (g & 1));
        a[i][0] = __uint_as_float(u.x << 16);
        a[i][1] = __uint_as_float(u.x & 0xffff0000u);
        a[i][2] = __uint_as_float(u.y << 16);
        a[i][3] = __uint_as_float(u.y & 0xffff0000u);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 b = *reinterpret_cast<const float2*>(B + (4 * g + kk) * kFloatCols);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        acc[i][0] = fmaf(a[i][kk], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i][kk], b.y, acc[i][1]);
      }
    }
  }
}

}  // namespace repro
