// The fused PE's tile product for a spike x (int8 spikes, or int32 words of
// 32 spikes), on the tensor cores (wgmma) — the Hopper counterpart of
// repro/kernels/gating.py::accum_tile for fused_pe_pallas under the three
// byte-skip strategies of event_gemm.cuh (kDense, kGated, kTwoLevel). A
// dense f32 or bf16 activation x, and the spike matmul (spike_matmul.cu),
// stay on event_gemm.cuh's scalar tile.
//
// Arithmetic. x is 0/1 (any int8 value is exact in bf16) and w is f32. The
// wrapper splits w once a weight into three bf16 terms, w = w1 + w2 + w3
// (kernels/spike_matmul/ref.py::split_g_bf16x3: w1 is w with its low 16
// bits cleared, w2 the same of w - w1, w3 the rest rounded to nearest; the
// sum is w for |w| >= 2^-110, and within 2^-134 below), and hands them to
// the kernel as one [3, Kp, Np] bf16 tensor (6 bytes an element, against
// the f32 w's 4; splitting in the kernel would read 4 and spend CUDA-core
// work and shared-memory bandwidth on every CTA's copy of every tile). A
// product of a bf16 x and a bf16 term is exact in f32, so x @ w is three
// bf16 products, x @ w1 + x @ w2 + x @ w3, each of exact products. The
// tensor cores round their own f32 accumulation toward zero, so a long
// chain of it drifts: each 32-deep k step's six wgmmas (two 16-deep slices,
// three terms each) go into a fresh register tile, which joins the running
// f32 sum with one correctly rounded add (__fadd_rn) per element. The
// plain twin of that order is kernels/fused_pe/ref.py::split_product. It
// is not the scalar tile's rounding, so a potential within kRecheckBand of
// v_th is decided on the scalar tile's chain instead (sequential_sum below;
// fused_pe.cuh's near-threshold recheck).
//
// Skips. A k step is 32 columns deep: one packed word a row, one occ bit,
// so the walk (StepWalk, twin ref.py::k_steps) visits the 32-deep steps of
// the blocks the route keeps, in ascending k, and under kTwoLevel only
// those whose occ bit is set. A skipped block or stripe issues no loads
// and no wgmma. That leaves the bits as they were: its x is all zero, so
// its fresh tile would be exact zeros (+0 or -0), and joining a zero to the
// sum changes no bit (the sum starts at +0 and, rounded to nearest, never
// becomes -0). The dense and gated walks meet the same steps in the same
// order. A packed x becomes the same bf16 fragments as its int8 map, so it
// gives the int8 launch's bits; no float atomics, so a second launch gives
// the same bits.
//
// Dataflow. One CTA of 256 threads owns the 128 x 128 output tile, as the
// scalar tile does: two warpgroups, rows 64 g .. 64 g + 63 each, one
// m64n128k16 accumulator (64 f32 registers a thread) over the tile's 128
// columns. A ring of six stages in shared memory, filled by cp.async four
// steps ahead, holds a step's three w terms (32 rows x 128 columns of bf16
// each, 8 KB, in the 128-byte-swizzled MN-major layout: wgmma's B operand
// through the transpose bit, as V is in flash_attention_wgmma.cu) and its
// x (int8 at a 48-byte row pitch, so the fragment reads do not conflict on
// the banks, or one word a row). The A operand comes from registers: each
// thread builds its fragments (rows r, r + 8; columns 2 (lane % 4) + {0, 1,
// 8, 9} of each 16-deep slice) straight from the staged bytes or words as
// bf16 0/1 pairs, and one fragment feeds all three terms' wgmmas. While a
// step's wgmmas run, the next step is readied (its stage waited for, the
// stage after it requested, its fragments built into a second register
// set); then the fresh tile joins the sum. One fresh tile, not two: two
// (the next step's wgmmas issued before this step's join) held 247-254
// registers and ptxas serialized every wgmma (its C7514 warning), since it
// then moved accumulator registers between a wgmma and its wait. After the
// last step the sum is restaged into shared memory (restage_sum: a 128 x
// 136 f32 tile over the ring), where fused_pe.cuh's epilogue reads it,
// thread (tx, ty) rows 8 ty .. 8 ty + 7 and columns 8 tx .. 8 tx + 7 as
// the scalar tile holds them.
//
// Bound on the H100: three bf16 products of the data's work, 3 * 2 *
// nnz(x) * N operations at 989 TFLOP/s, against the bytes of x, w and the
// outputs. The kernel does the dense product of every step it keeps (3 * 2
// * 128 * 32 * 128 a CTA and step, whatever the spike rate), and each CTA
// reads its steps' w terms from the L2 (24 KB a step, 6 bytes a weight):
// at the tensor cores' full rate the L2 would have to deliver about 7 TB/s,
// so the weight stream from the L2, the fragment and join work between the
// wgmmas, and a N = 64 layer's half-empty tile (res1: the 128-wide tile
// computes 64 padded columns) hold it above the bound. Measured times are
// in PERF.md.
//
// The caller guarantees what event_gemm.cuh's tile needs, and: ws is [3,
// Kp, Np] bf16, row-major, 16-byte aligned; the shared memory is
// kWgmmaSmemBytes of dynamic shared memory, 1024-byte aligned once
// wgmma_smem rounds it up.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "event_gemm.cuh"
#include "hopper.cuh"

namespace repro {

constexpr int kWStep = 32;                      // k depth of one step
constexpr int kWStages = 6;                     // the cp.async ring
constexpr int kWAhead = kWStages - 2;           // steps staged ahead of the one multiplied
constexpr int kTermBytes = kWStep * kTile * 2;  // one bf16 term of a step: 8 KB
constexpr int kTermAtom = kWStep * 128;         // its 64-column swizzle atom: 4 KB
constexpr int kXPitch = 48;                     // bytes a staged int8 x row
constexpr int kXStageBytes = kTile * kXPitch;   // 6 KB (a packed step uses 512 B)
constexpr int kWStageBytes = 3 * kTermBytes + kXStageBytes;  // 30 KB
constexpr int kRestagePitch = kTile + 8;        // floats a row of the restaged sum
constexpr int kRestageBytes = kTile * kRestagePitch * 4;
static_assert(kWStageBytes % 1024 == 0, "each stage's terms stay 1024-byte aligned");
static_assert(kRestageBytes <= kWStages * kWStageBytes, "the restaged sum fits the ring");

// the 1024-byte-aligned start of the dynamic shared memory (the swizzle
// phase of a tile is its address's own)
__device__ __forceinline__ uint8_t* wgmma_smem(uint8_t* raw) {
  const uint32_t a = hopper::smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// The k steps one CTA's route keeps, ascending: every 32-deep step of each
// block the dense skip keeps (vld != 0), or of each block of the compacted
// list (kGated), or of those only the steps whose occ bit is set
// (kTwoLevel). next() gives a step's first column, then -1 for ever.
template <int Skip>
struct StepWalk {
  const int* vld;   // this row block's vld (kDense) or kmap and occ entries
  const int* kmap;
  const int* occ;
  int bk, gk, steps, nact;
  int kb = -1, s = 0, pos, bits = 0;

  __device__ StepWalk(const Route& r, int row_blk, int kp)
      : vld(r.vld + row_blk * (kp / r.bk)), kmap(r.kmap + row_blk * (kp / r.bk)),
        occ(r.occ + row_blk * (kp / r.bk)), bk(r.bk), gk(kp / r.bk), steps(r.bk / kWStep),
        nact(Skip == kDense ? 0 : r.nact[row_blk]), pos(r.bk / kWStep) {}

  // on to the next kept block; false past the last
  __device__ __forceinline__ bool advance() {
    if constexpr (Skip == kDense) {
      while (kb + 1 < gk)
        if (vld[++kb] != 0) {
          bits = -1;
          return true;
        }
      return false;
    } else {
      if (s >= nact) return false;
      kb = kmap[s++];
      bits = Skip == kTwoLevel ? occ[kb] : -1;
      return true;
    }
  }

  __device__ __forceinline__ int next() {
    for (;;) {
      if (pos == steps) {
        if (!advance()) return -1;
        pos = 0;
      }
      const int st = pos++;
      if ((static_cast<unsigned>(bits) >> st) & 1u) return kb * bk + st * kWStep;
    }
  }
};

// the potentials within this of v_th are decided on the scalar tile's
// chain (fused_pe.cuh: the near-threshold recheck)
constexpr float kRecheckBand = 3.0517578125e-05f;  // 2^-15

// The sum of output (row, col) as event_gemm.cuh's scalar tile forms it: f32
// fmaf of x[row, k] and w[k, col] in ascending k, each x zero adding
// nothing (fmaf(0, w, s) is s: the sum is never -0; a block the route
// skips holds only zeros, so every k is walked). One warp forms it, a
// chunk of kChainChunk k at a time, pipelined: the lanes' loads of chunks
// c + 1 and c + 2's x (16 bytes, or one packed word, a lane) and chunk c's
// w[k, col] are in flight while lane 0 runs the fmaf chain over chunk
// c - 1's pairs; chunk c's nonzero x values go, in ascending k (a prefix count
// over the lanes places each lane's), into the warp's shared scratch (two
// buffers of kChainChunk (x, w) pairs), each beside its w, requested by
// 4-byte cp.async; the chain itself is one dependent fmaf a nonzero x.
// Every lane returns the sum.
constexpr int kChainChunk = 512;
constexpr int kChainFloats = 2 * 2 * kChainChunk;  // a warp's scratch

template <int XKind>
__device__ float sequential_sum(const void* __restrict__ x, const float* __restrict__ w,
                                int kp, int np, int row, int col, int lane,
                                float* __restrict__ scratch) {
  // this lane's piece of the chunk at k0: 16 int8 values at k0 + 16 lane,
  // or (lanes 0 .. 15) the word of k0 + 32 lane; zeros past kp
  auto load = [&](int k0) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (XKind == kXPacked) {
      if (lane < kChainChunk / 32 && k0 + 32 * lane < kp)
        v.x = static_cast<const unsigned*>(x)[static_cast<size_t>(row) * (kp / 32) +
                                              k0 / 32 + lane];
    } else {
      if (k0 + 16 * lane < kp)
        v = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(x) +
                                            static_cast<size_t>(row) * kp + k0 + 16 * lane);
    }
    return v;
  };
  // the chunk at k0 (this lane's piece v) into buf: its nonzero x values in
  // ascending k, each beside its requested w; returns their count
  auto compact = [&](int k0, const uint4& v, float* buf) {
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
    int n = 0;
    if constexpr (XKind == kXPacked) {
      n = __popc(u[0]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) n += __popc(__vcmpne4(u[e], 0u)) / 8;
    }
    int at = n;  // inclusive prefix over the lanes, then exclusive
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, at, off);
      if (lane >= off) at += t;
    }
    const int total = __shfl_sync(0xffffffffu, at, 31);
    at -= n;
    auto put = [&](int k, float xv) {
      buf[2 * at] = xv;
      hopper::cp_async4(hopper::smem_u32(buf + 2 * at + 1),
                        w + static_cast<size_t>(k) * np + col, true);
      ++at;
    };
    if constexpr (XKind == kXPacked) {
      for (unsigned bits = u[0]; bits != 0u; bits &= bits - 1u)
        put(k0 + 32 * lane + __ffs(bits) - 1, 1.f);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int8_t b = static_cast<int8_t>((u[e / 4] >> (8 * (e % 4))) & 0xffu);
        if (b != 0) put(k0 + 16 * lane + e, static_cast<float>(b));
      }
    }
    hopper::cp_async_commit();
    return total;
  };
  float acc = 0.f;
  const int chunks = (kp + kChainChunk - 1) / kChainChunk;
  uint4 v = load(0), v_ahead = load(kChainChunk);  // two chunks' x in flight
  int n_prev = 0;
  for (int c = 0; c <= chunks; ++c) {
    int n = 0;
    if (c < chunks) {
      n = compact(c * kChainChunk, v, scratch + (c % 2) * 2 * kChainChunk);
      v = v_ahead;
      if (c + 2 < chunks) v_ahead = load((c + 2) * kChainChunk);
    }
    if (c > 0) {
      if (c < chunks)
        hopper::cp_async_wait<1>();
      else
        hopper::cp_async_wait<0>();
      __syncwarp();
      if (lane == 0) {
        const float* buf = scratch + ((c - 1) % 2) * 2 * kChainChunk;
#pragma unroll 4
        for (int p = 0; p < n_prev; ++p) acc = fmaf(buf[2 * p], buf[2 * p + 1], acc);
      }
      __syncwarp();  // buffer (c - 1) % 2 is free for chunk c + 1
    }
    n_prev = n;
  }
  return __shfl_sync(0xffffffffu, acc, 0);
}

// step k0's three w terms and its x into the stage at shared address st,
// asynchronously: 6 16-byte copies a thread for the terms (term t, row r,
// 16-byte chunk c of the 128 columns, into its 64-column atom c / 8 with
// the chunk XOR-ed by r % 8), one for an int8 x (half a row), or one 4-byte
// word for a packed x (threads 0 .. 127, one row each)
template <int XKind>
__device__ __forceinline__ void stage_step(uint32_t st, const void* __restrict__ x,
                                           const uint16_t* __restrict__ ws, int kp, int np,
                                           size_t row0, int col0, int k0) {
  const int tid = threadIdx.x;
  const size_t term = static_cast<size_t>(kp) * np;
#pragma unroll
  for (int u = 0; u < 3 * kWStep * kTile / 8 / kThreads; ++u) {
    const int i = tid + u * kThreads;
    const int t = i / (kWStep * 16), r = (i / 16) % kWStep, c = i % 16;
    hopper::cp_async16(st + t * kTermBytes + (c / 8) * kTermAtom + r * 128 +
                           (((c % 8) ^ (r % 8)) << 4),
                       ws + t * term + static_cast<size_t>(k0 + r) * np + col0 + 8 * c, true);
  }
  const uint32_t xs = st + 3 * kTermBytes;
  if constexpr (XKind == kXPacked) {
    if (tid < kTile)
      hopper::cp_async4(xs + 4 * tid,
                        static_cast<const int*>(x) + (row0 + tid) * (kp / 32) + k0 / 32, true);
  } else {
    const int r = tid / 2, h = tid % 2;
    hopper::cp_async16(xs + r * kXPitch + 16 * h,
                       static_cast<const int8_t*>(x) + (row0 + r) * kp + k0 + 16 * h, true);
  }
}

// the bf16 pair of the two int8 values of u (the low byte the low half),
// exact
__device__ __forceinline__ uint32_t int8x2_bf16(uint32_t u) {
  const float lo = static_cast<float>(static_cast<int8_t>(u & 0xffu));
  const float hi = static_cast<float>(static_cast<int8_t>((u >> 8) & 0xffu));
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// bf16 1.0 or 0.0 for bits i and i + 1 of a packed word
__device__ __forceinline__ uint32_t bits_bf16(uint32_t word, int i) {
  return ((word >> i) & 1u) * 0x3F80u | ((word >> (i + 1)) & 1u) * 0x3F800000u;
}

// a thread's A fragments of one staged step, both 16-deep slices: rows r0
// and r0 + 8 of the tile, columns 16 s + 2 q + {0, 1} and those + 8
template <int XKind>
__device__ __forceinline__ void x_fragments(const uint8_t* xs, int r0, int q,
                                            uint32_t (&a)[2][4]) {
  if constexpr (XKind == kXPacked) {
    const uint32_t w0 = reinterpret_cast<const uint32_t*>(xs)[r0];
    const uint32_t w1 = reinterpret_cast<const uint32_t*>(xs)[r0 + 8];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int c = 16 * s + 2 * q;
      a[s][0] = bits_bf16(w0, c);
      a[s][1] = bits_bf16(w1, c);
      a[s][2] = bits_bf16(w0, c + 8);
      a[s][3] = bits_bf16(w1, c + 8);
    }
  } else {
    const uint16_t* p0 = reinterpret_cast<const uint16_t*>(xs + r0 * kXPitch) + q;
    const uint16_t* p1 = p0 + 8 * kXPitch / 2;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      a[s][0] = int8x2_bf16(p0[8 * s]);
      a[s][1] = int8x2_bf16(p1[8 * s]);
      a[s][2] = int8x2_bf16(p0[8 * s + 4]);
      a[s][3] = int8x2_bf16(p1[8 * s + 4]);
    }
  }
}

// acc = x[row_blk tile, k] @ w[k, col0 : col0 + 128] over the steps the
// route keeps (see the head note), in the wgmma accumulator's layout
// (restage_sum puts it in shared memory); smem is the 1024-byte-aligned
// dynamic shared memory, whose ring is free again on return
template <int XKind, int Skip>
__device__ __forceinline__ void event_wgmma_tile(const void* __restrict__ x,
                                                 const uint16_t* __restrict__ ws,
                                                 const Route& route, int kp, int np,
                                                 int row_blk, int col0, uint8_t* smem,
                                                 float (&acc)[64]) {
  using hopper::Wgmma;
  const uint32_t base = hopper::smem_u32(smem);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = 64 * wg + 16 * warp + lane / 4, q = lane % 4;
  const size_t row0 = static_cast<size_t>(row_blk) * kTile;
  StepWalk<Skip> walk(route, row_blk, kp);

  float fresh[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // step s lies in stage s % kWStages; `staged` steps have been requested
  // (one cp.async group a step, or an empty one past the last)
  int staged = 0;
  auto request = [&] {
    const int k0 = walk.next();
    if (k0 >= 0) {
      stage_step<XKind>(base + (staged % kWStages) * kWStageBytes, x, ws, kp, np, row0, col0,
                        k0);
      ++staged;
    }
    hopper::cp_async_commit();
  };
#pragma unroll 1
  for (int i = 0; i < kWAhead; ++i) request();

  int j = 0;
  // ready step j: wait for its stage, request step j + kWAhead into the
  // stage step j - 2 used, and build step j's fragments into `a`
  auto prepare = [&](uint32_t (&a)[2][4]) {
    hopper::cp_async_wait<kWAhead - 1>();
    // step j staged for every thread, and every thread past step j - 1's
    // wait, so no wgmma reads step j - 2's stage any more
    __syncthreads();
    request();
    x_fragments<XKind>(smem + (j % kWStages) * kWStageBytes + 3 * kTermBytes, r0, q, a);
  };
  // step j's products into the fresh tile (the first overwrites it); the
  // next step is readied while they run, then the tile joins the sum
  auto multiply = [&](const uint32_t (&a)[2][4], uint32_t (&next)[2][4]) {
    const uint32_t st = base + (j % kWStages) * kWStageBytes;
    hopper::wgmma_fence();
    // the smallest terms first: a wgmma truncates its sum at the scale of
    // its largest addend, the fresh tile among them, so w3's and w2's
    // products join while the tile is still small, and only the two w1
    // wgmmas truncate at the step's full scale
#pragma unroll
    for (int t = 2; t >= 0; --t)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        Wgmma<128>::rs(fresh, a[s],
                       hopper::smem_desc(st + t * kTermBytes + s * 16 * 128, kTermAtom,
                                         8 * 128, hopper::kSwizzle128),
                       t < 2 || s > 0);
    hopper::wgmma_commit();
    ++j;
    const bool more = j < staged;  // a next step exists: it is requested
    if (more) prepare(next);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(fresh);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], fresh[i]);
    return more;
  };
  // two steps an iteration, so that each fragment set is a fixed register
  // array (a wgmma in flight reads its fragments)
  uint32_t a0[2][4], a1[2][4];
  if (staged > 0) {
    prepare(a0);
    while (multiply(a0, a1) && multiply(a1, a0)) {
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is read and written no more
}

// The sum of event_wgmma_tile, from its accumulator layout into shared
// memory: tile[r][c] (kRestagePitch floats a row) of the CTA's 128 x 128,
// visible to every thread on return. Register 4 c + e is row r0 + 8 (e /
// 2), column 8 c + 2 q + e % 2; the 136-float pitch keeps a half-warp's
// float2 stores off each other's banks.
__device__ __forceinline__ void restage_sum(const float (&acc)[64], float* tile) {
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = 64 * wg + 16 * warp + lane / 4, q = lane % 4;
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * kRestagePitch + 8 * c + 2 * q) =
          make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  __syncthreads();
}

}  // namespace repro
