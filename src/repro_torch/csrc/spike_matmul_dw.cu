// Backward weight-gradient of a spiking linear layer — replaces two Pallas
// kernels of repro/kernels/spike_matmul/backward.py, spike_matmul_dw_pallas
// (skip="dense") and spike_matmul_dw_gated_pallas (skip="gated" and
// "two_level", with gating.py::accum_tile_t), for int8 x and for bit-packed
// x (packed_in: int32 words of 32 spikes): dw[K, N] = x^T @ g over M, on
// the tensor cores (wgmma), exact in every product.
//
// The skips. The dense skip leaves out every 128 x 128 (m, k) block of x
// whose forward vld_cnt is zero; the gated walk visits, for each k block,
// only the compacted list mmap[kb, 0 .. nact_t[kb]) of its non-silent m
// blocks (core/events.py::compact_kmap of the transposed vld map). Both
// visit the same blocks in the same ascending order, so they give the same
// bits. The two-level skip (x's occ bits: silent 32-column stripes inside
// a visited block) walks as the gated one does: a stripe is 32 of the 128
// columns of one wgmma, which cannot leave part of its N out, and the FMAs
// the stripe skip once left out only ever added exact zeros. A silent
// block's spikes are all zero, so every skip is exact, and the g rows of a
// block no CTA visits are never read.
//
// Arithmetic. x is 0/1 (any int8 value is exact in bf16) and g is f32. g
// is split exactly into three bf16 terms, g = g1 + g2 + g3: g1 is g with
// its low 16 bits cleared, g2 the same of r = g - g1, g3 = bf16_rn(r -
// g2); each difference is exact in f32 and 8 + 8 + 8 bits hold g's 24, so
// the sum is g wherever the terms stay in bf16's range (|g| >= 2^-110;
// below, within 2^-134). The first two terms round toward zero, unlike
// K9's split of p (which is at most 1): no finite g, and no partial sum
// g1 + g2, overflows. A 16-row slice of M is then three bf16 wgmmas, each
// of exact products, into a fresh f32 tile, which joins the run's f32 sum
// with one correctly rounded add (kernels/spike_matmul/ref.py::
// split_g_bf16x3 and spike_matmul_dw_split_ref are the plain twins). The
// tensor cores' own accumulation rounds toward zero: a long chain of it
// drifts where a column of g keeps its sign (on the training step's
// operands a block's twelve chained products read 0.82 of the statistical
// sqrt(n) gate of chip_smoke.check_dw), so it chains three. The split happens in registers, from a staged f32 g
// tile: three bf16 copies of g are never written (they would be 6 bytes
// an element of g, written and read again), and each CTA splits only the
// g columns it multiplies.
//
// Operands. The CTA computes dw^T's tile, D[n, k] = g^T[n, m] x[m, k]: g^T
// is the A operand from registers (a thread's fragment is eight f32 of the
// staged tile, split into three fragments of four bf16 pairs), x the B
// operand from shared memory, MN-major (its rows are x's rows, k
// contiguous: x as it lies in memory), read through the transpose bit, as
// V is in flash_attention_wgmma.cu. So the tensor cores read only x's bf16
// tile from shared memory (4 KB a m64n128k16 wgmma, 64 bytes a clock at
// the full rate), not a second operand. (x as the A operand from shared
// memory and g's three terms as B would read both from shared memory,
// twice the bytes a product, and write the terms there first.)
//
// Dataflow. One CTA of 256 threads (two warpgroups) owns the 128 x 64 tile
// dw[kb * 128 .., nb * 64 ..] and one run of the 128-row blocks of M (M is
// cut into S runs so that the CTAs fill the card: the wrapper's plan,
// backward.py::dw_plan, from the shape alone). The n tile is 64, so N = 64
// (res1) is not padded; the k tile is one vld column block, so a block is
// skipped or visited whole. For each visited block, in a ring of three
// cp.async stages filled two blocks ahead: the block's f32 g rows [128 x
// 64] (16-byte copies, zero outside M and N) and its x [128 x 128] (int8,
// 16 KB, or four words a row, 2 KB). Then all threads write x as bf16 0/1
// into one of two 128-byte-swizzled tiles (fence.proxy.async, sync), and
// warpgroup w takes the four 16-row slices of rows 64 w .. 64 w + 63:
// three wgmmas m64n128k16 a slice, while the next slice's fragments are
// loaded and split, then the slice's add into the run's sum. Each
// warpgroup keeps its own sum over its half of every block; the epilogue
// adds the two (acc0 + acc1) in shared memory and stores the tile's f32
// partial [S, Kp, Np] with float4s. A second kernel adds the S partials of
// each output in order s = 0 .. S-1. No float atomics: dw is the same bits
// on every launch, under every skip, and for a packed x (its bits become
// the same bf16 tile as the int8 x).
//
// Bound on the H100: the data needs 2 * nnz(x) * N operations, three times
// over in bf16 at 989 TFLOP/s, against reading the kept x blocks and the g
// rows they need once and writing dw; on the training step's operands the
// two are close and, summed over the step's launches, the bytes bind. The
// kernel does the dense product of each visited block (2 * 128 * 128 * 64
// a CTA, three times) and re-reads g from the L2 for each k tile; what
// holds it above that is the CUDA-core work between the slices' wgmmas
// (x to bf16, g's split, a slice's add, for which the slice waits), which
// the tensor cores sit out. Measured times are in PERF.md.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "event_gemm.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

using repro::kDense;
using repro::kGated;
using repro::kTwoLevel;

constexpr int kMB = 128;             // rows of M a block (the vld grid's)
constexpr int kKT = 128;             // dw rows a CTA (one vld column block)
constexpr int kNT = 64;              // dw columns a CTA
constexpr int kThreads = 256;        // two warpgroups, one half of M each
constexpr int kStages = 3;
constexpr int kGPitch = kNT + 4;     // floats a staged g row (conflict-free fragment reads)
constexpr int kGBytes = kMB * kGPitch * 4;
constexpr int kXBytes = kMB * kKT;   // an int8 block; a packed one uses 2 KB of it
constexpr int kXbBytes = kMB * kKT * 2;
constexpr int kAtomBytes = kMB * 128;  // 64 bf16 columns of all 128 rows
constexpr int kGOff = 2 * kXbBytes;
constexpr int kXOff = kGOff + kStages * kGBytes;
constexpr int kSmem = kXOff + kStages * kXBytes + 1024;
static_assert(kKT * kGPitch * 4 <= kGBytes, "the epilogue tile fits a g stage");

struct Args {
  const void* x;
  const float* g;
  const int* vld;
  const int* nact_t;
  const int* mmap;
  float* partial;
  int m, k, n, kw, gm, gk, np, kp, per;
  bool g_vec;   // n % 4 == 0 and g 16-byte aligned: 16-byte copies
  int x_vec;    // int8 x: 16 (k % 16 == 0, aligned), 4 (k % 4 == 0) or 1
};

// the visited m blocks of one run, ascending
struct Walker {
  const int* vld;
  const int* list;
  int gk, kb, mb, end, t, nact;

  template <int Skip>
  __device__ __forceinline__ int next() {
    if constexpr (Skip == kDense) {
      while (mb < end) {
        const int b = mb++;
        if (vld[b * gk + kb] != 0) return b;
      }
      return -1;
    } else {
      if (t < nact) {
        const int b = list[t];
        if (b < end) {
          ++t;
          return b;
        }
      }
      return -1;
    }
  }
};

// block mb's g rows and x tile into stage st, asynchronously (the 1-byte x
// path of a ragged k stores synchronously)
template <bool Packed>
__device__ __forceinline__ void stage_block(uint32_t smem, uint8_t* smem_p, int st, int mb,
                                            const Args& a, int col_k, int col_n) {
  const int tid = threadIdx.x;
  const int row0 = mb * kMB;
  const uint32_t gs = smem + kGOff + st * kGBytes;
  if (a.g_vec) {
#pragma unroll
    for (int i = 0; i < kMB * kNT / 4 / kThreads; ++i) {
      const int c = tid + i * kThreads;            // 16 copies a row
      const int r = c / 16, q = c % 16;
      const int row = row0 + r, col = col_n + 4 * q;
      const bool in = row < a.m && col < a.n;
      cp_async16(gs + (r * kGPitch + 4 * q) * 4,
                 in ? a.g + static_cast<size_t>(row) * a.n + col : a.g, in);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kMB * kNT / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kNT, q = c % kNT;
      const int row = row0 + r, col = col_n + q;
      const bool in = row < a.m && col < a.n;
      cp_async4(gs + (r * kGPitch + q) * 4,
                in ? a.g + static_cast<size_t>(row) * a.n + col : a.g, in);
    }
  }
  const uint32_t xs = smem + kXOff + st * kXBytes;
  if constexpr (Packed) {
    // the words lie on the 128 x 128 grid: a row's 128 columns are 4 words
    if (tid < kMB)
      cp_async16(xs + tid * 16,
                 static_cast<const int*>(a.x) + static_cast<size_t>(row0 + tid) * a.kw +
                     col_k / 32,
                 true);
  } else {
    const int8_t* x = static_cast<const int8_t*>(a.x);
    if (a.x_vec == 16) {
#pragma unroll
      for (int i = 0; i < kMB * kKT / 16 / kThreads; ++i) {
        const int c = tid + i * kThreads;          // 8 copies a row
        const int r = c / 8, q = c % 8;
        const int row = row0 + r, col = col_k + 16 * q;
        const bool in = row < a.m && col < a.k;
        cp_async16(xs + r * kKT + 16 * q, in ? x + static_cast<size_t>(row) * a.k + col : x,
                   in);
      }
    } else if (a.x_vec == 4) {
#pragma unroll 4
      for (int i = 0; i < kMB * kKT / 4 / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / 32, q = c % 32;
        const int row = row0 + r, col = col_k + 4 * q;
        const bool in = row < a.m && col < a.k;
        cp_async4(xs + r * kKT + 4 * q, in ? x + static_cast<size_t>(row) * a.k + col : x,
                  in);
      }
    } else {
      int8_t* dst = reinterpret_cast<int8_t*>(smem_p + kXOff + st * kXBytes);
      for (int i = 0; i < kMB * kKT / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / kKT, q = c % kKT;
        const int row = row0 + r, col = col_k + q;
        dst[r * kKT + q] =
            (row < a.m && col < a.k) ? x[static_cast<size_t>(row) * a.k + col] : int8_t{0};
      }
    }
  }
}

__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// the bf16 of two int8 values, exact
__device__ __forceinline__ uint32_t int8_pair(uint32_t word, int byte) {
  const float lo = static_cast<float>(static_cast<int8_t>(word >> (8 * byte)));
  const float hi = static_cast<float>(static_cast<int8_t>(word >> (8 * byte + 8)));
  return bf16_pair(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// bf16 1.0 or 0.0 for bits i and i + 1 of a packed word
__device__ __forceinline__ uint32_t bit_pair(uint32_t word, int i) {
  return ((word >> i) & 1u) * 0x3F80u | ((word >> (i + 1)) & 1u) * 0x3F800000u;
}

// 8 bf16 of row r, columns col .. col + 7 (col % 8 == 0) of the swizzled
// x tile: 64-column atoms of 128 rows, 16-byte chunks XOR-ed by r % 8
__device__ __forceinline__ void store_chunk(uint8_t* xb, int r, int col, uint4 v) {
  const int chunk = (col % 64) / 8;
  *reinterpret_cast<uint4*>(xb + (col / 64) * kAtomBytes + r * 128 +
                            ((chunk ^ (r % 8)) << 4)) = v;
}

// the staged x of stage st as bf16 0/1 into the swizzled tile xb
template <bool Packed>
__device__ __forceinline__ void convert_block(const uint8_t* xs, uint8_t* xb) {
  const int tid = threadIdx.x;
  if constexpr (Packed) {
#pragma unroll
    for (int i = 0; i < kMB * 4 / kThreads; ++i) {
      const int c = tid + i * kThreads;            // row c / 4, word c % 4
      const int r = c / 4, wq = c % 4;
      const uint32_t word = reinterpret_cast<const uint32_t*>(xs)[r * 4 + wq];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
        store_chunk(xb, r, 32 * wq + 8 * ch,
                    make_uint4(bit_pair(word, 8 * ch), bit_pair(word, 8 * ch + 2),
                               bit_pair(word, 8 * ch + 4), bit_pair(word, 8 * ch + 6)));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMB * kKT / 8 / kThreads; ++i) {
      const int c = tid + i * kThreads;            // row c / 16, chunk c % 16
      const int r = c / 16, ch = c % 16;
      const uint2 raw = *reinterpret_cast<const uint2*>(xs + r * kKT + 8 * ch);
      store_chunk(xb, r, 8 * ch,
                  make_uint4(int8_pair(raw.x, 0), int8_pair(raw.x, 2), int8_pair(raw.y, 0),
                             int8_pair(raw.y, 2)));
    }
  }
}

// g = g1 + g2 + g3 exactly, each a bf16 (see the head note), for the pair
// (x0, y0) of one A-fragment register (x0 the low half)
__device__ __forceinline__ void split_g_bf16x3(float x0, float y0, uint32_t& p1,
                                             uint32_t& p2, uint32_t& p3) {
  const uint32_t xb = __float_as_uint(x0), yb = __float_as_uint(y0);
  p1 = __byte_perm(xb, yb, 0x7632);
  const float xr = __fsub_rn(x0, __uint_as_float(xb & 0xFFFF0000u));
  const float yr = __fsub_rn(y0, __uint_as_float(yb & 0xFFFF0000u));
  const uint32_t xrb = __float_as_uint(xr), yrb = __float_as_uint(yr);
  p2 = __byte_perm(xrb, yrb, 0x7632);
  const float x3 = __fsub_rn(xr, __uint_as_float(xrb & 0xFFFF0000u));
  const float y3 = __fsub_rn(yr, __uint_as_float(yrb & 0xFFFF0000u));
  p3 = bf16_pair(__float2bfloat16_rn(x3), __float2bfloat16_rn(y3));
}

// slice q's A fragments: rows (n) r, r + 8 and columns (m) 16 q + c, + 1,
// + 8, + 9 of the staged g tile gs [128 m][kGPitch], split in three
__device__ __forceinline__ void slice_fragments(const float* gs, int q, int r, int c,
                                                uint32_t (&f)[3][4]) {
  const float* p = gs + (16 * q + c) * kGPitch + r;
  const float v[8] = {p[0],               p[kGPitch],               p[8],
                      p[kGPitch + 8],     p[8 * kGPitch],           p[9 * kGPitch],
                      p[8 * kGPitch + 8], p[9 * kGPitch + 8]};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_g_bf16x3(v[2 * i], v[2 * i + 1], f[0][i], f[1][i], f[2][i]);
}

// acc += g^T x over warpgroup wg's four 16-row slices of one block, x the
// swizzled bf16 tile at xb_addr. A slice's three products go to a fresh
// tile, blk (the first overwrites it), which joins acc with a correctly
// rounded add: the tensor cores' own accumulation (rounding toward zero)
// chains at most three products. The next slice's fragments are split
// while a slice's wgmmas run.
__device__ __forceinline__ void multiply_block(float (&acc)[64], float (&blk)[64],
                                               const float* gs, uint32_t xb_addr, int wg,
                                               int warp, int lane) {
  const int r = 16 * warp + lane / 4;          // the fragment's n rows r, r + 8
  const int c = 2 * (lane % 4);                // and m columns c, c + 1, c + 8, c + 9
  uint32_t f[2][3][4];
  slice_fragments(gs, 4 * wg, r, c, f[0]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int q = 4 * wg + kk;                 // rows 16 q .. 16 q + 15 of the block
    const uint64_t b = smem_desc(xb_addr + q * 16 * 128, kAtomBytes, 8 * 128, kSwizzle128);
    wgmma_fence();
    Wgmma<128>::rs(blk, f[kk % 2][0], b, 0);
    Wgmma<128>::rs(blk, f[kk % 2][1], b);
    Wgmma<128>::rs(blk, f[kk % 2][2], b);
    wgmma_commit();
    if (kk < 3) slice_fragments(gs, q + 1, r, c, f[(kk + 1) % 2]);
    wgmma_wait<0>();
    fence_regs(blk);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], blk[i]);
  }
}

template <int Skip, bool Packed>
__global__ void __launch_bounds__(kThreads, 1)
spike_matmul_dw_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* base_p = smem_raw + (base - smem_u32(smem_raw));
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int nb = blockIdx.x, kb = blockIdx.y, s = blockIdx.z;
  const int col_k = kb * kKT, col_n = nb * kNT;
  const int mb_begin = s * a.per, mb_end = min(a.gm, mb_begin + a.per);

  Walker walk{a.vld, nullptr, a.gk, kb, mb_begin, mb_end, 0, 0};
  if constexpr (Skip != kDense) {
    // the run's first entry of the ascending list: a lower bound
    walk.list = a.mmap + static_cast<size_t>(kb) * a.gm;
    walk.nact = a.nact_t[kb];
    int lo = 0, hi = walk.nact;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (walk.list[mid] < mb_begin) lo = mid + 1; else hi = mid;
    }
    walk.t = lo;
  }

  float acc[64], blk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  int cur = walk.next<Skip>();
  int nxt = -1;
  if (cur >= 0) stage_block<Packed>(base, base_p, 0, cur, a, col_k, col_n);
  cp_async_commit();
  if (cur >= 0) {
    nxt = walk.next<Skip>();
    if (nxt >= 0) stage_block<Packed>(base, base_p, 1, nxt, a, col_k, col_n);
  }
  cp_async_commit();

  for (int j = 0; cur >= 0; ++j) {
    const int st = j % kStages;
    cp_async_wait<1>();
    __syncthreads();   // block j staged; every thread is past block j - 1
    const int after = nxt >= 0 ? walk.next<Skip>() : -1;
    if (after >= 0) stage_block<Packed>(base, base_p, (j + 2) % kStages, after, a, col_k, col_n);
    cp_async_commit();
    uint8_t* xb = base_p + (j % 2) * kXbBytes;
    convert_block<Packed>(base_p + kXOff + st * kXBytes, xb);
    fence_proxy_async();
    __syncthreads();
    multiply_block(acc, blk, reinterpret_cast<const float*>(base_p + kGOff + st * kGBytes),
                   base + (j % 2) * kXbBytes, wg, warp, lane);
    cur = nxt;
    nxt = after;
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc0 + acc1 through a [128 k][kGPitch] f32 tile over g's stage 0;
  // register 4 j + e is n = 16 warp + lane / 4 + 8 (e / 2), k = 8 j +
  // 2 (lane % 4) + e % 2
  float* tile = reinterpret_cast<float*>(base_p + kGOff);
  const int n0 = 16 * warp + lane / 4, k0 = 2 * (lane % 4);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      tile[(8 * (i / 4) + k0 + i % 2) * kGPitch + n0 + 8 * ((i / 2) % 2)] = acc[i];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float* t = tile + (8 * (i / 4) + k0 + i % 2) * kGPitch + n0 + 8 * ((i / 2) % 2);
      *t = __fadd_rn(acc[i], *t);
    }
  }
  __syncthreads();
  float* out = a.partial + (static_cast<size_t>(s) * a.kp + col_k) * a.np + col_n;
#pragma unroll
  for (int i = 0; i < kKT * kNT / 4 / kThreads; ++i) {
    const int c = tid + i * kThreads;              // 16 float4s a row
    const int r = c / 16, q = c % 16;
    *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * a.np + 4 * q) =
        *reinterpret_cast<const float4*>(tile + r * kGPitch + 4 * q);
  }
}

// dw[r, c] = partial[0, r, c] + partial[1, r, c] + ... in that order
__global__ void dw_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                              int k, int n, int kp, int np, int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(k) * n) return;
  const int r = static_cast<int>(i / n), c = static_cast<int>(i % n);
  const size_t stride = static_cast<size_t>(kp) * np;
  const float* p = partial + static_cast<size_t>(r) * np + c;
  float s = p[0];
  for (int t = 1; t < splits; ++t) s = __fadd_rn(s, p[t * stride]);
  dw[i] = s;
}

template <int Skip, bool Packed>
int launch_dw(const Args& a, dim3 grid, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        spike_matmul_dw_kernel<Skip, Packed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  spike_matmul_dw_kernel<Skip, Packed><<<grid, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool Packed>
int launch_skip(const Args& a, int skip, dim3 grid, cudaStream_t stream) {
  if (skip == kDense) return launch_dw<kDense, Packed>(a, grid, stream);
  // the two-level walk is the gated one (see the head note)
  return launch_dw<kGated, Packed>(a, grid, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x [m, k] int8 or, packed != 0, [mp, kp/32] int32 words (mp, kp: m, k
// rounded up to 128), g [m, n] f32, partial [splits, kp, np] f32 scratch
// (np: n rounded up to 64) -> dw [k, n] f32. CTA s covers the 128-row
// blocks [s * blocks_per_split, (s + 1) * blocks_per_split). The route
// (skip, see event_gemm.cuh): kDense reads vld [gm, gk] (gm, gk: m, k
// over 128, rounded up); kGated and kTwoLevel nact_t [gk] and mmap [gk,
// gm], the compacted transposed vld map (kTwoLevel walks as kGated: see
// the head note). partial and the words are 16-byte aligned.
extern "C" int repro_spike_matmul_dw(const void* x, const float* g, const int* vld,
                                     const int* nact_t, const int* mmap, float* partial,
                                     float* dw, int m, int k, int n, int splits,
                                     int blocks_per_split, int skip, int packed,
                                     cudaStream_t stream) {
  if (skip < kDense || skip > kTwoLevel || !aligned16(partial) ||
      (packed && !aligned16(x)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0 && n > 0) {
    const int gm = (m + kMB - 1) / kMB, gk = (k + kKT - 1) / kKT;
    const int kp = gk * kKT, np = (n + kNT - 1) / kNT * kNT;
    // an int8 x's copies: 16 bytes, 4, or one at a time (a ragged k)
    int x_vec = 1;
    if (k % 16 == 0 && aligned16(x)) x_vec = 16;
    else if (k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0) x_vec = 4;
    Args a{x, g, vld, nact_t, mmap, partial, m, k, n, kp / 32, gm, gk, np, kp,
           blocks_per_split, n % 4 == 0 && aligned16(g), x_vec};
    const dim3 grid(np / kNT, gk, splits);
    const int err = packed ? launch_skip<true>(a, skip, grid, stream)
                           : launch_skip<false>(a, skip, grid, stream);
    if (err != 0) return err;
    const size_t total = static_cast<size_t>(k) * n;
    dw_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
        partial, dw, k, n, kp, np, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
