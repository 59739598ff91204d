// Event-driven spike matmul — replaces two Pallas kernels of
// repro/kernels/spike_matmul/spike_matmul.py: spike_matmul_pallas
// (skip="dense") and spike_matmul_gated_pallas (skip="gated" and
// "two_level"), for int8 x or packed_in words: out = x @ w in f32. The
// dense skip leaves out every (128-row, bk-column) block of x whose vld_cnt
// is zero; the gated walk visits only the compacted list kmap[row block,
// 0 .. nact) of non-silent blocks (core/events.py::compact_kmap); the
// two-level walk also leaves out every 32-column stripe whose occ bit is
// clear. The metadata grid is 128 rows by bk = 128 or 256 columns of k.
//
// The arithmetic is fixed: every output is one IEEE f32 fmaf chain from
// +0 over the kept k < K in ascending order, x (0 or 1) widened exactly
// (spike_matmul/ref.py::sequential_product). The reference's cuBLAS product
// forms the same chain, and so does the fused PE's near-threshold recheck,
// which takes a shortcut's output as its residual: a sum of another
// rounding (the tensor cores') moved the KD gradients past their gate.
// Leaving out a silent block, a block off the gated list, a silent stripe
// or the zero columns past K changes no bit: fmaf(0, w, acc) is acc for a
// finite w, and the sum never becomes -0. So the three skips give the same
// bits, and so does the decode route (decode_gemm.cuh), which takes a
// launch of at most kDecodeRows live rows on the dense skip.
//
// Bound on the H100: 2 nnz(x) N operations at the 67 TFLOP/s f32 rate
// outside the tensor cores, against the bytes of x, w and the f32 output
// (4 M N); the kernel does the dense product of the steps it keeps, 2 *
// 128 * 32 * BN an active step of a tile. At the ResNet shortcuts (K =
// 64..256) the f32 output weighs as much as the FMAs; at the unfused convs
// (K = 576..4608) the FMAs bind. What holds a SIMT product below the f32
// rate is the instruction slots and shared-memory reads around the FMAs,
// and the latency a CTA barrier exposes. The design:
//
// - Operands at their own K and N. w [K, N] is read in place; x [M, ldx]
//   int8 (ldx >= K, a multiple of 16) or [M, ldx] words of 32 spikes. The
//   k walk stops at K; what lies past the m, n and k edges arrives as
//   zeros (TMA fills it), and stores are bounds-checked.
// - Tiles. 128 rows by BN = 64, 128 or 192 columns (the wrapper's planner,
//   ops.py::tile_plan, picks BN per shape, so N = 64 runs no padded
//   column); four warps along m and one or two along n; a thread owns 8 x 8
//   outputs, or 8 x 12 at 192 (two 4-row and two or three 4-column quarters,
//   16 and 32 apart), so a k step reads 4 or 5 float4s of shared memory for
//   64 or 96 FMAs. Two CTAs of 64- or 128-wide tiles fit an SM (128
//   registers a thread, 80 or 112 KB of shared memory), so one CTA's
//   barrier and widening overlap the other's FMAs.
// - Pipeline. k is walked in 32-deep steps through a ring of kStages = 4
//   slots filled by TMA: one thread walks the steps and issues each step's
//   two boxes, w's 32 rows by BN columns (f32) and x's 128 rows by 32
//   bytes (or by the four words that hold the step's), on the slot's
//   mbarrier, so no other thread spends an instruction on a load. While
//   the FMAs of step s run, steps s + 1 .. s + 3 are in flight or landed,
//   and step s + 1 is widened to f32 once for the CTA (int8 through a byte
//   permute and an exact subtraction, not the quarter-rate I2F) into the
//   other half of a double-buffered x tile a[k][m]; one CTA barrier a step.
//   (A producer warp that widened for 8 consumer warps, one CTA an SM, was
//   slower on the card than two CTAs of this kind.)
// - Persistent grid. min(tiles, the CTAs the card holds at once) CTAs, each
//   a contiguous run of tiles, n fastest. The ring runs across tile
//   boundaries, so a CTA has the next tile's first steps in flight before
//   it stores the current tile, and the stores and their latency overlap
//   the next FMAs. Stores are float4s (scalar only where N % 4 != 0), and
//   every output of the launch is written once, silent tiles as zeros.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "decode_gemm.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

constexpr int kBM = 128;     // rows of a tile == rows of a metadata block
constexpr int kBK = 32;      // k depth of a step: one packed word a row

// 4 warps along m and WK along n, each 32 x 32 QC outputs; a thread 8 x 4 QC
template <int XKind, int WK, int QC>
struct Cfg {
  // the TMA ring's slots: steps s + 1 .. s + kStages - 1 in flight while
  // s runs
  static constexpr int kStages = 4;
  static constexpr int kBN = 32 * QC * WK;            // output columns a tile
  static constexpr int kThreads = 128 * WK;
  static constexpr int kWBytes = kBK * kBN * 4;       // a step's w rows, f32
  // a step's x: int8, 32 bytes a row; or the four words of each row that
  // hold the step's (a TMA box starts and ends on 16 bytes)
  static constexpr int kXBytes = XKind == kXPacked ? kBM * 16 : kBM * kBK;
  static constexpr int kXSlot = kBM * kBK;            // room for either
  static constexpr int kStage = kWBytes + kXSlot;
  static constexpr int kA = kBK * kBM;                // floats of a widened x tile
  static constexpr int kBars = kStages * kStage + 2 * kA * 4;
  static constexpr int kWords = kBars + 8 * kStages;   // a slot's word within its four
  static constexpr int kSmem = kWords + 4 * kStages;
};

struct Args {
  CUtensorMap wmap;   // w [k, n] f32, boxes of 32 rows by BN columns
  CUtensorMap xmap;   // x [m, ldx] int8 (boxes 128 rows by 32) or words (by 4)
  float* out;
  Route route;
  int m, k, n;        // x rows (= out rows), K, N
  int gk;             // metadata blocks along k
  int ntiles, tiles;  // column tiles, tiles in all
};

// the 2-D box of `map` at element coordinates (c0 innermost, c1) into
// shared memory at `dst`, counted on `bar`; elements outside arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The kept 32-deep steps of one row block in ascending k: the blocks the
// skip keeps (kDense: vld != 0; kGated / kTwoLevel: kmap[rb, 0 .. nact)),
// inside each the stripes below K (kTwoLevel: and whose occ bit is set).
template <int Skip>
struct Walk {
  int rb, s, slots, kb;
  unsigned bits;   // the current block's stripes still to visit

  __device__ __forceinline__ void begin(const Args& a, int row_blk) {
    rb = row_blk;
    s = -1;
    bits = 0u;
    slots = Skip == kDense ? a.gk : a.route.nact[rb];
  }

  // the next kept step's k0, or -1 when the row block has none left
  __device__ __forceinline__ int next(const Args& a) {
    while (bits == 0u) {
      if (++s >= slots) return -1;
      kb = Skip == kDense ? s : a.route.kmap[rb * a.gk + s];
      if (Skip == kDense && a.route.vld[rb * a.gk + kb] == 0) continue;
      const int left = a.k - kb * a.route.bk;   // k of the block below K
      const int cols = left < a.route.bk ? left : a.route.bk;
      bits = cols <= 0 ? 0u : (1u << ((cols + kBK - 1) / kBK)) - 1u;
      if (Skip == kTwoLevel) bits &= static_cast<unsigned>(a.route.occ[rb * a.gk + kb]);
    }
    const int j = __ffs(bits) - 1;
    bits &= bits - 1u;
    return kb * a.route.bk + j * kBK;
  }
};

// a landed stage's x widened to f32, transposed: at[k][m]; packed, the
// word `word` of each row's four
template <int XKind, class C>
__device__ __forceinline__ void widen(const unsigned char* __restrict__ xs,
                                      float* __restrict__ at, int word) {
  const int tid = threadIdx.x;
  const int m = tid % kBM;
#pragma unroll
  for (int h = tid / kBM; h < 2; h += C::kThreads / kBM) {   // 16 k a pass
    if constexpr (XKind == kXPacked) {
      const unsigned bits = reinterpret_cast<const unsigned*>(xs)[4 * m + word] >> (16 * h);
#pragma unroll
      for (int b = 0; b < 16; ++b) at[(16 * h + b) * kBM + m] = ((bits >> b) & 1u) ? 1.f : 0.f;
    } else {
      // byte b of a word, offset to unsigned, as the low byte of 2^23's
      // bits: (2^23 + b + 128) - (2^23 + 128) is b, exactly, on the full-rate
      // pipes (an I2F issues at a quarter of the FMA rate)
      const int4 v = *reinterpret_cast<const int4*>(xs + 32 * m + 16 * h);
      const unsigned u[4] = {static_cast<unsigned>(v.x) ^ 0x80808080u,
                             static_cast<unsigned>(v.y) ^ 0x80808080u,
                             static_cast<unsigned>(v.z) ^ 0x80808080u,
                             static_cast<unsigned>(v.w) ^ 0x80808080u};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        at[(16 * h + b) * kBM + m] = __fsub_rn(
            __uint_as_float(__byte_perm(u[b / 4], 0x4b000000u, 0x7540u + b % 4)), 8388736.f);
    }
  }
}

template <int XKind, int Skip, int WK, int QC>
__global__ void __launch_bounds__(Cfg<XKind, WK, QC>::kThreads, 1)
spike_matmul_tile_kernel(const __grid_constant__ Args a) {
  using C = Cfg<XKind, WK, QC>;
  constexpr int kCols = 4 * QC, kRows = 8;   // a thread's outputs
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kStages = C::kStages;
  float* const abuf = reinterpret_cast<float*>(smem + kStages * C::kStage);
  const uint32_t bars = hopper::smem_u32(smem + C::kBars);   // one full barrier a slot
  int* const word_of = reinterpret_cast<int*>(smem + C::kWords);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int lm = lane / 8, ln = lane % 8;
  const int a_off = wm * 32 + lm * 4, b_off = wn * 32 * QC + ln * 4;

  const int G = static_cast<int>(gridDim.x), c = static_cast<int>(blockIdx.x);
  const int t_begin = static_cast<int>(static_cast<long long>(a.tiles) * c / G);
  const int t_end = static_cast<int>(static_cast<long long>(a.tiles) * (c + 1) / G);
  if (t_begin >= t_end) return;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bars + 8 * s, 1);
      word_of[s] = 0;   // a slot past the run is widened too: keep it in bounds
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the producer, thread 0: the next step of the CTA's run, across its
  // tiles, into the next ring slot by two TMA loads (an arrival alone past
  // the run), so slot p % kStages holds the run's step p
  int pt = t_begin, pslot = 0;
  Walk<Skip> pw;
  if (tid == 0) pw.begin(a, pt / a.ntiles);
  const auto produce = [&]() {
    if (tid == 0) {
      int k0 = -1;
      while (pt < t_end) {
        k0 = pw.next(a);
        if (k0 >= 0) break;
        if (++pt < t_end) pw.begin(a, pt / a.ntiles);
      }
      const uint32_t bar = bars + 8 * pslot;
      if (k0 >= 0) {
        const uint32_t st = hopper::smem_u32(smem + pslot * C::kStage);
        // seen by the waiters on the slot's barrier (the arrival releases it)
        if constexpr (XKind == kXPacked) word_of[pslot] = (k0 / kBK) & 3;
        hopper::mbar_expect_tx(bar, C::kWBytes + C::kXBytes);
        tma_load_2d(st, &a.wmap, bar, (pt % a.ntiles) * C::kBN, k0);
        tma_load_2d(st + C::kWBytes, &a.xmap, bar, XKind == kXPacked ? (k0 / kBK) & ~3 : k0,
                    (pt / a.ntiles) * kBM);
      } else {
        hopper::mbar_arrive(bar);
      }
    }
    pslot = pslot + 1 == kStages ? 0 : pslot + 1;
  };

  uint32_t phases = 0u;   // bit s: the parity of slot s's next completion
  const auto landed = [&](int s) {
    hopper::mbar_wait(bars + 8 * s, (phases >> s) & 1u);
    phases ^= 1u << s;
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) produce();
  landed(0);
  widen<XKind, C>(smem + C::kWBytes, abuf, word_of[0]);

  int slot = 0, half = 0;   // step j's ring slot and x tile
  float acc[kRows][kCols];
  for (int t = t_begin; t < t_end; ++t) {
    const int row0 = (t / a.ntiles) * kBM, col0 = (t % a.ntiles) * C::kBN;
    Walk<Skip> cw;
    cw.begin(a, t / a.ntiles);
    int steps = 0;
    while (cw.next(a) >= 0) ++steps;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

    for (int s = 0; s < steps; ++s) {
      const int next = slot + 1 == kStages ? 0 : slot + 1;
      landed(next);      // step j + 1 (or an empty slot past the run)
      __syncthreads();   // step j - 1's reads of its slot and x tile are done
      produce();         // step j + 3, into step j - 1's slot
      widen<XKind, C>(smem + next * C::kStage + C::kWBytes, abuf + (half ^ 1) * C::kA,
                      word_of[next]);
      const float* A = abuf + half * C::kA + a_off;
      const float* B = reinterpret_cast<const float*>(smem + slot * C::kStage) + b_off;
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[kRows], bv[kCols];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 aq = *reinterpret_cast<const float4*>(A + kk * kBM + 16 * q);
          av[4 * q] = aq.x;
          av[4 * q + 1] = aq.y;
          av[4 * q + 2] = aq.z;
          av[4 * q + 3] = aq.w;
        }
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          const float4 bq = *reinterpret_cast<const float4*>(B + kk * C::kBN + 32 * q);
          bv[4 * q] = bq.x;
          bv[4 * q + 1] = bq.y;
          bv[4 * q + 2] = bq.z;
          bv[4 * q + 3] = bq.w;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      slot = next;
      half ^= 1;
    }

    // rows a_off + 16 p + {0..3}, columns b_off + 32 q + {0..3}
    const bool vec = a.n % 4 == 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = row0 + a_off + (i / 4) * 16 + i % 4;
      if (row >= a.m) continue;
      float* o = a.out + static_cast<size_t>(row) * a.n;
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        const int col = col0 + b_off + 32 * q;
        if (vec) {
          if (col < a.n)
            *reinterpret_cast<float4*>(o + col) = make_float4(
                acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < a.n) o[col + e] = acc[i][4 * q + e];
        }
      }
    }
  }
}

// a row-major 2-D tensor of `outer` rows of `inner` elements, `row_bytes`
// apart, as a map of boxes `box_outer` rows by `box_inner` elements, not
// swizzled; 0 or hopper::kEncodeError + the CUresult
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t inner,
              uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return hopper::kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : hopper::kEncodeError + static_cast<int>(r);
}

template <int XKind, int Skip, int WK, int QC>
int launch_tile(Args& a, const void* x, const float* w, int ldx, int ldw, cudaStream_t stream) {
  using C = Cfg<XKind, WK, QC>;
  const auto kernel = spike_matmul_tile_kernel<XKind, Skip, WK, QC>;
  static int resident = 0;   // CTAs of this instance one SM holds at once
  static int sms = 0;
  if (resident == 0) {
    int dev = 0;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, C::kThreads,
                                                          C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  int err = encode_2d(&a.wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, a.n, a.k, 4ull * ldw,
                      C::kBN, kBK);
  if (err == 0)
    err = XKind == kXPacked
              ? encode_2d(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_INT32, x, ldx, a.m, 4ull * ldx, 4,
                          kBM)
              : encode_2d(&a.xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, ldx, a.m, ldx, kBK, kBM);
  if (err != 0) return err;
  const int grid = a.tiles < sms * resident ? a.tiles : sms * resident;
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the tile widths: 64 and 128 as 1 and 2 warps along n of 8 x 8 threads,
// 192 as 2 warps of 8 x 12 threads
template <int XKind, int Skip>
int launch_width(Args& a, const void* x, const float* w, int ldx, int ldw, int block_n,
                 cudaStream_t stream) {
  a.ntiles = (a.n + block_n - 1) / block_n;
  a.tiles = (a.m + kBM - 1) / kBM * a.ntiles;
  if (block_n == 64) return launch_tile<XKind, Skip, 1, 2>(a, x, w, ldx, ldw, stream);
  if (block_n == 128) return launch_tile<XKind, Skip, 2, 2>(a, x, w, ldx, ldw, stream);
  return launch_tile<XKind, Skip, 2, 3>(a, x, w, ldx, ldw, stream);
}

using TileLaunch = int (*)(Args&, const void*, const float*, int, int, int, cudaStream_t);

// the decode route: each consumer thread writes its TR x TC outputs
// (DecodeGemm's rows and columns), then the CTA zeroes its columns of the
// rows up to mp
template <int XKind, int RM>
__global__ void __launch_bounds__(kDecodeThreads, 1)
spike_matmul_decode_kernel(const void* __restrict__ x, const float* __restrict__ w,
                           Route route, float* __restrict__ out, int mp, int kp, int np,
                           int m_valid) {
  using G = DecodeGemm<XKind, RM>;
  extern __shared__ __align__(16) unsigned char dsm[];
  constexpr int kRows = 16 * RM;
  const int col0 = blockIdx.x * kDecodeCols;
  const int tid = threadIdx.x;
  G gemm{dsm, x, w, kp, np, col0, m_valid, 0};
  gemm.start(route.vld, route.bk);
  float acc[G::kTR][G::kTC];
  gemm.run(acc, [] {});
  if (tid < G::kConsumers) {
    const int c = tid % G::kColGroups, rg = tid / G::kColGroups;
#pragma unroll
    for (int i = 0; i < G::kTR; ++i) {
      *reinterpret_cast<float2*>(out + static_cast<size_t>(rg + G::kRowGroups * i) * np +
                                 col0 + G::kTC * c) = make_float2(acc[i][0], acc[i][1]);
    }
  }
  for (int i = tid; i < (mp - kRows) * (kDecodeCols / 4); i += kDecodeThreads) {
    const int row = kRows + i / (kDecodeCols / 4), p = i % (kDecodeCols / 4);
    *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * np + col0 + 4 * p) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

using DecodeLaunch = void (*)(const void*, const float*, const Route&, float*, int, int, int,
                              int, cudaStream_t);

template <int XKind, int RM>
void launch_decode(const void* x, const float* w, const Route& route, float* out, int mp,
                   int kp, int np, int m_valid, cudaStream_t stream) {
  const auto kernel = spike_matmul_decode_kernel<XKind, RM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDecodeMaxSmem);
  (void)attr;  // a refusal shows as the launch's own error
  launch_decode_kernel(kernel, np, decode_smem_bytes<XKind, RM>(kp), stream, x, w, route,
                       out, mp, kp, np, m_valid);
}

}  // namespace

// The tile route. x [m, ldx] int8 (ldx a multiple of 16, at least k) or,
// with packed_x, [m, ldx] int32 words (ldx a multiple of 4, 32 ldx >= k);
// w [k, n] f32 with rows ldw floats apart (ldw >= n, a multiple of 4) ->
// out [m, n] f32, row-major; x, w and out 16-byte aligned. skip selects
// the walk: kDense reads vld [ceil(m/128), gk]; kGated reads nact
// [ceil(m/128)] and kmap [ceil(m/128), gk]; kTwoLevel also occ; gk =
// ceil(k / bk), bk 128 or 256. Pointers a walk does not read may be null.
// block_n is the tile's width, 64, 128 or 192 (ops.py::tile_plan).
extern "C" int repro_spike_matmul(const void* x, const float* w, const int* vld,
                                  const int* nact, const int* kmap, const int* occ,
                                  float* out, int m, int k, int n, int ldx, int ldw, int bk,
                                  int block_n, int packed_x, int skip, cudaStream_t stream) {
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (skip < kDense || skip > kTwoLevel || (bk != 128 && bk != 256) ||
      (block_n != 64 && block_n != 128 && block_n != 192) || m < 0 || k < 0 || n < 0 ||
      ldw < n || ldw % 4 || (packed_x ? (32ll * ldx < k || ldx % 4) : (ldx < k || ldx % 16)) ||
      !a16(x) || !a16(w) || !a16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  if (k == 0)   // no step: every output is the empty chain, +0
    return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(float) * m * n, stream));
  Args a{};
  a.out = out;
  a.route = Route{vld, nact, kmap, occ, bk};
  a.m = m;
  a.k = k;
  a.n = n;
  a.gk = (k + bk - 1) / bk;
  static const TileLaunch table[2][3] = {
      {&launch_width<kXInt8, kDense>, &launch_width<kXInt8, kGated>,
       &launch_width<kXInt8, kTwoLevel>},
      {&launch_width<kXPacked, kDense>, &launch_width<kXPacked, kGated>,
       &launch_width<kXPacked, kTwoLevel>}};
  return table[packed_x ? 1 : 0][skip](a, x, w, ldx, ldw, block_n, stream);
}

// The decode route (decode_gemm.cuh) on the dense skip: x [m_valid, kp]
// int8 or [m_valid, kp/32] words, m_valid <= kDecodeRows, w [kp, np] f32
// (np a multiple of 16), vld [mp/128, kp/bk] or null (every block kept) ->
// out [mp, np] f32, the rows past m_valid written as zeros, as the tile
// route's zero rows of x give.
extern "C" int repro_spike_matmul_decode(const void* x, const float* w, const int* vld,
                                         float* out, int mp, int kp, int np, int bk,
                                         int packed_x, int m_valid, cudaStream_t stream) {
  if (m_valid < 0 || m_valid > kDecodeRows || m_valid > mp || mp % kBM || kp % bk ||
      np % kDecodeCols)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mp > 0 && np > 0) {
    const Route r{vld, nullptr, nullptr, nullptr, bk};
    static const DecodeLaunch table[2][2] = {
        {&launch_decode<kXInt8, 1>, &launch_decode<kXInt8, 4>},
        {&launch_decode<kXPacked, 1>, &launch_decode<kXPacked, 4>}};
    table[packed_x ? 1 : 0][m_valid <= 16 ? 0 : 1](x, w, r, out, mp, kp, np, m_valid, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
