// The decode-shaped route of the event-gated product, shared by the fused
// PE (fused_pe.cuh) and the spike matmul (spike_matmul.cu): the LM's
// launches, whose live rows M are at most kDecodeRows (a decode tick of a
// few to a few dozen slots, a 64-token prefill chunk), on the dense skip.
//
// Bound on the H100: at M = 16, K = N = 2048 the product is 2 M K N = 134
// MFLOP (2 us at the 67 TFLOP/s f32 rate outside the tensor cores) against
// a 16.8 MB f32 weight (5 us at 3.35 TB/s): the weight stream bounds it.
// The 128-row tile (event_gemm.cuh) computes 112 rows of zeros for 16 live
// ones and runs N/128 = 16 CTAs, so 16 SMs pull the whole weight. This
// route keeps the tile's arithmetic and cuts the grid the other way: one
// CTA owns kDecodeCols = 16 output columns over all the live rows (N/16 =
// 128 CTAs at N = 2048, one wave on 132 SMs) and streams its [K, 16] slab
// of w exactly once.
//
// Bit for bit the 128-row tile's sums: every output is one ascending fmaf
// chain over k, from 0.f, over the k chunks whose vld block is not silent,
// each x value widened exactly (a bf16 is the top half of its f32, an int8
// or a packed bit a small integer). Split-K would sum in another order and
// is ruled out, so a chain is K dependent FMAs (about 4 us at K = 2048, 4
// cycles each), and an SM holds only 16 x 16 chains at M = 16. What bounds
// the FMAs is then shared memory: it delivers 128 bytes a cycle, paid per
// lane even where lanes read one address (a 16-byte load that a whole
// quarter-warp shares pays half), so a thread that owns TR rows by TC
// columns spends about 4 (TR + TC) bytes for TR TC FMAs a k.
// The consumers take TR x TC = 2 x 2 at M <= 16 (RM = 1, 64 threads) and
// 4 x 2 at M <= 64 (RM = 4, 128 threads): on the H100 one column pair a
// thread at M = 16, and 4 x 4 on two warps at M = 64, were slower. The
// CTA's warps are specialised. Warps 4-7 (producers) keep a ring of kStages
// chunks of kChunk k rows in shared memory filled by cp.async (16 bytes a
// thread: the w slab's rows and x's live rows in their own kind, int8,
// packed words, f32 or bf16; rows past m_valid are never read), and widen
// each chunk of x to an f32 tile one chunk ahead of use (double-buffered;
// integers through the 1.5 * 2^23 bias, which is exact and costs two
// full-rate operations where I2F is quarter-rate; an f32 x, and a bf16 x at 64
// rows, the consumers read raw instead); every copy and conversion loop has
// a constant trip count and issues unrolled. Warps 0-1, or 0-3 (consumers),
// only run FMAs: thread (c, rg) owns the columns col0 + TC c + j and the
// rows rg + (16 RM / TR) i, and loads the next 8 k of x (TR x 2 float4,
// rows 132 floats apart, in distinct banks) and w (8 float2) while the
// current 8 k's FMAs run; at 16 rows warps 2-3 are left idle, and the fused
// PE sums its QK gates there. One barrier a chunk hands the ring over
// (named full / empty barriers per stage, decoupling the two roles, were no
// faster; nor were 8-column CTAs, two an SM). No tensor cores: TF32 would
// break the parity with the reference.
//
// The caller guarantees: x is [>= m_valid, Kp] int8, f32 or bf16, or
// [>= m_valid, Kp/32] int32 words, row-major (only its first m_valid rows
// are read); w is [Kp, Np] f32 row-major; vld, when not null, is x's count
// map on the (128, bk) grid ([>= 1, Kp/bk] int32, row block 0 read); Kp is
// a multiple of bk (128 or 256), Np of kDecodeCols; the bases are 16-byte
// aligned; the launch has kDecodeThreads threads and decode_smem_bytes of
// dynamic shared memory.
#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "event_gemm.cuh"

namespace repro {

constexpr int kDecodeRows = 64;       // the most live rows the route takes
constexpr int kDecodeCols = 16;       // output columns of one CTA
constexpr int kProducers = 128;       // warps 4-7, the ring
constexpr int kDecodeThreads = 256;   // warps 0-3 hold the consumers
constexpr int kChunk = 128;           // k depth of one ring stage
constexpr int kStepK = 8;             // k a consumer loads ahead
constexpr int kXStride = kChunk + 4;  // f32 x tile row stride (floats)
// the largest dynamic shared memory a decode launch may ask for: the
// H100's 232,448 bytes a block, less room for the kernels' static arrays
constexpr int kDecodeMaxSmem = 232448 - 2048;

// the route argument of the C entries
constexpr int kRouteTile = 0, kRouteDecode = 1;

// bytes one row of x brings to one chunk, in its own kind
template <int XKind>
__host__ __device__ constexpr int chunk_row_bytes() {
  return XKind == kXPacked ? kChunk / 8
         : XKind == kXInt8 ? kChunk
         : XKind == kXBF16 ? 2 * kChunk
                           : 4 * kChunk;
}

// bytes of one x row in device memory
template <int XKind>
__device__ __forceinline__ size_t x_row_bytes(int kp) {
  return XKind == kXPacked ? static_cast<size_t>(kp) / 8
         : XKind == kXInt8 ? static_cast<size_t>(kp)
         : XKind == kXBF16 ? 2 * static_cast<size_t>(kp)
                           : 4 * static_cast<size_t>(kp);
}

// The dynamic shared memory of a decode launch: the ring's kStages stages,
// each the w slab's chunk ([kChunk][kDecodeCols] f32) and x's chunk in its
// own kind ([16 RM] rows of chunk_row_bytes); two f32 tiles of a widened
// chunk ([16 RM] rows of kXStride); the list of the kept chunks (Kp /
// kChunk ints). As many stages as fit, 3 to 8.
template <int XKind, int RM>
struct DecodeLayout {
  static constexpr int kRows = 16 * RM;
  static constexpr int kTR = RM == 1 ? 2 : 4;   // rows a consumer owns
  static constexpr int kTC = 2;                 // columns a consumer owns: a
                                                // float2 of each w row
  static constexpr int kConsumers = kRows * kDecodeCols / (kTR * kTC);
  static_assert(kConsumers <= kDecodeThreads - kProducers, "consumer tiling");
  // consumers read x from the ring in its own kind (no f32 tile): an f32 x,
  // and a bf16 x at 64 rows, where the tile's traffic outweighs widening
  // in registers (a shift or a mask a value)
  static constexpr bool kRawX = XKind == kXF32 || (XKind == kXBF16 && RM > 1);
  static constexpr int kWBytes = kChunk * kDecodeCols * 4;
  static constexpr int kXBytes = kRows * chunk_row_bytes<XKind>();
  static constexpr int kStage = kWBytes + kXBytes;
  static constexpr int kTileBytes = kRawX ? 0 : kRows * kXStride * 4;
  static constexpr int kFit = (kDecodeMaxSmem - 4096 - 2 * kTileBytes) / kStage;
  static constexpr int kStages = kFit < 3 ? 3 : kFit > 8 ? 8 : kFit;
  static constexpr int kTilesAt = kStages * kStage;
  static constexpr int kListAt = kTilesAt + 2 * kTileBytes;
  static constexpr size_t bytes(int kp) {
    return static_cast<size_t>(kListAt) + 4 * static_cast<size_t>(kp / kChunk);
  }
};

template <int XKind, int RM>
constexpr size_t decode_smem_bytes(int kp) {
  return DecodeLayout<XKind, RM>::bytes(kp);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch: a decode launch waits, before it touches
// memory, for the kernel before it to complete and publish its writes, and
// once its ring is drained lets the next kernel of its stream be
// dispatched, so that the next launch overlaps its epilogue. (Letting it
// be dispatched at the start was slower on the H100 than no overlap.)
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// Launch a decode kernel with programmatic stream serialization.
template <typename Kernel, typename... Args>
void launch_decode_kernel(Kernel kernel, int np, size_t smem, cudaStream_t stream,
                          Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(np / kDecodeCols);
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, args...);
}

// an integer of magnitude below 2^22 as f32, exactly: its bits added to
// those of 1.5 * 2^23, then the bias subtracted
__device__ __forceinline__ float int_to_float(int v) {
  return __int_as_float(0x4b400000 + v) - 12582912.f;
}

// One CTA's product: acc[i][j] = x[row(i), :] @ w[:, col(j)] over the kept
// chunks, in consumer thread (c, rg) = (tid % kColGroups, tid /
// kColGroups): row(i) = rg + kRowGroups i, col(j) = col0 + kTC c + j (acc
// is defined in the consumers only). x's rows at or past m_valid are never
// read: they widen to zeros, and a raw x (kRawX, the fused PE only, which
// masks those rows) leaves stale bytes there. start() builds the chunk list
// and puts the first kStages - 1 chunks in flight; run() drains the ring
// and ends with a CTA barrier, so what is written between the two, or by
// run()'s side work (the QK gates), is visible to all after.
template <int XKind, int RM>
struct DecodeGemm {
  using L = DecodeLayout<XKind, RM>;
  static constexpr int kStages = L::kStages, kTR = L::kTR, kTC = L::kTC;
  static constexpr int kConsumers = L::kConsumers;
  static constexpr bool kRawX = L::kRawX;
  static constexpr int kColGroups = kDecodeCols / kTC, kRowGroups = L::kRows / kTR;
  unsigned char* smem;
  const void* x;
  const float* w;
  int kp, np, col0, m_valid;
  int n;  // kept chunks

  __device__ __forceinline__ float* w_stage(int s) const {
    return reinterpret_cast<float*>(smem + s * L::kStage);
  }
  __device__ __forceinline__ unsigned char* x_stage(int s) const {
    return smem + s * L::kStage + L::kWBytes;
  }
  __device__ __forceinline__ float* x_tile(int b) const {
    return reinterpret_cast<float*>(smem + L::kTilesAt + b * L::kTileBytes);
  }
  __device__ __forceinline__ int* list() const {
    return reinterpret_cast<int*>(smem + L::kListAt);
  }
  __device__ __forceinline__ static bool producer() {
    return threadIdx.x >= kDecodeThreads - kProducers;
  }

  // The ascending list of the chunks the dense skip keeps (every chunk
  // without a vld map): a ballot per warp, the warps' counts in order.
  __device__ void build_list(const int* vld, int bk) {
    constexpr int kWarps = kDecodeThreads / 32;
    __shared__ int warp_tot[kWarps];
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int nk = kp / kChunk, per_block = bk / kChunk;
    int total = 0;
    for (int base = 0; base < nk; base += kDecodeThreads) {
      const int c = base + tid;
      const bool on = c < nk && (vld == nullptr || vld[c / per_block] != 0);
      const unsigned ball = __ballot_sync(0xffffffffu, on);
      if (lane == 0) warp_tot[warp] = __popc(ball);
      __syncthreads();
      int off = total, sum = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        if (v < warp) off += warp_tot[v];
        sum += warp_tot[v];
      }
      if (on) list()[off + __popc(ball & ((1u << lane) - 1u))] = c;
      total += sum;
      __syncthreads();
    }
    n = total;
  }

  // (producers) chunk c of w's column slab and of x's live rows into ring
  // stage s; every trip count is a constant, so the copies issue unrolled
  __device__ __forceinline__ void load(int c, int s) const {
    const int pt = threadIdx.x - (kDecodeThreads - kProducers);
    const int k0 = c * kChunk;
    float* ws = w_stage(s);
    constexpr int kPieces = kDecodeCols / 4;    // 16-byte pieces a w row
    static_assert(kChunk * kPieces % kProducers == 0, "w pieces per producer");
#pragma unroll
    for (int v = 0; v < kChunk * kPieces / kProducers; ++v) {
      const int i = pt + v * kProducers, r = i / kPieces, p = i % kPieces;
      cp_async16(ws + r * kDecodeCols + 4 * p,
                 w + static_cast<size_t>(k0 + r) * np + col0 + 4 * p);
    }
    constexpr int rb = chunk_row_bytes<XKind>();
    constexpr int pieces = rb / 16;
    constexpr int kXTrips = (L::kRows * pieces + kProducers - 1) / kProducers;
    unsigned char* xs = x_stage(s);
    const unsigned char* xg = static_cast<const unsigned char*>(x) + k0 * rb / kChunk;
#pragma unroll
    for (int v = 0; v < kXTrips; ++v) {
      const int i = pt + v * kProducers, r = i / pieces, p = i % pieces;
      if (r < m_valid)
        cp_async16(xs + r * rb + 16 * p, xg + r * x_row_bytes<XKind>(kp) + 16 * p);
    }
  }

  // (producers) stage s's x, widened exactly to f32 (zeros past m_valid),
  // into tile b, 4 k of one row at a time: all the loads first, then the
  // conversions and stores
  __device__ __forceinline__ void widen(int s, int b) const {
    constexpr int rb = chunk_row_bytes<XKind>();
    constexpr int kTrips = L::kRows * (kChunk / 4) / kProducers;
    static_assert(L::kRows * (kChunk / 4) % kProducers == 0, "x groups per producer");
    using Raw = typename std::conditional<
        XKind == kXF32, float4,
        typename std::conditional<XKind == kXBF16, uint2, unsigned>::type>::type;
    const unsigned char* xs = x_stage(s);
    float* t = x_tile(b);
    const int pt = threadIdx.x - (kDecodeThreads - kProducers);
    Raw raw[kTrips];
#pragma unroll
    for (int v = 0; v < kTrips; ++v) {
      const int i = pt + v * kProducers, r = i / (kChunk / 4), g = i % (kChunk / 4);
      const unsigned char* row = xs + r * rb;
      if constexpr (XKind == kXPacked)  // the word that holds columns 4g .. 4g + 3
        raw[v] = reinterpret_cast<const unsigned*>(row)[g / 8] >> (4 * (g % 8));
      else
        raw[v] = *reinterpret_cast<const Raw*>(row + sizeof(Raw) * g);
    }
#pragma unroll
    for (int v = 0; v < kTrips; ++v) {
      const int i = pt + v * kProducers, r = i / (kChunk / 4), g = i % (kChunk / 4);
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < m_valid) {
        if constexpr (XKind == kXF32) {
          f = raw[v];
        } else if constexpr (XKind == kXBF16) {  // the low half first
          const uint2 u = raw[v];
          f = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                          __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        } else if constexpr (XKind == kXInt8) {  // four signed bytes
          const int u = static_cast<int>(raw[v]);
          f = make_float4(int_to_float((u << 24) >> 24), int_to_float((u << 16) >> 24),
                          int_to_float((u << 8) >> 24), int_to_float(u >> 24));
        } else {  // bit b of a word is column 32 * word + b
          const unsigned bits = raw[v];
          f = make_float4(int_to_float(bits & 1u), int_to_float((bits >> 1) & 1u),
                          int_to_float((bits >> 2) & 1u), int_to_float((bits >> 3) & 1u));
        }
      }
      *reinterpret_cast<float4*>(t + r * kXStride + 4 * g) = f;
    }
  }

  // (consumers) the next kStepK k of x (rows row(i)) and w (columns
  // col(j)), into registers
  struct Step {
    float x[kTR][kStepK];
    float w[kStepK][kTC];
  };
  // x from an f32 tile (row stride kXStride floats), or raw from the ring
  // (row stride chunk_row_bytes: f32 as it is, bf16 widened here)
  __device__ __forceinline__ static void fetch(const void* t, const float* ws, int k,
                                               Step& st) {
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      if constexpr (kRawX && XKind == kXBF16) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            static_cast<const unsigned char*>(t) + kRowGroups * i * chunk_row_bytes<XKind>() +
            2 * k);
        const unsigned h[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // two bf16 a word, the low one first
          st.x[i][2 * q] = __uint_as_float(h[q] << 16);
          st.x[i][2 * q + 1] = __uint_as_float(h[q] & 0xffff0000u);
        }
      } else {
        constexpr int stride = kRawX ? chunk_row_bytes<XKind>() / 4 : kXStride;
        const float* row = static_cast<const float*>(t) + kRowGroups * i * stride + k;
#pragma unroll
        for (int q = 0; q < kStepK / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(row + 4 * q);
          st.x[i][4 * q] = v.x;
          st.x[i][4 * q + 1] = v.y;
          st.x[i][4 * q + 2] = v.z;
          st.x[i][4 * q + 3] = v.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStepK; ++u) {
      const float2 v = *reinterpret_cast<const float2*>(ws + (k + u) * kDecodeCols);
      st.w[u][0] = v.x;
      st.w[u][1] = v.y;
    }
  }
  __device__ __forceinline__ static void step(const Step& st, float (&acc)[kTR][kTC]) {
#pragma unroll
    for (int u = 0; u < kStepK; ++u)
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) acc[i][j] = fmaf(st.x[i][u], st.w[u][j], acc[i][j]);
  }

  // (consumers) acc += tile b's x @ stage s's w, k ascending (the tile
  // route's order), each step's operands loaded during the previous step
  __device__ __forceinline__ void fma(int s, int b, float (&acc)[kTR][kTC]) const {
    const int c = threadIdx.x % kColGroups, rg = threadIdx.x / kColGroups;
    const void* t = kRawX ? static_cast<const void*>(x_stage(s) + rg * chunk_row_bytes<XKind>())
                          : static_cast<const void*>(x_tile(b) + rg * kXStride);
    const float* ws = w_stage(s) + kTC * c;
    Step a, nx;
    fetch(t, ws, 0, a);
#pragma unroll
    for (int k = 0; k < kChunk; k += 2 * kStepK) {
      fetch(t, ws, k + kStepK, nx);
      step(a, acc);
      if (k + 2 * kStepK < kChunk) fetch(t, ws, k + 2 * kStepK, a);
      step(nx, acc);
    }
  }

  __device__ void start(const int* vld, int bk) {
    wait_for_prior_grid();
    if (vld == nullptr) {   // every chunk, in order
      n = kp / kChunk;
      for (int c = threadIdx.x; c < n; c += kDecodeThreads) list()[c] = c;
      __syncthreads();
    } else {
      build_list(vld, bk);
    }
    if (producer()) {
#pragma unroll 1
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < n) load(list()[s], s);
        cp_async_commit();
      }
    }
  }

  // The ring: at step i the consumers multiply chunk i while the producers
  // widen chunk i + 1 and load chunk i + kStages - 1 into the stage chunk i
  // - 1 left. One barrier a step (a named one, over the consumers and the
  // producers) publishes chunk i + 1's bytes and tile i, and retires the
  // stage and the tile that the producers overwrite next. The warps that
  // take no part (warps 2-3 at 16 rows) run side() meanwhile. A last CTA
  // barrier publishes what any warp wrote before or in run(); then the
  // stream's next kernel may be dispatched.
  template <typename Side>
  __device__ void run(float (&acc)[kTR][kTC], Side side) {
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;
    if (!producer() && threadIdx.x >= kConsumers) {
      side();
    } else {
      if (producer()) cp_async_wait<kStages - 2>();  // chunk 0 has landed
      ring_sync();
      if (!kRawX && producer() && n > 0) widen(0, 0);
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        if (producer()) cp_async_wait<kStages - 3>();  // chunk i + 1 has landed
        ring_sync();
        if (producer()) {
          const int j = i + kStages - 1;
          if (j < n) load(list()[j], j % kStages);
          cp_async_commit();
          if (!kRawX && i + 1 < n) widen((i + 1) % kStages, (i + 1) % 2);
        } else {
          fma(i % kStages, i % 2, acc);
        }
      }
    }
    __syncthreads();
    allow_next_grid();
  }

  // whether some warps take no part in the ring (and run run()'s side())
  static constexpr bool kIdleWarps = kConsumers < kDecodeThreads - kProducers;

  __device__ __forceinline__ static void ring_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers + kProducers) : "memory");
  }
};

}  // namespace repro
