// Streaming (flash) softmax attention, forward, at bf16 operands on the
// tensor cores — the wgmma route of the Pallas kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (its scalar route, and every f32 call, is flash_attention.cu).
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G]) v[b, j, h / G]
//
// over keys j <= i when causal, G = H / Hkv query heads a KV head. q and
// out are [B, S, H, D], k and v [B, S, Hkv, D], all bf16, read in that
// layout through 4-D tensor maps (no transpose, no repeat of K and V: a
// query head reads KV head h / G in place). The kernel's instances are D
// 32, 64 and 128; a head dim d between them (48, 96, 112, any d <= 128
// with d % 8 == 0, so that a head's row of 2 d bytes is a TMA stride) runs
// at the next instance: the tensor maps' extent is d, so TMA fills the
// tile's columns d .. D - 1 with zeros, which add exact zeros to QK^T and
// give PV zero columns, and the epilogue stores only the columns < d.
//
// Arithmetic: the reference's function, exact wherever it is.
// - S = q . k^T by wgmma over the raw bf16 tiles: every product is exact in
//   f32 and the sums are f32. Then s = scale * S in f32 (the reference
//   scales q first: one f32 rounding moves).
// - Keys above the query, and keys >= S (TMA fills them with zeros), get
//   s = -1e30, never -inf. m is the running max, p = expf(s - m_new) in
//   f32, l the running sum of that f32 p.
// - p is not a bf16 value. It is split exactly, p = p1 + p2 + p3, each a
//   bf16 (p1 = bf16_rn(p), p2 = bf16_rn(p - p1), p3 = bf16_rn(p - p1 -
//   p2): 24 significand bits in three 8-bit pieces; the differences are
//   exact), and PV is three wgmmas into one f32 accumulator, each of exact
//   products. p's 16-key slices are taken straight from the score
//   accumulator's registers as the A fragment of a k16 wgmma; V is B,
//   MN-major, through the transpose bit.
// - out = acc / max(l, 1e-30), rounded to bf16 to nearest.
//
// Dataflow, in the manner of FlashAttention-3: a CTA of 384 threads owns
// 128 query rows of one (b, h). Warpgroup 0 is the producer (setmaxnreg
// down to 24 registers): one thread loads the Q tile once by TMA, then K
// and V tiles of kBlockN = 128 keys through a 2-stage ring of mbarriers
// (K and V full apart, one empty barrier a stage), 128-byte-swizzled (64
// bytes at D 32; D 128 takes two 64-column boxes a tile). Warpgroups 1
// and 2 (setmaxnreg up to 240) each own 64 query rows: wait K, QK^T,
// softmax, wait V, the three PV wgmmas a 16-key slice, release the stage.
// Causal: the CTA stops at the last tile any of its rows reaches; a
// warpgroup computes nothing on a tile past its own rows (it waits for the
// tile and releases it, so the ring's phases stay in step); only tiles
// that cross a diagonal or the sequence's end are masked; the grid is 1-D
// with the longest q tiles first.
//
// Bound on the H100: operations. 4 B H S^2 D (halved when causal), half of
// them QK^T, half PV; with PV three times, 2 x (4 B H pairs D) at the 989
// TFLOP/s bf16 tensor-core rate; against it, q, k, v read and out written
// once at 3.35 TB/s.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRowsQ = 128;     // query rows a CTA
constexpr int kRowsWG = 64;     // query rows a consumer warpgroup
constexpr int kBlockN = 128;    // keys a K/V tile (64 ran 2-5 % slower on an H100)
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr float kNeg = -1e30f;

template <int D, int BN>
struct Cfg {
  static constexpr int kAtomCols = D < 64 ? D : 64;   // one TMA box's columns
  static constexpr int kRowBytes = 2 * kAtomCols;     // a swizzled row
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? kSwizzle128 : kSwizzle64;
  static constexpr int kQBytes = kRowsQ * D * 2;
  static constexpr int kKVBytes = BN * D * 2;
  static constexpr int kKOff = kQBytes;               // from the aligned base
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;
};

// s = A . B^T over one tile, both K-major: A 64 rows by D at a_addr (its
// 64-column swizzle atoms a_atom_bytes apart), B BN rows by D at b_addr
// (its atoms BN rows apart)
template <int D, int BN>
__device__ __forceinline__ void qk_tile(float (&s)[BN / 2], uint32_t a_addr,
                                        uint32_t a_atom_bytes, uint32_t b_addr) {
  using C = Cfg<D, BN>;
  constexpr int kSteps = C::kAtomCols / 16;           // k16 steps an atom
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % kSteps) * 32;
    const uint64_t a = smem_desc(a_addr + (kk / kSteps) * a_atom_bytes + col, 16,
                                 8 * C::kRowBytes, C::kSwizzle);
    const uint64_t b = smem_desc(b_addr + (kk / kSteps) * BN * C::kRowBytes + col,
                                 16, 8 * C::kRowBytes, C::kSwizzle);
    Wgmma<BN>::ss(s, a, b, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// x = x1 + x2 + x3 exactly, each a bf16 rounded to nearest from the f32
// remainder, for the pair (x0, y0) of one A-fragment register
__device__ __forceinline__ void split_bf16x3(float x0, float y0, uint32_t& p1,
                                             uint32_t& p2, uint32_t& p3) {
  const __nv_bfloat16 x1 = __float2bfloat16_rn(x0), y1 = __float2bfloat16_rn(y0);
  const float xr = __fsub_rn(x0, __bfloat162float(x1));
  const float yr = __fsub_rn(y0, __bfloat162float(y1));
  const __nv_bfloat16 x2 = __float2bfloat16_rn(xr), y2 = __float2bfloat16_rn(yr);
  const __nv_bfloat16 x3 = __float2bfloat16_rn(__fsub_rn(xr, __bfloat162float(x2)));
  const __nv_bfloat16 y3 = __float2bfloat16_rn(__fsub_rn(yr, __bfloat162float(y2)));
  p1 = bf16_pair(x1, y1);
  p2 = bf16_pair(x2, y2);
  p3 = bf16_pair(x3, y3);
}

// o += p . V over one tile: p the f32 scores' registers (64 x BN), V BN x D
// at v_addr, MN-major; three wgmmas (p1, p2, p3) a 16-key slice. A slice's
// fragments are built while the slice before it multiplies, and at most
// two slices' fragments are live (a commit group a slice, wait for all but
// the last), so the split does not hold BN / 16 slices' 12 registers each.
template <int D, int BN>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2], const float (&p)[BN / 2],
                                        uint32_t v_addr) {
  using C = Cfg<D, BN>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t a1[4], a2[4], a3[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16x3(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1], a1[i], a2[i], a3[i]);
    const uint64_t b = smem_desc(v_addr + kk * 16 * C::kRowBytes, BN * C::kRowBytes,
                                 8 * C::kRowBytes, C::kSwizzle);
    wgmma_fence();
    Wgmma<D>::rs(o, a1, b);
    Wgmma<D>::rs(o, a2, b);
    Wgmma<D>::rs(o, a3, b);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(o);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// scale and mask one tile's scores, then the online softmax step: s
// becomes p, m and l move on, o is rescaled. row0 is the thread's first
// row (its second is row0 + 8), k0 the tile's first key.
template <int D, int BN>
__device__ __forceinline__ void softmax_step(float (&s)[BN / 2], float (&o)[D / 2],
                                             float (&m)[2], float (&l)[2],
                                             float scale, bool masked, int k0,
                                             int row0, int s_len, int causal,
                                             int lane) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(s[4 * j + e], scale);
      if (masked) {
        const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
        if (key >= s_len || (causal && key > row0 + 8 * (e >> 1))) x = kNeg;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    corr[r] = expf(m[r] - mx[r]);
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float p = expf(s[i] - mx[(i >> 1) & 1]);
    s[i] = p;
    sum[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * corr[r] + quad_sum(sum[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ out, int s_len, int heads, int d,
                   int group, int n_bh, int n_qt, float scale, int causal) {
  constexpr int BN = kBlockN;
  using C = Cfg<D, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + C::kKOff, v_s = base + C::kVOff;
  // barriers: Q full, K full and V full a stage, empty a stage
  const uint32_t bar_q = base + C::kBarOff;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * kStages;
  const uint32_t bar_e = bar_v + 8 * kStages;

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh;   // longest first
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = qt * kRowsQ;
  const int n_kv = (s_len + BN - 1) / BN;
  const int n_tiles = causal ? min(n_kv, (min(s_len, q0 + kRowsQ) - 1) / BN + 1) : n_kv;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bar_k + 8 * i, 1);
      mbar_init(bar_v + 8 * i, 1);
      mbar_init(bar_e + 8 * i, 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(bar_q, C::kQBytes);
      for (int a = 0; a < C::kAtoms; ++a)
        tma_load_4d(q_s + a * kRowsQ * C::kRowBytes, &tm_q, bar_q, a * C::kAtomCols,
                    h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(bar_e + 8 * st, ((t / kStages) - 1) & 1);
        const uint32_t off = st * C::kKVBytes;
        mbar_expect_tx(bar_k + 8 * st, C::kKVBytes);
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load_4d(k_s + off + a * BN * C::kRowBytes, &tm_k, bar_k + 8 * st,
                      a * C::kAtomCols, kvh, t * BN, b);
        mbar_expect_tx(bar_v + 8 * st, C::kKVBytes);
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load_4d(v_s + off + a * BN * C::kRowBytes, &tm_v, bar_v + 8 * st,
                      a * C::kAtomCols, kvh, t * BN, b);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid % 32;
    const int q_lo = q0 + kRowsWG * c;
    const int row0 = q_lo + 16 * (tid / 32) + lane / 4;
    const int my_tiles = q_lo >= s_len ? 0
                         : causal ? min(n_kv, (min(s_len, q_lo + kRowsWG) - 1) / BN + 1)
                                  : n_kv;
    float o[D / 2], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    if (my_tiles > 0) mbar_wait(bar_q, 0);
    const uint32_t q_addr = q_s + c * kRowsWG * C::kRowBytes;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const uint32_t phase = (t / kStages) & 1;
      if (t >= my_tiles) {
        // past this warpgroup's rows: wait for the tile all the same, so
        // that its release lands in the stage's current phase
        mbar_wait(bar_k + 8 * st, phase);
        mbar_wait(bar_v + 8 * st, phase);
      } else {
        const int k0 = t * BN;
        float s[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
        mbar_wait(bar_k + 8 * st, phase);
        qk_tile<D, BN>(s, q_addr, kRowsQ * C::kRowBytes, k_s + st * C::kKVBytes);
        const bool masked = k0 + BN > s_len || (causal && k0 + BN - 1 > q_lo);
        softmax_step<D, BN>(s, o, m, l, scale, masked, k0, row0, s_len, causal, lane);
        mbar_wait(bar_v + 8 * st, phase);
        pv_tile<D, BN>(o, s, v_s + st * C::kKVBytes);
      }
      mbar_arrive(bar_e + 8 * st);
    }
    if (my_tiles > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= s_len) continue;
        const float den = fmaxf(l[r], 1e-30f);
        __nv_bfloat16* dst =
            out + ((static_cast<size_t>(b) * s_len + row) * heads + h) * d + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          // columns 8 j + 2 (lane % 4) and the next: both < d or neither
          // (d % 8 == 0)
          if (8 * j + 2 * (lane % 4) >= d) continue;
          const uint32_t pair = bf16_pair(__float2bfloat16_rn(o[4 * j + 2 * r] / den),
                                          __float2bfloat16_rn(o[4 * j + 2 * r + 1] / den));
          *reinterpret_cast<uint32_t*>(dst + 8 * j) = pair;
        }
      }
    }
  }
}

// One tile's products alone, through the kernel's own helpers (layouts and
// descriptors) at a 64-key tile, for testing them against torch.matmul:
// mode 0, out [64, 64] = A B^T (qk_tile, A and B [64, D]); mode 1, out
// [64, D] = P V (pv_tile, P [64, 64] f32 split in three, V [64, D]). A and
// B (V) are [1, 64, 1, D] bf16 read through tensor maps.
template <int D>
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b,
                   const float* __restrict__ p, float* __restrict__ out, int mode) {
  using C = Cfg<D, 64>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_s = base, b_s = base + 64 * D * 2, bar = b_s + 64 * D * 2;
  const int tid = threadIdx.x, lane = tid % 32;
  const int row = 16 * (tid / 32) + lane / 4, col = 2 * (lane % 4);
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (mode == 0 ? 2 : 1) * 64 * D * 2);
    for (int a = 0; a < C::kAtoms; ++a) {
      if (mode == 0)
        tma_load_4d(a_s + a * 64 * C::kRowBytes, &tm_a, bar, a * C::kAtomCols, 0, 0, 0);
      tma_load_4d(b_s + a * 64 * C::kRowBytes, &tm_b, bar, a * C::kAtomCols, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  if (mode == 0) {
    float s[32];
    qk_tile<D, 64>(s, a_s, 64 * C::kRowBytes, b_s);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      out[(row + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + col + (i & 1)] = s[i];
  } else {
    float pr[32], o[D / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      pr[i] = p[(row + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + col + (i & 1)];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    pv_tile<D, 64>(o, pr, b_s);
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      out[(row + 8 * ((i >> 1) & 1)) * D + 8 * (i >> 2) + col + (i & 1)] = o[i];
  }
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           void* out, int batch, int s_len, int heads, int kv_heads, int d, float scale,
           int causal, cudaStream_t stream) {
  using C = Cfg<D, kBlockN>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int n_qt = (s_len + kRowsQ - 1) / kRowsQ;
  const int n_bh = batch * heads;
  flash_wgmma_kernel<D><<<n_qt * n_bh, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), s_len, heads, d, heads / kv_heads,
      n_bh, n_qt, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_probe(const CUtensorMap& ta, const CUtensorMap& tb, const float* p,
                 float* out, int mode, cudaStream_t stream) {
  wgmma_probe_kernel<D><<<1, 128, 2 * 64 * D * 2 + 8 + 1024, stream>>>(ta, tb, p, out, mode);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q, out: [batch, s_len, heads, d]; k, v: [batch, s_len, kv_heads, d];
// contiguous bf16, 16-byte aligned; kv_heads divides heads; d <= 128 with
// d % 8 == 0, run at the instance D of 32, 64 or 128 that is the smallest
// >= d. Returns a CUDA error, or hopper::kEncodeError + the CUresult of a
// failed tensor-map encode.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                           void* out, int batch, int s_len, int heads,
                                           int kv_heads, int d, float scale, int causal,
                                           cudaStream_t stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || kv_heads < 1 || heads % kv_heads != 0 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || s_len == 0) return static_cast<int>(cudaGetLastError());
  const int inst = d <= 32 ? 32 : d <= 64 ? 64 : 128;
  CUtensorMap tq, tk, tv;
  int err = encode_bf16_rows(&tq, q, batch, s_len, heads, d, kRowsQ, inst);
  if (err == 0) err = encode_bf16_rows(&tk, k, batch, s_len, kv_heads, d, kBlockN, inst);
  if (err == 0) err = encode_bf16_rows(&tv, v, batch, s_len, kv_heads, d, kBlockN, inst);
  if (err != 0) return err;
  if (inst == 32)
    return launch<32>(tq, tk, tv, out, batch, s_len, heads, kv_heads, d, scale, causal,
                      stream);
  if (inst == 64)
    return launch<64>(tq, tk, tv, out, batch, s_len, heads, kv_heads, d, scale, causal,
                      stream);
  return launch<128>(tq, tk, tv, out, batch, s_len, heads, kv_heads, d, scale, causal,
                     stream);
}

// a, b: [64, d] bf16 (b is V in mode 1; a unused there); p: [64, 64] f32
// (mode 1); out: f32 [64, 64] (mode 0) or [64, d] (mode 1); d in {32, 64,
// 128}.
extern "C" int repro_wgmma_probe(const void* a, const void* b, const void* p, void* out,
                                 int d, int mode, cudaStream_t stream) {
  if ((d != 32 && d != 64 && d != 128) || (mode != 0 && mode != 1) || !aligned16(a) ||
      !aligned16(b))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tb;
  int err = encode_bf16_rows(&ta, a, 1, 64, 1, d, 64, d);
  if (err == 0) err = encode_bf16_rows(&tb, b, 1, 64, 1, d, 64, d);
  if (err != 0) return err;
  const float* pf = static_cast<const float*>(p);
  float* of = static_cast<float*>(out);
  if (d == 32) return launch_probe<32>(ta, tb, pf, of, mode, stream);
  if (d == 64) return launch_probe<64>(ta, tb, pf, of, mode, stream);
  return launch_probe<128>(ta, tb, pf, of, mode, stream);
}
