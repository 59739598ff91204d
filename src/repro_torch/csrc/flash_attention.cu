// Streaming (flash) softmax attention, forward, the scalar route —
// replaces the Pallas kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (body _kernel), batched by flash_attention in ops.py there.
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G]) v[b, j, h / G]
//
// over keys j <= i when causal, with G = H / Hkv query heads per KV head.
// q and out are [B, S, H, D], k and v [B, S, Hkv, D], all f32 or all bf16,
// read in that layout (no transpose, no repeat of K and V: each query head
// indexes its KV head as h / G). Every operand is widened to f32 (a bf16 by
// a 16-bit shift, exactly); q is multiplied by the scale first; scores, the
// running max m, the running sum l and the accumulator are IEEE f32
// (scalar FMAs, no TF32); masked scores are -1e30, never -inf, so a row
// that sees only masked keys stays finite; the output is acc / max(l,
// 1e-30), rounded to q's dtype. The causal sweep stops at the q tile's
// diagonal; a ragged S is masked in the kernel (keys >= S get -1e30), which
// for real rows is the reference's padding.
//
// Design: one CTA of 256 threads per (b * H + h, 64-row q tile). The q tile
// (scaled, f32) stays in shared memory; each 64-row K tile is staged, the
// 64 x 64 scores are formed, each thread holding a 4 x 4 block (rows
// ty + 16 i, columns tx + 16 j) in registers; the row max and sum go
// through 16-lane shuffles; p is written to a shared tile; then the V tile
// replaces the K tile in the same buffer and each thread accumulates its
// 4 rows x (D / 16) columns. Shared rows are padded to D + 1 floats, so
// the column reads of K and q hit distinct banks. 2 x 64 x 129 + 64 x 65
// floats = 82,688 bytes of dynamic shared memory at D = 128: two CTAs an
// SM.
//
// Bound on the H100: operations, 4 * B * H * S^2 * D (halved when causal),
// half of them QK^T and half PV. An f32 call at the 67 TFLOP/s f32 rate
// outside the tensor cores. A bf16 call is priced as the tensor cores can
// compute the same function (the wgmma route, flash_attention_wgmma.cu):
// the reference scales q in f32 before the product, so its QK^T operands
// are not both bf16, but the unscaled product of the bf16 q and k is exact
// in f32 and the scale can follow it (one f32 rounding moves); the weights
// p are f32, not bf16, and keep exact only as three bf16 terms: QK^T once
// and PV three times at the 989 TFLOP/s bf16 tensor-core rate. Against
// that, reading q, k, v (K and V at Hkv heads) and writing out once at
// 3.35 TB/s. This kernel issues every product as a scalar f32 FMA from
// shared memory; it is the route for f32, and for bf16 at a head dim the
// wgmma route has no instance for (other than 32, 64 and 128).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 16;     // accumulator columns a thread
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// rows [row0, row0 + 64) of one head of a [B, S, heads, D] tensor into a
// [64][ld] f32 tile, times mul; rows >= s_len as 0.
template <typename T>
__device__ __forceinline__ void stage(float* tile, const T* __restrict__ base,
                                      size_t row_stride, int row0, int s_len,
                                      int d, int ld, float mul) {
  for (int i = threadIdx.x; i < kTile * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int gr = row0 + r;
    tile[r * ld + c] =
        gr < s_len ? widen(base[static_cast<size_t>(gr) * row_stride + c]) * mul : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s_len,
                       int heads, int kv_heads, int d, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                   // [64][ld] q * scale
  float* kvs = qs + kTile * ld;       // [64][ld] the K tile, then the V tile
  float* ps = kvs + kTile * ld;       // [64][65] probabilities
  constexpr int pld = kTile + 1;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = blockIdx.x * kTile;
  const size_t q_stride = static_cast<size_t>(heads) * d;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * d;
  const size_t q_off = (static_cast<size_t>(b) * s_len * heads + h) * d;
  const size_t kv_off = (static_cast<size_t>(b) * s_len * kv_heads + kvh) * d;

  stage(qs, q + q_off, q_stride, q0, s_len, d, ld, scale);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (s_len + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_kv, static_cast<int>(blockIdx.x) + 1) : n_kv;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();                  // the last tile's V and p are consumed
    stage(kvs, k + kv_off, kv_stride, k0, s_len, d, ld, 1.f);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kvs[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float rmax = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        // the mask lands before the max and the exp
        if (k_pos >= s_len || (causal && k_pos > q_pos)) sc[i][j] = kNeg;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(rmax));
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty + 16 * i) * pld + tx + 16 * j] = p;
        rsum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }

    __syncthreads();                  // K consumed, p written
    stage(kvs, v + kv_off, kv_stride, k0, s_len, d, ld, 1.f);
    __syncthreads();
    const int rows = min(kTile, s_len - k0);
    for (int r = 0; r < rows; ++r) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * pld + r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < d ? kvs[r * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = out + q_off + static_cast<size_t>(row) * q_stride;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) put(dst + col, acc[i][c] / denom);
    }
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) * (2 * kTile * (d + 1) + kTile * (kTile + 1));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int s_len, int heads, int kv_heads, int d, float scale, int causal,
           cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxD)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((s_len + kTile - 1) / kTile, batch * heads);
  flash_attention_kernel<T><<<grid, kThreads, smem_bytes(d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s_len, heads, kv_heads, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: [batch, s_len, heads, d]; k, v: [batch, s_len, kv_heads, d];
// contiguous, one dtype (0: f32, 1: bf16); kv_heads divides heads; d <= 128.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int batch, int s_len, int heads,
                                     int kv_heads, int d, float scale, int causal,
                                     int dtype, cudaStream_t stream) {
  if (d < 1 || d > kMaxD || kv_heads < 1 || heads % kv_heads != 0 ||
      batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || s_len == 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 0)
    return launch<float>(q, k, v, out, batch, s_len, heads, kv_heads, d, scale,
                         causal, stream);
  if (dtype == 1)
    return launch<uint16_t>(q, k, v, out, batch, s_len, heads, kv_heads, d, scale,
                            causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
