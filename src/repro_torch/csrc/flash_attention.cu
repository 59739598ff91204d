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
// that sees only masked keys stays finite; p = expf(s - m_new); the output
// is acc / max(l, 1e-30), rounded to q's dtype. The causal sweep stops at
// the q tile's last row; a ragged S is masked in the kernel (keys >= S get
// -1e30), which for real rows is the reference's padding.
//
// Arithmetic a row: each score is one fmaf chain over d ascending; a 64-key
// tile's max and sum of p over its keys (a thread's four keys tc + 16 j in
// order, then the 16 lanes by xor shuffles 8, 4, 2, 1); l = l * corr + the
// tile's sum; acc = acc * corr, then one fmaf chain over the tile's keys
// ascending. That is the order of the 64-row tile this kernel replaced, so
// its results are the same bits.
//
// Bound on the H100: operations, 4 * B * H * S^2 * D (halved when causal),
// half of them QK^T and half PV, at the 67 TFLOP/s f32 rate outside the
// tensor cores for an f32 call; against it, q, k, v read and out written
// once at 3.35 TB/s. The function's operands are f32 (the reference widens
// q, k and v and forms f32 dots), so the products run as IEEE f32 FMAs;
// bf16 reaches this route only at a head dim the wgmma route cannot
// address by TMA (flash_attention_wgmma.cu; ops.py::pick_route).
//
// Design: a CTA of 256 threads owns R = 16 * RM query rows (RM = 8, 4 or 2:
// 128, 64 or 32 rows, ops.py::flash_plan, so that a short sequence still
// gives the card about 132 CTAs) of one (b, h), on a 1-D grid with the
// longest causal q tiles first. Thread (tr, tc) = (tid / 16, tid % 16)
// holds rows tr * RM .. tr * RM + RM - 1: their scores at the keys tc + 16 j
// (j < 4) of a 64-key tile, and their accumulator at D / 16 columns.
// - q, scaled, stays in shared memory for the whole sweep, its 16-byte
//   quads swizzled (quad c of row r at c ^ ((r / RM) & 1)), so the two row
//   groups of a warp read distinct banks.
// - K and V tiles of 64 keys move through a ring of two stages, K and V in
//   buffers of their own, by 16-byte cp.async (an f32 operand whose rows
//   are 16-byte aligned; keys >= S and columns >= D zero-filled by the
//   copy's source size), 4-byte cp.async for another f32 operand, plain
//   loads that widen a bf16 one. The next tile is in flight while this
//   one's products run; there is no division per element. K rows are
//   swizzled by key (quad c of key n at c ^ (n & 7)), or padded by one quad
//   where D / 4 is no multiple of 8, so 8 lanes' keys fall on distinct
//   banks.
// - QK^T: per quad of d, RM + 4 16-byte shared loads feed RM x 4 x 4 FMAs
//   (8 rows: 12 loads for 128 FMAs; the warp's two row groups and 16 key
//   groups share them by broadcast).
// - p goes to a [64][R + 4] transposed tile; PV then reads, a key, the
//   thread's RM weights (16-byte loads) and its D / 16 columns of V
//   (16-byte loads at D 64 and 128, columns 4 (tc + 16 i) + e, so a warp's
//   load is contiguous) and issues RM x D / 16 FMAs.
// - Two barriers a tile: the tile has landed (and the last one's PV is
//   done, freeing its stage and the p tile), and p is written.
// Shared memory at D 128, 128 rows: 64 KB q, 2 x 32 KB K, 2 x 32 KB V,
// 33 KB p = 230,400 bytes, one CTA an SM.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 64;           // keys a K/V tile
constexpr float kNeg = -1e30f;

template <int D, int RM>
struct Plan {
  static constexpr int kRows = 16 * RM;           // query rows a CTA
  static constexpr int kQuads = D / 4;
  static constexpr bool kKSwizzle = kQuads % 8 == 0;
  static constexpr int kKLd = kKSwizzle ? D : D + 4;   // floats a K row
  static constexpr int kPLd = kRows + 4;               // floats a p row (a key)
  // accumulator columns a thread: quads tc + 16 i where D % 64 == 0, else
  // D / 16 contiguous columns from tc * D / 16
  static constexpr bool kStrided = D % 64 == 0;
  static constexpr int kCols = D / 16;
  static constexpr int kQ = kRows * D;
  static constexpr int kK = kKeys * kKLd;
  static constexpr int kV = kKeys * D;
  static constexpr int kP = kKeys * kPLd;
  static constexpr int kBytes = 4 * (kQ + 2 * kK + 2 * kV + kP);
  static_assert(D % 16 == 0 && kQuads % 4 == 0, "D a multiple of 16");
  static_assert(kBytes <= 232448, "shared memory past the H100's 227 KB");
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared, zero-filled where !valid (the source
// is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// the shared offset (floats) of quad c of key n in a K tile
template <int D, int RM>
__device__ __forceinline__ int k_at(int n, int c) {
  using P = Plan<D, RM>;
  return n * P::kKLd + 4 * (P::kKSwizzle ? (c ^ (n & 7)) : c);
}

// the q tile, times scale, rows >= s_len and columns >= d as 0
template <typename T, int D, int RM, bool kVec>
__device__ __forceinline__ void stage_q(float* qs, const T* __restrict__ q, size_t q_off,
                                        size_t q_stride, int q0, int s_len, int d,
                                        float scale) {
  using P = Plan<D, RM>;
  for (int idx = threadIdx.x; idx < P::kRows * P::kQuads; idx += kThreads) {
    const int r = idx / P::kQuads, c = idx % P::kQuads;
    const int gr = q0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (gr < s_len) {
      const T* src = q + q_off + static_cast<size_t>(gr) * q_stride + 4 * c;
      if constexpr (kVec) {
        if (4 * c < d) {
          const float4 y = *reinterpret_cast<const float4*>(src);
          x[0] = y.x * scale;
          x[1] = y.y * scale;
          x[2] = y.z * scale;
          x[3] = y.w * scale;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * c + e < d) x[e] = widen(src[e]) * scale;
      }
    }
    *reinterpret_cast<float4*>(qs + r * D + 4 * (c ^ ((r / RM) & 1))) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// keys [k0, k0 + 64) of K and V into one stage: asynchronous for f32,
// plain widening loads for bf16; keys >= s_len and columns >= d as 0
template <typename T, int D, int RM, bool kVec>
__device__ __forceinline__ void load_kv(float* ks, float* vs, const T* __restrict__ k,
                                        const T* __restrict__ v, size_t kv_off,
                                        size_t kv_stride, int k0, int s_len, int d) {
  using P = Plan<D, RM>;
  if constexpr (kVec) {
    static_assert(std::is_same<T, float>::value, "16-byte copies take f32");
#pragma unroll
    for (int it = 0; it < kKeys * P::kQuads / kThreads; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int n = idx / P::kQuads, c = idx % P::kQuads;
      const int gk = k0 + n;
      const bool ok = gk < s_len && 4 * c < d;
      const size_t off = ok ? kv_off + static_cast<size_t>(gk) * kv_stride + 4 * c : kv_off;
      cp_async16(ks + k_at<D, RM>(n, c), k + off, ok);
      cp_async16(vs + n * D + 4 * c, v + off, ok);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kKeys * D / kThreads; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int n = idx / D, col = idx % D;
      const int gk = k0 + n;
      const bool ok = gk < s_len && col < d;
      const size_t off = ok ? kv_off + static_cast<size_t>(gk) * kv_stride + col : kv_off;
      float* kd = ks + k_at<D, RM>(n, col / 4) + col % 4;
      float* vd = vs + n * D + col;
      if constexpr (std::is_same<T, float>::value) {
        cp_async4(kd, k + off, ok);
        cp_async4(vd, v + off, ok);
      } else {
        *kd = ok ? widen(k[off]) : 0.f;
        *vd = ok ? widen(v[off]) : 0.f;
      }
    }
  }
}

// the shared offset (floats, within a V row or an accumulator row) of the
// thread's accumulator column c
template <int D, int RM>
__device__ __forceinline__ int col_at(int tc, int c) {
  using P = Plan<D, RM>;
  return P::kStrided ? 4 * (tc + 16 * (c / 4)) + c % 4 : tc * P::kCols + c;
}

template <typename T, int D, int RM, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s_len,
                       int heads, int kv_heads, int d, float scale, int causal, int n_bh,
                       int n_qt) {
  using P = Plan<D, RM>;
  constexpr int kRows = P::kRows, kCols = P::kCols;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kRows][D], quads swizzled
  float* ks0 = qs + P::kQ;                       // two stages of [64][kKLd]
  float* vs0 = ks0 + 2 * P::kK;                  // two stages of [64][D]
  float* ps = vs0 + 2 * P::kV;                   // [64][kPLd]: p transposed

  const int tc = threadIdx.x % 16, tr = threadIdx.x / 16;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh;   // longest first
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / heads, h = bh - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qt * kRows;
  const size_t q_stride = static_cast<size_t>(heads) * d;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * d;
  const size_t q_off = (static_cast<size_t>(b) * s_len * heads + h) * d;
  const size_t kv_off = (static_cast<size_t>(b) * s_len * kv_heads + kvh) * d;
  const int n_kv = (s_len + kKeys - 1) / kKeys;
  const int n_tiles =
      causal ? min(n_kv, (min(s_len, q0 + kRows) - 1) / kKeys + 1) : n_kv;

  load_kv<T, D, RM, kVec>(ks0, vs0, k, v, kv_off, kv_stride, 0, s_len, d);
  cp_async_commit();
  stage_q<T, D, RM, kVec>(qs, q, q_off, q_stride, q0, s_len, d, scale);

  float m[RM], l[RM], acc[RM][kCols];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const float* qrow = qs + tr * RM * D;
  const int qflip = tr & 1;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    const float* ks = ks0 + (t & 1) * P::kK;
    const float* vs = vs0 + (t & 1) * P::kV;
    cp_async_wait_all();
    __syncthreads();                  // tile t landed; tile t - 1's PV done
    if (t + 1 < n_tiles) {
      load_kv<T, D, RM, kVec>(ks0 + ((t + 1) & 1) * P::kK, vs0 + ((t + 1) & 1) * P::kV, k,
                              v, kv_off, kv_stride, k0 + kKeys, s_len, d);
      cp_async_commit();
    }

    float sc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < P::kQuads; ++c) {
      float4 qv[RM], kv[4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qrow + i * D + 4 * (c ^ qflip));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + k_at<D, RM>(tc + 16 * j, c));
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = sc[i][j];
          s = fmaf(qv[i].x, kv[j].x, s);
          s = fmaf(qv[i].y, kv[j].y, s);
          s = fmaf(qv[i].z, kv[j].z, s);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, s);
        }
    }

    const bool masked = k0 + kKeys > s_len || (causal && k0 + kKeys - 1 > q0);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int q_pos = q0 + tr * RM + i;
      float rmax = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tc + 16 * j;
        // the mask lands before the max and the exp
        if (masked && (k_pos >= s_len || (causal && k_pos > q_pos))) sc[i][j] = kNeg;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(rmax));
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rsum += sc[i][j];
      }
      l[i] = l[i] * corr + half_warp_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = ps + (tc + 16 * j) * P::kPLd + tr * RM;
      if constexpr (RM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RM; i += 4)
          *reinterpret_cast<float4*>(dst + i) =
              make_float4(sc[i][j], sc[i + 1][j], sc[i + 2][j], sc[i + 3][j]);
      } else {
#pragma unroll
        for (int i = 0; i < RM; i += 2)
          *reinterpret_cast<float2*>(dst + i) = make_float2(sc[i][j], sc[i + 1][j]);
      }
    }
    __syncthreads();                  // p written

    const int n_keys = min(kKeys, s_len - k0);
    const float* prow = ps + tr * RM;
#pragma unroll 4
    for (int n = 0; n < n_keys; ++n) {
      float pv[RM], vv[kCols];
      if constexpr (RM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RM; i += 4) {
          const float4 x = *reinterpret_cast<const float4*>(prow + n * P::kPLd + i);
          pv[i] = x.x;
          pv[i + 1] = x.y;
          pv[i + 2] = x.z;
          pv[i + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RM; i += 2) {
          const float2 x = *reinterpret_cast<const float2*>(prow + n * P::kPLd + i);
          pv[i] = x.x;
          pv[i + 1] = x.y;
        }
      }
      const float* vrow = vs + n * D;
      if constexpr (P::kStrided || kCols % 4 == 0) {
#pragma unroll
        for (int c = 0; c < kCols; c += 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + col_at<D, RM>(tc, c));
          vv[c] = x.x;
          vv[c + 1] = x.y;
          vv[c + 2] = x.z;
          vv[c + 3] = x.w;
        }
      } else if constexpr (kCols % 2 == 0) {
#pragma unroll
        for (int c = 0; c < kCols; c += 2) {
          const float2 x = *reinterpret_cast<const float2*>(vrow + col_at<D, RM>(tc, c));
          vv[c] = x.x;
          vv[c + 1] = x.y;
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = vrow[col_at<D, RM>(tc, c)];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + tr * RM + i;
    if (row >= s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = out + q_off + static_cast<size_t>(row) * q_stride;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = col_at<D, RM>(tc, c);
      if (col < d) put(dst + col, acc[i][c] / den);
    }
  }
}

template <typename T, int D, int RM, bool kVec>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int s_len,
           int heads, int kv_heads, int d, float scale, int causal, cudaStream_t stream) {
  using P = Plan<D, RM>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D, RM, kVec>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 P::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int n_qt = (s_len + P::kRows - 1) / P::kRows;
  const int n_bh = batch * heads;
  const long long ctas = static_cast<long long>(n_qt) * n_bh;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_kernel<T, D, RM, kVec><<<static_cast<unsigned>(ctas), kThreads, P::kBytes,
                                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s_len, heads, kv_heads, d, scale, causal, n_bh, n_qt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kVec>
int by_rows(int rows, const void* q, const void* k, const void* v, void* out, int batch,
            int s_len, int heads, int kv_heads, int d, float scale, int causal,
            cudaStream_t stream) {
  switch (rows) {
    case 32:
      return launch<T, D, 2, kVec>(q, k, v, out, batch, s_len, heads, kv_heads, d, scale,
                                   causal, stream);
    case 64:
      return launch<T, D, 4, kVec>(q, k, v, out, batch, s_len, heads, kv_heads, d, scale,
                                   causal, stream);
    case 128:
      return launch<T, D, 8, kVec>(q, k, v, out, batch, s_len, heads, kv_heads, d, scale,
                                   causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q, out: [batch, s_len, heads, d]; k, v: [batch, s_len, kv_heads, d];
// contiguous, one dtype (0: f32, 1: bf16); kv_heads divides heads; d <= 128;
// rows (32, 64 or 128) the query rows a CTA (ops.py::flash_plan). vector
// != 0 (f32, d % 4 == 0, q, k and v 16-byte aligned) takes the instance of
// the smallest of D 32, 64, 96, 112, 128 that holds d, with 16-byte
// copies; otherwise the general instance (D 128, columns >= d zero).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int batch, int s_len, int heads,
                                     int kv_heads, int d, float scale, int causal,
                                     int dtype, int rows, int vector,
                                     cudaStream_t stream) {
  if (d < 1 || d > 128 || kv_heads < 1 || heads % kv_heads != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vector && (dtype != 0 || d % 4 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || s_len == 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 1)
    return by_rows<uint16_t, 128, false>(rows, q, k, v, out, batch, s_len, heads, kv_heads, d,
                                         scale, causal, stream);
  if (!vector)
    return by_rows<float, 128, false>(rows, q, k, v, out, batch, s_len, heads, kv_heads, d,
                                      scale, causal, stream);
  if (d <= 32)
    return by_rows<float, 32, true>(rows, q, k, v, out, batch, s_len, heads, kv_heads, d,
                                    scale, causal, stream);
  if (d <= 64)
    return by_rows<float, 64, true>(rows, q, k, v, out, batch, s_len, heads, kv_heads, d,
                                    scale, causal, stream);
  if (d <= 96)
    return by_rows<float, 96, true>(rows, q, k, v, out, batch, s_len, heads, kv_heads, d,
                                    scale, causal, stream);
  if (d <= 112)
    return by_rows<float, 112, true>(rows, q, k, v, out, batch, s_len, heads, kv_heads, d,
                                     scale, causal, stream);
  return by_rows<float, 128, true>(rows, q, k, v, out, batch, s_len, heads, kv_heads, d,
                                   scale, causal, stream);
}
