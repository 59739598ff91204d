// Fused W2TTFS head (TTFS filter + unit-scale FC) — replaces the Pallas
// kernel repro/kernels/w2ttfs_pool/w2ttfs_pool.py::w2ttfs_pool_pallas.
//
//   counts[b, ho, wo, c] = sum of spikes[b, ho*win + i, wo*win + j, c]
//   out[b, k]            = (counts[b] . fc_w[:, k]) * (1/win^2) + fc_b[k]
//
// The spike map is read in the caller's dtype (int8, bf16 or f32, one
// template instance each), as the TPU kernel casts inside its body: on the
// main path K2's int8 map, one byte a spike.
//
// Bound on the H100: one byte read per spike against one add, plus a small
// FC, so device-memory bandwidth binds; on the main path (256 images of
// 4x4x512, 2 MB) the launch itself is most of the time. The design:
//   - a CTA takes block_b images (the wrapper's ``w2ttfs_plan``: enough
//     CTAs to cover the SMs, at most 8 images as the TPU kernel's block);
//   - window sums: a quad of lanes takes 16 bytes of channels (16 int8,
//     8 bf16 or 4 f32) of one output position, each lane a quarter of the
//     window's positions (a compile-time window of 2 or 4; one lane at a
//     window of 1, and a loop over a window known only at run time),
//     every load issued before the adds, the quarters joined by
//     shuffles. The counts are integers, so any summing order is exact;
//     they go to shared memory in the fc_w row order;
//   - the FC: fc_w is staged through shared memory as it lies, in chunks
//     of rows (one chunk at the main path's 512 x 10 and CIFAR-100's
//     512 x 100) by cp.async, the first chunk while the window sums load,
//     and reused across the CTA's images: a thread takes a class and a
//     slice of the features (256 / classes slices) and keeps one sum per
//     image; the slices' sums are added in order in shared memory. Only
//     this dot order differs from the plain version's (its tolerance is
//     the FC's).
// A channel count that is not a multiple of 16 bytes, or a misaligned map,
// takes an instance with one load per channel.
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlockB = 8;

// element types: int8 spikes, bf16 (its bits), f32
template <int kKind> struct Elem;
template <> struct Elem<0> { using T = int8_t; };
template <> struct Elem<1> { using T = uint16_t; };
template <> struct Elem<2> { using T = float; };

__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// the values of one 16-byte load, added to acc in place
template <int kKind>
__device__ __forceinline__ void add16(float* acc, const int4& v) {
  const unsigned q[4] = {static_cast<unsigned>(v.x), static_cast<unsigned>(v.y),
                         static_cast<unsigned>(v.z), static_cast<unsigned>(v.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kKind == 0) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc[4 * i + b] += static_cast<float>(static_cast<int8_t>(q[i] >> (8 * b)));
    } else if constexpr (kKind == 1) {
      acc[2 * i] += __uint_as_float(q[i] << 16);
      acc[2 * i + 1] += __uint_as_float(q[i] & 0xffff0000u);
    } else {
      acc[i] += __uint_as_float(q[i]);
    }
  }
}

// fc_w rows [f0, f0 + rows) into shared memory as they lie (row-major),
// by cp.async: one committed group, coalesced reads, no registers
__device__ __forceinline__ void stage_rows(float* fcs, const float* fc_w,
                                           int f0, int rows, int classes) {
  const float* chunk = fc_w + static_cast<size_t>(f0) * classes;
  for (int i = threadIdx.x; i < rows * classes; i += kThreads)
    hopper::cp_async4(hopper::smem_u32(fcs + i), chunk + i, true);
  hopper::cp_async_commit();
}

}  // namespace

template <int kKind, int kWin, bool kVector>
__global__ void __launch_bounds__(kThreads) w2ttfs_pool_kernel(
    const typename Elem<kKind>::T* __restrict__ spikes,
    const float* __restrict__ fc_w, const float* __restrict__ fc_b,
    float* __restrict__ out, int b, int h, int w, int c, int window,
    int classes, float unit, int block_b, int rows_chunk) {
  using T = typename Elem<kKind>::T;
  constexpr int kVec = 16 / sizeof(T);         // channels a 16-byte load
  const int win = kWin > 0 ? kWin : window;
  const int ho = h / win, wo = w / win;
  const int features = ho * wo * c;
  const int img0 = blockIdx.x * block_b;
  const int nimg = min(block_b, b - img0);
  // the FC's threads: a pass takes cw classes, each over nsl slices of
  // the features (thread t: class t % cw, slice t / cw)
  const int cw = min(classes, kThreads), nsl = kThreads / cw;
  extern __shared__ float smem[];
  float* counts = smem;                           // [block_b][features]
  float* fcs = counts + block_b * features;       // [rows_chunk][classes]
  float* part = fcs + rows_chunk * classes;       // [nsl][block_b][cw]
  float* sums = part + nsl * block_b * cw;        // [block_b][classes]
  const size_t img_elems = static_cast<size_t>(h) * w * c;
  const T* src = spikes + img0 * img_elems;
  // fc_w's first chunk is in flight while the window sums load
  stage_rows(fcs, fc_w, 0, min(rows_chunk, features), classes);

  // ---- window counts
  if constexpr (kVector) {
    // a compile-time window of 2 or 4 is split over a quad of lanes (each
    // a quarter of its positions), joined by shuffles within the quad
    constexpr int kSplit = kWin >= 2 ? 4 : 1;
    constexpr int kPer = kWin > 0 ? kWin * kWin / kSplit : 1;
    const int groups = c / kVec;
    const int tasks = nimg * ho * wo * groups * kSplit;
    for (int t = threadIdx.x; t < tasks; t += kThreads) {
      const int q = t % kSplit, g = t / kSplit % groups;
      const int p = t / kSplit / groups;
      const int oj = p % wo, oi = (p / wo) % ho, img = p / (wo * ho);
      const T* at = src + img * img_elems +
                    (static_cast<size_t>(oi * win) * w + oj * win) * c + g * kVec;
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
      if constexpr (kWin > 0) {
        int4 v[kPer];                         // every load before the adds
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int pos = q * kPer + i;
          v[i] = __ldg(reinterpret_cast<const int4*>(
              at + (static_cast<size_t>(pos / kWin) * w + pos % kWin) * c));
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i) add16<kKind>(acc, v[i]);
        if constexpr (kSplit > 1) {
          const unsigned quad = 0xfu << (threadIdx.x % 32 & ~3);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            acc[e] += __shfl_xor_sync(quad, acc[e], 1);
            acc[e] += __shfl_xor_sync(quad, acc[e], 2);
          }
        }
      } else {
        for (int i = 0; i < win; ++i)
          for (int j = 0; j < win; ++j)
            add16<kKind>(acc, __ldg(reinterpret_cast<const int4*>(
                                  at + (static_cast<size_t>(i) * w + j) * c)));
      }
      // each lane of the quad writes its quarter of the channels (acc
      // indexed by constants only, so it stays in registers)
      float* dst = counts + img * features + (oi * wo + oj) * c + g * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (e / (kVec / kSplit) == q) dst[e] = acc[e];
    }
  } else {
    const int tasks = nimg * features;
    for (int t = threadIdx.x; t < tasks; t += kThreads) {
      const int ch = t % c, p = t / c;
      const int oj = p % wo, oi = (p / wo) % ho, img = p / (wo * ho);
      const T* at = src + img * img_elems +
                    (static_cast<size_t>(oi * win) * w + oj * win) * c + ch;
      float s = 0.f;
      for (int i = 0; i < win; ++i)
        for (int j = 0; j < win; ++j)
          s += to_f32(at[(static_cast<size_t>(i) * w + j) * c]);
      counts[t] = s;
    }
  }

  // ---- FC: per chunk of fc_w rows and pass of classes, each thread
  // keeps one sum per image over its slice (rows sl, sl + nsl, ...: a
  // warp reads consecutive fc_w words and broadcasts the counts), and the
  // slices' sums are added in order into the running sums
  for (int f0 = 0; f0 < features; f0 += rows_chunk) {
    const int rows = min(rows_chunk, features - f0);
    if (f0 > 0) {
      __syncthreads();        // the last chunk consumed
      stage_rows(fcs, fc_w, f0, rows, classes);
    }
    hopper::cp_async_wait<0>();
    __syncthreads();          // counts and this chunk in shared memory
    for (int c0 = 0; c0 < classes; c0 += cw) {
      const int kc = c0 + threadIdx.x % cw, sl = threadIdx.x / cw;
      if (sl < nsl && kc < classes) {
        float d[kMaxBlockB];
#pragma unroll
        for (int i = 0; i < kMaxBlockB; ++i) d[i] = 0.f;
#pragma unroll 4
        for (int f = sl; f < rows; f += nsl) {
          const float wv = fcs[f * classes + kc];
#pragma unroll
          for (int i = 0; i < kMaxBlockB; ++i)
            if (i < nimg) d[i] = fmaf(counts[i * features + f0 + f], wv, d[i]);
        }
#pragma unroll
        for (int i = 0; i < kMaxBlockB; ++i)
          if (i < nimg) part[(sl * block_b + i) * cw + kc - c0] = d[i];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < nimg * cw; i += kThreads) {
        const int img = i / cw, kc = c0 + i % cw;
        if (kc >= classes) continue;
        float t = f0 == 0 ? 0.f : sums[img * classes + kc];
#pragma unroll 8
        for (int j = 0; j < nsl; ++j) t += part[(j * block_b + img) * cw + i % cw];
        sums[img * classes + kc] = t;
      }
      __syncthreads();        // part is free for the next pass
    }
  }
  for (int i = threadIdx.x; i < nimg * classes; i += kThreads) {
    const int kc = i % classes;
    out[static_cast<size_t>(img0) * classes + i] =
        __fadd_rn(__fmul_rn(sums[i], unit), fc_b[kc]);
  }
}

namespace {

struct HeadArgs {
  const void* spikes;
  const float* fc_w;
  const float* fc_b;
  float* out;
  int b, h, w, c, window, classes;
  float unit;
  int block_b, rows_chunk;
  size_t smem;
  cudaStream_t stream;
};

template <int kKind, int kWin, bool kVector>
int launch_head(const HeadArgs& a) {
  const auto kernel = w2ttfs_pool_kernel<kKind, kWin, kVector>;
  if (a.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (a.b + a.block_b - 1) / a.block_b;
  w2ttfs_pool_kernel<kKind, kWin, kVector><<<grid, kThreads, a.smem, a.stream>>>(
      static_cast<const typename Elem<kKind>::T*>(a.spikes), a.fc_w, a.fc_b,
      a.out, a.b, a.h, a.w, a.c, a.window, a.classes, a.unit, a.block_b,
      a.rows_chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int kKind, bool kVector>
int launch_window(const HeadArgs& a) {
  switch (a.window) {
    case 1: return launch_head<kKind, 1, kVector>(a);
    case 2: return launch_head<kKind, 2, kVector>(a);
    case 4: return launch_head<kKind, 4, kVector>(a);
    default: return launch_head<kKind, 0, kVector>(a);
  }
}

template <int kKind>
int launch_kind(const HeadArgs& a, bool vector) {
  return vector ? launch_window<kKind, true>(a) : launch_window<kKind, false>(a);
}

}  // namespace

// spikes [b, h, w, c] of dtype kind (0 int8, 1 bf16, 2 f32), fc_w
// [(h/window)*(w/window)*c, classes] f32, fc_b [classes] f32 -> out
// [b, classes] f32. h and w are multiples of window; unit is 1/window^2
// formed in double and rounded to f32; block_b images a CTA (at most 8);
// rows_chunk fc_w rows a shared-memory chunk; vector != 0 takes 16-byte
// loads (c * element size % 16 == 0 and spikes 16-byte aligned).
extern "C" int repro_w2ttfs_pool(const void* spikes, const float* fc_w,
                                 const float* fc_b, float* out, int kind,
                                 int b, int h, int w, int c, int window,
                                 int classes, float unit, int block_b,
                                 int rows_chunk, int vector,
                                 cudaStream_t stream) {
  if (b <= 0) return static_cast<int>(cudaGetLastError());
  if (block_b < 1 || block_b > kMaxBlockB || rows_chunk < 1 || kind < 0 ||
      kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t features = static_cast<size_t>(h / window) * (w / window) * c;
  const size_t cw = classes < kThreads ? classes : kThreads;
  const size_t smem = sizeof(float) *
      (block_b * features + static_cast<size_t>(rows_chunk) * classes +
       (kThreads / cw) * block_b * cw + static_cast<size_t>(block_b) * classes);
  const HeadArgs a{spikes, fc_w,   fc_b,    out,        b,    h,     w,
                   c,      window, classes, unit,       block_b, rows_chunk,
                   smem,   stream};
  switch (kind) {
    case 0: return launch_kind<0>(a, vector != 0);
    case 1: return launch_kind<1>(a, vector != 0);
    default: return launch_kind<2>(a, vector != 0);
  }
}
