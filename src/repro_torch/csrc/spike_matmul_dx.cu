// Backward data-gradient of a spiking linear layer — replaces the Pallas
// kernel repro/kernels/spike_matmul/backward.py::spike_matmul_dx_pallas:
//   dv = g * surr'(v - v_th)   (dv = g when no membrane current is given)
//   dx = dv @ w^T              (f32, accumulated over N)
// g, v are [M, N] f32, w is [K, N] f32, dx is [M, K] f32 and dv [M, N] f32,
// all row-major and unpadded: every load and store checks its bounds, so
// no padded copy of g, v or w is made.
//
// One CTA owns one 128 x 128 tile of dx and walks N in 32-deep steps. Each
// step loads the [128 m x 32 n] tiles of g (and v), forms dv in registers
// with the launch's surrogate (a template argument) and stores it
// transposed in shared memory; the [128 k x 32 n] tile of w is stored the
// same way; then the register-tiled f32 FMA loop of event_gemm.cuh (8 x 8
// outputs a thread) runs over the 32 n of the step. Only the CTAs of the
// first k block write dv, so each dv element is written once. The
// surrogate formulas keep the reference's operation order with explicitly
// rounded intrinsics (nvcc would otherwise contract a*b+c into an FMA).
//
// Bound on the H100: the product is dense in g, 2*M*N*K operations at the
// 67 TFLOP/s f32 rate outside the tensor cores (parity rules out TF32),
// against 4*(2*M*N + K*N + M*K + M*N) bytes; at the training path's
// shapes the operations bind. The design keeps 64 accumulators a thread
// and feeds each loaded value to 8 FMAs; its shared tiles have a 4-float
// row pad so the transposed stores conflict 4-way, not 32-way. TMA,
// wgmma and a multi-stage pipeline are later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "event_gemm.cuh"

using namespace repro;

namespace {

// the surrogate argument of repro_spike_matmul_dx
enum Surrogate { kNone = 0, kAtan = 1, kSigmoid = 2, kTriangle = 3, kRect = 4 };

// the constants the reference forms in double and rounds to f32 once
struct SurrogateArgs {
  float alpha;      // alpha
  float atan_c;     // pi / 2 * alpha
  float alpha_sq;   // alpha * alpha
  float rect_half;  // 0.5 / alpha
  float v_th;
};

template <int S>
__device__ __forceinline__ float surrogate_grad(float v, const SurrogateArgs& a) {
  if constexpr (S == kAtan) {
    // alpha / (2 * (1 + (pi/2 * alpha * v)^2))
    const float x = __fmul_rn(a.atan_c, v);
    return __fdiv_rn(a.alpha, __fmul_rn(2.f, __fadd_rn(1.f, __fmul_rn(x, x))));
  } else if constexpr (S == kSigmoid) {
    // s = sigmoid(alpha * v); alpha * s * (1 - s)
    const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(a.alpha, v))));
    return __fmul_rn(__fmul_rn(a.alpha, s), __fsub_rn(1.f, s));
  } else if constexpr (S == kTriangle) {
    // max(0, alpha - alpha*alpha*|v|) / alpha * alpha
    const float t = fmaxf(0.f, __fsub_rn(a.alpha, __fmul_rn(a.alpha_sq, fabsf(v))));
    return __fmul_rn(__fdiv_rn(t, a.alpha), a.alpha);
  } else {
    // rect: |v| < 0.5 / alpha ? alpha : 0
    return fabsf(v) < a.rect_half ? a.alpha : 0.f;
  }
}

constexpr int kPad = 4;  // keeps 16-byte rows for the float4 reads

template <int S>
__global__ void __launch_bounds__(kThreads)
spike_matmul_dx_kernel(const float* __restrict__ g, const float* __restrict__ v,
                       const float* __restrict__ w, float* __restrict__ dx,
                       float* __restrict__ dv, int m, int n, int k,
                       SurrogateArgs sa) {
  __shared__ __align__(16) float a[kStep][kTile + kPad];  // dv tile: a[n][m]
  __shared__ __align__(16) float b[kStep][kTile + kPad];  // w tile:  b[n][k]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const bool write_dv = S != kNone && blockIdx.x == 0;

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < n; n0 += kStep) {
#pragma unroll 4
    for (int i = 0; i < kTile * kStep / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kStep, c = idx % kStep;  // a warp reads one row
      const int gn = n0 + c;
      const int gm = row0 + r, gk = col0 + r;
      float d = 0.f;
      if (gm < m && gn < n) {
        const size_t off = static_cast<size_t>(gm) * n + gn;
        d = g[off];
        if constexpr (S != kNone) {
          d = __fmul_rn(d, surrogate_grad<S>(__fsub_rn(v[off], sa.v_th), sa));
          if (write_dv) dv[off] = d;
        }
      }
      a[c][r] = d;
      b[c][r] = (gk < k && gn < n) ? w[static_cast<size_t>(gk) * n + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a[kk][ty * kSub]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a[kk][ty * kSub + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b[kk][tx * kSub]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b[kk][tx * kSub + 4]);
      const float av[kSub] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kSub] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int row = row0 + ty * kSub + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int col = col0 + tx * kSub + j;
      if (col < k) dx[static_cast<size_t>(row) * k + col] = acc[i][j];
    }
  }
}

template <int S>
void launch(const float* g, const float* v, const float* w, float* dx, float* dv,
            int m, int n, int k, const SurrogateArgs& sa, cudaStream_t stream) {
  const dim3 grid((k + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  spike_matmul_dx_kernel<S><<<grid, kThreads, 0, stream>>>(g, v, w, dx, dv, m, n, k, sa);
}

}  // namespace

// g [m, n] f32, w [k, n] f32 -> dx [m, k] f32. With surrogate != 0, v [m, n]
// f32 is the membrane current and dv [m, n] f32 is written as well; with
// surrogate == 0, v and dv are not read or written (dv = g).
extern "C" int repro_spike_matmul_dx(const float* g, const float* v, const float* w,
                                     float* dx, float* dv, int m, int n, int k,
                                     int surrogate, float alpha, float atan_c,
                                     float alpha_sq, float rect_half, float v_th,
                                     cudaStream_t stream) {
  if (m > 0 && k > 0) {
    const SurrogateArgs sa{alpha, atan_c, alpha_sq, rect_half, v_th};
    switch (surrogate) {
      case kNone: launch<kNone>(g, v, w, dx, dv, m, n, k, sa, stream); break;
      case kAtan: launch<kAtan>(g, v, w, dx, dv, m, n, k, sa, stream); break;
      case kSigmoid: launch<kSigmoid>(g, v, w, dx, dv, m, n, k, sa, stream); break;
      case kTriangle: launch<kTriangle>(g, v, w, dx, dv, m, n, k, sa, stream); break;
      case kRect: launch<kRect>(g, v, w, dx, dv, m, n, k, sa, stream); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
