// Fused W2TTFS head (TTFS filter + unit-scale FC) — replaces the Pallas
// kernel repro/kernels/w2ttfs_pool/w2ttfs_pool.py::w2ttfs_pool_pallas.
//
//   counts[b, ho, wo, c] = sum of spikes[b, ho*win + i, wo*win + j, c]
//   out[b, k]            = (counts[b] . fc_w[:, k]) * (1/win^2) + fc_b[k]
//
// One CTA per image: its window counts go to shared memory in
// (ho, wo, c) row-major order (the fc_w row order), then each warp takes
// classes and reduces its dot product across lanes. The spike map is read
// from device memory once, and counts, scale and FC never leave the SM.
//
// Bound on the H100: 4 bytes read per spike against one add, plus a small
// FC, so device-memory bandwidth binds. On the main path (256 images of
// 4x4x512) the input is 8 MB, and the 256 CTAs are fewer than two waves of
// the 132 SMs: the kernel is short enough that launch latency is a large
// share of it.
#include <cuda_runtime.h>

extern "C" __global__ void w2ttfs_pool_kernel(
    const float* __restrict__ spikes, const float* __restrict__ fc_w,
    const float* __restrict__ fc_b, float* __restrict__ out, int h, int w,
    int c, int window, int classes, float unit) {
  extern __shared__ float counts[];
  const int ho = h / window, wo = w / window;
  const int features = ho * wo * c;
  const float* img = spikes + static_cast<size_t>(blockIdx.x) * h * w * c;
  for (int f = threadIdx.x; f < features; f += blockDim.x) {
    const int ch = f % c, p = f / c, oj = p % wo, oi = p / wo;
    float s = 0.f;
    for (int i = 0; i < window; ++i)
      for (int j = 0; j < window; ++j)
        s = __fadd_rn(s, img[(static_cast<size_t>(oi * window + i) * w + oj * window + j) * c + ch]);
    counts[f] = s;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int k = threadIdx.x / 32; k < classes; k += warps) {
    float d = 0.f;
    for (int f = lane; f < features; f += 32)
      d = fmaf(counts[f], fc_w[static_cast<size_t>(f) * classes + k], d);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_down_sync(0xffffffffu, d, off);
    if (lane == 0)
      out[static_cast<size_t>(blockIdx.x) * classes + k] = __fadd_rn(__fmul_rn(d, unit), fc_b[k]);
  }
}

// spikes [b, h, w, c] f32, fc_w [(h/window)*(w/window)*c, classes] f32,
// fc_b [classes] f32 -> out [b, classes] f32. h and w are multiples of
// window; unit is 1/window^2 formed in double and rounded to f32.
extern "C" int repro_w2ttfs_pool(const float* spikes, const float* fc_w,
                                 const float* fc_b, float* out, int b, int h,
                                 int w, int c, int window, int classes,
                                 float unit, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(h / window) * (w / window) * c;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        w2ttfs_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (b > 0) {
    w2ttfs_pool_kernel<<<b, 256, smem, stream>>>(spikes, fc_w, fc_b, out, h, w,
                                                 c, window, classes, unit);
  }
  return static_cast<int>(cudaGetLastError());
}
