// Fused PE layer, dense stateless variant — replaces the Pallas kernel
// repro/kernels/fused_pe/fused_pe.py::fused_pe_pallas (skip="dense", int8 x,
// bias, f32 residual, whole-row dense Q mask, emit_vld; T=1, no state).
//
// Per 128x128 output tile, in one pass: the event-gated f32 product
// x @ w (event_gemm.cuh), then in registers
//   cur   = (acc + bias) + residual          (the reference's order)
//   spike = cur >= v_th                      (T=1: v = cur, no state)
//   spike &= rowsum(q[row]) >= qk_threshold  (QKFormer write-back mask)
//   spike &= row < m_valid && col < n_valid  (padding never fires)
// and the tile's spike count is written as the next layer's vld_cnt. The
// f32 pre-activation never reaches device memory.
//
// Bound on the H100: the kernel runs the dense f32 product over every
// 128x128 block the vld map does not skip, 2*128*128*Np operations per
// block against int8 x and f32 w, so the 67 TFLOP/s f32 rate outside the
// tensor cores bounds it (parity with the reference rules out TF32). The
// data needs less: one add per spike and output column, a quarter to a
// half of that at the main path's spike rates, and a layer with N < 128
// (resblock 1, N = 64) computes a half-empty tile. The design keeps 64
// accumulators per thread in registers and stages x and w through 32 KB
// of shared memory so each loaded value feeds 8 FMAs; the skip removes
// both the loads and the FMAs of a silent block. wgmma, TMA, a multi-stage
// pipeline and a narrower tile for N = 64 are later work.
#include <cstdint>
#include <cuda_runtime.h>

#include "event_gemm.cuh"

using namespace repro;

extern "C" __global__ void __launch_bounds__(kThreads)
fused_pe_kernel(const int8_t* __restrict__ x, const float* __restrict__ w,
                const int* __restrict__ vld, const float* __restrict__ bias,
                const float* __restrict__ residual, const int8_t* __restrict__ q,
                int dq, int8_t* __restrict__ spikes, int* __restrict__ vld_next,
                int kp, int np, int m_valid, int n_valid, float v_th,
                float qk_threshold) {
  __shared__ GemmSmem sm;
  __shared__ float row_gate[kTile];
  __shared__ int warp_count[kThreads / 32];
  const int row_blk = blockIdx.y, col0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
  event_gemm_tile(x, w, vld, kp, np, row_blk, col0, sm, acc);

  if (q != nullptr) {  // one warp per row: integer row sum of Q spikes
    for (int r = warp; r < kTile; r += kThreads / 32) {
      const int8_t* qr = q + static_cast<size_t>(row_blk * kTile + r) * dq;
      int s = 0;
      for (int c = lane * 16; c < dq; c += 32 * 16) {
        const int4 v = *reinterpret_cast<const int4*>(qr + c);
        const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int i = 0; i < 16; ++i) s += e[i];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) row_gate[r] = static_cast<float>(s) >= qk_threshold ? 1.f : 0.f;
    }
    __syncthreads();
  }

  const int c0 = col0 + tx * kSub;
  float b[kSub];
#pragma unroll
  for (int j = 0; j < kSub; ++j) b[j] = 0.f;
  if (bias != nullptr) {
    const float4 b0 = *reinterpret_cast<const float4*>(bias + c0);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + c0 + 4);
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
  }
  int count = 0;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int rl = ty * kSub + i;
    const int row = row_blk * kTile + rl;
    float r[kSub] = {};
    if (residual != nullptr) {
      const float* rp = residual + static_cast<size_t>(row) * np + c0;
      const float4 r0 = *reinterpret_cast<const float4*>(rp);
      const float4 r1 = *reinterpret_cast<const float4*>(rp + 4);
      r[0] = r0.x; r[1] = r0.y; r[2] = r0.z; r[3] = r0.w;
      r[4] = r1.x; r[5] = r1.y; r[6] = r1.z; r[7] = r1.w;
    }
    const bool row_on = row < m_valid && (q == nullptr || row_gate[rl] != 0.f);
    uint64_t packed = 0;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      float cur = acc[i][j];
      if (bias != nullptr) cur = __fadd_rn(cur, b[j]);
      if (residual != nullptr) cur = __fadd_rn(cur, r[j]);
      const bool s = row_on && (c0 + j) < n_valid && cur >= v_th;
      count += s;
      packed |= static_cast<uint64_t>(s) << (8 * j);
    }
    *reinterpret_cast<uint64_t*>(spikes + static_cast<size_t>(row) * np + c0) = packed;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) total += warp_count[i];
    vld_next[row_blk * (np / kTile) + blockIdx.x] = total;
  }
}

// x [mp, kp] int8, w [kp, np] f32, vld [mp/128, kp/128] int32; bias [np] f32,
// residual [mp, np] f32 and q [mp, dq] int8 (dq a multiple of 128) may be
// null. Writes spikes [mp, np] int8 and vld_next [mp/128, np/128] int32.
extern "C" int repro_fused_pe(const int8_t* x, const float* w, const int* vld,
                              const float* bias, const float* residual,
                              const int8_t* q, int dq, int8_t* spikes,
                              int* vld_next, int mp, int kp, int np,
                              int m_valid, int n_valid, float v_th,
                              float qk_threshold, cudaStream_t stream) {
  if (mp > 0 && np > 0) {
    const dim3 grid(np / kTile, mp / kTile);
    fused_pe_kernel<<<grid, kThreads, 0, stream>>>(
        x, w, vld, bias, residual, q, dq, spikes, vld_next, kp, np, m_valid,
        n_valid, v_th, qk_threshold);
  }
  return static_cast<int>(cudaGetLastError());
}
