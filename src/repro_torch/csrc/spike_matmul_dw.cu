// Backward weight-gradient of a spiking linear layer — replaces two Pallas
// kernels of repro/kernels/spike_matmul/backward.py, spike_matmul_dw_pallas
// (skip="dense") and spike_matmul_dw_gated_pallas (skip="gated" and
// "two_level", with gating.py::accum_tile_t), for int8 x and for bit-packed
// x (packed_in: int32 words of 32 spikes): dw[K, N] = x^T @ g over M. The dense skip leaves out every 128 x 128 (m, k) block of x whose
// forward vld_cnt is zero; the gated walk visits, for each k block, only
// the compacted list mmap[kb, 0 .. nact_t[kb]) of its non-silent m blocks
// (core/events.py::compact_kmap of the transposed vld map); the two-level
// walk also leaves out, inside a visited block, the 32 output rows of dw
// that a silent 32-column stripe of x (a clear occ bit) never feeds. A
// silent block's spikes are all zero, so every skip is exact. x is [M, K]
// int8 spikes, g is [M, N] f32, both row-major and unpadded (loads check
// their bounds); vld and occ are x's [ceil(M/128), ceil(K/128)] maps. A
// packed x is the words [Mp, Kp/32] of the map packed on the 128 x 128
// grid (Mp, Kp: M, K rounded up to 128); a tile row's 128 columns are
// four words, and each thread stores its element's bit as 0.f/1.f in the
// same f32 shared tile the int8 load fills with the same values, so the
// FMAs, their order and dw are the int8 launch's bits.
//
// The TPU grid reduces over M inside one output tile. On the card that
// gives far too few CTAs (at resblock 1, K x N = 576 x 64 is 5 tiles of
// 128 x 128 for M = 262144 rows), so M is cut into S contiguous runs of
// 128-row blocks: CTA (n block, k block, s) sums its run into a f32
// partial [S, Kp, Np], and a second kernel of this source adds the S
// partials of each output in the order s = 0 .. S-1. S depends only on the
// shape (the wrapper picks it), and no float atomics are used, so dw is
// the same bits on every run. The gated walk keeps the runs: mmap is
// ascending, so a CTA visits the non-silent blocks of its run in the order
// the dense skip does, and a run with none writes a zero partial, as the
// dense skip does: the partials and dw are the same bits under every skip.
// The two-level skip leaves out FMAs whose x is 0, exact zeros wherever g
// is finite; a stripe is 32 rows of the CTA's tile, the rows of two warps,
// so the skip is warp-uniform.
//
// Bound on the H100: the data needs 2 * nnz(x) * N operations over the
// blocks it keeps, against reading x and g once and writing dw; at the
// training path's spike rates the f32 operations bind at 67 TFLOP/s
// outside the tensor cores. Each kept block costs the dense 2*128*128*128
// product, in the register-tiled FMA loop of event_gemm.cuh (8 x 8 outputs
// a thread, 32-deep steps through shared memory); the partials add
// 4 * S * Kp * Np bytes written and read once. A packed x is read as an
// eighth of the int8 bytes (each 4-byte word loaded once a warp).
#include <cstdint>
#include <cuda_runtime.h>

#include "event_gemm.cuh"

using namespace repro;

namespace {

// one m block of the CTA's run: acc += x[mb, kb tile]^T @ g[mb, nb tile],
// leaving out the output rows of the stripes whose bit of `bits` is clear.
// x is int8 [m, k] or, Packed, int32 words [Mp, kw]
template <bool Packed>
__device__ __forceinline__ void dw_block(
    const void* __restrict__ x, const float* __restrict__ g, int m, int k, int n,
    int kw, int mb, int col_k, int col_n, unsigned bits, float (&a)[kStep][kTile],
    float (&b)[kStep][kTile], float (&acc)[kSub][kSub]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // thread rows ty*8 .. ty*8+7 of the k tile lie in stripe ty / 4
  const bool rows_on = (bits >> (ty / 4)) & 1u;
  for (int ms = 0; ms < kTile; ms += kStep) {
    const int m0 = mb * kTile + ms;
#pragma unroll 4
    for (int i = 0; i < kTile * kStep / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kTile, c = idx % kTile;  // a warp reads one row
      const int row = m0 + r;
      const bool row_ok = row < m;
      float xv = 0.f;
      if (row_ok && col_k + c < k) {
        if constexpr (Packed) {  // a warp's 32 columns lie in one word
          const unsigned word = static_cast<unsigned>(static_cast<const int*>(x)[
              static_cast<size_t>(row) * kw + (col_k + c) / 32]);
          xv = ((word >> ((col_k + c) % 32)) & 1u) ? 1.f : 0.f;
        } else {
          xv = static_cast<float>(
              static_cast<const int8_t*>(x)[static_cast<size_t>(row) * k + col_k + c]);
        }
      }
      a[r][c] = xv;
      b[r][c] = (row_ok && col_n + c < n) ? g[static_cast<size_t>(row) * n + col_n + c]
                                          : 0.f;
    }
    __syncthreads();
    if (rows_on) {
#pragma unroll
      for (int mm = 0; mm < kStep; ++mm) {
        const float4 a0 = *reinterpret_cast<const float4*>(&a[mm][ty * kSub]);
        const float4 a1 = *reinterpret_cast<const float4*>(&a[mm][ty * kSub + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&b[mm][tx * kSub]);
        const float4 b1 = *reinterpret_cast<const float4*>(&b[mm][tx * kSub + 4]);
        const float av[kSub] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[kSub] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kSub; ++i)
#pragma unroll
          for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

template <int Skip, bool Packed>
__global__ void __launch_bounds__(kThreads)
spike_matmul_dw_kernel(const void* __restrict__ x, const float* __restrict__ g,
                       const int* __restrict__ vld, const int* __restrict__ nact_t,
                       const int* __restrict__ mmap, const int* __restrict__ occ,
                       float* __restrict__ partial, int m, int k, int n,
                       int blocks_per_split) {
  __shared__ __align__(16) float a[kStep][kTile];  // x tile: a[m][k]
  __shared__ __align__(16) float b[kStep][kTile];  // g tile: b[m][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nb = blockIdx.x, kb = blockIdx.y, s = blockIdx.z;
  const int gk = (k + kTile - 1) / kTile, gm = (m + kTile - 1) / kTile;
  const int kp = gk * kTile, np = gridDim.x * kTile, kw = kp / 32;
  const int col_k = kb * kTile, col_n = nb * kTile;
  const int mb_begin = s * blocks_per_split;
  const int mb_end = min(gm, mb_begin + blocks_per_split);

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;

  if constexpr (Skip == kDense) {
    for (int mb = mb_begin; mb < mb_end; ++mb) {
      if (vld[mb * gk + kb] == 0) continue;  // event skip (uniform)
      dw_block<Packed>(x, g, m, k, n, kw, mb, col_k, col_n, 0xffffffffu, a, b, acc);
    }
  } else {
    // the non-silent m blocks of k block kb, ascending: those of this run
    const int* list = mmap + static_cast<size_t>(kb) * gm;
    for (int t = 0; t < nact_t[kb]; ++t) {
      const int mb = list[t];
      if (mb < mb_begin) continue;
      if (mb >= mb_end) break;
      unsigned bits = 0xffffffffu;
      if constexpr (Skip == kTwoLevel) bits = static_cast<unsigned>(occ[mb * gk + kb]);
      dw_block<Packed>(x, g, m, k, n, kw, mb, col_k, col_n, bits, a, b, acc);
    }
  }

  float* out = partial + static_cast<size_t>(s) * kp * np;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    float* op = out + static_cast<size_t>(col_k + ty * kSub + i) * np + col_n + tx * kSub;
    *reinterpret_cast<float4*>(op) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(op + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
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

template <bool Packed>
void launch_dw(const void* x, const float* g, const int* vld, const int* nact_t,
               const int* mmap, const int* occ, float* partial, int m, int k, int n,
               int blocks_per_split, int skip, dim3 grid, cudaStream_t stream) {
  if (skip == kDense)
    spike_matmul_dw_kernel<kDense, Packed><<<grid, kThreads, 0, stream>>>(
        x, g, vld, nact_t, mmap, occ, partial, m, k, n, blocks_per_split);
  else if (skip == kGated)
    spike_matmul_dw_kernel<kGated, Packed><<<grid, kThreads, 0, stream>>>(
        x, g, vld, nact_t, mmap, occ, partial, m, k, n, blocks_per_split);
  else
    spike_matmul_dw_kernel<kTwoLevel, Packed><<<grid, kThreads, 0, stream>>>(
        x, g, vld, nact_t, mmap, occ, partial, m, k, n, blocks_per_split);
}

}  // namespace

// x [m, k] int8 or, packed != 0, [mp, kp/32] int32 words (mp: m rounded
// up to 128), g [m, n] f32, partial [splits, kp, np] f32 scratch (kp, np:
// k, n rounded up to 128) -> dw [k, n] f32. CTA s covers the 128-row
// blocks [s * blocks_per_split, (s + 1) * blocks_per_split). The route
// (skip, see event_gemm.cuh): kDense reads vld [gm, gk] (gm, gk: m, k
// over 128, rounded up); kGated nact_t [gk] and mmap [gk, gm], the
// compacted transposed vld map; kTwoLevel also occ [gm, gk].
extern "C" int repro_spike_matmul_dw(const void* x, const float* g, const int* vld,
                                     const int* nact_t, const int* mmap, const int* occ,
                                     float* partial, float* dw, int m, int k, int n,
                                     int splits, int blocks_per_split, int skip,
                                     int packed, cudaStream_t stream) {
  if (skip < kDense || skip > kTwoLevel) return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0 && n > 0) {
    const int kp = (k + kTile - 1) / kTile * kTile, np = (n + kTile - 1) / kTile * kTile;
    const dim3 grid(np / kTile, kp / kTile, splits);
    if (packed)
      launch_dw<true>(x, g, vld, nact_t, mmap, occ, partial, m, k, n, blocks_per_split,
                      skip, grid, stream);
    else
      launch_dw<false>(x, g, vld, nact_t, mmap, occ, partial, m, k, n, blocks_per_split,
                       skip, grid, stream);
    const size_t total = static_cast<size_t>(k) * n;
    dw_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
        partial, dw, k, n, kp, np, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
