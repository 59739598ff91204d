// Backward data-gradient of a spiking linear layer — replaces the Pallas
// kernel repro/kernels/spike_matmul/backward.py::spike_matmul_dx_pallas:
//   dv = g * surr'(v - v_th)   (dv = g when no membrane current is given)
//   dx = dv @ w^T              (f32, accumulated over N)
// g, v are [M, N] f32, w is [K, N] f32, dx is [M, K] f32 and dv [M, N] f32,
// all row-major and unpadded: every load and store checks its bounds, so
// no padded copy of g, v or w is made.
//
// Bound on the H100: operations. The product is dense in g, 2*M*N*K
// operations at the 67 TFLOP/s f32 rate outside the tensor cores (parity
// with the reference rules out TF32 and bf16 products), against
// 4*(2*M*N + K*N + M*K + M*N) bytes; at the training path's shapes the
// FMAs bind (at the data-sheet rates of an H100 SXM at 700 W, res1's 604
// MB of dx take 0.18 ms to write against 0.29 ms of FMAs; measured times
// are in PERF.md). What holds a SIMT product below that rate is the
// instruction slots and shared-memory reads around the FMAs: an SM runs
// 128 f32 FMAs a clock (twice an A100's) from the same 128 bytes a clock
// of shared memory, so every operand read from shared memory, every load,
// every surrogate and every sync takes FMA slots. The design:
//
// - Tiles. A tile of dx is 128 rows by 64, 128 or 192 columns (the
//   wrapper's planner, backward.py::dx_plan, picks the width per shape:
//   K = 576 .. 4608 are cut in 192-wide tiles with no padded column).
//   Four warps along m and one or two along k; a thread owns 8 x 8
//   outputs, or 8 x 12 at 192 (two 4-row and two or three 4-column
//   quarters, 16 and 32 apart), so a k step reads 5 float4s of shared
//   memory for 96 FMAs, and a warp's reads touch 64 and 128 contiguous
//   bytes.
// - Pipeline. N is walked in 16-deep steps through two shared buffers.
//   While the FMAs of step s run, the raw g (and v) and w of step s + 1
//   are in flight into registers: one float4 load a chunk (a warp reads
//   16 rows by 32 bytes), from offsets set once a tile, with the bounds
//   checks only at a ragged edge. After the FMAs the surrogate is formed
//   from those registers and dv stored transposed, dvT[n][m], and w as
//   wT[n][k] (conflict-free: a row pad of 4 floats and 16 rows by 2 quads
//   a warp), one sync a step; the FMA loop reads float4s.
// - dv once a row block. For N <= 256 (res1-res3 and their shortcuts) dvT
//   holds all of a row block's N (up to 135 KB), so a CTA forms dv once
//   for all the k tiles of the block that it runs and then streams w
//   alone; the surrogate, v and g are not read again. For N = 512 (res4,
//   the QKFormer passes) dvT is the two-step ring, formed anew a tile.
// - Persistent grid. min(tiles, the CTAs the card holds at once) CTAs,
//   each a contiguous run of tiles, k fastest (so one CTA runs the k tiles
//   of a row block in turn). A CTA loads the next tile's first step before
//   it stores the current tile, so the stores and the next tile's load
//   latency overlap the FMAs.
// - Stores. dx leaves as float4s (a warp writes 4 rows by 128 bytes);
//   scalar only where K % 4 != 0. dv, also float4s where N % 4 == 0, is
//   written by the CTA that runs k tile 0 of a row block: once.
//
// Every output is one ascending f32 FMA chain over n. The surrogate
// formulas keep the reference's operation order with explicitly rounded
// intrinsics (nvcc would otherwise contract a*b+c into an FMA); the kNone
// variant (no v: the shortcut matmuls) reads g as dv and writes no dv.
#include <cstdint>
#include <cuda_runtime.h>

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

constexpr int kBN = 16;    // n depth of a pipeline step
constexpr int kPad = 4;    // row pad of the transposed tiles (16-byte rows)

// 4 warps along m and WK along k, each 32 x 32 QC outputs, a thread
// 8 x 4 QC (two 4-row and QC 4-column quarters, 16 and 32 apart)
template <int WK, int QC>
struct Cfg {
  static constexpr int kBM = 128;                     // dx rows a tile
  static constexpr int kBK = 32 * QC * WK;            // dx columns a tile
  static constexpr int kThreads = 128 * WK;           // 4 x WK warps
  static constexpr int kGChunks = kBM * kBN / 4;      // float4s of a g step
  static constexpr int kWChunks = kBK * kBN / 4;      // float4s of a w step
  static constexpr int kGPer = kGChunks / kThreads;
  static constexpr int kWPer = kWChunks / kThreads;
  static constexpr int kDvt = kBN * (kBM + kPad);     // floats of a dvT buffer
  static constexpr int kWt = kBN * (kBK + kPad);      // floats of a wT buffer
  static_assert(kGChunks % kThreads == 0 && kWChunks % kThreads == 0,
                "chunks split evenly");
};

// chunk c of a [rows x kBN] step: the float4 of row `row`, columns
// 4 quad .. 4 quad + 3. A warp's 32 chunks are 16 rows by 2 quads: 32
// bytes of each row in global memory, and 32 distinct banks when stored
// transposed with a row pitch of 4 mod 32 floats.
template <int Rows>
__device__ __forceinline__ void chunk_pos(int c, int& row, int& quad) {
  const int lane = c % 32, blk = c / 32;
  row = (blk % (Rows / 16)) * 16 + lane % 16;
  quad = 2 * (blk / (Rows / 16)) + lane / 16;
}

struct Shape {
  int m, n, k, ktiles;
  bool vec_n, vec_k;
};

// a thread's chunks in the current tile: element offsets at n = 0 of its
// g (v, dv) and w chunks, and which of them lie inside M / K (bit i)
template <class C>
struct Chunks {
  int a[C::kGPer];
  int w[C::kWPer];
  unsigned a_in, w_in;
};

template <class C>
__device__ __forceinline__ void tile_chunks(Chunks<C>& ch, const Shape& sh, int m0, int k0) {
  ch.a_in = ch.w_in = 0u;
#pragma unroll
  for (int i = 0; i < C::kGPer; ++i) {
    int row, quad;
    chunk_pos<C::kBM>(threadIdx.x + i * C::kThreads, row, quad);
    ch.a[i] = (m0 + row) * sh.n + 4 * quad;
    if (m0 + row < sh.m) ch.a_in |= 1u << i;
  }
#pragma unroll
  for (int i = 0; i < C::kWPer; ++i) {
    int row, quad;
    chunk_pos<C::kBK>(threadIdx.x + i * C::kThreads, row, quad);
    ch.w[i] = (k0 + row) * sh.n + 4 * quad;
    if (k0 + row < sh.k) ch.w_in |= 1u << i;
  }
}

// four floats at p (columns col .. col + 3 of `cols`), zero outside or when
// !in; a float4 load when vec
__device__ __forceinline__ float4 load4(const float* __restrict__ p, bool in, int col,
                                        int cols, bool vec) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!in) return r;
  if (vec) {
    if (col < cols) r = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (col < cols) r.x = __ldg(p);
    if (col + 1 < cols) r.y = __ldg(p + 1);
    if (col + 2 < cols) r.z = __ldg(p + 2);
    if (col + 3 < cols) r.w = __ldg(p + 3);
  }
  return r;
}

// the raw operands of one step, in registers
template <int S, class C>
struct Stage {
  float4 g[C::kGPer];
  float4 v[S == kNone ? 1 : C::kGPer];
  float4 w[C::kWPer];
};

// step n0's chunks into registers (g and v only with_a): plain float4
// loads inside the operands (!edge), checked ones at the ragged edges
template <int S, class C>
__device__ __forceinline__ void load_step(Stage<S, C>& st, const float* __restrict__ g,
                                          const float* __restrict__ v,
                                          const float* __restrict__ w, const Chunks<C>& ch,
                                          const Shape& sh, int n0, bool edge, bool with_a) {
  if (!edge) {
    if (with_a) {
#pragma unroll
      for (int i = 0; i < C::kGPer; ++i) {
        st.g[i] = __ldg(reinterpret_cast<const float4*>(g + ch.a[i] + n0));
        if constexpr (S != kNone)
          st.v[i] = __ldg(reinterpret_cast<const float4*>(v + ch.a[i] + n0));
      }
    }
#pragma unroll
    for (int i = 0; i < C::kWPer; ++i)
      st.w[i] = __ldg(reinterpret_cast<const float4*>(w + ch.w[i] + n0));
    return;
  }
#pragma unroll
  for (int i = 0; i < C::kGPer; ++i) {
    if (!with_a) break;
    int row, quad;
    chunk_pos<C::kBM>(threadIdx.x + i * C::kThreads, row, quad);
    const bool in = (ch.a_in >> i) & 1u;
    st.g[i] = load4(g + ch.a[i] + n0, in, n0 + 4 * quad, sh.n, sh.vec_n);
    if constexpr (S != kNone)
      st.v[i] = load4(v + ch.a[i] + n0, in, n0 + 4 * quad, sh.n, sh.vec_n);
  }
#pragma unroll
  for (int i = 0; i < C::kWPer; ++i) {
    int row, quad;
    chunk_pos<C::kBK>(threadIdx.x + i * C::kThreads, row, quad);
    st.w[i] = load4(w + ch.w[i] + n0, (ch.w_in >> i) & 1u, n0 + 4 * quad, sh.n, sh.vec_n);
  }
}

template <int S>
__device__ __forceinline__ float dv_of(float g, float v, const SurrogateArgs& sa) {
  return __fmul_rn(g, surrogate_grad<S>(__fsub_rn(v, sa.v_th), sa));
}

// dv from the staged g (and v) into dvT[n][m] (with_a), w into wT[n][k];
// the CTA of k tile 0 also writes dv
template <int S, class C>
__device__ __forceinline__ void store_step(const Stage<S, C>& st, float* __restrict__ dvt,
                                           float* __restrict__ wt, float* __restrict__ dv,
                                           const Chunks<C>& ch, const Shape& sh, int n0,
                                           bool with_a, bool write_dv,
                                           const SurrogateArgs& sa) {
#pragma unroll
  for (int i = 0; i < C::kGPer; ++i) {
    if (!with_a) break;
    int row, quad;
    chunk_pos<C::kBM>(threadIdx.x + i * C::kThreads, row, quad);
    float4 d = st.g[i];
    if constexpr (S != kNone) {
      d = make_float4(dv_of<S>(d.x, st.v[i].x, sa), dv_of<S>(d.y, st.v[i].y, sa),
                      dv_of<S>(d.z, st.v[i].z, sa), dv_of<S>(d.w, st.v[i].w, sa));
      const int col = n0 + 4 * quad;
      if (write_dv && ((ch.a_in >> i) & 1u) && col < sh.n) {
        float* q = dv + ch.a[i] + n0;
        if (sh.vec_n) {
          *reinterpret_cast<float4*>(q) = d;
        } else {
          q[0] = d.x;
          if (col + 1 < sh.n) q[1] = d.y;
          if (col + 2 < sh.n) q[2] = d.z;
          if (col + 3 < sh.n) q[3] = d.w;
        }
      }
    }
    float* t = dvt + 4 * quad * (C::kBM + kPad) + row;
    t[0] = d.x;
    t[C::kBM + kPad] = d.y;
    t[2 * (C::kBM + kPad)] = d.z;
    t[3 * (C::kBM + kPad)] = d.w;
  }
#pragma unroll
  for (int i = 0; i < C::kWPer; ++i) {
    int row, quad;
    chunk_pos<C::kBK>(threadIdx.x + i * C::kThreads, row, quad);
    float* t = wt + 4 * quad * (C::kBK + kPad) + row;
    t[0] = st.w[i].x;
    t[C::kBK + kPad] = st.w[i].y;
    t[2 * (C::kBK + kPad)] = st.w[i].z;
    t[3 * (C::kBK + kPad)] = st.w[i].w;
  }
}

// Resident: dvT holds all of a row block's N (the tile's rows by up to
// kResidentN), formed by the first tile of the block a CTA runs and read
// by its later k tiles, which stream w alone; else dvT is a ring of two
// 16-deep steps, formed anew for every tile.
constexpr int kResidentN = 256;

template <int S, int WK, int QC, bool Resident>
__global__ void __launch_bounds__(Cfg<WK, QC>::kThreads, 1)
spike_matmul_dx_kernel(const float* __restrict__ g, const float* __restrict__ v,
                       const float* __restrict__ w, float* __restrict__ dx,
                       float* __restrict__ dv, Shape sh, int tiles, SurrogateArgs sa) {
  using C = Cfg<WK, QC>;
  constexpr int kCols = 4 * QC, kRows = 8;      // a thread's dx columns and rows
  const int steps = (sh.n + kBN - 1) / kBN;
  extern __shared__ float4 smem4[];
  float* const dvt = reinterpret_cast<float*>(smem4);        // Resident ? steps : 2 slices
  float* const wt = dvt + (Resident ? steps : 2) * C::kDvt;  // 2 slices

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wk = warp / 4;       // the warp's 32 x 32 QC outputs
  const int lm = lane / 8, lk = lane % 8;       // the thread's 4-row, 4-column quarters
  const int a_off = wm * 32 + lm * 4, b_off = wk * 32 * QC + lk * 4;

  // the CTA's tiles: a contiguous run, k fastest, so that runs of k tiles
  // of one row block follow each other
  const int G = static_cast<int>(gridDim.x), c = static_cast<int>(blockIdx.x);
  int t = static_cast<int>(static_cast<long long>(tiles) * c / G);
  const int t_end = static_cast<int>(static_cast<long long>(tiles) * (c + 1) / G);
  if (t >= t_end) return;
  // a step is an edge where the tile crosses M or K or the step crosses N
  const auto edge = [&](int m0, int k0, int n0) {
    return !sh.vec_n || m0 + C::kBM > sh.m || k0 + C::kBK > sh.k || n0 + kBN > sh.n;
  };
  const auto dvt_at = [&](int s, int buf) { return dvt + (Resident ? s : buf) * C::kDvt; };
  Stage<S, C> st;
  Chunks<C> ch, ch_next;
  int buf = 0;
  bool form = true;   // this tile forms its row block's dvT
  {
    const int m0 = (t / sh.ktiles) * C::kBM, k0 = (t % sh.ktiles) * C::kBK;
    tile_chunks<C>(ch, sh, m0, k0);
    load_step<S, C>(st, g, v, w, ch, sh, 0, edge(m0, k0, 0), true);
    store_step<S, C>(st, dvt_at(0, 0), wt, dv, ch, sh, 0, true, t % sh.ktiles == 0, sa);
  }
  __syncthreads();

  float acc[kRows][kCols];
  while (true) {
    const int m0 = (t / sh.ktiles) * C::kBM, k0 = (t % sh.ktiles) * C::kBK;
    const bool write_dv = t % sh.ktiles == 0;
    const int t_next = t + 1;
    const int m0_next = (t_next / sh.ktiles) * C::kBM, k0_next = (t_next % sh.ktiles) * C::kBK;
    const bool form_next = !Resident || m0_next != m0;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

    for (int s = 0; s < steps; ++s) {
      const bool more = s + 1 < steps;
      if (more) {
        load_step<S, C>(st, g, v, w, ch, sh, (s + 1) * kBN, edge(m0, k0, (s + 1) * kBN),
                        form);
      } else if (t_next < t_end) {   // the next tile's first step, early
        tile_chunks<C>(ch_next, sh, m0_next, k0_next);
        load_step<S, C>(st, g, v, w, ch_next, sh, 0, edge(m0_next, k0_next, 0), form_next);
      }
      const float* a = dvt_at(s, buf) + a_off;
      const float* b = wt + buf * C::kWt + b_off;
#pragma unroll
      for (int kk = 0; kk < kBN; ++kk) {
        float av[kRows], bv[kCols];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 aq = *reinterpret_cast<const float4*>(a + kk * (C::kBM + kPad) + 16 * q);
          av[4 * q] = aq.x;
          av[4 * q + 1] = aq.y;
          av[4 * q + 2] = aq.z;
          av[4 * q + 3] = aq.w;
        }
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          const float4 bq =
              *reinterpret_cast<const float4*>(b + kk * (C::kBK + kPad) + 32 * q);
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
      buf ^= 1;
      if (more) {
        store_step<S, C>(st, dvt_at(s + 1, buf), wt + buf * C::kWt, dv, ch, sh, (s + 1) * kBN,
                         form, write_dv, sa);
        __syncthreads();
      }
    }

    // the tile's dx: rows a_off + 16 p + {0..3}, columns b_off + 32 q + {0..3}
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = m0 + a_off + (i / 4) * 16 + i % 4;
      if (row >= sh.m) continue;
      float* out = dx + static_cast<size_t>(row) * sh.k;
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        const int col = k0 + b_off + 32 * q;
        if (sh.vec_k) {
          if (col < sh.k)
            *reinterpret_cast<float4*>(out + col) = make_float4(
                acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < sh.k) out[col + j] = acc[i][4 * q + j];
        }
      }
    }

    t = t_next;
    if (t >= t_end) break;
    ch = ch_next;
    form = form_next;
    // a resident dvT is read by every step of a tile: the new block's first
    // slice waits for all of them
    if (Resident && form) __syncthreads();
    store_step<S, C>(st, dvt_at(0, buf), wt + buf * C::kWt, dv, ch, sh, 0, form,
                     t % sh.ktiles == 0, sa);
    __syncthreads();
  }
}

template <int S, int WK, int QC, bool Resident>
int launch(const float* g, const float* v, const float* w, float* dx, float* dv,
           const Shape& sh, const SurrogateArgs& sa, cudaStream_t stream) {
  using C = Cfg<WK, QC>;
  constexpr int kMaxSmem =
      ((Resident ? kResidentN / kBN : 2) * C::kDvt + 2 * C::kWt) * 4;
  static int resident = 0;   // CTAs of this instance one SM holds at once
  static int sms = 0;
  if (resident == 0) {
    int dev = 0;
    cudaError_t err = cudaFuncSetAttribute(spike_matmul_dx_kernel<S, WK, QC, Resident>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kMaxSmem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, spike_matmul_dx_kernel<S, WK, QC, Resident>, C::kThreads, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int steps = (sh.n + kBN - 1) / kBN;
  const int smem = ((Resident ? steps : 2) * C::kDvt + 2 * C::kWt) * 4;
  const int tiles = (sh.m + C::kBM - 1) / C::kBM * sh.ktiles;
  const int grid = tiles < sms * resident ? tiles : sms * resident;
  spike_matmul_dx_kernel<S, WK, QC, Resident><<<grid, C::kThreads, smem, stream>>>(
      g, v, w, dx, dv, sh, tiles, sa);
  return static_cast<int>(cudaGetLastError());
}

template <int S, int WK, int QC>
int launch_n(const float* g, const float* v, const float* w, float* dx, float* dv,
             const Shape& sh, const SurrogateArgs& sa, cudaStream_t stream) {
  if (sh.n <= kResidentN) return launch<S, WK, QC, true>(g, v, w, dx, dv, sh, sa, stream);
  return launch<S, WK, QC, false>(g, v, w, dx, dv, sh, sa, stream);
}

// the tile shapes by width: 64 and 128 as 1 and 2 warps along k of 8 x 8
// threads, 192 as 2 warps of 8 x 12 threads
template <int S>
int launch_bk(const float* g, const float* v, const float* w, float* dx, float* dv,
              const Shape& sh, int block_k, const SurrogateArgs& sa, cudaStream_t stream) {
  if (block_k == 64) return launch_n<S, 1, 2>(g, v, w, dx, dv, sh, sa, stream);
  if (block_k == 128) return launch_n<S, 2, 2>(g, v, w, dx, dv, sh, sa, stream);
  return launch_n<S, 2, 3>(g, v, w, dx, dv, sh, sa, stream);
}

}  // namespace

// g [m, n] f32, w [k, n] f32 -> dx [m, k] f32. With surrogate != 0, v [m, n]
// f32 is the membrane current and dv [m, n] f32 is written as well; with
// surrogate == 0, v and dv are not read or written (dv = g). block_k is the
// dx tile's width, 64, 128 or 192 (backward.py::dx_plan). Loads and stores
// are float4s where the rows and pointers allow (N or K % 4 == 0, 16-byte
// aligned), else scalar.
extern "C" int repro_spike_matmul_dx(const float* g, const float* v, const float* w,
                                     float* dx, float* dv, int m, int n, int k,
                                     int surrogate, int block_k, float alpha,
                                     float atan_c, float alpha_sq, float rect_half,
                                     float v_th, cudaStream_t stream) {
  if (block_k != 64 && block_k != 128 && block_k != 192)
    return static_cast<int>(cudaErrorInvalidValue);
  // a thread's chunk offsets are 32-bit: (m + 128) n and (k + 192) n fit
  if ((static_cast<long long>(m) + 128) * n >= (1ll << 31) ||
      (static_cast<long long>(k) + 192) * n >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_n =
      n % 4 == 0 && a16(g) && a16(w) && (surrogate == kNone || (a16(v) && a16(dv)));
  const Shape sh{m, n, k, (k + block_k - 1) / block_k, vec_n, k % 4 == 0 && a16(dx)};
  const SurrogateArgs sa{alpha, atan_c, alpha_sq, rect_half, v_th};
  switch (surrogate) {
    case kNone: return launch_bk<kNone>(g, v, w, dx, dv, sh, block_k, sa, stream);
    case kAtan: return launch_bk<kAtan>(g, v, w, dx, dv, sh, block_k, sa, stream);
    case kSigmoid: return launch_bk<kSigmoid>(g, v, w, dx, dv, sh, block_k, sa, stream);
    case kTriangle: return launch_bk<kTriangle>(g, v, w, dx, dv, sh, block_k, sa, stream);
    case kRect: return launch_bk<kRect>(g, v, w, dx, dv, sh, block_k, sa, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
