// Fused LIF membrane update — replaces the Pallas kernel
// repro/kernels/lif_update/lif_update.py::lif_update_pallas.
//
//   v      = tau * v_prev * (1 - s_prev) + I
//   spike  = v >= v_th                          (int8)
//   v_next = v * (1 - spike)   or   v - v_th * spike (soft reset)
//
// Bound on the H100: elementwise, 12 bytes read and 5 written per element
// against ~6 operations, so device-memory bandwidth (3.35 TB/s) binds.
// The design is one grid-stride pass that reads each input once and writes
// each output once, with consecutive threads on consecutive elements so
// every warp access is coalesced. Each operation is rounded on its own
// (__fmul_rn/__fadd_rn: no FMA contraction), as the plain PyTorch version
// rounds it, so v_next matches it bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

extern "C" __global__ void lif_update_kernel(
    const float* __restrict__ cur, const float* __restrict__ v_prev,
    const float* __restrict__ s_prev, int8_t* __restrict__ spikes,
    float* __restrict__ v_next, long long n, float tau, float v_th,
    int soft_reset) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float decay = __fmul_rn(__fmul_rn(tau, v_prev[i]), __fsub_rn(1.f, s_prev[i]));
    const float v = __fadd_rn(decay, cur[i]);
    const bool s = v >= v_th;
    const float sf = s ? 1.f : 0.f;
    spikes[i] = static_cast<int8_t>(s);
    v_next[i] = soft_reset ? __fsub_rn(v, __fmul_rn(v_th, sf)) : __fmul_rn(v, __fsub_rn(1.f, sf));
  }
}

// All tensors hold n elements: cur, v_prev, s_prev f32 in; spikes int8 and
// v_next f32 out.
extern "C" int repro_lif_update(const float* cur, const float* v_prev,
                                const float* s_prev, int8_t* spikes,
                                float* v_next, long long n, float tau,
                                float v_th, int soft_reset,
                                cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;  // 32 resident blocks per SM
    lif_update_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        cur, v_prev, s_prev, spikes, v_next, n, tau, v_th, soft_reset);
  }
  return static_cast<int>(cudaGetLastError());
}
