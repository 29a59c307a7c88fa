// ConvLSTM gate nonlinearities + state update, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of
// unet_convlstm_tpu/ops/pallas/convlstm_fused.py (reached through `_fwd_2d`,
// public `fused_gate_update`).
//
// For each row r of N (one pixel of one frame) and channel j of C, with the
// gate row laid out i|f|g|o:
//
//   i, f, o = sigmoid(gates[r, 0C+j], gates[r, 1C+j], gates[r, 3C+j])
//   g       = tanh(gates[r, 2C+j])
//   c'[r,j] = f * c[r,j] + i * g           (f32, stored f32)
//   h'[r,j] = o * tanh(c'[r,j])            (f32, stored in the gates' dtype)
//
// What bounds it on this card: device-memory bytes. Per row it reads 4C gate
// values and C f32 cell values and writes C h values and C f32 cell values
// (8C + 4C + 2C + 4C = 18C bytes with bf16 gates) for about 20 flops and five
// transcendentals per channel, two orders of magnitude below the H100's
// ridge of ~295 flops per byte. So the design only streams: one thread per
// (row, channel), consecutive threads on consecutive channels, so that each
// of the six streams (four gate slices, c, and the two outputs) is read or
// written in whole coalesced segments; nothing is staged in shared memory
// and nothing intermediate reaches device memory. The TPU kernel needed
// C % 128 == 0 for its lanes; this one takes any C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(256)
gate_update_fwd_kernel(const T* __restrict__ gates, const float* __restrict__ c,
                       T* __restrict__ h_out, float* __restrict__ c_out,
                       int64_t total, int C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t r = idx / C;
    const int j = (int)(idx - r * C);
    const T* g = gates + r * 4 * (int64_t)C + j;
    const float i_ = sigmoid(to_f32(g[0]));
    const float f_ = sigmoid(to_f32(g[C]));
    const float g_ = tanhf(to_f32(g[2 * C]));
    const float o_ = sigmoid(to_f32(g[3 * C]));
    // no FMA contraction: the same two roundings as the plain version
    const float cn = __fadd_rn(__fmul_rn(f_, c[idx]), __fmul_rn(i_, g_));
    c_out[idx] = cn;
    h_out[idx] = from_f32<T>(o_ * tanhf(cn));
  }
}

template <typename T>
int launch(const void* gates, const void* c, void* h_out, void* c_out,
           int64_t total, int C, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  // grid-stride beyond 16 resident blocks of each of the 132 SMs
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  gate_update_fwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(gates), static_cast<const float*>(c),
      static_cast<T*>(h_out), static_cast<float*>(c_out), total, C);
  return (int)cudaGetLastError();
}

}  // namespace

// gates [rows, 4C] (bf16 if is_bf16 else f32), c [rows, C] f32 →
// h_out [rows, C] in the gates' dtype, c_out [rows, C] f32. All contiguous.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gate_update_fwd(const void* gates, const void* c, void* h_out,
                               void* c_out, long long rows, int C,
                               int is_bf16, void* stream) {
  const int64_t total = (int64_t)rows * C;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(gates, c, h_out, c_out, total, C, s);
  return launch<float>(gates, c, h_out, c_out, total, C, s);
}
