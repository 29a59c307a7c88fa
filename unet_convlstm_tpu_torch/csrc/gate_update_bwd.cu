// ConvLSTM gate nonlinearities + state update, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` of
// unet_convlstm_tpu/ops/pallas/convlstm_fused.py (reached through `_bwd_2d`,
// the custom VJP of `fused_gate_update`).
//
// The forward saved only (gates, c); the activations are recomputed here in
// f32. For each row r of N and channel j of C, with the gate row i|f|g|o:
//
//   i, f, o = sigmoid(gates[r, 0C+j], gates[r, 1C+j], gates[r, 3C+j])
//   g       = tanh(gates[r, 2C+j])
//   c'      = f * c + i * g ;  tc = tanh(c')
//   dc'     = dc_out + dh * o * (1 - tc^2)
//   dgates  = [dc' g i (1-i) | dc' c f (1-f) | dc' i (1-g^2) | dh tc o (1-o)]
//   dc      = dc' * f
//
// dgates is stored in the gates' dtype, dc in f32; dh arrives in the gates'
// dtype. dc_out may be absent (the last step's cell is not used): it is then
// zero and not read.
//
// What bounds it on this card: device-memory bytes. Per element it reads
// 4 gate values, c, dh and dc_out and writes 4 dgates and dc (8 + 4 + 2 + 4 +
// 8 + 4 = 30 bytes with bf16 gates) for about 40 flops and five
// transcendentals, two orders of magnitude below the H100's ridge of ~295
// flops per byte. So, as the forward, it only streams: one thread per
// (row, channel), consecutive threads on consecutive channels, so that each
// of the nine streams is read or written in whole coalesced segments; every
// intermediate stays in registers. Any C.

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
gate_update_bwd_kernel(const T* __restrict__ gates, const float* __restrict__ c,
                       const T* __restrict__ dh,
                       const float* __restrict__ dc_out,
                       T* __restrict__ dgates, float* __restrict__ dc,
                       int64_t total, int C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t r = idx / C;
    const int j = (int)(idx - r * C);
    const int64_t g_off = r * 4 * (int64_t)C + j;
    const T* g = gates + g_off;
    const float i_ = sigmoid(to_f32(g[0]));
    const float f_ = sigmoid(to_f32(g[C]));
    const float g_ = tanhf(to_f32(g[2 * C]));
    const float o_ = sigmoid(to_f32(g[3 * C]));
    const float cv = c[idx];
    // the forward's two roundings, no FMA contraction
    const float cn = __fadd_rn(__fmul_rn(f_, cv), __fmul_rn(i_, g_));
    const float tc = tanhf(cn);
    const float dhv = to_f32(dh[idx]);
    float dcn = dhv * o_ * (1.0f - tc * tc);
    if (dc_out != nullptr) dcn = dc_out[idx] + dcn;
    T* dg = dgates + g_off;
    dg[0] = from_f32<T>(dcn * g_ * i_ * (1.0f - i_));
    dg[C] = from_f32<T>(dcn * cv * f_ * (1.0f - f_));
    dg[2 * C] = from_f32<T>(dcn * i_ * (1.0f - g_ * g_));
    dg[3 * C] = from_f32<T>(dhv * tc * o_ * (1.0f - o_));
    dc[idx] = dcn * f_;
  }
}

template <typename T>
int launch(const void* gates, const void* c, const void* dh,
           const void* dc_out, void* dgates, void* dc, int64_t total, int C,
           cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  // grid-stride beyond 16 resident blocks of each of the 132 SMs
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  gate_update_bwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(gates), static_cast<const float*>(c),
      static_cast<const T*>(dh), static_cast<const float*>(dc_out),
      static_cast<T*>(dgates), static_cast<float*>(dc), total, C);
  return (int)cudaGetLastError();
}

}  // namespace

// gates [rows, 4C] and dh [rows, C] (bf16 if is_bf16 else f32), c [rows, C]
// f32, dc_out [rows, C] f32 or null (zero) → dgates [rows, 4C] in the gates'
// dtype, dc [rows, C] f32. All contiguous. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int gate_update_bwd(const void* gates, const void* c,
                               const void* dh, const void* dc_out,
                               void* dgates, void* dc, long long rows, int C,
                               int is_bf16, void* stream) {
  const int64_t total = (int64_t)rows * C;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(gates, c, dh, dc_out, dgates, dc, total, C,
                                 s);
  return launch<float>(gates, c, dh, dc_out, dgates, dc, total, C, s);
}
