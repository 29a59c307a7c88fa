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
// What bounds it on this card. Per element it moves 18 bytes with bf16
// gates (8 of gates, 4 of c, 2 of h, 4 of c'): 3.35 TB/s then asks for about
// 186 G elements a second, which the SMs' issue rate turns into roughly 160
// thread-instructions per element. The first design (one thread per
// element, a 64-bit division per element, precise expf and a precise divide
// per sigmoid, seven scalar memory instructions) spent more than that and
// reached 44% of the bytes bound a training step and 38% a serving request
// on an H100 (PERF.md section 6). So this design cuts instructions:
//   * vector route: one thread takes a vector of 8 consecutive channels of
//     one row (4 with f32 gates) and loads it as one 16-byte vector from each
//     of the four gate slices and 16-byte vectors of c, all before any
//     arithmetic, then stores one 16-byte h vector and 16-byte c' vectors:
//     9 memory instructions per 8 elements, where the first design issued
//     56;
//   * the row comes from one 32-bit division per vector by the launch's
//     vectors per row (c's offset is the vector's own, since C is a multiple
//     of the vector); no per-element index arithmetic;
//   * the sigmoids take __expf and a fast reciprocal; the two tanh stay
//     tanhf. c' keeps its two roundings (no FMA contraction), as the plain
//     version's;
//   * at most 64 registers a thread, so four blocks of 256 share an SM; the
//     grid is at most one such wave and strides over the rest. One vector a
//     thread: two or four (more bytes in flight a thread, fewer warps) were
//     slower at every level on an H100;
//   * the launch plan (route, vector, blocks) comes from Python
//     (`convlstm_fused.gate_update_plan`), from the shape, dtype and
//     alignment alone.
// What bounds the new design, as measured on an H100 at 700 W (PERF.md
// section 6): the large launches are bound by bytes (the 37.7 MB one at 80%
// of the bound), the small ones by the launch's fixed cost, one trip to
// device memory and the grid's ramp (the 4.7 MB one at 29%: 4.9
// microseconds, where an empty launch takes 1.7-1.9).
// The scalar route (C not a multiple of the vector, a base address not
// 16-byte aligned, or more vectors than 32-bit indexing takes) is the first
// design's loop, one thread per element, with the same math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // both routes; `convlstm_fused.THREADS`

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

// __expf and a fast reciprocal: a few ulp of f32 (1/inf = 0, so +-inf
// give 1 and 0, as the plain version's; NaN stays NaN)
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

// one element: gates i, f, g, o and the cell c -> (h, c')
__device__ __forceinline__ void cell(float gi, float gf, float gg, float go,
                                     float c, float& h, float& cn) {
  const float i_ = sigmoid(gi);
  const float f_ = sigmoid(gf);
  const float g_ = tanhf(gg);
  const float o_ = sigmoid(go);
  // no FMA contraction: the same two roundings as the plain version
  cn = __fadd_rn(__fmul_rn(f_, c), __fmul_rn(i_, g_));
  h = o_ * tanhf(cn);
}

// A vector of N channels of one gate slice (or of h) as one 16-byte word.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 -> f32 is exact: the 16 bits are the f32's high half
  __device__ static void unpack(const uint4& w, float (&f)[N]) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& w, float (&f)[N]) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// The vector route: one thread per vector. Vector v (of nvec = rows * C /
// N) covers channels [(v % groups) * N, +N) of row r = v / groups; c, h and
// c' are [rows, C], so its offset there is v * N, and in the gates'
// [rows, 4C] it is v * N + r * 3C (+ q * C for gate slice q). All six loads
// are issued before any arithmetic.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
gate_update_vec_kernel(const T* __restrict__ gates,
                       const float* __restrict__ c, T* __restrict__ h_out,
                       float* __restrict__ c_out, uint32_t nvec,
                       uint32_t groups, uint32_t C) {
  constexpr int N = Vec<T>::N;
  constexpr int NC = N / 4;          // float4 words of c per vector
  for (uint32_t v = blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += gridDim.x * blockDim.x) {
    const uint32_t r = v / groups;
    const T* gp = gates + (size_t)v * N + (size_t)r * (3 * (size_t)C);
    uint4 g[4];
    float4 cv[NC];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      g[q] = __ldg(reinterpret_cast<const uint4*>(gp + (size_t)q * C));
    const float4* cp = reinterpret_cast<const float4*>(c + (size_t)v * N);
#pragma unroll
    for (int m = 0; m < NC; ++m) cv[m] = __ldg(cp + m);
    float gi[N], gf[N], gg[N], go[N], h[N], cn[N];
    Vec<T>::unpack(g[0], gi);
    Vec<T>::unpack(g[1], gf);
    Vec<T>::unpack(g[2], gg);
    Vec<T>::unpack(g[3], go);
    const float* cf = reinterpret_cast<const float*>(cv);
#pragma unroll
    for (int e = 0; e < N; ++e)
      cell(gi[e], gf[e], gg[e], go[e], cf[e], h[e], cn[e]);
    *reinterpret_cast<uint4*>(h_out + (size_t)v * N) = Vec<T>::pack(h);
    float4* co = reinterpret_cast<float4*>(c_out + (size_t)v * N);
#pragma unroll
    for (int m = 0; m < NC; ++m)
      co[m] = make_float4(cn[4 * m], cn[4 * m + 1], cn[4 * m + 2],
                          cn[4 * m + 3]);
  }
}

// The scalar route: one thread per element, any C and alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_update_scalar_kernel(const T* __restrict__ gates,
                          const float* __restrict__ c, T* __restrict__ h_out,
                          float* __restrict__ c_out, int64_t total, int C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t r = idx / C;
    const int j = (int)(idx - r * C);
    const T* g = gates + r * 4 * (int64_t)C + j;
    float h, cn;
    cell(to_f32(g[0]), to_f32(g[C]), to_f32(g[2 * C]), to_f32(g[3 * C]),
         c[idx], h, cn);
    c_out[idx] = cn;
    h_out[idx] = from_f32<T>(h);
  }
}

template <typename T>
int launch(const void* gates, const void* c, void* h_out, void* c_out,
           long long rows, int C, int route, int blocks, cudaStream_t s) {
  const T* g = static_cast<const T*>(gates);
  const float* cc = static_cast<const float*>(c);
  T* h = static_cast<T*>(h_out);
  float* co = static_cast<float*>(c_out);
  if (route == 1) {
    gate_update_scalar_kernel<T><<<blocks, kThreads, 0, s>>>(
        g, cc, h, co, (int64_t)rows * C, C);
  } else {
    const uint32_t groups = (uint32_t)(C / Vec<T>::N);
    gate_update_vec_kernel<T><<<blocks, kThreads, 0, s>>>(
        g, cc, h, co, (uint32_t)(rows * groups), groups, (uint32_t)C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// gates [rows, 4C] (bf16 if is_bf16 else f32), c [rows, C] f32 ->
// h_out [rows, C] in the gates' dtype, c_out [rows, C] f32, all contiguous,
// with the plan of `convlstm_fused.gate_update_plan`: route 0 (vector: C a
// multiple of 8 for bf16 or 4 for f32, every pointer 16-byte aligned,
// rows * C / vector < 2^31) or 1 (scalar), and blocks of 256 threads.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gate_update_fwd(const void* gates, const void* c, void* h_out,
                               void* c_out, long long rows, int C,
                               int is_bf16, int route, int blocks,
                               void* stream) {
  if (rows == 0 || C == 0 || blocks == 0) return 0;
  if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(gates, c, h_out, c_out, rows, C, route,
                                 blocks, s);
  return launch<float>(gates, c, h_out, c_out, rows, C, route, blocks, s);
}
