// Per-channel sum and sum of squares of a channels-last activation, for
// Hopper (sm_90a): x [R, C] (every axis but the last folded into R rows),
// bf16 or f32 -> sum [C], sumsq [C] in f32.
//
// Replaces the TPU kernel `_sum_kernel` of scripts/perf/bn_kernel_proto.py
// (:46, wrapper `pallas_stats` :64-87), the BatchNorm-statistics probe.
//
// What bounds it on this card: device-memory bytes. Each element is read
// once and costs two adds and a multiply, far below the H100's ridge: at the
// probe's [640, 64, 64, 32] bf16 activation the kernel must read 167,772,160
// bytes, 0.0501 ms at 3.35 TB/s. So the design only streams, and keeps the
// reduction off the critical path:
//   * the TPU kernel carries one f32 [1, 128] accumulator through a grid that
//     runs in order; on Hopper blocks run in parallel, so each block reduces
//     the rows it owns and a second pass adds the blocks' partials;
//   * 16-byte vector loads (8 bf16 or 4 f32 channels a thread), neighbouring
//     threads on neighbouring addresses: a block is TPR x RPB threads, TPR
//     threads across a row's channel vectors and RPB rows, so for C = 32
//     bf16 four threads cover a 64-byte row and a warp reads 512 contiguous
//     bytes. A thread always owns the same channels, so its partial sums stay
//     in registers through a grid-stride loop over rows, four rows in flight;
//   * the RPB rows' partials meet in shared memory in a fixed tree, one row
//     of [blocks, C] partials per block goes to a scratch buffer the wrapper
//     allocates, and a second kernel (one block per channel) adds them in a
//     fixed order. No float atomics: results are bit-identical from run to
//     run.
// Any row count and any C: a C whose rows are not 16-byte multiples (or an
// unaligned pointer) takes the one-channel-per-thread path; rows beyond R
// are masked. Unlike the TPU wrapper, no ragged tail is dropped and C need
// not divide 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ void widen(const uint4& v, float* f) {
  // 8 bf16 -> f32: a bf16 is the high half of an f32
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void widen(const float4& v, float* f) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void widen(const __nv_bfloat16& v, float* f) {
  f[0] = __bfloat162float(v);
}

__device__ __forceinline__ void widen(const float& v, float* f) { f[0] = v; }

// One block: TPR threads across a row's vectors (a chunk of them, chosen by
// blockIdx.y, when a row has more than kThreads vectors), RPB rows. Vec is
// the load type, V the channels it holds. Writes the block's partials to
// part[c * nblk + blockIdx.x] (sums) and part[(C + c) * nblk + ...] (squares).
template <typename Vec, int V>
__global__ void __launch_bounds__(kThreads)
channel_partials_kernel(const Vec* __restrict__ x, int64_t R, int nvec,
                        int tpr, int rpb, float* __restrict__ part, int C) {
  __shared__ float s_sum[kThreads * V];
  __shared__ float s_sq[kThreads * V];
  const int tx = threadIdx.x % tpr, ty = threadIdx.x / tpr;
  const int col = blockIdx.y * tpr + tx;  // this thread's vector in a row
  const bool active = ty < rpb && col < nvec;
  const int nblk = gridDim.x;

  float acc[V], acc2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = acc2[j] = 0.0f;

  if (active) {
    const int64_t step = (int64_t)nblk * rpb;
    for (int64_t r = (int64_t)blockIdx.x * rpb + ty; r < R;
         r += kUnroll * step) {
      Vec v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t rr = r + k * step;
        if (rr < R) v[k] = x[rr * nvec + col];
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (r + k * step < R) {
          float f[V];
          widen(v[k], f);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            acc[j] += f[j];
            acc2[j] = fmaf(f[j], f[j], acc2[j]);
          }
        }
      }
    }
  }

  // the RPB rows of partials meet in a fixed tree over ty
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_sum[threadIdx.x * V + j] = acc[j];
    s_sq[threadIdx.x * V + j] = acc2[j];
  }
  __syncthreads();
  int half = 1;
  while (half < rpb) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {
    if (ty < half && ty + half < rpb) {
      const int o = (threadIdx.x + half * tpr) * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s_sum[threadIdx.x * V + j] += s_sum[o + j];
        s_sq[threadIdx.x * V + j] += s_sq[o + j];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && col < nvec) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = col * V + j;
      part[(int64_t)c * nblk + blockIdx.x] = s_sum[tx * V + j];
      part[(int64_t)(C + c) * nblk + blockIdx.x] = s_sq[tx * V + j];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

// One block per channel: adds its nblk partials (and squares) in a fixed
// order: a strided pass per thread, then shuffles, then the warps in order.
__global__ void __launch_bounds__(kThreads)
channel_finish_kernel(const float* __restrict__ part, int nblk, int C,
                      float* __restrict__ sum, float* __restrict__ sumsq) {
  __shared__ float w_sum[kThreads / 32], w_sq[kThreads / 32];
  const int c = blockIdx.x;
  const float* ps = part + (int64_t)c * nblk;
  const float* pq = part + (int64_t)(C + c) * nblk;
  float a = 0.0f, b = 0.0f;
  for (int i = threadIdx.x; i < nblk; i += kThreads) {
    a += ps[i];
    b += pq[i];
  }
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    w_sum[warp] = a;
    w_sq[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ta = 0.0f, tb = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) {
      ta += w_sum[w];
      tb += w_sq[w];
    }
    sum[c] = ta;
    sumsq[c] = tb;
  }
}

template <typename Vec, int V>
int launch(const void* x, int64_t R, int C, int nblk, float* part,
           float* sum, float* sumsq, cudaStream_t s) {
  const int nvec = C / V;
  const int tpr = nvec < kThreads ? nvec : kThreads;
  const int rpb = kThreads / tpr;
  const dim3 grid((unsigned)nblk, (unsigned)((nvec + tpr - 1) / tpr));
  channel_partials_kernel<Vec, V><<<grid, kThreads, 0, s>>>(
      static_cast<const Vec*>(x), R, nvec, tpr, rpb, part, C);
  channel_finish_kernel<<<(unsigned)C, kThreads, 0, s>>>(part, nblk, C, sum,
                                                         sumsq);
  return (int)cudaGetLastError();
}

}  // namespace

// x [rows, C] contiguous (bf16 if is_bf16 else f32); scratch f32 [2 * C *
// nblk]; sum, sumsq f32 [C]. nblk >= 1 blocks stride over the rows. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int channel_sum_sumsq(const void* x, long long rows, int C,
                                 int is_bf16, int nblk, void* scratch,
                                 void* sum, void* sumsq, void* stream) {
  if (C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  float* o_sum = static_cast<float*>(sum);
  float* o_sq = static_cast<float*>(sumsq);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (is_bf16) {
    if (aligned && C % 8 == 0)
      return launch<uint4, 8>(x, rows, C, nblk, part, o_sum, o_sq, s);
    return launch<__nv_bfloat16, 1>(x, rows, C, nblk, part, o_sum, o_sq, s);
  }
  if (aligned && C % 4 == 0)
    return launch<float4, 4>(x, rows, C, nblk, part, o_sum, o_sq, s);
  return launch<float, 1>(x, rows, C, nblk, part, o_sum, o_sq, s);
}
