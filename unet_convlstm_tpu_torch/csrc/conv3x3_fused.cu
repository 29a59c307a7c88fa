// 3x3 SAME convolution with a BN-normalize+ReLU prologue and a per-channel
// sum / sum-of-squares epilogue, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of
// unet_convlstm_tpu/ops/pallas/doubleconv_fused.py (reached through
// `_fused_conv3x3_fwd_impl`, public `fused_conv3x3`).
//
// x [N,H,W,Cin], wk [9*Cin, Cout] (row k = (3*kh + kw)*Cin + ci), bias, and,
// with the prologue, inv and shift [Cin] (f32):
//
//   z[n,h,w,ci] = relu(x*inv[ci] + shift[ci]) rounded to x's dtype   (or x)
//   z           = 0 outside the image: SAME padding is zero in z-space
//   y[n,h,w,co] = round(bias[co] + sum_k z[...] * wk[k, co])   f32 accumulation
//   sum[co]    += y,  sumsq[co] += y*y    over the ROUNDED y, in f32
//
// An implicit GEMM: M = N*H*W output pixels, K = 9*Cin, N = Cout.
//
// What bounds it on this card: at the serving path's shapes (Cin, Cout of 64
// to 1024, maps of 128x128 down to 8x8, 16 frames) the product does
// 2*M*K*Cout flops against x, w and y once each: from ~290 flops per byte
// at 64 channels on 128x128 maps (the H100's bf16 ridge is ~295) to several
// thousand on the narrow deep maps. So the tensor cores bound it, and the
// design is a tiled product on them: each block computes a 128-pixel by
// 64-channel tile of y with eight warps of bf16 WMMA (16x16x16, f32
// accumulators), walking K in chunks of 32 that it stages in shared memory.
// The prologue is applied while a chunk of x is staged, so z never reaches
// device memory; the halo is written as zeros of z. The epilogue adds the
// bias in f32, rounds, stores y, and reduces the rounded tile per channel in
// shared memory before one atomicAdd per channel and block: blocks run in
// no order, so there is no carry between them as the TPU grid had. f32
// inputs take the same tiling with FMA in place of the tensor cores. This
// first version does not overlap the loads of one chunk with the products
// of the last; that (cp.async or TMA rings, wgmma) is where its time goes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // K chunk staged per step
constexpr int THREADS = 256; // 8 warps
constexpr int LDC = BN + 4;  // f32 epilogue tile row stride
constexpr int SMEM_BYTES = BM * LDC * 4;  // the epilogue tile; A/B fit inside

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

template <typename T>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte vector
  static constexpr int PAD = VEC;              // keeps 16-byte rows, skews banks
  static constexpr int LDA = BK + PAD;
  static constexpr int LDB = BN + PAD;
  static constexpr int A_VECS = BM * BK / VEC / THREADS;  // per thread
  static constexpr int B_VECS = BK * BN / VEC / THREADS;
  static constexpr int A_BYTES = BM * LDA * sizeof(T);
  static constexpr int B_BYTES = BK * LDB * sizeof(T);
  static_assert(A_BYTES + B_BYTES <= SMEM_BYTES, "A/B tiles exceed smem");
  static_assert(A_BYTES % 128 == 0, "B tile must stay aligned");
};

union Vec16 {
  uint4 u;
  __nv_bfloat16 h[8];
  float f[4];
};

// 16 bytes of z at one pixel and VEC channels starting at ci, or zeros.
template <typename T, bool PROLOGUE>
__device__ __forceinline__ uint4 load_z(const T* __restrict__ x,
                                        const float* __restrict__ inv,
                                        const float* __restrict__ shift,
                                        int64_t offset, int ci, bool inside) {
  Vec16 v;
  v.u = make_uint4(0u, 0u, 0u, 0u);
  if (!inside) return v.u;
  v.u = __ldg(reinterpret_cast<const uint4*>(x + offset));
  if (PROLOGUE) {
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int q = 0; q < Tile<T>::VEC; ++q) {
      // no FMA contraction: the same roundings as the plain version
      const float a = __fadd_rn(__fmul_rn(to_f32(e[q]), __ldg(inv + ci + q)),
                                __ldg(shift + ci + q));
      // ReLU that keeps a NaN, as torch's clamp_min and XLA's max do
      // (fmaxf would return 0 and hide a non-finite batch)
      e[q] = from_f32<T>(a < 0.0f ? 0.0f : a);
    }
  }
  return v.u;
}

template <typename T, bool PROLOGUE>
__global__ void __launch_bounds__(THREADS)
conv3x3_fused_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wk,
                         const float* __restrict__ bias,
                         const float* __restrict__ inv,
                         const float* __restrict__ shift, T* __restrict__ y,
                         float* __restrict__ sum, float* __restrict__ sumsq,
                         int H, int W, int Cin, int Cout, int M) {
  using TT = Tile<T>;
  constexpr int VEC = TT::VEC;
  constexpr int A_VPR = BK / VEC;   // vectors per A row
  constexpr int B_VPR = BN / VEC;   // vectors per B row

  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ float red_s[THREADS / BN][BN];
  __shared__ float red_q[THREADS / BN][BN];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + TT::A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;
  const int HW = H * W;

  // the output pixels whose x rows this thread stages, fixed over K
  int a_n[TT::A_VECS], a_h[TT::A_VECS], a_w[TT::A_VECS];
  bool a_ok[TT::A_VECS];
#pragma unroll
  for (int s = 0; s < TT::A_VECS; ++s) {
    const int row = (tid + s * THREADS) / A_VPR;
    const int m = m0 + row;
    a_ok[s] = m < M;
    const int mm = a_ok[s] ? m : 0;
    a_n[s] = mm / HW;
    const int rem = mm - a_n[s] * HW;
    a_h[s] = rem / W;
    a_w[s] = rem - a_h[s] * W;
  }

  // accumulators: WMMA fragments (bf16) or an 8x4 register tile (f32)
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cfrag[2][2];
  float acc[8][4];
  const int warp = tid / 32;
  const int wm = warp >> 1;  // 4 warps over M: 32 rows each
  const int wn = warp & 1;   // 2 warps over N: 32 columns each
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(cfrag[i][j], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int kc = 0; kc < K; kc += BK) {
    // stage A: z at the tap each vector's k falls in
#pragma unroll
    for (int s = 0; s < TT::A_VECS; ++s) {
      const int v = tid + s * THREADS;
      const int row = v / A_VPR;
      const int kv = v - row * A_VPR;
      const int k = kc + kv * VEC;
      bool inside = a_ok[s] && k < K;
      int64_t off = 0;
      int ci = 0;
      if (inside) {
        const int tap = k / Cin;
        ci = k - tap * Cin;
        const int ih = a_h[s] + tap / 3 - 1;
        const int iw = a_w[s] + tap % 3 - 1;
        inside = ih >= 0 && ih < H && iw >= 0 && iw < W;
        off = (((int64_t)a_n[s] * H + ih) * W + iw) * Cin + ci;
      }
      *reinterpret_cast<uint4*>(As + row * TT::LDA + kv * VEC) =
          load_z<T, PROLOGUE>(x, inv, shift, off, ci, inside);
    }
    // stage B: rows kc..kc+BK of wk, columns n0..n0+BN
#pragma unroll
    for (int s = 0; s < TT::B_VECS; ++s) {
      const int v = tid + s * THREADS;
      const int kr = v / B_VPR;
      const int cv = v - kr * B_VPR;
      const int k = kc + kr;
      const int col = n0 + cv * VEC;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < K && col < Cout)
        val = __ldg(reinterpret_cast<const uint4*>(wk + (int64_t)k * Cout + col));
      *reinterpret_cast<uint4*>(Bs + kr * TT::LDB + cv * VEC) = val;
    }
    __syncthreads();

    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              af[i],
              reinterpret_cast<const __nv_bfloat16*>(As) + (wm * 32 + i * 16) * TT::LDA + kk,
              TT::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              bf[j],
              reinterpret_cast<const __nv_bfloat16*>(Bs) + kk * TT::LDB + wn * 32 + j * 16,
              TT::LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(cfrag[i][j], af[i], bf[j], cfrag[i][j]);
      }
    } else {
      const int tr = tid >> 4;  // rows tr*8 .. tr*8+7
      const int tc = tid & 15;  // columns tc + 16*j
      const float* Af = reinterpret_cast<const float*>(As);
      const float* Bf = reinterpret_cast<const float*>(Bs);
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bf[kk * TT::LDB + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = Af[(tr * 8 + i) * TT::LDA + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // the f32 tile goes to shared memory (over the A/B tiles, now free)
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                cfrag[i][j], LDC, wmma::mem_row_major);
  } else {
    const int tr = tid >> 4;
    const int tc = tid & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(tr * 8 + i) * LDC + tc + 16 * j] = acc[i][j];
  }
  __syncthreads();

  // epilogue: bias in f32, round, store; stats over the rounded values
  const int c = tid % BN;
  const int rg = tid / BN;
  const int col = n0 + c;
  float ps = 0.0f, pq = 0.0f;
  if (col < Cout) {
    const float b = __ldg(bias + col);
    for (int r = rg; r < BM; r += THREADS / BN) {
      const int m = m0 + r;
      if (m >= M) break;
      const T yv = from_f32<T>(__fadd_rn(Cs[r * LDC + c], b));
      y[(int64_t)m * Cout + col] = yv;
      const float yr = to_f32(yv);
      ps += yr;
      pq = fmaf(yr, yr, pq);
    }
  }
  red_s[rg][c] = ps;
  red_q[rg][c] = pq;
  __syncthreads();
  if (tid < BN && n0 + tid < Cout) {
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int g = 0; g < THREADS / BN; ++g) {
      s += red_s[g][tid];
      q += red_q[g][tid];
    }
    atomicAdd(sum + n0 + tid, s);
    atomicAdd(sumsq + n0 + tid, q);
  }
}

template <typename T, bool PROLOGUE>
int launch(const void* x, const void* wk, const void* bias, const void* inv,
           const void* shift, void* y, void* sum, void* sumsq, int N, int H,
           int W, int Cin, int Cout, cudaStream_t stream) {
  const int M = N * H * W;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv3x3_fused_fwd_kernel<T, PROLOGUE><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk),
      static_cast<const float*>(bias), static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<T*>(y),
      static_cast<float*>(sum), static_cast<float*>(sumsq), H, W, Cin, Cout, M);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N,H,W,Cin], wk [9*Cin, Cout] (both bf16 if is_bf16 else f32), bias
// [Cout] f32, inv/shift [Cin] f32 (read only with has_prologue) → y
// [N,H,W,Cout] in x's dtype; sum/sumsq [Cout] f32, which the caller zeroes
// and this launch adds to. All contiguous, 16-byte aligned, Cin % 8 == 0,
// Cout % 8 == 0, N*H*W*max(Cin, Cout) < 2^31. Returns cudaGetLastError().
extern "C" int conv3x3_fused_fwd(const void* x, const void* wk,
                                 const void* bias, const void* inv,
                                 const void* shift, void* y, void* sum,
                                 void* sumsq, int N, int H, int W, int Cin,
                                 int Cout, int has_prologue, int is_bf16,
                                 void* stream) {
  if ((long long)N * H * W == 0 || Cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (has_prologue)
      return launch<__nv_bfloat16, true>(x, wk, bias, inv, shift, y, sum, sumsq, N, H, W, Cin, Cout, s);
    return launch<__nv_bfloat16, false>(x, wk, bias, inv, shift, y, sum, sumsq, N, H, W, Cin, Cout, s);
  }
  if (has_prologue)
    return launch<float, true>(x, wk, bias, inv, shift, y, sum, sumsq, N, H, W, Cin, Cout, s);
  return launch<float, false>(x, wk, bias, inv, shift, y, sum, sumsq, N, H, W, Cin, Cout, s);
}
