// 3x3 SAME convolution with a BN-normalize+ReLU prologue and a per-channel
// sum / sum-of-squares epilogue, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of
// unet_convlstm_tpu/ops/pallas/doubleconv_fused.py (reached through
// `_fused_conv3x3_fwd_impl`, public `fused_conv3x3`).
//
// x [N,H,W,Cin] and, with the prologue, inv and shift [Cin] (f32):
//
//   z[n,h,w,ci] = relu(x*inv[ci] + shift[ci]) rounded to x's dtype   (or x)
//   z           = 0 outside the image: SAME padding is zero in z-space
//   y[n,h,w,co] = round(bias[co] + sum_k z[...] * w[...])   f32 accumulation
//   sum[co]     = sum of y,  sumsq[co] = sum of y*y   over the ROUNDED y, f32
//
// An implicit GEMM: M = N*H*W output pixels, K = 9*Cin, N = Cout.
//
// What bounds it on this card: from ~290 flops per byte at 64 channels on
// 128x128 maps (the H100's bf16 ridge is ~295) to several thousand on the
// deep 8x8 and 16x16 maps, so the tensor cores bound most shapes, and the
// bytes the 64x64 maps at 32 channels. Two routes, picked by the wrapper's
// planner from the shape alone:
//
// * `conv3x3_fused_wgmma` (bf16, Cin % 16 == 0, Cout 16, 32, 64 or a
//   multiple of 128). A block computes a 128-pixel by BN-channel tile (BN =
//   Cout up to 128) with two warpgroups of `wgmma` (m64nBNk16, f32
//   accumulators in registers), over a ring of 3-4 stages in dynamic shared
//   memory, 2-4 blocks an SM. K is walked tap by tap in chunks of BK whole channels (16, 32
//   or 64: one 32/64/128-byte swizzled row per pixel), so a chunk of A is a
//   block of shifted pixel rows and one test per row says whether the row
//   lies outside the image. Weight tiles come by TMA (`cp.async.bulk.tensor`
//   with an mbarrier per stage) from a K-major copy [Cout, 9*Cin] that a
//   prep kernel writes (it also zeroes sum and sumsq, which an empty batch
//   returns); x rows come by
//   `cp.async` 16-byte vectors, zero-filled outside the image. The loads of
//   the next stages overlap the products of the current one. The prologue
//   runs once per staged element, between its arrival and its product:
//   each thread rewrites the vectors it loaded in place with inv and shift
//   from shared memory and leaves the halo rows at zero (z = 0, not
//   relu(shift)), then fences the async proxy before `wgmma` reads them.
//   Where the output tiles are fewer than the SMs, K is split over blocks
//   (grid z); each split writes f32 partials to a workspace and
//   `conv3x3_fused_splitk_reduce` adds them in a fixed order. The epilogue
//   (in the block, or in the reduce pass) adds the bias in f32, rounds once,
//   stores y with 16-byte stores and reduces the rounded values per channel
//   in shared memory in a fixed order.
//
// The per-channel sums, both routes: the TPU kernel adds each grid step's
// sums to one accumulator in grid order, so its sums are the same bits on
// every run; here blocks run in parallel. So no block adds to a shared
// total: the 128-pixel row of blocks x (blockIdx.x, one of nblk =
// ceil(M/128)) writes its partials to its own column of part [2, Cout,
// nblk] (sums, then squares), and `conv3x3_fused_stats_finish` (one block
// a channel, as K6's second pass in channel_stats.cu) adds each channel's
// nblk partials in a fixed order: a strided pass a thread, shuffles, the
// warps in order. Where K is split, the reduce pass writes the partials
// (the main kernel writes none). No float atomics: y and the sums are the
// same bits from run to run; the finishing pass reads nblk * Cout * 8
// bytes.
// * `conv3x3_fused_fwd` (f32, the FP32 policy's parity route, and the bf16
//   shapes the first cannot take): 128x64 tiles, eight warps of WMMA
//   (bf16) or FMA (f32), K in chunks of 32 staged without overlap.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
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

// z = relu(x*inv + shift) in f32, no FMA contraction (the same roundings as
// the plain version), with a ReLU that keeps a NaN as torch's clamp_min and
// XLA's max do: max.NaN (fmaxf would return 0 and hide a non-finite batch)
__device__ __forceinline__ float prologue(float x, float inv, float shift) {
  const float a = __fadd_rn(__fmul_rn(x, inv), shift);
  float z;
  asm("max.NaN.f32 %0, %1, 0f00000000;\n" : "=f"(z) : "f"(a));
  return z;
}

constexpr int BLOCK_ROWS = 128;    // output pixels a block of either route
constexpr int FINISH_THREADS = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

// One block a channel: sum[c] and sumsq[c] from the nblk partials in
// part [2, Cout, nblk], in a fixed order (a strided pass per thread, then
// shuffles, then the warps in order).
__global__ void __launch_bounds__(FINISH_THREADS)
conv3x3_fused_stats_finish_kernel(const float* __restrict__ part, int nblk,
                                  int Cout, float* __restrict__ sum,
                                  float* __restrict__ sumsq) {
  __shared__ float w_sum[FINISH_THREADS / 32], w_sq[FINISH_THREADS / 32];
  const int c = blockIdx.x;
  const float* ps = part + (int64_t)c * nblk;
  const float* pq = part + (int64_t)(Cout + c) * nblk;
  float a = 0.0f, b = 0.0f;
  for (int i = threadIdx.x; i < nblk; i += FINISH_THREADS) {
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
    for (int w = 0; w < FINISH_THREADS / 32; ++w) {
      ta += w_sum[w];
      tb += w_sq[w];
    }
    sum[c] = ta;
    sumsq[c] = tb;
  }
}

int stats_finish(const void* part, int M, int Cout, void* sum, void* sumsq,
                 cudaStream_t stream) {
  const int nblk = (M + BLOCK_ROWS - 1) / BLOCK_ROWS;
  conv3x3_fused_stats_finish_kernel<<<Cout, FINISH_THREADS, 0, stream>>>(
      static_cast<const float*>(part), nblk, Cout, static_cast<float*>(sum),
      static_cast<float*>(sumsq));
  return (int)cudaGetLastError();
}

// ===========================================================================
// The generic route: f32, and bf16 shapes the wgmma route does not take
// ===========================================================================

namespace generic {

constexpr int BM = BLOCK_ROWS;   // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // K chunk staged per step
constexpr int THREADS = 256; // 8 warps
constexpr int LDC = BN + 4;  // f32 epilogue tile row stride
constexpr int SMEM_BYTES = BM * LDC * 4;  // the epilogue tile; A/B fit inside

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

// 16 bytes of z at one pixel and VEC channels starting at ci, or zeros.
template <typename T, bool PROLOGUE>
__device__ __forceinline__ uint4 load_z(const T* __restrict__ x,
                                        const float* __restrict__ inv,
                                        const float* __restrict__ shift,
                                        int64_t offset, int ci, bool inside) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!inside) return v;
  v = __ldg(reinterpret_cast<const uint4*>(x + offset));
  if (PROLOGUE) {
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int q = 0; q < Tile<T>::VEC; ++q)
      e[q] = from_f32<T>(prologue(to_f32(e[q]), __ldg(inv + ci + q),
                                  __ldg(shift + ci + q)));
  }
  return v;
}

template <typename T, bool PROLOGUE>
__global__ void __launch_bounds__(THREADS)
conv3x3_fused_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wk,
                         const float* __restrict__ bias,
                         const float* __restrict__ inv,
                         const float* __restrict__ shift, T* __restrict__ y,
                         float* __restrict__ part, int H, int W, int Cin,
                         int Cout, int M) {
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
    // this row of blocks' column of part (the finishing pass adds them)
    part[(int64_t)(n0 + tid) * gridDim.x + blockIdx.x] = s;
    part[(int64_t)(Cout + n0 + tid) * gridDim.x + blockIdx.x] = q;
  }
}

template <typename T, bool PROLOGUE>
int launch(const void* x, const void* wk, const void* bias, const void* inv,
           const void* shift, void* y, void* sum, void* sumsq, void* part,
           int N, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const int M = N * H * W;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv3x3_fused_fwd_kernel<T, PROLOGUE><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk),
      static_cast<const float*>(bias), static_cast<const float*>(inv),
      static_cast<const float*>(shift), static_cast<T*>(y),
      static_cast<float*>(part), H, W, Cin, Cout, M);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return stats_finish(part, M, Cout, sum, sumsq, stream);
}

}  // namespace generic

// ===========================================================================
// The wgmma route (bf16)
// ===========================================================================

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int BM = BLOCK_ROWS;  // output pixels per block: two warpgroups of 64
constexpr int THREADS = 256;  // every thread loads; each warpgroup multiplies
constexpr int REDUCE_COLS = 64, REDUCE_ROWS = BLOCK_ROWS;  // the split-K pass's tile
constexpr int BAR_BYTES = 64;   // the stages' mbarriers; keeps inv/shift 16-byte aligned

// error codes beside cudaError_t's (which are positive)
constexpr int ERR_NO_ENCODER = -1;   // no cuTensorMapEncodeTiled in the driver
constexpr int ERR_ENCODE = -2;       // the weight's tensor map was refused
constexpr int ERR_PLAN = -3;         // a tile the source does not instantiate

template <int BN, int BK>
struct Cfg {
  // blocks an SM keeps: the register cap __launch_bounds__ gives each
  // thread (65536 / (256 * MIN_BLOCKS)), and the ring's stages, which must
  // leave each of them its shared memory (3 where a 128-byte-row ring of 4
  // would not fit). Under these caps ptxas spills a few registers in some
  // instantiations (chip_smoke.py's ptxas line); the blocks an SM keeps
  // weigh more than those spills
  static constexpr int MIN_BLOCKS = BN >= 128 ? 2 : BN == 64 ? 3 : 4;
  static constexpr int STAGES = BK == 64 ? 3 : 4;
  static constexpr int ROW = BK * 2;            // bytes of a staged row
  static constexpr int VPR = ROW / 16;          // 16-byte vectors per row
  static constexpr int SWZ_MASK = VPR - 1;      // 128/64/32-byte swizzle:
  static constexpr int SWZ_SHIFT = ROW == 128 ? 0 : ROW == 64 ? 1 : 2;
  static constexpr int LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;  // wgmma
  static constexpr int A_VECS = BM * VPR / THREADS;   // per thread
  static constexpr int ROWS_PER_PASS = THREADS / VPR;
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int B_BYTES = BN * ROW;
  static constexpr int PIPE_BYTES = STAGES * (A_BYTES + B_BYTES);
  static constexpr int ACC = BN / 2;            // f32 accumulators a thread
  static constexpr int LDY = BN + 8;            // epilogue tile row stride
  static constexpr int CG = BN / 8;             // 16-byte column groups
  static constexpr int GROUPS = THREADS / CG;   // row groups of the epilogue
  static constexpr int EPI_BYTES = BM * LDY * 2 + 2 * GROUPS * BN * 4;
  static constexpr int MAIN_BYTES =
      PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
  static_assert(BK == 16 || BK == 32 || BK == 64, "BK");
  static_assert(BN % 16 == 0 && BN <= 128, "BN");
  static_assert(A_VECS >= 1 && (BM * VPR) % THREADS == 0, "A vectors");
  static_assert(B_BYTES % (ROW * 8) == 0, "B tile alignment");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros where !valid (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Waits for the phase of parity `parity` to complete: one asm block, whose
// loop the compiler leaves alone while products are in flight. A load that
// never lands traps after 2^22 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 4194304;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box at (k, row) of the weight's tensor map -> shared memory,
// completing `bytes` on the mbarrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// generic-proxy writes to shared memory (cp.async, the prologue) become
// visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major, swizzled tile: start address,
// leading offset 1 (unused when swizzled), stride between 8-row groups
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int layout,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

// D[64 x N] += A[64 x 16] * B[16 x N], bf16 in, f32 accumulators, both
// operands K-major in shared memory
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <int BN, int BK, bool PRO>
__global__ void __launch_bounds__(THREADS, (Cfg<BN, BK>::MIN_BLOCKS))
conv3x3_fused_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                           const bf16* __restrict__ x,
                           const float* __restrict__ bias,
                           const float* __restrict__ inv,
                           const float* __restrict__ shift,
                           bf16* __restrict__ y, float* __restrict__ part,
                           float* __restrict__ ws, int H, int W, int Cin,
                           int Cout, int M, int splits) {
  using C = Cfg<BN, BK>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle's period
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t a_base = smem_u32(smem);
  const uint32_t b_base = a_base + C::STAGES * C::A_BYTES;
  const uint32_t bar_base = a_base + C::MAIN_BYTES;
  float* inv_s = reinterpret_cast<float*>(smem + C::MAIN_BYTES + BAR_BYTES);
  float* shift_s = inv_s + Cin;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const int groups = Cin / BK;          // channel chunks per tap
  const int nk_all = 9 * groups;
  const int kb = (int)((long long)blockIdx.z * nk_all / splits);
  const int nk = (int)((long long)(blockIdx.z + 1) * nk_all / splits) - kb;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) mbar_init(bar_base + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (PRO) {
    for (int c = tid; c < Cin; c += THREADS) {
      inv_s[c] = __ldg(inv + c);
      shift_s[c] = __ldg(shift + c);
    }
  }
  __syncthreads();

  // the pixel rows this thread stages: row r = tid / VPR + i * ROWS_PER_PASS
  // of the tile, 16-byte vector j of the row; rows beyond M get h far
  // outside the image
  const int j = tid % C::VPR;
  int pm[C::A_VECS] = {}, ph[C::A_VECS] = {}, pw[C::A_VECS] = {};
  // byte offset of this thread's vector in a stage's A tile (swizzled)
  auto a_off = [&](int i) {
    const int r = tid / C::VPR + i * C::ROWS_PER_PASS;
    return r * C::ROW + ((j ^ ((r >> C::SWZ_SHIFT) & C::SWZ_MASK)) << 4);
  };
  auto inside = [&](int i, int dh, int dw) {
    return (unsigned)(ph[i] + dh) < (unsigned)H &&
           (unsigned)(pw[i] + dw) < (unsigned)W;
  };

  auto load_chunk = [&](int c, int stage) {
    const int tap = c / groups;
    const int ci = (c - tap * groups) * BK + 8 * j;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    const uint32_t a_st = a_base + stage * C::A_BYTES;
#pragma unroll
    for (int i = 0; i < C::A_VECS; ++i) {
      const bool ok = inside(i, dh, dw);
      const bf16* src =
          ok ? x + ((int64_t)(pm[i] + dh * W + dw) * Cin + ci) : x;
      cp_async16(a_st + a_off(i), src, ok);
    }
    if (tid == 0) {
      const uint32_t bar = bar_base + 8 * stage;
      mbar_expect_tx(bar, C::B_BYTES);
      tma_load_2d(b_base + stage * C::B_BYTES, &wmap, bar, c * BK, n0);
    }
  };

  // z = relu(x*inv + shift) over this thread's own vectors of a landed
  // chunk; halo rows keep the zeros cp.async wrote (z-space padding)
  auto apply_prologue = [&](int c, int stage) {
    const int tap = c / groups;
    const int ci = (c - tap * groups) * BK + 8 * j;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    float iv[8], sv[8];
    *reinterpret_cast<float4*>(iv) = *reinterpret_cast<const float4*>(inv_s + ci);
    *reinterpret_cast<float4*>(iv + 4) =
        *reinterpret_cast<const float4*>(inv_s + ci + 4);
    *reinterpret_cast<float4*>(sv) = *reinterpret_cast<const float4*>(shift_s + ci);
    *reinterpret_cast<float4*>(sv + 4) =
        *reinterpret_cast<const float4*>(shift_s + ci + 4);
    uint8_t* a_st = smem + stage * C::A_BYTES;
#pragma unroll
    for (int i = 0; i < C::A_VECS; ++i) {
      if (!inside(i, dh, dw)) continue;
      uint4* p = reinterpret_cast<uint4*>(a_st + a_off(i));
      uint4 v = *p;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(e[q]);
        e[q] = __floats2bfloat162_rn(prologue(f.x, iv[2 * q], sv[2 * q]),
                                     prologue(f.y, iv[2 * q + 1], sv[2 * q + 1]));
      }
      *p = v;
    }
  };

  const int wg = tid / 128;
  // accumulator fragment: rows wg*64 + warp*16 + lane/4 (+8), columns
  // 8*q + 2*(lane%4) (+1) for q < BN/8
  const int lane = tid % 32;
  const int row0 = wg * 64 + (tid / 32 % 4) * 16 + lane / 4;
  const int colq = 2 * (lane % 4);
  // the epilogue's view: 16-byte column group cg of rows rg + k * GROUPS;
  // this thread's per-channel sums
  const int cg = tid % C::CG, rg = tid / C::CG;
  float s[8], sq[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = sq[e] = 0.0f;

  const int m0 = blockIdx.x * BM;
#pragma unroll
  for (int i = 0; i < C::A_VECS; ++i) {
    const int m = m0 + tid / C::VPR + i * C::ROWS_PER_PASS;
    const int n = m / (H * W);
    const int rem = m - n * H * W;
    pm[i] = m;
    ph[i] = m < M ? rem / W : -4;
    pw[i] = rem % W;
  }
  float acc[C::ACC];
#pragma unroll
  for (int q = 0; q < C::ACC; ++q) acc[q] = 0.0f;

  // chunk i lives in stage i % STAGES, STAGES - 1 chunks ahead of the
  // products
#pragma unroll
  for (int i = 0; i < C::STAGES - 1; ++i) {
    if (i < nk) load_chunk(kb + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    const int stage = i % C::STAGES;
    cp_async_wait<C::STAGES - 2>();              // this thread's A of chunk i
    mbar_wait(bar_base + 8 * stage, (i / C::STAGES) & 1);   // B of chunk i
    if (PRO) apply_prologue(kb + i, stage);
    fence_async_shared();
    wgmma_wait<0>();      // this warpgroup's products of chunk i - 1
    fence_operands(acc);
    __syncthreads();      // both warpgroups': stage (i - 1) % STAGES is free
    const int next = i + C::STAGES - 1;
    if (next < nk) load_chunk(kb + next, next % C::STAGES);
    cp_async_commit();
    wgmma_fence();
    const uint64_t da = make_desc(a_base + stage * C::A_BYTES +
                                      wg * 64 * C::ROW,
                                  C::LAYOUT, 8 * C::ROW);
    const uint64_t db =
        make_desc(b_base + stage * C::B_BYTES, C::LAYOUT, 8 * C::ROW);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)   // 32 bytes further along the row
      Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);
  cp_async_wait<0>();
  __syncthreads();        // the ring's memory is the epilogue's now

  if (splits > 1) {
    // f32 partials of this split; the reduce pass finishes them
    float* wz = ws + (int64_t)blockIdx.z * M * Cout;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int col = n0 + 8 * q + colq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row0 + 8 * h;
        if (m < M && col < Cout)
          *reinterpret_cast<float2*>(wz + (int64_t)m * Cout + col) =
              make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
      }
    }
    return;
  }

  // bias in f32, one rounding, into a bf16 tile in shared memory
  bf16* ys = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int col = 8 * q + colq;
    const bool ok = n0 + col < Cout;
    const float b0 = ok ? __ldg(bias + n0 + col) : 0.0f;
    const float b1 = ok ? __ldg(bias + n0 + col + 1) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(ys + (row0 + 8 * h) * C::LDY + col) =
          __floats2bfloat162_rn(__fadd_rn(acc[4 * q + 2 * h], b0),
                                __fadd_rn(acc[4 * q + 2 * h + 1], b1));
  }
  __syncthreads();
  // 16-byte stores of y; per-channel sums of the rounded values
  const int col = n0 + 8 * cg;
  if (col < Cout) {
    for (int r = rg; r < BM && m0 + r < M; r += C::GROUPS) {
      const uint4 v = *reinterpret_cast<const uint4*>(ys + r * C::LDY + 8 * cg);
      *reinterpret_cast<uint4*>(y + (int64_t)(m0 + r) * Cout + col) = v;
      const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(e2[q]);
        s[2 * q] += f.x;
        s[2 * q + 1] += f.y;
        sq[2 * q] = fmaf(f.x, f.x, sq[2 * q]);
        sq[2 * q + 1] = fmaf(f.y, f.y, sq[2 * q + 1]);
      }
    }
  }

  // the block's sums: shared memory past the y tile, added in group
  // order, then this row of blocks' column of part
  float* red = reinterpret_cast<float*>(smem + BM * C::LDY * 2);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[rg * BN + 8 * cg + e] = s[e];
    red[(C::GROUPS + rg) * BN + 8 * cg + e] = sq[e];
  }
  __syncthreads();
  if (tid < BN && n0 + tid < Cout) {
    float ts = 0.0f, tq = 0.0f;
    for (int g = 0; g < C::GROUPS; ++g) {
      ts += red[g * BN + tid];
      tq += red[(C::GROUPS + g) * BN + tid];
    }
    part[(int64_t)(n0 + tid) * gridDim.x + blockIdx.x] = ts;
    part[(int64_t)(Cout + n0 + tid) * gridDim.x + blockIdx.x] = tq;
  }
}

// y = round(bias + sum over splits of the partials, in split order), 16-byte
// stores, per-channel sums of the rounded y into this row of blocks' column
// of part. A block takes 64 channels of 128 rows; a thread 8 channels.
__global__ void __launch_bounds__(256)
conv3x3_fused_splitk_reduce_kernel(const float* __restrict__ ws,
                                   const float* __restrict__ bias,
                                   bf16* __restrict__ y,
                                   float* __restrict__ part, int M,
                                   int Cout, int splits) {
  constexpr int CG = REDUCE_COLS / 8, RG = 256 / CG;
  __shared__ float red[2][RG][REDUCE_COLS];
  const int cg = threadIdx.x % CG, rg = threadIdx.x / CG;
  const int col = blockIdx.y * REDUCE_COLS + 8 * cg;
  const int m0 = blockIdx.x * REDUCE_ROWS;
  float s[8], sq[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = sq[e] = 0.0f;
  if (col < Cout) {
    float b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) b[e] = __ldg(bias + col + e);
    const int64_t plane = (int64_t)M * Cout;
    for (int r = rg; r < REDUCE_ROWS && m0 + r < M; r += RG) {
      const float* p = ws + (int64_t)(m0 + r) * Cout + col;
      float a[8];
      *reinterpret_cast<float4*>(a) = __ldg(reinterpret_cast<const float4*>(p));
      *reinterpret_cast<float4*>(a + 4) =
          __ldg(reinterpret_cast<const float4*>(p + 4));
      for (int z = 1; z < splits; ++z) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(p + z * plane));
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(p + z * plane + 4));
        a[0] = __fadd_rn(a[0], u.x); a[1] = __fadd_rn(a[1], u.y);
        a[2] = __fadd_rn(a[2], u.z); a[3] = __fadd_rn(a[3], u.w);
        a[4] = __fadd_rn(a[4], v.x); a[5] = __fadd_rn(a[5], v.y);
        a[6] = __fadd_rn(a[6], v.z); a[7] = __fadd_rn(a[7], v.w);
      }
      uint4 out;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        o[q] = __floats2bfloat162_rn(__fadd_rn(a[2 * q], b[2 * q]),
                                     __fadd_rn(a[2 * q + 1], b[2 * q + 1]));
        const float2 f = __bfloat1622float2(o[q]);
        s[2 * q] += f.x;
        s[2 * q + 1] += f.y;
        sq[2 * q] = fmaf(f.x, f.x, sq[2 * q]);
        sq[2 * q + 1] = fmaf(f.y, f.y, sq[2 * q + 1]);
      }
      *reinterpret_cast<uint4*>(y + (int64_t)(m0 + r) * Cout + col) = out;
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[0][rg][8 * cg + e] = s[e];
    red[1][rg][8 * cg + e] = sq[e];
  }
  __syncthreads();
  const int c = blockIdx.y * REDUCE_COLS + threadIdx.x;
  if (threadIdx.x < REDUCE_COLS && c < Cout) {
    float ts = 0.0f, tq = 0.0f;
    for (int g = 0; g < RG; ++g) {
      ts += red[0][g][threadIdx.x];
      tq += red[1][g][threadIdx.x];
    }
    part[(int64_t)c * gridDim.x + blockIdx.x] = ts;
    part[(int64_t)(Cout + c) * gridDim.x + blockIdx.x] = tq;
  }
}

// wt[co, tap*Cin + ci] = bf16(w[co, ci, tap]) (OIHW -> the K-major weight the
// TMA reads), 8 channels a thread; and sum = sumsq = 0
template <typename TW>
__global__ void __launch_bounds__(256)
conv3x3_fused_prep_kernel(const TW* __restrict__ w, bf16* __restrict__ wt,
                          float* __restrict__ sum, float* __restrict__ sumsq,
                          int Cout, int Cin) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Cout) {
    sum[i] = 0.0f;
    sumsq[i] = 0.0f;
  }
  const int K = 9 * Cin, vecs = K / 8;
  if (i >= (int64_t)Cout * vecs) return;
  const int co = (int)(i / vecs);
  const int k = (int)(i - (int64_t)co * vecs) * 8;
  const int tap = k / Cin, ci = k - tap * Cin;
  const TW* src = w + ((int64_t)co * Cin + ci) * 9 + tap;
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16_rn(to_f32(src[9 * e]));
  *reinterpret_cast<uint4*>(wt + (int64_t)co * K + k) = out;
}

// cuTensorMapEncodeTiled, reached through the runtime (the library is not
// linked against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int BN, int BK, bool PRO>
int launch_main(const CUtensorMap& map, const void* x, const void* bias,
                const void* inv, const void* shift, void* y, void* part,
                void* ws, int M, int H, int W, int Cin, int Cout, int splits,
                cudaStream_t stream) {
  using C = Cfg<BN, BK>;
  const int smem = 1024 + C::MAIN_BYTES + BAR_BYTES + (PRO ? 8 * Cin : 0);
  auto kernel = conv3x3_fused_wgmma_kernel<BN, BK, PRO>;
  // the dynamic shared memory this instantiation may take on each card,
  // raised only when a call needs more
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) allowed[dev] = smem;
  }
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, smem, stream>>>(
      map, static_cast<const bf16*>(x), static_cast<const float*>(bias),
      static_cast<const float*>(inv), static_cast<const float*>(shift),
      static_cast<bf16*>(y), static_cast<float*>(part),
      static_cast<float*>(ws), H, W, Cin, Cout, M, splits);
  return (int)cudaGetLastError();
}

template <int BN, int BK>
int dispatch_pro(bool pro, const CUtensorMap& map, const void* x,
                 const void* bias, const void* inv, const void* shift,
                 void* y, void* part, void* ws, int M, int H, int W, int Cin,
                 int Cout, int splits, cudaStream_t s) {
  if (pro)
    return launch_main<BN, BK, true>(map, x, bias, inv, shift, y, part, ws, M,
                                     H, W, Cin, Cout, splits, s);
  return launch_main<BN, BK, false>(map, x, bias, inv, shift, y, part, ws, M,
                                    H, W, Cin, Cout, splits, s);
}

}  // namespace hopper

}  // namespace

// The generic route. x [N,H,W,Cin], wk [9*Cin, Cout] (both bf16 if is_bf16
// else f32), bias [Cout] f32, inv/shift [Cin] f32 (read only with
// has_prologue) → y [N,H,W,Cout] in x's dtype; sum/sumsq [Cout] f32, which
// the finishing pass writes (an empty batch launches nothing and leaves
// them as they are); part [2, Cout, ceil(N*H*W/128)] f32, the blocks'
// partials. All contiguous, 16-byte aligned, Cin % 8 == 0, Cout % 8 == 0,
// N*H*W*max(Cin, Cout) < 2^31. Returns cudaGetLastError().
extern "C" int conv3x3_fused_fwd(const void* x, const void* wk,
                                 const void* bias, const void* inv,
                                 const void* shift, void* y, void* sum,
                                 void* sumsq, void* part, int N, int H, int W,
                                 int Cin, int Cout, int has_prologue,
                                 int is_bf16, void* stream) {
  using namespace generic;
  if ((long long)N * H * W == 0 || Cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (has_prologue)
      return launch<__nv_bfloat16, true>(x, wk, bias, inv, shift, y, sum, sumsq, part, N, H, W, Cin, Cout, s);
    return launch<__nv_bfloat16, false>(x, wk, bias, inv, shift, y, sum, sumsq, part, N, H, W, Cin, Cout, s);
  }
  if (has_prologue)
    return launch<float, true>(x, wk, bias, inv, shift, y, sum, sumsq, part, N, H, W, Cin, Cout, s);
  return launch<float, false>(x, wk, bias, inv, shift, y, sum, sumsq, part, N, H, W, Cin, Cout, s);
}

// The wgmma route, one call: the prep kernel (w [Cout, Cin, 3, 3], bf16 if
// w_is_bf16 else f32 → wt [Cout, 9*Cin] bf16; sum = sumsq = 0), the
// tensor map over wt, the main kernel on a (ceil(M/128), Cout/bn, splits)
// grid and, with splits > 1, the reduce pass over ws [splits, M, Cout] f32,
// then the finishing pass over part [2, Cout, ceil(M/128)] f32 (the
// partials of the main kernel, or of the reduce pass where K is split).
// With M == 0 only the prep kernel runs (the sums come back 0).
// x, y bf16 NHWC; bias [Cout], inv/shift [Cin] f32. The plan (bn, bk,
// splits) comes from the wrapper's planner: bn in {16, 32, 64, 128}
// dividing Cout, bk in {16, 32, 64} dividing Cin, 1 <= splits <= 9*Cin/bk.
// Returns 0, a cudaError_t, or ERR_NO_ENCODER / ERR_ENCODE / ERR_PLAN.
extern "C" int conv3x3_fused_wgmma(const void* x, const void* w, int w_is_bf16,
                                   const void* bias, const void* inv,
                                   const void* shift, void* wt, void* y,
                                   void* sum, void* sumsq, void* ws,
                                   void* part, int N, int H, int W, int Cin,
                                   int Cout,
                                   int has_prologue, int bn, int bk,
                                   int splits, void* stream) {
  using namespace hopper;
  const int M = N * H * W;
  if (Cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int K = 9 * Cin;

  const long long vecs = (long long)Cout * (K / 8);
  const long long threads = vecs > Cout ? vecs : Cout;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  if (w_is_bf16)
    conv3x3_fused_prep_kernel<bf16><<<blocks, 256, 0, s>>>(
        static_cast<const bf16*>(w), static_cast<bf16*>(wt),
        static_cast<float*>(sum), static_cast<float*>(sumsq), Cout, Cin);
  else
    conv3x3_fused_prep_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(w), static_cast<bf16*>(wt),
        static_cast<float*>(sum), static_cast<float*>(sumsq), Cout, Cin);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || M == 0) return rc;

  EncodeTiled encode = encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)Cout};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      bk == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : bk == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wt, dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_ENCODE;

  const bool pro = has_prologue != 0;
#define K2_TILE(BN_, BK_)                                                   \
  if (bn == BN_ && bk == BK_)                                               \
    rc = dispatch_pro<BN_, BK_>(pro, map, x, bias, inv, shift, y, part, ws, \
                                M, H, W, Cin, Cout, splits, s);             \
  else
  K2_TILE(16, 16) K2_TILE(16, 32) K2_TILE(16, 64)
  K2_TILE(32, 16) K2_TILE(32, 32) K2_TILE(32, 64)
  K2_TILE(64, 16) K2_TILE(64, 32) K2_TILE(64, 64)
  K2_TILE(128, 16) K2_TILE(128, 32) K2_TILE(128, 64)
  return ERR_PLAN;
#undef K2_TILE
  if (rc != 0) return rc;
  if (splits == 1) return stats_finish(part, M, Cout, sum, sumsq, s);

  const dim3 grid((M + REDUCE_ROWS - 1) / REDUCE_ROWS,
                  (Cout + REDUCE_COLS - 1) / REDUCE_COLS);
  conv3x3_fused_splitk_reduce_kernel<<<grid, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<bf16*>(y), static_cast<float*>(part), M, Cout, splits);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return stats_finish(part, M, Cout, sum, sumsq, s);
}
