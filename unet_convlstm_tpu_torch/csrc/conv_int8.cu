// Int8 implicit-GEMM convolution for Hopper (sm_90a), with the dequant and
// bias epilogue fused:
//
//   acc[m, o] = sum_{kh, kw, c} x_q[n, p*s + kh - pad_h, q*s + kw - pad_w, c]
//                               * w_q[o, kh, kw, c]                  (int32)
//   y[m, o]   = float(acc) * (x_s * w_s[o]) + b[o]  in bf16 or f32
//
// x_q NHWC int8, w_q OHWI int8 (the OIHW weight in channels-last memory),
// w_s f32 [O] per output channel, x_s one f32 on the card (the activation's
// scale, dynamic or calibrated: read on the card, so no host round trip),
// b f32 [O] or none; m runs over the N*P*Q output pixels, y is NHWC.
//
// Replaces the int8 convolutions of the JAX package's post-training
// quantization, unet_convlstm_tpu/ops/quant.py:215-227 (conv2d_int8) and
// :259-271 (conv_transpose2d_int8): XLA's conv_general_dilated on int8 with
// preferred_element_type=int32. There is no Pallas kernel behind them, and
// PyTorch has no int8 convolution on CUDA, so this one is written by hand.
//
// Shapes it takes: every conv of the two model families after
// ops/quant.quantize_model: 3x3 SAME stride 1 (Cin 2 to 2,048), 1x1 (outc,
// the resnet downsample at stride 2), the 7x7 stride-2 resnet stem, the 7x7
// attention conv, and the 2x2 stride-2 transposed conv, which is a 1x1 GEMM
// to 4*O columns (column (a*2 + b)*O + o) whose epilogue writes each value
// to output pixel (2p + a, 2q + b) of the 2x map ("up2").
//
// What bounds it on this card: int8 tensor-core operations for the deep
// convs (2*M*N*K over 1,979 TOP/s dense), device-memory bytes (x_q and w_q
// read once, y written once, over 3.35 TB/s) for the wide, shallow maps.
// This first design is simple and exact; wgmma with s8 and TMA come later:
//   * a block computes a BM x BN = 128 x 64 tile of the GEMM with four warps
//     (2 x 2, 64 x 32 each), mma.sync m16n8k32 s8 x s8 -> s32 in registers;
//   * K runs in steps of BK = 64 bytes (two m16n8k32 products; where Cin is
//     a multiple of 64 and K is at least 256) or 32 bytes (one; the shallow
//     convs, which 64 would pad with zeros) through a 3-stage ring in shared
//     memory (46,080 or 27,648 bytes). Where Cin is a multiple of 16
//     ("vec"), a step is one tap (kh, kw) and BK channels, staged with
//     16-byte cp.async, zero-filled (src-size 0) at the halo, past Cin and
//     past the ragged M and N edges. Any other Cin (the network's 2-channel
//     input) takes the "gather" loader: K is the flat (kh, kw, c) index,
//     padded with zeros to a multiple of 32, so a 3x3 conv of 2 channels is
//     one step and not nine;
//   * shared rows are BK + 16 bytes, so each ldmatrix phase of 8 rows x 16
//     bytes hits 32 distinct banks; one ldmatrix.x4 loads a 16 x 32-byte A
//     fragment or two 8 x 32-byte B fragments;
//   * the epilogue converts the exact int32 with round-to-nearest and
//     applies the scale and bias in two separately rounded f32 operations
//     (__fmul_rn, __fadd_rn: no fused multiply-add), as the plain version
//     and XLA do, so f32 and bf16 outputs are bit-equal to the plain
//     version's; where the channel count is even, a thread's two adjacent
//     channels go out as one 4-byte (bf16) or 8-byte (f32) store.
// |acc| <= 18,432 * 127^2 < 2^31 at the widest conv (3x3 x 2,048 channels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kStages = 3;
constexpr int kThreads = 128;

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* w_s;
  const float* x_s;
  const float* bias;   // may be null
  void* y;
  int H, W, C;         // input map
  int KW, stride, pad_h, pad_w;
  int P, Q;            // output map (up2: the input map)
  int cols;            // GEMM columns: O, or 4*O for up2
  int cout;            // channels of y
  int K;               // KH*KW*C
  int M;               // N*P*Q
  int nk;              // K steps
  int cpt;             // vec: BK-channel steps per tap
  int up2;
  int bf16;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output pixel's input origin: image base and the top-left tap.
struct Pixel {
  const int8_t* img;
  int h0, w0;
  bool ok;
};

__device__ __forceinline__ Pixel pixel_of(const Params& p, int m) {
  Pixel px{p.x, 0, 0, m < p.M};
  if (px.ok) {
    const int pq = p.P * p.Q;
    const int n = m / pq;
    const int r = m - n * pq;
    const int pp = r / p.Q;
    const int qq = r - pp * p.Q;
    px.img = p.x + static_cast<int64_t>(n) * p.H * p.W * p.C;
    px.h0 = pp * p.stride - p.pad_h;
    px.w0 = qq * p.stride - p.pad_w;
  }
  return px;
}

// vec loader: step kt is tap kt / cpt, channels (kt % cpt) * BK + [0, BK).
// Thread tid stages the BK / 16 chunks of 16 bytes of A row tid and half
// (tid & 1) of B row tid >> 1.
template <int kBK>
__device__ __forceinline__ void load_vec(const Params& p, const Pixel& px,
                                         const int8_t* wrow, bool b_ok,
                                         int8_t* as, int8_t* bs, int kt,
                                         int tid) {
  constexpr int kRow = kBK + 16;
  const int tap = kt / p.cpt;
  const int c0 = (kt - tap * p.cpt) * kBK;
  const int kh = tap / p.KW;
  const int kw = tap - kh * p.KW;
  const int ih = px.h0 + kh, iw = px.w0 + kw;
  const bool in = px.ok && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
  const int8_t* src = in ? px.img + (static_cast<int64_t>(ih) * p.W + iw) * p.C
                         : p.x;
#pragma unroll
  for (int h = 0; h < kBK / 16; ++h) {
    const int c = c0 + 16 * h;
    const bool v = in && c < p.C;
    cp_async16(as + tid * kRow + 16 * h, v ? src + c : p.x, v);
  }
#pragma unroll
  for (int j = 0; j < kBK / 32; ++j) {
    const int h = (tid & 1) * (kBK / 32) + j;
    const int c = c0 + 16 * h;
    const bool v = b_ok && c < p.C;
    cp_async16(bs + (tid >> 1) * kRow + 16 * h,
               v ? wrow + tap * p.C + c : p.w, v);
  }
}

// gather loader: K is the flat (kh, kw, c) index; bytes past K are zero.
template <int kBK>
__device__ __forceinline__ void load_gather(const Params& p, const Pixel& px,
                                            const int8_t* wrow, bool b_ok,
                                            int8_t* as, int8_t* bs, int kt,
                                            int tid) {
  constexpr int kRow = kBK + 16;
  const int k0 = kt * kBK;
  uint32_t* arow = reinterpret_cast<uint32_t*>(as + tid * kRow);
#pragma unroll 2
  for (int j = 0; j < kBK; j += 4) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + j + e;
      uint32_t v = 0;
      if (px.ok && k < p.K) {
        const int tap = k / p.C;
        const int c = k - tap * p.C;
        const int kh = tap / p.KW;
        const int kw = tap - kh * p.KW;
        const int ih = px.h0 + kh, iw = px.w0 + kw;
        if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
          v = static_cast<uint8_t>(
              px.img[(static_cast<int64_t>(ih) * p.W + iw) * p.C + c]);
      }
      word |= v << (8 * e);
    }
    arow[j / 4] = word;
  }
  const int half = tid & 1;           // half of the row's BK bytes
  uint32_t* brow = reinterpret_cast<uint32_t*>(bs + (tid >> 1) * kRow +
                                               (kBK / 2) * half);
#pragma unroll
  for (int j = 0; j < kBK / 2; j += 4) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + (kBK / 2) * half + j + e;
      const uint32_t v =
          (b_ok && k < p.K) ? static_cast<uint8_t>(wrow[k]) : 0u;
      word |= v << (8 * e);
    }
    brow[j / 4] = word;
  }
}

template <typename T>
__device__ __forceinline__ void store(void* y, int64_t i, float v);

template <>
__device__ __forceinline__ void store<float>(void* y, int64_t i, float v) {
  static_cast<float*>(y)[i] = v;
}

template <>
__device__ __forceinline__ void store<__nv_bfloat16>(void* y, int64_t i,
                                                     float v) {
  static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
}

// Two adjacent channels i, i + 1 (i even, the output 8-byte aligned for
// f32 and 4-byte aligned for bf16 when the channel count is even).
template <typename T>
__device__ __forceinline__ void store2(void* y, int64_t i, float v0,
                                       float v1);

template <>
__device__ __forceinline__ void store2<float>(void* y, int64_t i, float v0,
                                              float v1) {
  *reinterpret_cast<float2*>(static_cast<float*>(y) + i) =
      make_float2(v0, v1);
}

template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(void* y, int64_t i,
                                                      float v0, float v1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(v0);
  v.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + i) = v;
}

template <typename T>
__device__ __forceinline__ void epilogue(const Params& p, int (&acc)[4][4][4],
                                         int m0, int n0, int wm, int wn,
                                         int g, int t) {
  const float xs = *p.x_s;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wm * 64 + mi * 16 + g + 8 * hf;
      if (m >= p.M) continue;
      const int pq = p.P * p.Q;
      const int n = m / pq;
      const int r = m - n * pq;
      const int pp = r / p.Q;
      const int qq = r - pp * p.Q;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + t * 2;   // even
        if (col >= p.cols) continue;
        int o = col;
        int64_t idx = static_cast<int64_t>(m) * p.cols + col;
        if (p.up2) {
          const int ab = col / p.cout;
          o = col - ab * p.cout;
          const int a = ab >> 1, b = ab & 1;
          idx = ((static_cast<int64_t>(n) * 2 * p.P + 2 * pp + a) * 2 * p.Q +
                 2 * qq + b) * p.cout + o;
        }
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // channel o + e; with an odd cout the pair may cross into the
          // next column block, so each value keeps its own channel
          const int oe = (p.up2 ? (col + e) % p.cout : col + e);
          if (col + e >= p.cols) break;
          const float scale = __fmul_rn(xs, p.w_s[oe]);
          v[e] = __fmul_rn(__int2float_rn(acc[mi][ni][2 * hf + e]), scale);
          if (p.bias != nullptr) v[e] = __fadd_rn(v[e], p.bias[oe]);
        }
        if ((p.cout & 1) == 0) {           // o even, o + 1 < cout: adjacent
          store2<T>(p.y, idx, v[0], v[1]);
          continue;
        }
        store<T>(p.y, idx, v[0]);
        if (col + 1 < p.cols) {
          int64_t idx1 = idx + 1;
          if (p.up2) {
            const int c1 = col + 1, ab = c1 / p.cout, o1 = c1 - ab * p.cout;
            idx1 = ((static_cast<int64_t>(n) * 2 * p.P + 2 * pp + (ab >> 1)) *
                        2 * p.Q + 2 * qq + (ab & 1)) * p.cout + o1;
          }
          store<T>(p.y, idx1, v[1]);
        }
      }
    }
  }
}

template <bool kVec, int kBK, typename T>
__global__ void __launch_bounds__(kThreads)
conv_int8_kernel(const Params p) {
  constexpr int kRow = kBK + 16;       // shared bytes per tile row
  __shared__ __align__(16) int8_t As[kStages][kBM * kRow];
  __shared__ __align__(16) int8_t Bs[kStages][kBN * kRow];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  const Pixel px = pixel_of(p, m0 + tid);
  const int brow = n0 + (tid >> 1);
  const bool b_ok = brow < p.cols;
  const int8_t* wrow = p.w + static_cast<int64_t>(b_ok ? brow : 0) * p.K;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < p.nk) {
      if (kVec)
        load_vec<kBK>(p, px, wrow, b_ok, As[s], Bs[s], s, tid);
      else
        load_gather<kBK>(p, px, wrow, b_ok, As[s], Bs[s], s, tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < p.nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = kt + kStages - 1;
    if (nx < p.nk) {
      const int s = nx % kStages;
      if (kVec)
        load_vec<kBK>(p, px, wrow, b_ok, As[s], Bs[s], nx, tid);
      else
        load_gather<kBK>(p, px, wrow, b_ok, As[s], Bs[s], nx, tid);
    }
    cp_async_commit();

    const int8_t* a = As[kt % kStages];
    const int8_t* b = Bs[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)      // rows +0..7 / +8..15, bytes +0 / +16
        ldmatrix_x4(af[mi], a + (wm * 64 + mi * 16 + (lane & 7) +
                                 8 * ((lane >> 3) & 1)) * kRow +
                                kk + 16 * (lane >> 4));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {    // columns of ni = 2 nj and 2 nj + 1
        uint32_t r[4];
        ldmatrix_x4(r, b + (wn * 32 + nj * 16 + 8 * (lane >> 4) +
                            (lane & 7)) * kRow +
                           kk + 16 * ((lane >> 3) & 1));
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  epilogue<T>(p, acc, m0, n0, wm, wn, g, t);
}

template <bool kVec, int kBK>
void launch(Params p, int KH, dim3 grid, cudaStream_t st) {
  p.cpt = (p.C + kBK - 1) / kBK;
  p.nk = kVec ? KH * p.KW * p.cpt : (p.K + kBK - 1) / kBK;
  if (p.bf16)
    conv_int8_kernel<kVec, kBK, __nv_bfloat16><<<grid, kThreads, 0, st>>>(p);
  else
    conv_int8_kernel<kVec, kBK, float><<<grid, kThreads, 0, st>>>(p);
}

}  // namespace

// Returns 0 or the CUDA error of the launch. vec: the 16-byte loader (the
// wrapper's route; it needs C % 16 == 0 and 16-byte aligned x and w). up2:
// x is the input map of a 2x2 stride-2 transposed conv, w its [4*cout, C]
// GEMM weight (row (a*2 + b) * cout + o), and y the [N, 2H, 2W, cout] map;
// KH = KW = 1, stride 1.
extern "C" int conv_int8(const void* x, const void* w, const void* w_s,
                         const void* x_s, const void* bias, void* y, int N,
                         int H, int W, int C, int KH, int KW, int stride,
                         int pad_h, int pad_w, int P, int Q, int cols,
                         int cout, int vec, int up2, int bf16,
                         void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.w_s = static_cast<const float*>(w_s);
  p.x_s = static_cast<const float*>(x_s);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.H = H;
  p.W = W;
  p.C = C;
  p.KW = KW;
  p.stride = stride;
  p.pad_h = pad_h;
  p.pad_w = pad_w;
  p.P = P;
  p.Q = Q;
  p.cols = cols;
  p.cout = cout;
  p.K = KH * KW * C;
  p.M = N * P * Q;
  p.up2 = up2;
  p.bf16 = bf16;
  if (vec && (C % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(w) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.M == 0 || cols == 0) return 0;
  const dim3 grid((p.M + kBM - 1) / kBM, (cols + kBN - 1) / kBN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!vec)
    launch<false, 32>(p, KH, grid, st);
  else if (C % 64 == 0 && p.K >= 256)
    launch<true, 64>(p, KH, grid, st);
  else
    launch<true, 32>(p, KH, grid, st);
  return static_cast<int>(cudaGetLastError());
}
