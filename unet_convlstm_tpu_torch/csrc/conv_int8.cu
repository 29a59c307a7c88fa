// Int8 implicit-GEMM convolution for Hopper (sm_90a), with the activation
// quantizer in its prologue and the dequant and bias in its epilogue:
//
//   x_q[n, h, w, c] = clamp(rint(x / x_s), -127, 127)   (x float; or given)
//   acc[m, o] = sum_{kh, kw, c} x_q[n, p*s + kh - pad_h, q*s + kw - pad_w, c]
//                               * w_q[o, kh, kw, c]                  (int32)
//   y[m, o]   = float(acc) * (x_s * w_s[o]) + b[o]  in bf16 or f32
//
// x NHWC, either int8 (x_q itself, with its scale x_s) or bf16/f32 with a
// scale on the card: x_s itself (a calibrated static scale) or max|x| in
// x's dtype (dynamic), from which every block forms x_s = amax > 0 ? amax /
// 127 : 1 with IEEE division. w_q OHWI int8 (the OIHW weight in
// channels-last memory), w_s f32 [O] per output channel, b f32 [O] or
// none; m runs over the N*P*Q output pixels, y is NHWC.
//
// Replaces the int8 convolutions of the JAX package's post-training
// quantization, unet_convlstm_tpu/ops/quant.py:215-227 (conv2d_int8) and
// :259-271 (conv_transpose2d_int8): XLA's conv_general_dilated on int8 with
// preferred_element_type=int32, the activation quantize fused into its
// producer by XLA. There is no Pallas kernel behind them, and PyTorch has
// no int8 convolution on CUDA, so this one is written by hand.
//
// Shapes it takes: every conv of the two model families after
// ops/quant.quantize_model: 3x3 SAME stride 1 (Cin 2 to 2,048), 1x1 (outc,
// the resnet downsample at stride 2), the 7x7 stride-2 resnet stem, the 7x7
// attention conv, and the 2x2 stride-2 transposed conv, which is a 1x1 GEMM
// to 4*O columns (column (a*2 + b)*O + o) whose epilogue writes each value
// to output pixel (2p + a, 2q + b) of the 2x map ("up2").
//
// What bounds it on this card: int8 tensor-core operations for the deep
// convs (2*M*N*K over 1,979 TOP/s dense), device-memory bytes (x read once
// in its own dtype, w_q once, y written once, over 3.35 TB/s) for the wide,
// shallow maps. Two routes, picked by the wrapper's planner from the shape
// alone (ops/kernels/conv_int8.plan):
//
// * "wgmma" (Cin % 16 == 0, Cout % 8 == 0, K >= 32): K2's skeleton
//   (csrc/conv3x3_fused.cu). A block computes a 128-pixel by BN-column tile
//   (BN 32, 64 or 128) with two warpgroups of wgmma.mma_async m64nBNk32
//   .s32.s8.s8, int32 accumulators in registers, both operands K-major in
//   swizzled shared memory (the swizzle follows BK's bytes: 128, 64 or 32).
//   K is the flat (kh, kw, c) index in chunks of BK bytes; each 16-byte
//   vector of a chunk finds its own tap (a vector never straddles one, as
//   Cin % 16 == 0), so Cin 16 or 48 cost no padding but the last chunk's.
//   Weight tiles of the [cols, K] matrix come by TMA (cp.async.bulk.tensor,
//   zero-filled past cols and K) with an mbarrier per stage; x rows come by
//   16-byte cp.async, zero-filled outside the image and past M and K. An
//   int8 x is staged straight into the swizzled s8 tile. A float x is
//   staged into a float ring (2x or 4x the s8 tile's bytes), and each
//   thread quantizes the vectors it staged into one of two s8 tiles as
//   clamp(rint(RN(x / x_s)), -127, 127), round half to even (torch.round's
//   rule), so the int8 activation never reaches device memory: x times the
//   correctly rounded 1 / x_s, rounded by adding 1.5 * 2^23, exact wherever
//   the product lies at least 2^-12 from a rounding midpoint (its error is
//   below 2^-15), and where a vector has a value that close (or a NaN) it
//   is quantized again with __fdiv_rn and __float2int_rn. Zero-filled
//   (halo) vectors quantize to 0, so SAME padding stays exact. Each thread
//   then fences the async proxy before wgmma reads the tile. The
//   loads of the next stages overlap the products of the current one.
//   A 3x3 stride-1 conv of a float x runs the halo mode (HaloCfg below):
//   each channel block's pixels are quantized once for its 9 taps and
//   copied into the tile per tap.
//   Where the output tiles are fewer than the SMs, K is split over blocks
//   (grid z): each split writes int32 partials to a workspace and
//   conv_int8_splitk_reduce adds them. Integer sums are exact in any order,
//   so the result is bit-equal with or without a split. The epilogue
//   stages y in shared memory and writes it with 16-byte stores.
// * "vec" / "gather" (the first design; Cin % 16 != 0, Cout % 8 != 0, K <
//   32): a block computes a 128 x 64 tile with four warps of mma.sync
//   m16n8k32 s8 x s8 -> s32, K in steps of 64 or 32 bytes through a
//   3-stage ring. "vec" (Cin % 16 == 0) stages a step as one tap and BK
//   channels by 16-byte cp.async (an int8 x) or by 16-byte loads quantized
//   in registers (a float x); "gather" (any other Cin: the 2-channel input,
//   the 7x7 stem) walks the flat (kh, kw, c) index byte by byte, quantizing
//   a float x element by element.
//
// Both routes convert the exact int32 with round-to-nearest and apply the
// scale and the bias as two separately rounded f32 operations (__fmul_rn,
// __fadd_rn: no fused multiply-add), as the plain version and XLA do, so
// f32 and bf16 outputs are bit-equal to the plain version's on finite
// inputs. Non-finite inputs: a NaN quantizes to 0 (cvt.rni of NaN), +-inf
// to +-127; a NaN or inf max|x| gives x_s = 1 (NaN) or inf, as the plain
// version's where(amax > 0) does. |acc| <= 18,432 * 127^2 < 2^31 at the
// widest conv (3x3 x 2,048 channels).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// error codes beside cudaError_t's (which are positive)
constexpr int ERR_NO_ENCODER = -1;   // no cuTensorMapEncodeTiled in the driver
constexpr int ERR_ENCODE = -2;       // the weight's tensor map was refused
constexpr int ERR_PLAN = -3;         // a tile the source does not instantiate

enum Route { ROUTE_WGMMA = 0, ROUTE_VEC = 1, ROUTE_GATHER = 2 };
enum XType { X_S8 = 0, X_BF16 = 1, X_F32 = 2 };

struct Params {
  const void* x;
  const int8_t* w;
  const float* w_s;
  const void* scale;   // x_s (f32), or max|x| in x's dtype
  int scale_mode;      // 0: x_s; 1: max|x| bf16; 2: max|x| f32
  const float* bias;   // may be null
  void* y;
  int* ws;             // split-K partials [splits, M, cols]
  int H, W, C;         // input map
  int KW, stride, pad_h, pad_w;
  int P, Q;            // output map (up2: the input map)
  int cols;            // GEMM columns: O, or 4*O for up2
  int cout;            // channels of y
  int K;               // KH*KW*C
  int M;               // N*P*Q
  int nk;              // generic route: K steps
  int cpt;             // generic vec loader: BK-channel steps per tap
  int splits;
  int up2;
  int out_bf16;
};

// x_s on the card: given, or max|x| > 0 ? max|x| / 127 : 1 (IEEE division)
__device__ __forceinline__ float x_scale(const Params& p) {
  if (p.scale_mode == 0) return *static_cast<const float*>(p.scale);
  const float a = p.scale_mode == 1
                      ? __bfloat162float(*static_cast<const bf16*>(p.scale))
                      : *static_cast<const float*>(p.scale);
  return a > 0.0f ? __fdiv_rn(a, 127.0f) : 1.0f;
}

// clamp(rint(x / x_s), -127, 127): one IEEE division, round half to even
__device__ __forceinline__ uint32_t quant1(float x, float xs) {
  const int v = __float2int_rn(__fdiv_rn(x, xs));
  return static_cast<uint32_t>(max(-127, min(127, v))) & 0xffu;
}

// The activation quantizer of a launch: x_s, its reciprocal (correctly
// rounded) and whether the fast path holds for it (x_s and 1 / x_s normal).
struct Quant {
  float xs, inv;
  bool fast;
};

__device__ __forceinline__ Quant make_quant(const Params& p) {
  Quant q;
  q.xs = x_scale(p);
  q.inv = __frcp_rn(q.xs);
  q.fast = q.xs >= 1e-30f && q.xs <= 1e30f;
  return q;
}

// The fast path: c = clamp(x * (1/x_s), -127, 127) (NaN kept), rounded to
// an integer half to even by adding 1.5 * 2^23, whose low byte is then the
// s8 value. |x * (1/x_s) - RN(x / x_s)| < 2^-15 wherever |c| < 127, so
// wherever c lies at least 2^-12 from a rounding midpoint its integer is
// rint(RN(x / x_s)), and where it is clamped so is RN(x / x_s). `err`
// collects |c - rint(c)| (NaN if c is): a vector whose err reaches 0.5 -
// 2^-12 takes the exact path.
constexpr float kRound = 12582912.0f;          // 1.5 * 2^23
constexpr float kMidpointGuard = 0.5f - 1.0f / 4096.0f;

__device__ __forceinline__ uint32_t quant_fast(float x, float inv,
                                               float& err) {
  float c;
  asm("max.NaN.f32 %0, %1, 0fC2FE0000;\n" : "=f"(c) : "f"(__fmul_rn(x, inv)));
  asm("min.NaN.f32 %0, %0, 0f42FE0000;\n" : "+f"(c));
  const float t = __fadd_rn(c, kRound);
  const float e = fabsf(__fsub_rn(c, __fsub_rn(t, kRound)));
  asm("max.NaN.f32 %0, %0, %1;\n" : "+f"(err) : "f"(e));
  return __float_as_uint(t);
}

// the low bytes of four words, in order
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// n floats -> n s8 values packed 4 to a word: the fast path, or the exact
// one where a value lies near a rounding midpoint or is not finite
template <int N>
__device__ __forceinline__ void quant_n(const float (&f)[N], const Quant& q,
                                        uint32_t (&out)[N / 4]) {
  uint32_t t[N];
  float err = 0.0f;
  if (q.fast) {
#pragma unroll
    for (int e = 0; e < N; ++e) t[e] = quant_fast(f[e], q.inv, err);
  }
  if (!q.fast || !(err < kMidpointGuard)) {
#pragma unroll
    for (int e = 0; e < N; ++e) t[e] = quant1(f[e], q.xs);
  }
#pragma unroll
  for (int w = 0; w < N / 4; ++w)
    out[w] = pack4(t[4 * w], t[4 * w + 1], t[4 * w + 2], t[4 * w + 3]);
}

// one 16-byte vector of x (8 bf16 or 4 f32) -> its 8 or 4 s8 values
__device__ __forceinline__ uint2 quant_vec(const uint4& v, const Quant& q,
                                           const bf16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {       // bf16 -> f32: the high half-word
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  uint32_t out[2];
  quant_n<8>(f, q, out);
  return make_uint2(out[0], out[1]);
}
__device__ __forceinline__ uint32_t quant_vec(const uint4& v, const Quant& q,
                                              const float*) {
  const float f[4] = {__uint_as_float(v.x), __uint_as_float(v.y),
                      __uint_as_float(v.z), __uint_as_float(v.w)};
  uint32_t out[1];
  quant_n<4>(f, q, out);
  return out[0];
}

// 16 channels of a float x from global memory -> 16 s8 values
template <typename TX>
__device__ __forceinline__ uint4 quant16(const TX* src, const Quant& q) {
  constexpr int kVecs = sizeof(TX);     // 16-byte loads for 16 channels
  uint32_t out[4];
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const uint4 v = __ldg(s + u);
    if constexpr (sizeof(TX) == 2) {
      const uint2 w = quant_vec(v, q, static_cast<const bf16*>(nullptr));
      out[2 * u] = w.x;
      out[2 * u + 1] = w.y;
    } else {
      out[u] = quant_vec(v, q, static_cast<const float*>(nullptr));
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// one element of x as an s8 byte
__device__ __forceinline__ uint32_t x_byte(const int8_t* x, int64_t i,
                                           const Quant&) {
  return static_cast<uint8_t>(x[i]);
}
__device__ __forceinline__ uint32_t x_byte(const bf16* x, int64_t i,
                                           const Quant& q) {
  return quant1(__bfloat162float(x[i]), q.xs);
}
__device__ __forceinline__ uint32_t x_byte(const float* x, int64_t i,
                                           const Quant& q) {
  return quant1(x[i], q.xs);
}

// y's element offset of GEMM row m, column col: NHWC, or for up2 the
// pixel (2p + a, 2q + b) of column (a*2 + b)*cout + o
__device__ __forceinline__ int64_t out_index(const Params& p, int m,
                                             int col) {
  if (!p.up2) return static_cast<int64_t>(m) * p.cols + col;
  const int pq = p.P * p.Q;
  const int n = m / pq;
  const int r = m - n * pq;
  const int pp = r / p.Q;
  const int qq = r - pp * p.Q;
  const int ab = col / p.cout;
  const int o = col - ab * p.cout;
  return ((static_cast<int64_t>(n) * 2 * p.P + 2 * pp + (ab >> 1)) * 2 *
              p.Q + 2 * qq + (ab & 1)) * p.cout + o;
}

// float(acc) * (x_s * w_s[o]) + b[o], each a separately rounded operation
__device__ __forceinline__ float dequant(const Params& p, int acc, int o,
                                         float xs) {
  const float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(xs, p.w_s[o]));
  return p.bias != nullptr ? __fadd_rn(v, p.bias[o]) : v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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

// ===========================================================================
// The generic route (the first design): mma.sync m16n8k32
// ===========================================================================

namespace generic {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kStages = 3;
constexpr int kThreads = 128;

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(smem)));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output pixel's input origin: its image's element offset and the
// top-left tap.
struct Pixel {
  int64_t img;
  int h0, w0;
  bool ok;
};

__device__ __forceinline__ Pixel pixel_of(const Params& p, int m) {
  Pixel px{0, 0, 0, m < p.M};
  if (px.ok) {
    const int pq = p.P * p.Q;
    const int n = m / pq;
    const int r = m - n * pq;
    const int pp = r / p.Q;
    const int qq = r - pp * p.Q;
    px.img = static_cast<int64_t>(n) * p.H * p.W * p.C;
    px.h0 = pp * p.stride - p.pad_h;
    px.w0 = qq * p.stride - p.pad_w;
  }
  return px;
}

// vec loader: step kt is tap kt / cpt, channels (kt % cpt) * BK + [0, BK).
// Thread tid stages the BK / 16 chunks of 16 bytes of A row tid and half
// (tid & 1) of B row tid >> 1. An int8 x goes by cp.async; a float x is
// loaded and quantized in registers.
template <int kBK, typename TX>
__device__ __forceinline__ void load_vec(const Params& p, const Pixel& px,
                                         const int8_t* wrow, bool b_ok,
                                         int8_t* as, int8_t* bs, int kt,
                                         int tid, const Quant& q) {
  constexpr int kRow = kBK + 16;
  const TX* x = static_cast<const TX*>(p.x);
  const int tap = kt / p.cpt;
  const int c0 = (kt - tap * p.cpt) * kBK;
  const int kh = tap / p.KW;
  const int kw = tap - kh * p.KW;
  const int ih = px.h0 + kh, iw = px.w0 + kw;
  const bool in = px.ok && ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
  const TX* src =
      in ? x + px.img + (static_cast<int64_t>(ih) * p.W + iw) * p.C : x;
#pragma unroll
  for (int h = 0; h < kBK / 16; ++h) {
    const int c = c0 + 16 * h;
    const bool v = in && c < p.C;
    int8_t* dst = as + tid * kRow + 16 * h;
    if constexpr (sizeof(TX) == 1) {
      cp_async16(smem_u32(dst), v ? src + c : x, v);
    } else {
      *reinterpret_cast<uint4*>(dst) =
          v ? quant16(src + c, q) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int j = 0; j < kBK / 32; ++j) {
    const int h = (tid & 1) * (kBK / 32) + j;
    const int c = c0 + 16 * h;
    const bool v = b_ok && c < p.C;
    cp_async16(smem_u32(bs + (tid >> 1) * kRow + 16 * h),
               v ? wrow + tap * p.C + c : p.w, v);
  }
}

// gather loader: K is the flat (kh, kw, c) index; bytes past K are zero.
template <int kBK, typename TX>
__device__ __forceinline__ void load_gather(const Params& p, const Pixel& px,
                                            const int8_t* wrow, bool b_ok,
                                            int8_t* as, int8_t* bs, int kt,
                                            int tid, const Quant& q) {
  constexpr int kRow = kBK + 16;
  const TX* x = static_cast<const TX*>(p.x);
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
          v = x_byte(x, px.img + (static_cast<int64_t>(ih) * p.W + iw) *
                                     p.C + c, q);
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
__device__ __forceinline__ void store<bf16>(void* y, int64_t i, float v) {
  static_cast<bf16*>(y)[i] = __float2bfloat16_rn(v);
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
__device__ __forceinline__ void store2<bf16>(void* y, int64_t i, float v0,
                                             float v1) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16_rn(v0);
  v.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(y) + i) = v;
}

template <typename T>
__device__ __forceinline__ void epilogue(const Params& p, int (&acc)[4][4][4],
                                         int m0, int n0, int wm, int wn,
                                         int g, int t, float xs) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wm * 64 + mi * 16 + g + 8 * hf;
      if (m >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + t * 2;   // even
        if (col >= p.cols) continue;
        const int64_t idx = out_index(p, m, col);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // channel o + e; with an odd cout the pair may cross into the
          // next column block, so each value keeps its own channel
          const int oe = (p.up2 ? (col + e) % p.cout : col + e);
          if (col + e >= p.cols) break;
          v[e] = dequant(p, acc[mi][ni][2 * hf + e], oe, xs);
        }
        if ((p.cout & 1) == 0) {           // o even, o + 1 < cout: adjacent
          store2<T>(p.y, idx, v[0], v[1]);
          continue;
        }
        store<T>(p.y, idx, v[0]);
        if (col + 1 < p.cols) store<T>(p.y, out_index(p, m, col + 1), v[1]);
      }
    }
  }
}

template <bool kVec, int kBK, typename T, typename TX>
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
  const Quant q = make_quant(p);

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
        load_vec<kBK, TX>(p, px, wrow, b_ok, As[s], Bs[s], s, tid, q);
      else
        load_gather<kBK, TX>(p, px, wrow, b_ok, As[s], Bs[s], s, tid, q);
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
        load_vec<kBK, TX>(p, px, wrow, b_ok, As[s], Bs[s], nx, tid, q);
      else
        load_gather<kBK, TX>(p, px, wrow, b_ok, As[s], Bs[s], nx, tid, q);
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

  epilogue<T>(p, acc, m0, n0, wm, wn, g, t, q.xs);
}

template <bool kVec, int kBK, typename TX>
void launch(Params p, int KH, cudaStream_t st) {
  p.cpt = (p.C + kBK - 1) / kBK;
  p.nk = kVec ? KH * p.KW * p.cpt : (p.K + kBK - 1) / kBK;
  const dim3 grid((p.M + kBM - 1) / kBM, (p.cols + kBN - 1) / kBN);
  if (p.out_bf16)
    conv_int8_kernel<kVec, kBK, bf16, TX><<<grid, kThreads, 0, st>>>(p);
  else
    conv_int8_kernel<kVec, kBK, float, TX><<<grid, kThreads, 0, st>>>(p);
}

template <typename TX>
void dispatch(const Params& p, int KH, int route, int bk, cudaStream_t st) {
  if (route == ROUTE_GATHER)
    launch<false, 32, TX>(p, KH, st);
  else if (bk == 64)
    launch<true, 64, TX>(p, KH, st);
  else
    launch<true, 32, TX>(p, KH, st);
}

}  // namespace generic

// ===========================================================================
// The wgmma route: s8 wgmma fed by a TMA ring, the quantizer in its prologue
// ===========================================================================

namespace hopper {

constexpr int THREADS = 256;   // every thread loads; each warpgroup multiplies
constexpr int BAR_BYTES = 64;  // the stages' mbarriers
constexpr int PIPE_BUDGET = 96 * 1024;  // ring bytes: two blocks an SM
constexpr int REDUCE_THREADS = 256;

// A block computes BM pixels by BN columns with two warpgroups: BM = 128
// stacks them along the pixels (each m64 x BN), BM = 64 (the wide tile of a
// float x: it quantizes half the rows for twice the columns) side by side
// along the columns (each m64 x BN/2).
template <int BM, int BN, int BK, typename TX>
struct Cfg {
  static constexpr int BM_ = BM, BN_ = BN;
  static constexpr int WG_M = BM / 64;           // warpgroups along pixels
  static constexpr int WN = BN * WG_M / 2;       // columns a warpgroup
  static constexpr bool QUANT = sizeof(TX) > 1;   // a float x, quantized here
  static constexpr int ESZ = sizeof(TX);
  static constexpr int FROW = BK * ESZ;          // staged bytes of a row
  static constexpr int FVPR = FROW / 16;         // 16-byte vectors a row
  static constexpr int RPP = THREADS / FVPR;     // rows a pass of the block
  static constexpr int A_VECS = BM / RPP;        // vectors a thread a chunk
  static constexpr int CH_PER_VEC = 16 / ESZ;    // channels a vector
  static constexpr int A_STAGE = BM * FROW;
  static constexpr int B_STAGE = BN * BK;
  static constexpr int S8_TILE = BM * BK;
  static constexpr int S8_BYTES = QUANT ? 2 * S8_TILE : 0;   // double buffer
  static constexpr int STAGE_BYTES = A_STAGE + B_STAGE;
  static constexpr int FIT = (PIPE_BUDGET - S8_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT < 2 ? 2 : FIT;
  static constexpr int PIPE_BYTES = STAGES * STAGE_BYTES + S8_BYTES;
  // the s8 tile's rows are BK bytes: a 128/64/32-byte swizzle
  static constexpr int SWZ_MASK = BK / 16 - 1;
  static constexpr int SWZ_SHIFT = BK == 128 ? 0 : BK == 64 ? 1 : 2;
  static constexpr int LAYOUT = BK == 128 ? 1 : BK == 64 ? 2 : 3;   // wgmma
  static constexpr int ACC = WN / 2;             // int32 accumulators a thread
  static constexpr int LDY_F32 = BN + 4;         // epilogue tile row stride
  static constexpr int LDY_BF16 = BN + 8;
  static constexpr int EPI_BYTES = BM * LDY_F32 * 4;
  static constexpr int MAIN_BYTES =
      PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
  static_assert(BK == 32 || BK == 64 || BK == 128, "BK");
  static_assert((BM == 128 && (BN == 32 || BN == 64 || BN == 128)) ||
                    (BM == 64 && BN == 256), "tile");
  static_assert(THREADS % FVPR == 0 && BM % RPP == 0 && A_VECS >= 1,
                "A vectors");
  static_assert(A_STAGE % 1024 == 0 && B_STAGE % 1024 == 0 &&
                    S8_TILE % 1024 == 0, "swizzle alignment");
  static_assert(!QUANT || CH_PER_VEC * A_VECS * RPP * FVPR ==
                              BM * BK, "quantized vectors cover the tile");
};

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
// completing its bytes on the mbarrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
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
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// generic-proxy writes to shared memory (cp.async, the quantizer) become
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

// D[64 x N] += A[64 x 32] * B[32 x N], s8 in, s32 accumulators, both
// operands K-major in shared memory
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// The block's accumulators out: int32 partials to the split-K workspace,
// or y, dequantized into a tile in shared memory (the ring's, now free) in
// y's dtype and written with 16-byte stores
template <typename C>
__device__ __forceinline__ void store_tile(const Params& p,
                                           int (&acc)[C::ACC], uint8_t* smem,
                                           int m0, int n0, int wg_m, int wg_n,
                                           float xs) {
  constexpr int BM = C::BM_, BN = C::BN_;
  const int tid = threadIdx.x;
  // accumulator fragment: rows wg_m*64 + warp*16 + lane/4 (+8), columns
  // wg_n*WN + 8*q + 2*(lane%4) (+1) for q < WN/8
  const int lane = tid % 32;
  const int row0 = wg_m * 64 + (tid / 32 % 4) * 16 + lane / 4;
  const int colq = wg_n * C::WN + 2 * (lane % 4);

  if (p.splits > 1) {
    // int32 partials of this split; the reduce pass finishes them
    int* wz = p.ws + (int64_t)blockIdx.z * p.M * p.cols;
#pragma unroll
    for (int q = 0; q < C::WN / 8; ++q) {
      const int col = n0 + 8 * q + colq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row0 + 8 * h;
        if (m < p.M && col < p.cols)
          *reinterpret_cast<int2*>(wz + (int64_t)m * p.cols + col) =
              make_int2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
      }
    }
    return;
  }

  // dequantized y into a tile in shared memory, in y's dtype
#pragma unroll
  for (int q = 0; q < C::WN / 8; ++q) {
    const int col = n0 + 8 * q + colq;
    if (col >= p.cols) continue;           // cols % 8 == 0: whole pairs
    const int o = p.up2 ? col % p.cout : col;   // o + 1 in the same group
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const float v0 = dequant(p, acc[4 * q + 2 * h], o, xs);
      const float v1 = dequant(p, acc[4 * q + 2 * h + 1], o + 1, xs);
      if (p.out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(
            reinterpret_cast<bf16*>(smem) + r * C::LDY_BF16 + 8 * q + colq) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(smem) +
                                   r * C::LDY_F32 + 8 * q + colq) =
            make_float2(v0, v1);
    }
  }
  __syncthreads();
  // 16-byte stores: 8 bf16 or 4 f32 channels a vector
  const int ve = p.out_bf16 ? 8 : 4;
  const int cgs = BN / ve;
  const int cg = tid % cgs, rg = tid / cgs, groups = THREADS / cgs;
  const int col = n0 + ve * cg;
  if (col < p.cols) {
    const int esz = p.out_bf16 ? 2 : 4;
    const int ldy = p.out_bf16 ? C::LDY_BF16 : C::LDY_F32;
    for (int r = rg; r < BM && m0 + r < p.M; r += groups) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          smem + (r * ldy + ve * cg) * esz);
      *reinterpret_cast<uint4*>(static_cast<uint8_t*>(p.y) +
                                out_index(p, m0 + r, col) * esz) = v;
    }
  }
}

template <int BM, int BN, int BK, typename TX>
__global__ void __launch_bounds__(THREADS, 2)
conv_int8_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                       const Params p) {
  using C = Cfg<BM, BN, BK, TX>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle's period
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t a_base = smem_u32(smem);
  const uint32_t b_base = a_base + C::STAGES * C::A_STAGE;
  const uint32_t q_base = b_base + C::STAGES * C::B_STAGE;   // s8 tiles
  const uint32_t bar_base = a_base + C::MAIN_BYTES;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk_all = (p.K + BK - 1) / BK;
  const int kb = (int)((long long)blockIdx.z * nk_all / p.splits);
  const int nk = (int)((long long)(blockIdx.z + 1) * nk_all / p.splits) - kb;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) mbar_init(bar_base + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Quant qz = make_quant(p);
  const float xs = qz.xs;
  const TX* x = static_cast<const TX*>(p.x);

  // the pixel rows this thread stages: row r = tid / FVPR + i * RPP of the
  // tile, vector fv of the row; rows beyond M lie far outside the image
  const int fv = tid % C::FVPR;
  int pb[C::A_VECS], ph[C::A_VECS], pw[C::A_VECS];
  const int pq = p.P * p.Q;
#pragma unroll
  for (int i = 0; i < C::A_VECS; ++i) {
    const int m = m0 + tid / C::FVPR + i * C::RPP;
    const int n = m / pq;
    const int r = m - n * pq;
    const int pp = r / p.Q;
    pb[i] = n * p.H * p.W;
    ph[i] = m < p.M ? pp * p.stride - p.pad_h : -(1 << 28);
    pw[i] = (r - pp * p.Q) * p.stride - p.pad_w;
  }
  auto row_of = [&](int i) { return tid / C::FVPR + i * C::RPP; };
  // byte offset of vector i in a stage's A ring slot: the swizzled s8 tile
  // for an int8 x, a thread-major float layout for a float x (each thread
  // reads back only what it staged)
  auto a_off = [&](int i) {
    if constexpr (C::QUANT) {
      return (i * THREADS + tid) * 16;
    } else {
      const int r = row_of(i);
      return r * BK + ((fv ^ ((r >> C::SWZ_SHIFT) & C::SWZ_MASK)) << 4);
    }
  };

  auto load_chunk = [&](int c, int stage) {
    const int k = c * BK + fv * C::CH_PER_VEC;   // this thread's flat K
    const bool kin = k < p.K;
    const int tap = kin ? k / p.C : 0;
    const int ci = k - tap * p.C;
    const int kh = tap / p.KW;
    const int kw = tap - kh * p.KW;
    const uint32_t a_st = a_base + stage * C::A_STAGE;
#pragma unroll
    for (int i = 0; i < C::A_VECS; ++i) {
      const int ih = ph[i] + kh, iw = pw[i] + kw;
      const bool ok =
          kin && (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W;
      const TX* src = ok ? x + ((int64_t)(pb[i] + ih * p.W + iw) * p.C + ci)
                         : x;
      cp_async16(a_st + a_off(i), src, ok);
    }
    if (tid == 0) {
      const uint32_t bar = bar_base + 8 * stage;
      mbar_expect_tx(bar, C::B_STAGE);
      tma_load_2d(b_base + stage * C::B_STAGE, &wmap, bar, c * BK, n0);
    }
  };

  // the vectors this thread staged of a landed chunk -> s8 tile `buf`:
  // clamp(rint(x / x_s)); zero-filled vectors give 0
  auto quantize_chunk = [&](int stage, int buf) {
    if constexpr (C::QUANT) {
      const uint8_t* st = smem + stage * C::A_STAGE;
      uint8_t* q = smem + (q_base - a_base) + buf * C::S8_TILE;
      const int off = fv * C::CH_PER_VEC;        // s8 bytes into the row
      const int unit = off >> 4, within = off & 15;
#pragma unroll
      for (int i = 0; i < C::A_VECS; ++i) {
        const int r = row_of(i);
        const uint4 v = *reinterpret_cast<const uint4*>(st + a_off(i));
        uint8_t* dst = q + r * BK +
                       ((unit ^ ((r >> C::SWZ_SHIFT) & C::SWZ_MASK)) << 4) +
                       within;
        if constexpr (sizeof(TX) == 2)
          *reinterpret_cast<uint2*>(dst) =
              quant_vec(v, qz, static_cast<const bf16*>(nullptr));
        else
          *reinterpret_cast<uint32_t*>(dst) =
              quant_vec(v, qz, static_cast<const float*>(nullptr));
      }
    }
  };

  const int wg = tid / 128;
  const int wg_m = wg % C::WG_M, wg_n = wg / C::WG_M;   // the tile's part
  int acc[C::ACC];
#pragma unroll
  for (int q = 0; q < C::ACC; ++q) acc[q] = 0;

  // chunk i lives in ring stage i % STAGES, STAGES - 1 chunks ahead of the
  // products; a float x's chunk i is quantized into s8 tile i % 2
#pragma unroll
  for (int i = 0; i < C::STAGES - 1; ++i) {
    if (i < nk) load_chunk(kb + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    const int stage = i % C::STAGES;
    cp_async_wait<C::STAGES - 2>();              // this thread's A of chunk i
    quantize_chunk(stage, i & 1);
    fence_async_shared();
    mbar_wait(bar_base + 8 * stage, (i / C::STAGES) & 1);   // B of chunk i
    wgmma_wait<0>();      // this warpgroup's products of chunk i - 1
    fence_operands(acc);
    __syncthreads();      // both warpgroups': stage (i - 1) % STAGES is free
    const int next = i + C::STAGES - 1;
    if (next < nk) load_chunk(kb + next, next % C::STAGES);
    cp_async_commit();
    wgmma_fence();
    const uint32_t a_tile = C::QUANT ? q_base + (i & 1) * C::S8_TILE
                                     : a_base + stage * C::A_STAGE;
    const uint64_t da =
        make_desc(a_tile + wg_m * 64 * BK, C::LAYOUT, 8 * BK);
    const uint64_t db = make_desc(
        b_base + stage * C::B_STAGE + wg_n * C::WN * BK, C::LAYOUT, 8 * BK);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)   // 32 bytes further along the row
      Wgmma<C::WN>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);
  cp_async_wait<0>();
  __syncthreads();        // the ring's memory is the epilogue's now

  store_tile<C>(p, acc, smem, m0, n0, wg_m, wg_n, xs);
}

// The halo mode of the wgmma route (a 3x3 stride-1 SAME conv of a float x,
// Cin % BK == 0): the K chunks run channel block by channel block, the 9
// taps of a block in turn. Per channel block, the block stages and
// quantizes once the contiguous run of input pixels its BM output pixels'
// taps read, [m0 - W - 1, m0 + BM + W + 1) (stride 1: an input pixel's
// linear index is an output pixel's), into an s8 halo in shared memory;
// for each tap it copies the rows it needs from the halo into the swizzled
// s8 tile with 16-byte shared-memory moves, zeroing those whose tap lies
// outside the image (SAME padding; a row of the halo may hold the
// neighbouring image row's pixel there). Each activation is quantized
// (BM + 2W + 2) / BM times per column tile instead of 9. The next channel
// block's halo is loaded while the 9 taps of this one multiply.
template <int BM, int BN, int BK, typename TX>
struct HaloCfg {
  static constexpr int ESZ = sizeof(TX);
  static constexpr int FVPR = BK * ESZ / 16;     // 16-byte vectors a row of x
  static constexpr int RPP = THREADS / FVPR;     // halo rows a pass
  static constexpr int CH_PER_VEC = 16 / ESZ;
  static constexpr int UPR = BK / 16;            // 16-byte units an s8 row
  static constexpr int CRPP = THREADS / UPR;     // copied rows a pass
  static constexpr int C_VECS = (BM + CRPP - 1) / CRPP;   // copies a tap
  static constexpr int A_TILE = BM * BK;         // two s8 tiles
  static constexpr int B_STAGE = BN * BK;
  static constexpr int STAGES = BN == 256 ? 3 : 4;
  static constexpr int FIXED = 2 * A_TILE + STAGES * B_STAGE;   // then halos
  static_assert(ESZ > 1 && (BM % CRPP == 0 || CRPP % BM == 0), "halo");
  static_assert(FIXED % 1024 == 0 && B_STAGE % 1024 == 0, "alignment");
  // halo rows, padded to whole passes; shared bytes of the main phase
  __host__ __device__ static int rows(int W) {
    return (BM + 2 * W + 2 + RPP - 1) / RPP * RPP;
  }
  __host__ __device__ static int main_bytes(int W) {
    const int pipe = FIXED + rows(W) * BK * (1 + ESZ);
    const int epi = Cfg<BM, BN, BK, TX>::EPI_BYTES;
    return pipe > epi ? pipe : epi;
  }
};

template <int BM, int BN, int BK, typename TX>
__global__ void __launch_bounds__(THREADS, 2)
conv_int8_halo_kernel(const __grid_constant__ CUtensorMap wmap,
                      const Params p) {
  using C = Cfg<BM, BN, BK, TX>;
  using H = HaloCfg<BM, BN, BK, TX>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t a_base = smem_u32(smem);
  const uint32_t b_base = a_base + 2 * H::A_TILE;
  const int hrows = H::rows(p.W);
  uint8_t* halo = smem + H::FIXED;                 // s8 [hrows][BK]
  uint8_t* fhalo = halo + hrows * BK;              // x, thread-major
  const uint32_t bar_base = a_base + H::main_bytes(p.W);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ncb_all = p.C / BK;                    // channel blocks
  const int cb0 = (int)((long long)blockIdx.z * ncb_all / p.splits);
  const int nk =
      9 * ((int)((long long)(blockIdx.z + 1) * ncb_all / p.splits) - cb0);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < H::STAGES; ++s) mbar_init(bar_base + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Quant qz = make_quant(p);
  const TX* x = static_cast<const TX*>(p.x);

  // halo row hr = tid / FVPR + j * RPP, vector fv: input pixel m0 - W - 1 +
  // hr, zero where it lies outside [0, M) or past the rows the taps read
  const int fv = tid % H::FVPR;
  const int passes = hrows / H::RPP;
  const int hr_end = BM + 2 * p.W + 2;
  auto load_halo = [&](int cb) {
    for (int j = 0; j < passes; ++j) {
      const int hr = tid / H::FVPR + j * H::RPP;
      const int pix = m0 - p.W - 1 + hr;
      const bool ok = hr < hr_end && pix >= 0 && pix < p.M;
      const TX* src =
          ok ? x + ((int64_t)pix * p.C + cb * BK + fv * H::CH_PER_VEC) : x;
      cp_async16(smem_u32(fhalo) + (j * THREADS + tid) * 16, src, ok);
    }
  };
  auto quantize_halo = [&]() {
    for (int j = 0; j < passes; ++j) {
      const int hr = tid / H::FVPR + j * H::RPP;
      const uint4 v =
          *reinterpret_cast<const uint4*>(fhalo + (j * THREADS + tid) * 16);
      uint8_t* dst = halo + hr * BK + fv * H::CH_PER_VEC;
      if constexpr (sizeof(TX) == 2)
        *reinterpret_cast<uint2*>(dst) =
            quant_vec(v, qz, static_cast<const bf16*>(nullptr));
      else
        *reinterpret_cast<uint32_t*>(dst) =
            quant_vec(v, qz, static_cast<const float*>(nullptr));
    }
  };
  // the tile rows this thread copies: r = tid / UPR + k * CRPP < BM, unit
  // u; (p - 1, q - 1) of each, rows beyond M far outside the image
  const int u = tid % H::UPR;
  int cph[H::C_VECS], cpw[H::C_VECS];
  const int hw = p.H * p.W;
#pragma unroll
  for (int k = 0; k < H::C_VECS; ++k) {
    const int m = m0 + tid / H::UPR + k * H::CRPP;
    const int rem = m - (m / hw) * hw;
    const int pp = rem / p.W;
    cph[k] = m < p.M ? pp - 1 : -(1 << 28);
    cpw[k] = rem - pp * p.W - 1;
  }
  auto copy_tap = [&](int tap, int buf) {
    const int kh = tap / 3, kw = tap - 3 * (tap / 3);
    uint8_t* a = smem + buf * H::A_TILE;
#pragma unroll
    for (int k = 0; k < H::C_VECS; ++k) {
      const int r = tid / H::UPR + k * H::CRPP;
      if (r >= BM) break;
      const bool ok = (unsigned)(cph[k] + kh) < (unsigned)p.H &&
                      (unsigned)(cpw[k] + kw) < (unsigned)p.W;
      const uint4 v =
          ok ? *reinterpret_cast<const uint4*>(
                   halo + (r + kh * p.W + kw) * BK + u * 16)
             : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(
          a + r * BK + ((u ^ ((r >> C::SWZ_SHIFT) & C::SWZ_MASK)) << 4)) = v;
    }
  };
  // chunk i: channel block cb0 + i / 9, tap i % 9, B ring stage i % STAGES
  auto load_b = [&](int i) {
    if (tid == 0) {
      const int stage = i % H::STAGES;
      const uint32_t bar = bar_base + 8 * stage;
      mbar_expect_tx(bar, H::B_STAGE);
      tma_load_2d(b_base + stage * H::B_STAGE, &wmap, bar,
                  (i % 9) * p.C + (cb0 + i / 9) * BK, n0);
    }
  };

  const int wg = tid / 128;
  const int wg_m = wg % C::WG_M, wg_n = wg / C::WG_M;
  int acc[C::ACC];
#pragma unroll
  for (int q = 0; q < C::ACC; ++q) acc[q] = 0;

  if (nk > 0) load_halo(cb0);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < H::STAGES - 1; ++i)
    if (i < nk) load_b(i);
  for (int i = 0; i < nk; ++i) {
    const int tap = i % 9;
    if (tap == 0) {
      cp_async_wait<0>();     // this thread's x of the channel block
      quantize_halo();
      __syncthreads();        // the halo whole; the last block's copies done
      if (i + 9 < nk) load_halo(cb0 + i / 9 + 1);
      cp_async_commit();
    }
    copy_tap(tap, i & 1);
    fence_async_shared();
    const int stage = i % H::STAGES;
    mbar_wait(bar_base + 8 * stage, (i / H::STAGES) & 1);   // B of chunk i
    wgmma_wait<0>();          // this warpgroup's products of chunk i - 1
    fence_operands(acc);
    __syncthreads();          // s8 tile i % 2 whole; stage (i-1) % S free
    if (i + H::STAGES - 1 < nk) load_b(i + H::STAGES - 1);
    wgmma_fence();
    const uint64_t da = make_desc(
        a_base + (i & 1) * H::A_TILE + wg_m * 64 * BK, C::LAYOUT, 8 * BK);
    const uint64_t db = make_desc(
        b_base + stage * H::B_STAGE + wg_n * C::WN * BK, C::LAYOUT, 8 * BK);
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      Wgmma<C::WN>::mma(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);
  cp_async_wait<0>();
  __syncthreads();
  store_tile<C>(p, acc, smem, m0, n0, wg_m, wg_n, qz.xs);
}

// y = dequant(sum over splits of the int32 partials): one thread takes 8
// columns of one row, 16-byte loads and stores
__global__ void __launch_bounds__(REDUCE_THREADS)
conv_int8_splitk_reduce_kernel(const Params p) {
  const int groups = p.cols / 8;
  const int64_t t = (int64_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (t >= (int64_t)p.M * groups) return;
  const int m = (int)(t / groups);
  const int col = (int)(t - (int64_t)m * groups) * 8;
  const int64_t plane = (int64_t)p.M * p.cols;
  const int* src = p.ws + (int64_t)m * p.cols + col;
  int a[8] = {};
  for (int z = 0; z < p.splits; ++z) {
    const int4 u = __ldg(reinterpret_cast<const int4*>(src + z * plane));
    const int4 v = __ldg(reinterpret_cast<const int4*>(src + z * plane + 4));
    a[0] += u.x; a[1] += u.y; a[2] += u.z; a[3] += u.w;
    a[4] += v.x; a[5] += v.y; a[6] += v.z; a[7] += v.w;
  }
  const float xs = x_scale(p);
  const int o = p.up2 ? col % p.cout : col;
  float y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) y[e] = dequant(p, a[e], o + e, xs);
  const int64_t idx = out_index(p, m, col);
  if (p.out_bf16) {
    uint4 out;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h[e] = __floats2bfloat162_rn(y[2 * e], y[2 * e + 1]);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(p.y) + idx) = out;
  } else {
    float4* d = reinterpret_cast<float4*>(static_cast<float*>(p.y) + idx);
    d[0] = make_float4(y[0], y[1], y[2], y[3]);
    d[1] = make_float4(y[4], y[5], y[6], y[7]);
  }
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
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

template <int BM, int BN, int BK, typename TX>
int launch(const CUtensorMap& map, const Params& p, cudaStream_t st) {
  using C = Cfg<BM, BN, BK, TX>;
  const int smem = 1024 + C::MAIN_BYTES + BAR_BYTES;
  auto kernel = conv_int8_wgmma_kernel<BM, BN, BK, TX>;
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
  const dim3 grid((p.M + BM - 1) / BM, (p.cols + BN - 1) / BN, p.splits);
  kernel<<<grid, THREADS, smem, st>>>(map, p);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int BK, typename TX>
int launch_halo(const CUtensorMap& map, const Params& p, cudaStream_t st) {
  using H = HaloCfg<BM, BN, BK, TX>;
  const int smem = 1024 + H::main_bytes(p.W) + BAR_BYTES;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv_int8_halo_kernel<BM, BN, BK, TX>;
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
  const dim3 grid((p.M + BM - 1) / BM, (p.cols + BN - 1) / BN, p.splits);
  kernel<<<grid, THREADS, smem, st>>>(map, p);
  return (int)cudaGetLastError();
}

// the tiles this source instantiates: (BM, BN, BK) with at most 128
// staged bytes of x a row (BK 128 for an int8 x, 64 for bf16, 32 for f32);
// the wide tile (64 x 256) and the halo mode for a float x only
template <typename TX>
int dispatch(const CUtensorMap& map, const Params& p, int bm, int bn, int bk,
             bool halo, cudaStream_t st) {
#define K8_TILE(BM_, BN_, BK_)                                              \
  if constexpr (BK_ * sizeof(TX) <= 128 && (BM_ == 128 || sizeof(TX) > 1)) \
    if (bm == BM_ && bn == BN_ && bk == BK_) {                              \
      if constexpr (sizeof(TX) > 1)                                         \
        if (halo) return launch_halo<BM_, BN_, BK_, TX>(map, p, st);        \
      return launch<BM_, BN_, BK_, TX>(map, p, st);                         \
    }
  K8_TILE(128, 32, 32) K8_TILE(128, 64, 32) K8_TILE(128, 128, 32)
  K8_TILE(128, 32, 64) K8_TILE(128, 64, 64) K8_TILE(128, 128, 64)
  K8_TILE(128, 32, 128) K8_TILE(128, 64, 128) K8_TILE(128, 128, 128)
  K8_TILE(64, 256, 32) K8_TILE(64, 256, 64)
#undef K8_TILE
  return ERR_PLAN;
}

int run(const Params& p, int bm, int bn, int bk, bool halo, int x_type,
        cudaStream_t st) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return ERR_NO_ENCODER;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.cols};
  const cuuint64_t strides[1] = {(cuuint64_t)p.K};
  const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)bn};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<int8_t*>(p.w), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_ENCODE;
  int rc = x_type == X_S8 ? dispatch<int8_t>(map, p, bm, bn, bk, false, st)
           : x_type == X_BF16
               ? dispatch<bf16>(map, p, bm, bn, bk, halo, st)
               : dispatch<float>(map, p, bm, bn, bk, halo, st);
  if (rc != 0 || p.splits == 1) return rc;
  const long long threads = (long long)p.M * (p.cols / 8);
  conv_int8_splitk_reduce_kernel<<<
      (unsigned)((threads + REDUCE_THREADS - 1) / REDUCE_THREADS),
      REDUCE_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace hopper

}  // namespace

// One K8 call. x NHWC: int8 (x_type 0, scale -> x_s f32, scale_mode 0) or
// bf16/f32 (x_type 1/2; scale -> x_s f32 with scale_mode 0, or max|x| in
// x's dtype with scale_mode 1 (bf16) / 2 (f32)). w the [cols, K] int8 GEMM
// weight (OHWI; up2: [4*cout, C], row (a*2 + b)*cout + o), w_s f32 [cout],
// bias f32 [cout] or null, y bf16 (out_bf16) or f32 NHWC (up2: [N, 2H, 2W,
// cout]; KH = KW = 1, stride 1), ws int32 [splits, M, cols] when splits > 1.
// The plan (route 0 wgmma / 1 vec / 2 gather, bm, bn, bk, splits) comes
// from the wrapper's planner: wgmma needs C % 16 == 0, cout % 8 == 0, K >=
// 32, 16-byte aligned x and w, (bm, bn) (128, 32/64/128) or, for a float
// x, (64, 256), bk in {32, 64, 128} with bk * sizeof(x) <= 128, 1 <= splits
// <= ceil(K / bk); halo (a float x, 3x3 stride 1 pad 1, C % bk == 0,
// splits <= C / bk) stages and quantizes each channel block's halo once;
// vec needs C % 16 == 0 and aligned x and w, bk 32 or 64; gather takes
// any C and alignment.
// Returns 0, a cudaError_t, or ERR_NO_ENCODER / ERR_ENCODE / ERR_PLAN.
extern "C" int conv_int8(const void* x, int x_type, const void* w,
                         const void* w_s, const void* scale, int scale_mode,
                         const void* bias, void* y, void* ws, int N, int H,
                         int W, int C, int KH, int KW, int stride, int pad_h,
                         int pad_w, int P, int Q, int cols, int cout, int up2,
                         int out_bf16, int route, int bm, int bn, int bk,
                         int splits, int halo, void* stream) {
  Params p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.w_s = static_cast<const float*>(w_s);
  p.scale = scale;
  p.scale_mode = scale_mode;
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.ws = static_cast<int*>(ws);
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
  p.nk = 0;
  p.cpt = 0;
  p.splits = route == ROUTE_WGMMA ? splits : 1;
  p.up2 = up2;
  p.out_bf16 = out_bf16;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (x_type < X_S8 || x_type > X_F32 || scale_mode < 0 || scale_mode > 2 ||
      (x_type == X_S8 && scale_mode != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route != ROUTE_GATHER && (C % 16 != 0 || !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == ROUTE_WGMMA &&
      (cout % 8 != 0 || p.K < 32 || splits < 1 ||
       (splits > 1 && ws == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (halo && (route != ROUTE_WGMMA || x_type == X_S8 || KH != 3 ||
               KW != 3 || stride != 1 || pad_h != 1 || pad_w != 1 ||
               P != H || Q != W || up2 || C % bk != 0 || splits > C / bk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.M == 0 || cols == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_WGMMA)
    return hopper::run(p, bm, bn, bk, halo != 0, x_type, st);
  if (x_type == X_S8)
    generic::dispatch<int8_t>(p, KH, route, bk, st);
  else if (x_type == X_BF16)
    generic::dispatch<bf16>(p, KH, route, bk, st);
  else
    generic::dispatch<float>(p, KH, route, bk, st);
  return static_cast<int>(cudaGetLastError());
}
