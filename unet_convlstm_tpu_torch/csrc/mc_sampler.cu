// Fused per-iteration sampling block of the Monte-Carlo path tracer, for
// Hopper (sm_90a): free flight, collision-acceptance uniform and an exact
// Henyey-Greenstein direction, one thread per lane.
//
// Replaces the TPU kernels of unet_convlstm_tpu/ops/pallas/mc_sampler.py:
//   mc_sample_flights           <- `_hw_kernel` (:86, public `sample_flights`)
//   mc_sample_flights_uniforms  <- `_uniforms_kernel` (:105, public
//                                  `sample_flights_with_uniforms`)
//
// For lane l with direction d, local majorant m and uniforms u1..u4:
//   t     = -log1p(-u1) / max(m, 1e-12)
//   u_acc = u2
//   cos   = HG inverse CDF of u3 (isotropic 1 - 2 u3 when |g| < 1e-3),
//   phi   = 2 pi u4, new_d = the unit vector at (cos, phi) in the Duff et
//           al. frame about d, normalised with rsqrt.
// mc_sample_flights draws u1..u4 itself: the TPU's hardware PRNG has no
// CUDA counterpart, so a counter-based Philox4x32-10 takes its place, key
// (seed, 0) and counter (lane within its group, 0, 0, 0), its four output
// words mapped to [0, 1) by ((w >> 9) & 0x7FFFFF) * 2^-23 as the TPU kernel
// maps its bits. A launch serves G groups of lanes (sample rounds, or patch
// x round) that the tracer runs in one lockstep loop; group k's seed is the
// tracer's Weyl sequence base_seed[k] + step * 0x9E3779B9 (mod 2^32).
// mc_sample_flights_uniforms reads u [4, N] instead.
//
// What bounds it on this card: device-memory bytes. A lane reads 16 bytes
// (d, m; plus 16 of uniforms for the second entry point) and writes 20
// (t, u_acc, new_d), for about 100 flops and a log1p, a sincos and two
// square roots: far below the H100's ridge. So the design only streams:
// one thread per lane, everything between the loads and the stores in
// registers. The [R, 128] planes and the padding of the TPU kernel were its
// lane layout and are not carried over; the [N, 3] directions are read as
// three strided floats (every 12-byte row lies in one or two sectors that
// the warp's neighbours share). The arithmetic uses the precise library
// functions and explicit round-to-nearest products and sums, so nvcc does
// not contract them into FMAs: the plain PyTorch version runs each
// operation as its own rounding, and the two must agree to a few ulps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The HG constants, rounded to f32 on the host exactly as the plain
// version's Python scalars are: 1 - g^2, 1 + g, 2 g, 1 + g^2.
struct HG {
  float one_m_g2, one_p_g, two_g, one_p_g2;
  int isotropic;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ void flight_and_hg(
    float u1, float u2, float u3, float u4, float dx, float dy, float dz,
    float m, const HG& hg, float* t, float* ua, float* nd) {
  *t = -log1pf(-u1) / fmaxf(m, 1e-12f);
  *ua = u2;

  float cos_t;
  if (hg.isotropic) {
    cos_t = sub(1.0f, mul(2.0f, u3));
  } else {
    const float s = hg.one_m_g2 / sub(hg.one_p_g, mul(hg.two_g, u3));
    cos_t = sub(hg.one_p_g2, mul(s, s)) / hg.two_g;
  }
  // clip keeping NaN, as jnp.clip does
  cos_t = cos_t < -1.0f ? -1.0f : (cos_t > 1.0f ? 1.0f : cos_t);
  const float sin_t = sqrtf(fmaxf(0.0f, sub(1.0f, mul(cos_t, cos_t))));
  const float phi = mul(6.2831854820251465f, u4);  // f32(2 pi)
  float sp, cp;
  sincosf(phi, &sp, &cp);

  const float sign = dz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / add(sign, dz);
  const float b = mul(mul(dx, dy), a);
  const float t1x = add(1.0f, mul(mul(mul(sign, dx), dx), a));
  const float t1y = mul(sign, b);
  const float t1z = -mul(sign, dx);
  const float t2x = b;
  const float t2y = add(sign, mul(mul(dy, dy), a));
  const float t2z = -dy;
  const float w1 = mul(sin_t, cp), w2 = mul(sin_t, sp);
  const float nx = add(add(mul(w1, t1x), mul(w2, t2x)), mul(cos_t, dx));
  const float ny = add(add(mul(w1, t1y), mul(w2, t2y)), mul(cos_t, dy));
  const float nz = add(add(mul(w1, t1z), mul(w2, t2z)), mul(cos_t, dz));
  const float n2 = add(add(mul(nx, nx), mul(ny, ny)), mul(nz, nz));
  const float inv = rsqrtf(fmaxf(n2, 1e-30f));
  nd[0] = mul(nx, inv);
  nd[1] = mul(ny, inv);
  nd[2] = mul(nz, inv);
}

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t c1 = c[1], c3 = c[3];
    c[0] = hi1 ^ c1 ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c3 ^ k1;
    c[3] = lo0;
  }
}

__device__ __forceinline__ float unit_from_bits(uint32_t w) {
  return (float)((w >> 9) & 0x7FFFFFu) * (1.0f / 8388608.0f);
}

__global__ void __launch_bounds__(256)
mc_sample_flights_kernel(const int32_t* __restrict__ base_seeds,
                         uint32_t step, const float* __restrict__ d,
                         const float* __restrict__ m, float* __restrict__ t,
                         float* __restrict__ ua, float* __restrict__ nd,
                         int64_t n, int64_t per_group, HG hg) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; l < n;
       l += stride) {
    const int64_t grp = l / per_group;
    const uint32_t seed = (uint32_t)base_seeds[grp] + step * 0x9E3779B9u;
    uint32_t c[4] = {(uint32_t)(l - grp * per_group), 0u, 0u, 0u};
    philox4x32_10(c, seed, 0u);
    flight_and_hg(unit_from_bits(c[0]), unit_from_bits(c[1]),
                  unit_from_bits(c[2]), unit_from_bits(c[3]), d[3 * l],
                  d[3 * l + 1], d[3 * l + 2], m[l], hg, t + l, ua + l,
                  nd + 3 * l);
  }
}

__global__ void __launch_bounds__(256)
mc_sample_flights_uniforms_kernel(const float* __restrict__ u,
                                  const float* __restrict__ d,
                                  const float* __restrict__ m,
                                  float* __restrict__ t,
                                  float* __restrict__ ua,
                                  float* __restrict__ nd, int64_t n, HG hg) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; l < n;
       l += stride) {
    flight_and_hg(u[l], u[n + l], u[2 * n + l], u[3 * n + l], d[3 * l],
                  d[3 * l + 1], d[3 * l + 2], m[l], hg, t + l, ua + l,
                  nd + 3 * l);
  }
}

unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 16;  // grid-stride beyond 16 blocks per SM
  return (unsigned)(blocks > cap ? cap : blocks);
}

}  // namespace

// base_seeds [G] int32, d [n, 3] f32, m [n] f32 -> t [n], u_acc [n],
// new_d [n, 3] f32, all contiguous; n = G * per_group. Lane l belongs to
// group l / per_group and draws Philox counter l % per_group. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mc_sample_flights(const void* base_seeds, long long step,
                                 const void* d, const void* m, void* t,
                                 void* ua, void* nd, long long n,
                                 long long per_group, float one_m_g2,
                                 float one_p_g, float two_g, float one_p_g2,
                                 int isotropic, void* stream) {
  if (n == 0) return 0;
  const HG hg{one_m_g2, one_p_g, two_g, one_p_g2, isotropic};
  mc_sample_flights_kernel<<<grid_for(n, 256), 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(base_seeds), (uint32_t)step,
      static_cast<const float*>(d), static_cast<const float*>(m),
      static_cast<float*>(t), static_cast<float*>(ua),
      static_cast<float*>(nd), n, per_group, hg);
  return (int)cudaGetLastError();
}

// u [4, n], d [n, 3], m [n] f32 -> t [n], u_acc [n], new_d [n, 3] f32.
extern "C" int mc_sample_flights_uniforms(const void* u, const void* d,
                                          const void* m, void* t, void* ua,
                                          void* nd, long long n,
                                          float one_m_g2, float one_p_g,
                                          float two_g, float one_p_g2,
                                          int isotropic, void* stream) {
  if (n == 0) return 0;
  const HG hg{one_m_g2, one_p_g, two_g, one_p_g2, isotropic};
  mc_sample_flights_uniforms_kernel<<<grid_for(n, 256), 256, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(d),
      static_cast<const float*>(m), static_cast<float*>(t),
      static_cast<float*>(ua), static_cast<float*>(nd), n, hg);
  return (int)cudaGetLastError();
}
