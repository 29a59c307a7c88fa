// A chain of dependent gathers inside one block, for Hopper (sm_90a): the
// gather-throughput probe. x f32 [R, L], idx int32 [R, L], axis 0 or 1,
// reps links -> acc f32 [R, L], where each link is
//     v   = take_along_axis(x, idx, axis)
//     acc = acc + v
//     idx = (idx + int32(v) + 1) mod n,   n = x.shape[axis]
// with int32(v) truncating toward zero and mod the floor modulo of jnp's %
// (never negative, where C's % keeps the dividend's sign).
//
// Replaces the TPU kernel `gather_kernel` of
// scripts/perf/probe_pallas_gather.py (:33, built by `build` :46-53), which
// holds both arrays in VMEM as one block and lowers each link to Mosaic's
// dynamic gather.
//
// What bounds it on this card: neither bytes nor operations. x and idx are
// read once and acc written once, 12 bytes an element (0.24 microseconds at
// (512, 128) over 3.35 TB/s), far below the launch's own floor. The first
// design (10.4 microseconds against a 1.67 microsecond launch floor, in
// PERF.md section 6's table) was bounded by each link's latency: a
// shared load, a truncation, an add and a `%` by a runtime n on the critical
// path, 64 times. So this design takes the arithmetic off the chain:
//   * an element's next index depends only on where it is: while a line is
//     staged into shared memory, each position p gets
//     next[p] = floor_mod(p + int32(x[p]) + 1, n), and a link is
//     `acc += x[k]; k = next[k]`. Every start index is taken into [0, n) once
//     (the contract says it is there already), so no load leaves the line;
//   * x[p] and next[p] sit side by side (8 bytes), so one 8-byte shared load
//     gives both and the critical path of a link is that load. A line too
//     long for 8 bytes an element (more than 29,056 values) keeps next alone
//     in shared memory, 4 bytes an element, and reads x through L1: the
//     wrapper takes exactly the lines it took before (4 (n + 1) bytes within
//     a block's 227 KB). Where both fit, the 8-byte layout is the faster:
//     at (512, 128) along axis 0 5.8 microseconds against 10.0 on an H100
//     (PERF.md section 6, `python -m unet_convlstm_tpu_torch.probes.
//     kernel_ab`), as the 4-byte one adds an L1 load a link whose lanes
//     hit different sectors;
//   * a block owns whole lines along the gathered axis: a tile of 16 rows
//     (axis 1) or 16 neighbouring columns (axis 0), stored position-major
//     (slot p * 16 + l), so the 16 lanes of a half-warp, each on its own
//     line, load from 16 different pairs of banks whatever their positions:
//     a link's 8-byte load is served without a bank conflict. With fewer
//     than 16 lines a tile is one line, and the links' random banks
//     conflict; lines too long for 16 a block take the most, a power of
//     two, that shared memory holds;
//   * several blocks may stage the same tile and each run a part of its
//     chains (about one block an SM); a block's start indices are loaded
//     before its staging, so the two trips to device memory overlap. The
//     split is sized for a full tile: where the last tile has fewer lines,
//     its later blocks have no chain and return before reading anything;
//   * acc is added in link order, so the result is bit-equal to the plain
//     version's.
// The launch plan (lines a tile, blocks a tile, chains a block, blocks,
// threads, layout, shared memory) comes from Python (`chained_gather.plan`).
// What bounds the new design, as measured on an H100 at 700 W (PERF.md
// section 6): latency. `chained_gather_latency_floor` (one block, 64
// dependent shared loads) takes 3.0 microseconds, an empty launch 1.9;
// (512, 128) along axis 0 takes 6.5, the rest being the staging (a trip to
// device memory, and each tile staged by the 16 blocks that share it) and
// 512 chains an SM through its load/store unit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 227 * 1024;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ int floor_mod(int a, int n) {
  if ((unsigned)a < (unsigned)n) return a;            // the usual cases
  if (a >= n && a - n < n) return a - n;
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// Tile t = blockIdx.x / splits holds lines [t * lines, + here) of length n.
// Element (l, p), line l of the tile at position p, sits in shared memory at
// slot (p << shift) + l, lines = 1 << shift: 16 lines a tile put the chains
// of a half-warp's 16 lanes (consecutive l) each in its own pair of banks,
// whatever their positions, so an 8-byte load of a link is served without a
// conflict. Staging walks the tile in the order of its global addresses
// (f = l * n + p for axis 1, f = p * here + l for axis 0); chains are
// numbered e = p * here + l, and block (t, s) runs e in [s * chunk, + chunk).
template <int AXIS>
struct Tile {
  int n, here, shift, L;
  int64_t gbase;   // global offset of (0, 0)
  __device__ int64_t goff(int l, int p) const {
    return AXIS == 1 ? gbase + (int64_t)l * L + p
                     : gbase + (int64_t)p * L + l;
  }
  __device__ int slot(int l, int p) const { return (p << shift) + l; }
  __device__ void chain(int e, int& l, int& p) const {
    p = e / here;
    l = e - p * here;
  }
  __device__ void staged(int f, int& l, int& p) const {
    if (AXIS == 1) { l = f / n; p = f - l * n; }
    else chain(f, l, p);
  }
  // (l, p) of staged(f + step) from staged(f) and (dl, dp) = staged(step):
  // the minor coordinate carries into the major one, no division a step
  __device__ void advance(int& l, int& p, int dl, int dp) const {
    l += dl;
    p += dp;
    if (AXIS == 1) { if (p >= n) { p -= n; ++l; } }
    else { if (l >= here) { l -= here; ++p; } }
  }
};

template <int AXIS, bool PAIR>
__global__ void __launch_bounds__(kMaxThreads, 2)
chained_gather_kernel(const float* __restrict__ x,
                      const int32_t* __restrict__ idx,
                      float* __restrict__ out, int R, int L, int reps,
                      int lines, int splits, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* pair = reinterpret_cast<float2*>(smem);   // PAIR: (x, next slot)
  int* nxt = reinterpret_cast<int*>(smem);          // else: next slot
  const int nlines = AXIS == 1 ? R : L;
  const int tile = blockIdx.x / splits;
  const int split = blockIdx.x - tile * splits;
  const int line0 = tile * lines;
  Tile<AXIS> t;
  t.n = AXIS == 1 ? L : R;
  t.here = min(lines, nlines - line0);
  t.shift = __ffs(lines) - 1;
  t.L = L;
  t.gbase = AXIS == 1 ? (int64_t)line0 * L : line0;
  const int n = t.n;
  const int count = t.here * n;
  const int c0 = split * chunk;
  // the plan sizes splits for a full tile: a last tile of fewer lines has
  // fewer chains, and its later blocks none (nor anything to stage for them)
  if (c0 >= count) return;
  const int c1 = min(c0 + chunk, count);
  const int T = blockDim.x;

  // the first chain's start index, loaded before staging so that the two
  // trips to device memory overlap (a thread without a chain loads c0's)
  int e = c0 + threadIdx.x;
  int l, p;
  t.chain(e < c1 ? e : c0, l, p);
  int64_t g = t.goff(l, p);
  int k = idx[g];

  {
    int le, pe, dl, dp;
    t.staged(threadIdx.x, le, pe);
    t.staged(T, dl, dp);
#pragma unroll 4
    for (int f = threadIdx.x; f < count; f += T) {
      const float v = x[t.goff(le, pe)];
      // int32 wrap-around on overflow, as jnp's and torch's int32 adds
      const int kn = floor_mod(
          (int)((uint32_t)pe + (uint32_t)__float2int_rz(v) + 1u), n);
      if (PAIR) {
        pair[t.slot(le, pe)] = make_float2(v, __int_as_float(t.slot(le, kn)));
      } else {
        nxt[t.slot(le, pe)] = t.slot(le, kn);
      }
      t.advance(le, pe, dl, dp);
    }
  }
  __syncthreads();

  for (; e < c1; e += T) {
    if (e != c0 + (int)threadIdx.x) {   // a later chain: its own start
      t.chain(e, l, p);
      g = t.goff(l, p);
      k = idx[g];
    }
    int s = t.slot(l, floor_mod(k, n));
    float acc = 0.0f;
    for (int r = 0; r < reps; ++r) {
      if (PAIR) {
        const float2 q = pair[s];
        acc = __fadd_rn(acc, q.x);
        s = __float_as_int(q.y);
      } else {
        // x[s's position] through L1, off the chain's critical path
        acc = __fadd_rn(acc, __ldg(x + t.goff(l, s >> t.shift)));
        s = nxt[s];
      }
    }
    out[g] = acc;
  }
}

// One block of one warp: each lane follows 64 dependent shared-memory loads
// through its own bank (no conflict), the least time a chain of `reps` links
// can take after the launch.
__global__ void chase_floor_kernel(int* __restrict__ out, int reps) {
  __shared__ int table[32];
  volatile int* t = table;        // every link a load, none forwarded
  t[threadIdx.x] = threadIdx.x;
  __syncwarp();
  int k = threadIdx.x;
  for (int r = 0; r < reps; ++r) k = t[k];
  out[threadIdx.x] = k;
}

template <int AXIS, bool PAIR>
cudaError_t launch(unsigned blocks, int threads, int smem, cudaStream_t st,
                   const float* x, const int32_t* idx, float* out, int R,
                   int L, int reps, int lines, int splits, int chunk) {
  auto kernel = chained_gather_kernel<AXIS, PAIR>;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, threads, smem, st>>>(x, idx, out, R, L, reps, lines,
                                        splits, chunk);
  return cudaGetLastError();
}

}  // namespace

// x f32 [R, L], idx int32 [R, L], out f32 [R, L], contiguous; every idx in
// [0, n). The plan of `chained_gather.plan`: lines a tile (a power of two),
// splits (blocks a tile), chunk (chains a block), blocks (tiles * splits),
// threads, pair (x beside next in shared memory) and smem bytes. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int chained_gather(const void* x, const void* idx, void* out,
                              int R, int L, int axis, int reps, int lines,
                              int splits, int chunk, int blocks, int threads,
                              int pair, int smem, void* stream) {
  if (R == 0 || L == 0) return 0;
  if (lines < 1 || (lines & (lines - 1)) || splits < 1 || chunk < 1 ||
      blocks < 1 || threads < 32 || threads > kMaxThreads ||
      smem > kMaxSmem || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* of = static_cast<float*>(out);
  cudaError_t err;
  if (axis == 1 && pair)
    err = launch<1, true>(blocks, threads, smem, st, xf, ix, of, R, L, reps,
                          lines, splits, chunk);
  else if (axis == 1)
    err = launch<1, false>(blocks, threads, smem, st, xf, ix, of, R, L, reps,
                           lines, splits, chunk);
  else if (pair)
    err = launch<0, true>(blocks, threads, smem, st, xf, ix, of, R, L, reps,
                          lines, splits, chunk);
  else
    err = launch<0, false>(blocks, threads, smem, st, xf, ix, of, R, L, reps,
                           lines, splits, chunk);
  return (int)err;
}

// The latency floor beside K7: one block of 32 threads, `reps` dependent
// shared loads each; out int32 [32]. Returns cudaGetLastError().
extern "C" int chained_gather_latency_floor(void* out, int reps,
                                            void* stream) {
  chase_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), reps);
  return (int)cudaGetLastError();
}
