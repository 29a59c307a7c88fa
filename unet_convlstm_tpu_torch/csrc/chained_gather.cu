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
// What bounds it on this card: neither bytes nor operations but the launch.
// x and idx are read once and acc written once: 12 bytes an element, 0.24
// microseconds at (512, 128) over 3.35 TB/s; a link is one shared-memory
// load and a few integer operations. So the design keeps the chain on chip:
//   * element (i, j)'s chain reads only column j (axis 0) or row i (axis 1).
//     A block therefore owns whole lines along the gathered axis (rows for
//     axis 1, a tile of neighbouring columns for axis 0), stages them in
//     shared memory with coalesced loads, and runs every link from there.
//     The TPU's one-block layout does not carry over: a whole (512, 128) f32
//     array is 256 KiB, more than the 227 KB a block may hold;
//   * one thread per element where possible (up to 1,024 threads a block,
//     a block-stride loop beyond), idx and acc in registers, acc added in
//     link order, so the result is bit-equal to the plain version's; a
//     block holds as few lines as keeps two blocks on each of the 132 SMs;
//   * lines are padded by one float in shared memory, so the column tile of
//     axis 0 is stored without bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSMs = 132;
constexpr int kMaxLines = 32;
constexpr int kSmemDefault = 48 * 1024;

__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// Lines [line0, line0 + lines) of x along the gathered axis (length n).
// axis 1: line = row, element (line, p) at x[line * L + p].
// axis 0: line = column, element (line, p) at x[p * L + line].
__global__ void __launch_bounds__(kMaxThreads)
chained_gather_kernel(const float* __restrict__ x,
                      const int32_t* __restrict__ idx,
                      float* __restrict__ out, int R, int L, int axis,
                      int reps, int lines) {
  extern __shared__ float s[];  // [lines][n + 1]
  const int n = axis == 1 ? L : R;
  const int nlines = axis == 1 ? R : L;
  const int line0 = blockIdx.x * lines;
  const int here = min(lines, nlines - line0);
  const int pitch = n + 1;
  const int count = here * n;

  // element e of the block: axis 1 walks a row (p fastest), axis 0 walks
  // the tile's columns first, so that global addresses are contiguous
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int l = axis == 1 ? e / n : e % here;
    const int p = axis == 1 ? e % n : e / here;
    const int64_t g = axis == 1 ? (int64_t)(line0 + l) * L + p
                                : (int64_t)p * L + line0 + l;
    s[l * pitch + p] = x[g];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int l = axis == 1 ? e / n : e % here;
    const int p = axis == 1 ? e % n : e / here;
    const int64_t g = axis == 1 ? (int64_t)(line0 + l) * L + p
                                : (int64_t)p * L + line0 + l;
    const float* line = s + l * pitch;
    int k = idx[g];
    float acc = 0.0f;
    for (int r = 0; r < reps; ++r) {
      const float v = line[k];
      acc = __fadd_rn(acc, v);
      // int32 wrap-around on overflow, as jnp's and torch's int32 adds
      k = floor_mod((int)((uint32_t)k + (uint32_t)__float2int_rz(v) + 1u), n);
    }
    out[g] = acc;
  }
}

// Lines a block stages for this shape (at least 1), and the shared memory
// they take; -1 if one line does not fit in a block's 227 KB.
long long smem_for(int R, int L, int axis, int* lines_out) {
  const int n = axis == 1 ? L : R;
  const int nlines = axis == 1 ? R : L;
  const long long per_line = 4LL * (n + 1);
  if (per_line > 227 * 1024) return -1;
  // enough blocks for two on each SM, at most kMaxLines lines a block
  int lines = nlines / (2 * kSMs);
  if (lines < 1) lines = 1;
  if (lines > kMaxLines) lines = kMaxLines;
  while (lines > 1 && lines * per_line > kSmemDefault) lines >>= 1;
  if (lines > nlines) lines = nlines;
  *lines_out = lines;
  return lines * per_line;
}

}  // namespace

// x f32 [R, L], idx int32 [R, L], out f32 [R, L], contiguous; every idx in
// [0, n). Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue when a line exceeds a block's shared memory.
extern "C" int chained_gather(const void* x, const void* idx, void* out,
                              int R, int L, int axis, int reps, void* stream) {
  if (R == 0 || L == 0) return 0;
  int lines = 1;
  const long long smem = smem_for(R, L, axis, &lines);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        chained_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nlines = axis == 1 ? R : L;
  const unsigned blocks = (unsigned)((nlines + lines - 1) / lines);
  long long threads = ((long long)lines * (axis == 1 ? L : R) + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  chained_gather_kernel<<<blocks, (unsigned)threads, (size_t)smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), R, L, axis, reps, lines);
  return (int)cudaGetLastError();
}
