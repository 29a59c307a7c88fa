// hostio: the input pipeline's host kernels (this package's own copy of
// unet_convlstm_tpu/native/hostio.cpp; the same two functions, the same
// semantics). They run on the host's CPU, not on the card.
//
// gather_transpose_f32: the training loop's per-batch host work, "gather B
// sequences by index and convert [N,T,C,H,W] -> [B,T,H,W,C]"
// (data/npz_dataset.py get_batch_raw). numpy does it in two full passes (a
// fancy-index copy, then a moveaxis copy); this is one pass, blocked over
// pixels so that the C source planes stay in cache, split over threads,
// straight into the buffer that is then copied to the card.
//
// paste_digit_f32: the Moving-MNIST generator's inner loop
// (data/moving_mnist.py).
//
// Built by native/build.py with g++ -O3 and bound with ctypes
// (data/fast_gather.py). The callers check shapes, dtypes, contiguity and
// index ranges before passing pointers.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// src: [N, T, C, H, W] float32, C-contiguous
// idx: [B] int64 sample indices, each in [0, N)
// dst: [B, T, H, W, C] float32, C-contiguous (allocated by the caller)
void gather_transpose_f32(const float* src, const int64_t* idx, float* dst,
                          int64_t B, int64_t T, int64_t C, int64_t H,
                          int64_t W, int32_t nthreads) {
  const int64_t hw = H * W;
  const int64_t src_frame = C * hw;  // one [C, H, W] frame
  const int64_t src_seq = T * src_frame;
  const int64_t dst_frame = hw * C;  // one [H, W, C] frame
  const int64_t dst_seq = T * dst_frame;
  const int64_t jobs = B * T;

  auto work = [&](int64_t j0, int64_t j1) {
    for (int64_t j = j0; j < j1; ++j) {
      const int64_t b = j / T;
      const int64_t t = j % T;
      const float* s = src + idx[b] * src_seq + t * src_frame;
      float* d = dst + b * dst_seq + t * dst_frame;
      if (C == 1) {  // no transpose: a copy
        std::memcpy(d, s, sizeof(float) * hw);
        continue;
      }
      constexpr int64_t BLK = 512;  // pixels a block
      for (int64_t p0 = 0; p0 < hw; p0 += BLK) {
        const int64_t p1 = (p0 + BLK < hw) ? p0 + BLK : hw;
        for (int64_t c = 0; c < C; ++c) {
          const float* sc = s + c * hw;
          for (int64_t p = p0; p < p1; ++p) d[p * C + c] = sc[p];
        }
      }
    }
  };

  if (nthreads <= 1 || jobs < 2) {
    work(0, jobs);
    return;
  }
  const int nt = static_cast<int>(nthreads < jobs ? nthreads : jobs);
  const int64_t per = (jobs + nt - 1) / nt;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int i = 0; i < nt; ++i) {
    const int64_t j0 = i * per;
    const int64_t j1 = (j0 + per < jobs) ? j0 + per : jobs;
    if (j0 >= j1) break;
    threads.emplace_back(work, j0, j1);
  }
  for (auto& th : threads) th.join();
}

// One digit pasted into one frame: where the digit's pixel is > 0 it
// overwrites the frame (a later digit wins) and its vx adds into the
// velocity map. frame, vel: [S, S]; digit: [28, 28] in [0, 1]; the 28x28
// window at (y, x) lies inside the frame.
void paste_digit_f32(float* frame, float* vel, const float* digit,
                     int64_t S, int64_t y, int64_t x, float vx) {
  for (int64_t r = 0; r < 28; ++r) {
    float* fr = frame + (y + r) * S + x;
    float* vr = vel + (y + r) * S + x;
    const float* dr = digit + r * 28;
    for (int64_t c = 0; c < 28; ++c) {
      if (dr[c] > 0.0f) {
        fr[c] = dr[c];
        vr[c] += vx;
      }
    }
  }
}

}  // extern "C"
