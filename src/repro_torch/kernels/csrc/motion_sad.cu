// motion_sad: exhaustive +-R block-matching motion search, f32.
//
// Replaces src/repro/kernels/motion_sad/kernel.py:motion_sad_rows
// (exhaustive mode, _kernel); oracle repro/codec/motion.py:block_sad_scan.
//
// Bound on an H100 SXM: at the main path's LR frame (352x640, R=8) the
// search is 880 blocks x 289 candidates x 256 pixels = 65 M
// abs-diff-adds (130 M f32 operations, about 2 us at 67 TFLOP/s), while
// the bytes it must move (cur and ref in, mv and sad out: 1.8 MB) take
// about 0.5 us at 3.35 TB/s.  It is bound by operations.
//
// Design: one thread block per macroblock, one thread per current pixel.
// The block stages the (16+2R)^2 reference window in shared memory once
// (4 KB at R=8), with source indices clamped to the frame: the reference
// pads by edge replication (jnp.pad(..., mode="edge")), not zeros.  Every
// candidate then reads only shared memory.  Candidates run dy-major; each
// SAD is reduced in a fixed order (a shuffle tree inside each warp, then
// the eight warp partials summed in order), so every thread holds the same
// sum and the best is updated with a strict < (first candidate wins a
// tie), as in the oracle.  One barrier per candidate: the warp partials
// are double-buffered.

#include "common.cuh"

namespace {

constexpr int kThreads = MB * MB;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
motion_sad_kernel(const float* __restrict__ cur, const float* __restrict__ ref,
                  int H, int W, int radius, int* __restrict__ mv,
                  float* __restrict__ sad) {
  extern __shared__ float win[];
  __shared__ float partial[2][kWarps];
  const int nbx = W / MB;
  const int by = blockIdx.x / nbx, bx = blockIdx.x % nbx;
  const int t = threadIdx.x, ty = t / MB, tx = t % MB;
  const int lane = t & 31, warp = t >> 5;
  const int side = MB + 2 * radius;
  const int y0 = by * MB - radius, x0 = bx * MB - radius;

  for (int k = t; k < side * side; k += kThreads) {
    const int sy = clampi(y0 + k / side, 0, H - 1);
    const int sx = clampi(x0 + k % side, 0, W - 1);
    win[k] = ref[sy * W + sx];
  }
  const float c = cur[(by * MB + ty) * W + bx * MB + tx];
  __syncthreads();

  const int nd = 2 * radius + 1;
  float best = CUDART_INF_F;
  int best_k = 0;
  for (int k = 0; k < nd * nd; ++k) {
    const int oy = k / nd, ox = k % nd;  // offset + R
    float d = fabsf(c - win[(ty + oy) * side + tx + ox]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_down_sync(0xffffffffu, d, off);
    if (lane == 0) partial[k & 1][warp] = d;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[k & 1][w];
    if (s < best) {
      best = s;
      best_k = k;
    }
  }
  if (t == 0) {
    const int b = by * nbx + bx;
    mv[2 * b] = best_k / nd - radius;
    mv[2 * b + 1] = best_k % nd - radius;
    sad[b] = best;
  }
}

}  // namespace

// cur, ref: (H, W) f32, H and W multiples of 16.  mv: (H/16, W/16, 2)
// int32 (dy, dx), sad: (H/16, W/16) f32.
extern "C" int motion_sad_launch(const float* cur, const float* ref, int H,
                                 int W, int radius, int* mv, float* sad,
                                 cudaStream_t stream) {
  const int side = MB + 2 * radius;
  const size_t smem = sizeof(float) * side * side;
  if (H % MB || W % MB || H <= 0 || W <= 0 || radius < 0 ||
      smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  motion_sad_kernel<<<(H / MB) * (W / MB), kThreads, smem, stream>>>(
      cur, ref, H, W, radius, mv, sad);
  return static_cast<int>(cudaGetLastError());
}
