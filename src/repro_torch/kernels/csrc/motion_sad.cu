// motion_sad: +-R block-matching motion search over 16x16 macroblocks, in
// two strategies (exhaustive, diamond) and two storage types (f32, bf16;
// every SAD is summed in f32).
//
// Replaces src/repro/kernels/motion_sad/kernel.py:motion_sad_rows: its
// exhaustive _kernel (oracle repro/codec/motion.py:block_sad_scan) and its
// _diamond_kernel (oracle repro/codec/motion.py:block_sad_diamond), each
// with dtype=None or bf16 storage.
//
// Bound on an H100 SXM, at the main path's LR frame (352x640, R=8, 880
// blocks):
//   exhaustive: 880 x 289 candidates x 256 px = 65 M abs-diff-adds (130 M
//     f32 operations, about 2 us at 67 TFLOP/s) against 1.8 MB of cur and
//     ref in f32 (0.5 us at 3.35 TB/s): bound by operations.
//   diamond: 880 x 37 evaluations x 256 px x 2 = 16.7 M operations (0.25
//     us) against 1.8 MB in f32 (0.55 us) or 0.9 MB in bf16 (0.27 us):
//     bound by bytes.
//
// Design: one thread block per macroblock, one thread per current pixel.
// The block stages the (16+2R)^2 reference window in shared memory once,
// in the storage type (4 KB f32, 2 KB bf16 at R=8), with source indices
// clamped to the frame: the reference pads by edge replication
// (jnp.pad(..., mode="edge")), not zeros.  Pixels are converted to f32
// before the subtraction, so the bf16 variant differs from f32 only by
// the rounding of its inputs (none on integer frames <= 256).  Every
// candidate reads only shared memory, and each SAD is reduced in one
// fixed order (a shuffle tree inside each warp, then the eight warp
// partials summed in order), so every thread holds the same sum and the
// best is updated with a strict < (first candidate wins a tie), as in
// the oracles.  One barrier per candidate: the warp partials are
// double-buffered.
//   The exhaustive search runs candidates dy-major.  The diamond search
// probes the 3x3 neighbourhood, at step s, of the best offset found
// before the round (steps: the largest power of two <= R, halving to 1),
// dy-major, each probe clipped to +-R; a clipped probe may repeat a
// candidate, which the strict < makes harmless.  The rounds depend on
// each other, so their loop lives inside the block.

#include "common.cuh"

namespace {

constexpr int kThreads = MB * MB;
constexpr int kWarps = kThreads / 32;

template <typename T, bool kDiamond>
__global__ void __launch_bounds__(kThreads)
motion_sad_kernel(const T* __restrict__ cur, const T* __restrict__ ref,
                  int H, int W, int radius, int* __restrict__ mv,
                  float* __restrict__ sad) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
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
  const float c = to_f32(cur[(by * MB + ty) * W + bx * MB + tx]);
  __syncthreads();

  int n = 0;  // candidates evaluated so far: picks the partials' buffer
  auto sad_at = [&](int dy, int dx) {
    float d = fabsf(c - to_f32(win[(ty + dy + radius) * side
                                   + tx + dx + radius]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_down_sync(0xffffffffu, d, off);
    float* p = partial[n++ & 1];
    if (lane == 0) p[warp] = d;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += p[w];
    return s;
  };

  float best = CUDART_INF_F;
  int best_y = 0, best_x = 0;
  if (!kDiamond) {
    for (int dy = -radius; dy <= radius; ++dy)
      for (int dx = -radius; dx <= radius; ++dx) {
        const float s = sad_at(dy, dx);
        if (s < best) {
          best = s;
          best_y = dy;
          best_x = dx;
        }
      }
  } else {
    best = sad_at(0, 0);
    int step = 1;
    while (2 * step <= radius) step *= 2;
    for (; step >= 1; step /= 2) {
      const int cy = best_y, cx = best_x;
      for (int py = -step; py <= step; py += step)
        for (int px = -step; px <= step; px += step) {
          const int oy = clampi(cy + py, -radius, radius);
          const int ox = clampi(cx + px, -radius, radius);
          const float s = sad_at(oy, ox);
          if (s < best) {
            best = s;
            best_y = oy;
            best_x = ox;
          }
        }
    }
  }
  if (t == 0) {
    const int b = by * nbx + bx;
    mv[2 * b] = best_y;
    mv[2 * b + 1] = best_x;
    sad[b] = best;
  }
}

template <typename T, bool kDiamond>
int launch(const void* cur, const void* ref, int H, int W, int radius,
           int* mv, float* sad, cudaStream_t stream) {
  const int side = MB + 2 * radius;
  const size_t smem = sizeof(T) * side * side;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  motion_sad_kernel<T, kDiamond><<<(H / MB) * (W / MB), kThreads, smem,
                                   stream>>>(
      static_cast<const T*>(cur), static_cast<const T*>(ref), H, W, radius,
      mv, sad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cur, ref: (H, W) in the storage type (f32, or bf16 when bf16 != 0), H
// and W multiples of 16.  diamond: 0 exhaustive, 1 diamond.  mv:
// (H/16, W/16, 2) int32 (dy, dx), sad: (H/16, W/16) f32.
extern "C" int motion_sad_launch(const void* cur, const void* ref, int H,
                                 int W, int radius, int diamond, int bf16,
                                 int* mv, float* sad, cudaStream_t stream) {
  if (H % MB || W % MB || H <= 0 || W <= 0 || radius < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return diamond ? launch<__nv_bfloat16, true>(cur, ref, H, W, radius, mv,
                                                 sad, stream)
                   : launch<__nv_bfloat16, false>(cur, ref, H, W, radius, mv,
                                                  sad, stream);
  return diamond ? launch<float, true>(cur, ref, H, W, radius, mv, sad, stream)
                 : launch<float, false>(cur, ref, H, W, radius, mv, sad,
                                        stream);
}
