// qtransfer: 16x16 macroblock gather at per-block motion vectors, with an
// optional residual add and clip to [0, 255], over a batch of frames, in
// f32 or bf16 storage (the bf16 variant gathers and adds in f32 and
// rounds the clipped result back to bf16).
//
// Replaces src/repro/kernels/qtransfer/kernel.py:qtransfer_rows (_kernel).
// Two edge modes, each held against its own oracle:
//   pixel: repro/codec/motion.py:warp_blocks, the main path's form (P-frame
//          motion compensation and quality transfer).  The block's source
//          start s = y0 + 16 + dy indexes a 16-px edge-padded plane of
//          H + 32 rows through lax.dynamic_slice, which first adds H + 32
//          to a negative start (Python-style) and then clamps it to
//          [0, H + 16]; each pixel then reads ref[clamp(s - 16 + i, 0,
//          H - 1)], and likewise on x.  Both steps matter once |mv| > 16,
//          which the cumulative quality-transfer vectors reach.
//   block: repro/kernels/qtransfer/ref.py:qtransfer_ref (the TPU kernel's
//          own form): dy is clamped to +-radius against a vertically
//          edge-padded plane and the x start to [0, W - 16].  Its bf16
//          storage variant follows repro/kernels/qtransfer/ops.py:qtransfer
//          with dtype=bf16.
//
// Bound on an H100 SXM: a pure gather.  Over a main-path chunk (30 frames
// of 720x1280 with a residual) it reads the anchor plane and the residual
// once and writes the output once, 332 MB, about 99 us at 3.35 TB/s; the
// add and clip are 2 operations a pixel.  It is bound by bytes.  In bf16
// the same chunk moves half the bytes, 166 MB, about 50 us.
//
// Design: one thread per output pixel, neighbouring threads on
// neighbouring pixels of a row, so the residual read and the output write
// are coalesced and a block's 16 gathered pixels of a row are contiguous.
// The motion vector is read once per pixel from a tiny array that stays in
// L1.  No shared memory: each source pixel is read about once.  The
// storage type is a template parameter of the one kernel.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEdgePixel = 0;
constexpr int kEdgeBlock = 1;

// lax.dynamic_slice's start of a 16-wide slice of an (n + 32)-long padded
// axis: a negative start counts from the end, then the start is clamped.
__device__ __forceinline__ int padded_start(int s, int n) {
  return clampi(s < 0 ? s + n + 2 * MB : s, 0, n + MB);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qtransfer_kernel(const T* __restrict__ anchor, const int* __restrict__ mv,
                 const T* __restrict__ resid, long n, int H, int W,
                 int edge, int radius, T* __restrict__ out) {
  const long idx = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int x = static_cast<int>(idx % W);
  const long fy = idx / W;
  const int y = static_cast<int>(fy % H);
  const long b = fy / H;
  const int nby = H / MB, nbx = W / MB;
  const int by = y / MB, bx = x / MB, i = y % MB, j = x % MB;
  const int* m = mv + ((b * nby + by) * nbx + bx) * 2;
  const int dy = m[0], dx = m[1];
  int sy, sx;
  if (edge == kEdgePixel) {
    const int start_y = padded_start(by * MB + MB + dy, H);
    const int start_x = padded_start(bx * MB + MB + dx, W);
    sy = clampi(start_y - MB + i, 0, H - 1);
    sx = clampi(start_x - MB + j, 0, W - 1);
  } else {
    sy = clampi(by * MB + clampi(dy, -radius, radius) + i, 0, H - 1);
    sx = clampi(bx * MB + dx, 0, W - MB) + j;
  }
  float v = to_f32(anchor[(b * H + sy) * W + sx]);
  if (resid != nullptr)
    v = fminf(fmaxf(v + to_f32(resid[idx]), 0.f), 255.f);
  out[idx] = from_f32<T>(v);
}

template <typename T>
void launch(const void* anchor, const int* mv, const void* resid, long n,
            int H, int W, int edge, int radius, void* out,
            cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  qtransfer_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(anchor), mv, static_cast<const T*>(resid), n, H,
      W, edge, radius, static_cast<T*>(out));
}

}  // namespace

// anchor, resid, out: (B, H, W) in the storage type (f32, or bf16 when
// bf16 != 0), H and W multiples of 16; resid may be null (bare gather).
// mv: (B, H/16, W/16, 2) int32 (dy, dx).  edge: 0 pixel, 1 block.
extern "C" int qtransfer_launch(const void* anchor, const int* mv,
                                const void* resid, long B, int H, int W,
                                int edge, int radius, int bf16, void* out,
                                cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % MB || W % MB || radius < 0 ||
      (edge != kEdgePixel && edge != kEdgeBlock))
    return static_cast<int>(cudaErrorInvalidValue);
  const long n = B * H * W;
  if (bf16)
    launch<__nv_bfloat16>(anchor, mv, resid, n, H, W, edge, radius, out,
                          stream);
  else
    launch<float>(anchor, mv, resid, n, H, W, edge, radius, out, stream);
  return static_cast<int>(cudaGetLastError());
}
