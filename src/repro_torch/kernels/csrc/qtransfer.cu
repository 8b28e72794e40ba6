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
// Design, for the bytes: each thread owns 16 bytes of an output row (4 f32
// or 8 bf16 pixels), which always lie inside one macroblock, so it reads
// the motion vector once, the residual as one 16-byte load and writes the
// output as one 16-byte store; a warp covers 512 contiguous bytes of a row.
// A 3-D grid (column run, row, frame) gives every thread its coordinates
// with shifts and no division.  A gather is a copy of bits, so the anchor
// is moved as raw words: a source run inside the row is one aligned 16-byte
// load, or two and a funnel shift when it starts between 16-byte
// boundaries; only a run that crosses the frame's left or right edge reads
// pixel by pixel with the clamp.  Only the residual add reads the bits as
// numbers.

#include <algorithm>

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

// The 16 bytes that start `half` 2-byte halves past the start of `lo` in the
// 32 bytes lo, hi (half in 0..7).
__device__ __forceinline__ uint4 funnel(uint4 lo, uint4 hi, int half) {
  const unsigned w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int ws = half >> 1;
  unsigned r[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    r[i] = ws == 0 ? w[i] : ws == 1 ? w[i + 1] : ws == 2 ? w[i + 2] : w[i + 3];
  if (half & 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = __byte_perm(r[i], r[i + 1], 0x5432);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// The run of 16 bytes of source row `row` (W pixels of Raw) that starts at
// column sx0, each column clamped to [0, W - 1].
template <typename Raw>
__device__ __forceinline__ uint4 gather_run(const Raw* __restrict__ row,
                                            int sx0, int W) {
  constexpr int n = 16 / sizeof(Raw);
  if (sx0 >= 0 && sx0 + n <= W) {
    // inside the row; W is a multiple of 16 pixels, so the second aligned
    // load never passes the row's end
    const int s = sx0 & (n - 1);
    const uint4* p = reinterpret_cast<const uint4*>(row + (sx0 - s));
    const uint4 lo = __ldg(p);
    if (s == 0) return lo;
    return funnel(lo, __ldg(p + 1), s * static_cast<int>(sizeof(Raw)) / 2);
  }
  Raw e[n];
#pragma unroll
  for (int k = 0; k < n; ++k) e[k] = __ldg(row + clampi(sx0 + k, 0, W - 1));
  if constexpr (sizeof(Raw) == 4) {
    return make_uint4(e[0], e[1], e[2], e[3]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = static_cast<unsigned>(e[2 * k]) |
             (static_cast<unsigned>(e[2 * k + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ float clip(float v) {
  return fminf(fmaxf(v, 0.f), 255.f);
}

// One word of a + r, clipped: one f32, or two bf16 added in f32.
template <typename Raw>
__device__ __forceinline__ unsigned add_clip(unsigned a, unsigned r) {
  if constexpr (sizeof(Raw) == 4) {
    return __float_as_uint(clip(__uint_as_float(a) + __uint_as_float(r)));
  } else {
    const float2 fa =
        __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
    const float2 fr =
        __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
    __nv_bfloat162 o = __floats2bfloat162_rn(clip(fa.x + fr.x),
                                             clip(fa.y + fr.y));
    return *reinterpret_cast<unsigned*>(&o);
  }
}

// Raw: the storage type's bits, unsigned (f32) or unsigned short (bf16).
template <typename Raw>
__global__ void __launch_bounds__(kThreads)
qtransfer_kernel(const Raw* __restrict__ anchor, const int2* __restrict__ mv,
                 const Raw* __restrict__ resid, int B, int H, int W, int edge,
                 int radius, Raw* __restrict__ out) {
  constexpr int n = 16 / sizeof(Raw);
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * n;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x0 >= W || y >= H) return;
  const int nby = H / MB, nbx = W / MB;
  static_assert(MB == 16, "macroblock coordinates by shifts");
  const int by = y >> 4, i = y & 15, bx = x0 >> 4, j0 = x0 & 15;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const int2 m = __ldg(mv + (static_cast<long>(b) * nby + by) * nbx + bx);
    int sy, sx0;
    if (edge == kEdgePixel) {
      sy = clampi(padded_start(by * MB + MB + m.x, H) - MB + i, 0, H - 1);
      sx0 = padded_start(bx * MB + MB + m.y, W) - MB + j0;
    } else {
      sy = clampi(by * MB + clampi(m.x, -radius, radius) + i, 0, H - 1);
      sx0 = clampi(bx * MB + m.y, 0, W - MB) + j0;
    }
    const long frame = static_cast<long>(b) * H * W;
    uint4 v = gather_run(anchor + frame + static_cast<long>(sy) * W, sx0, W);
    const long o = frame + static_cast<long>(y) * W + x0;
    if (resid != nullptr) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(resid + o));
      v = make_uint4(add_clip<Raw>(v.x, r.x), add_clip<Raw>(v.y, r.y),
                     add_clip<Raw>(v.z, r.z), add_clip<Raw>(v.w, r.w));
    }
    *reinterpret_cast<uint4*>(out + o) = v;
  }
}

bool aligned(const void* p, unsigned long bytes) {
  return (reinterpret_cast<unsigned long>(p) & (bytes - 1)) == 0;
}

template <typename Raw>
int launch(const void* anchor, const int* mv, const void* resid, long B,
           int H, int W, int edge, int radius, void* out,
           cudaStream_t stream) {
  constexpr int n = 16 / sizeof(Raw);
  // a warp across 32 runs of a row (fewer when the row is narrower), the
  // rest of the block down the rows
  const int runs = W / n;
  const int across = std::min(runs, 32);
  const dim3 block(across, kThreads / across);
  const dim3 grid((runs + block.x - 1) / block.x,
                  (H + block.y - 1) / block.y,
                  static_cast<unsigned>(std::min(B, 65535L)));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  qtransfer_kernel<Raw><<<grid, block, 0, stream>>>(
      static_cast<const Raw*>(anchor), reinterpret_cast<const int2*>(mv),
      static_cast<const Raw*>(resid), static_cast<int>(B), H, W, edge, radius,
      static_cast<Raw*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// anchor, resid, out: (B, H, W) in the storage type (f32, or bf16 when
// bf16 != 0), H and W multiples of 16, 16-byte aligned; resid may be null
// (bare gather).  mv: (B, H/16, W/16, 2) int32 (dy, dx), 8-byte aligned.
// edge: 0 pixel, 1 block.
extern "C" int qtransfer_launch(const void* anchor, const int* mv,
                                const void* resid, long B, int H, int W,
                                int edge, int radius, int bf16, void* out,
                                cudaStream_t stream) {
  if (B <= 0 || B > 0x7fffffffL || H <= 0 || W <= 0 || H % MB || W % MB ||
      radius < 0 || (edge != kEdgePixel && edge != kEdgeBlock))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(anchor, 16) || !aligned(out, 16) || !aligned(resid, 16) ||
      !aligned(mv, 8))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (bf16)
    return launch<unsigned short>(anchor, mv, resid, B, H, W, edge, radius,
                                  out, stream);
  return launch<unsigned>(anchor, mv, resid, B, H, W, edge, radius, out,
                          stream);
}
