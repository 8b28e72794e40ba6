// roi_gather: packs the detector's top-K regions of each frame into a
// dense batch of (P, P) patches, P = region_px + 2 * halo, f32.
//
// Replaces src/repro/kernels/roi_gather/kernel.py:roi_gather_patches
// (_gather_kernel); oracle repro/kernels/roi_gather/ops.py:roi_gather_ref.
// Lane (t, k) copies the patch of the halo-padded plane t that starts at
// (ry[t, k] * region_px, rx[t, k] * region_px); a start out of range is
// treated as lax.dynamic_slice treats it (a negative one counts from the
// end, then each is clamped to the plane).  An exact gather: lanes the
// gate left invalid still gather their region (the caller points them at
// region 0) and are dropped later.
//
// Bound on an H100 SXM: pure data movement.  At the ROI path's shapes (T=30
// frames of 720x1280 padded by 8, K=36 distinct regions of 80 px, P=96) it
// writes 39.8 MB and must read the distinct source bytes under its lanes'
// windows: less than it writes, since neighbouring patches share their
// 16-px halo strips, from 29.5 MB (the 36 regions in one 6x6 block) to
// 39.8 MB (no two adjacent).  That is 21-24 us at 3.35 TB/s; no
// arithmetic.  It is bound by bytes.  chip_smoke.py counts the union of
// the windows its regions touch and reports the bound from it.
//
// Design: one thread block per (t, k) lane; the block reads its own
// region indices and copies the P rows of its patch, neighbouring threads
// on neighbouring columns, with 16-byte loads and stores where the plane's
// width, the patch side and the starts are multiples of 4 floats (the ROI
// path's are), else 4-byte ones.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// lax.dynamic_slice's start of a P-long slice of an n-long axis
__device__ __forceinline__ int slice_start(int s, int n, int P) {
  return clampi(s < 0 ? s + n : s, 0, n - P);
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
roi_gather_kernel(const float* __restrict__ planes, const int* __restrict__ ry,
                  const int* __restrict__ rx, int K, int Hp, int Wp,
                  int region_px, int P, float* __restrict__ out) {
  const long lane = blockIdx.x;  // t * K + k
  const long t = lane / K;
  const int y0 = slice_start(ry[lane] * region_px, Hp, P);
  const int x0 = slice_start(rx[lane] * region_px, Wp, P);
  const float* src = planes + (t * Hp + y0) * Wp + x0;
  float* dst = out + lane * P * P;
  const int cols = P / kVec;  // vectors per patch row
  for (int i = threadIdx.x; i < P * cols; i += kThreads) {
    const int r = i / cols, c = (i % cols) * kVec;
    if (kVec == 4)
      *reinterpret_cast<float4*>(dst + r * P + c) =
          *reinterpret_cast<const float4*>(src + r * Wp + c);
    else
      dst[r * P + c] = src[r * Wp + c];
  }
}

}  // namespace

// planes: (T, Hp, Wp) f32 halo-padded planes; ry, rx: (T, K) int32 region
// indices; out: (T, K, P, P) f32 with P = region_px + 2 * halo.
extern "C" int roi_gather_launch(const float* planes, const int* ry,
                                 const int* rx, int T, int K, int Hp, int Wp,
                                 int region_px, int halo, float* out,
                                 cudaStream_t stream) {
  const int P = region_px + 2 * halo;
  if (T <= 0 || K <= 0 || region_px <= 0 || halo < 0 || P > Hp || P > Wp)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(planes) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0) &&
                   Wp % 4 == 0 && P % 4 == 0 && region_px % 4 == 0 &&
                   (Wp - P) % 4 == 0;
  const unsigned grid = static_cast<unsigned>(T) * static_cast<unsigned>(K);
  if (vec)
    roi_gather_kernel<4><<<grid, kThreads, 0, stream>>>(
        planes, ry, rx, K, Hp, Wp, region_px, P, out);
  else
    roi_gather_kernel<1><<<grid, kThreads, 0, stream>>>(
        planes, ry, rx, K, Hp, Wp, region_px, P, out);
  return static_cast<int>(cudaGetLastError());
}
