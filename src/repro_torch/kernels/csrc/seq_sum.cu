// seq_sum: the order-stable sum of a row-major grid of f32 partials, one
// total per lane.
//
// No TPU kernel stands behind it: it is the semantics of
// src/repro/codec/blockdct.py:seq_sum, which XLA runs as lax.scan (a strict
// left-to-right f32 scan of each row, vmapped over the rows, then a strict
// scan over the row totals).  That order is what makes zeroed padding an
// exact no-op: a column suffix of zeros within each row and a suffix of
// all-zero rows add +0.0 to the same add sequence the unpadded grid runs.
// In PyTorch a strict scan costs one launch a column; this kernel does the
// whole grid of every lane in one launch.
//
// Layout: x is (L, R, C) f32, contiguous; out is (L,) f32.  A 1-D sum is
// R = 1; leading axes of the caller (streams x frames) are the L lanes.
//
// Bound on an H100 SXM: it reads 4 bytes a partial and writes 4 a lane, and
// does one add a partial.  At the main path's largest grid (270 lanes of
// 90 x 160 8x8-block partials of an HD anchor frame) that is 15.6 MB, about
// 4.6 us at 3.35 TB/s; the adds are 3.9 M, under 0.1 us: bound by bytes.
//
// Design: one thread block a lane.  Thread r scans row r (and r + 128, ...)
// serially from column 0 up, so each row's adds are the reference's; the
// row totals go to shared memory, and thread 0 scans them in row order.
// Every add is __fadd_rn: the sum is exactly IEEE round-to-nearest adds in
// the reference's order, with nothing that nvcc could contract or reorder
// (there are no products to fuse, and __fadd_rn is never reassociated).
// A row is read by one thread, 4 bytes a step; the 32-byte sectors of a
// row serve 8 steps of that thread from L1.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
// the row totals of a lane live in shared memory: at most 48 KB
constexpr int kMaxRows = 48 * 1024 / 4;

__global__ void __launch_bounds__(kThreads)
seq_sum_kernel(const float* __restrict__ x, int rows, int cols,
               float* __restrict__ out) {
  extern __shared__ float totals[];
  const float* lane = x + static_cast<long>(blockIdx.x) * rows * cols;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const float* row = lane + static_cast<long>(r) * cols;
    float acc = 0.f;
    for (int c = 0; c < cols; ++c) acc = __fadd_rn(acc, __ldg(row + c));
    totals[r] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, totals[r]);
    out[blockIdx.x] = acc;
  }
}

}  // namespace

// x: (lanes, rows, cols) f32 contiguous -> out: (lanes,) f32.
extern "C" int seq_sum_launch(const float* x, long lanes, int rows, int cols,
                              float* out, cudaStream_t stream) {
  if (lanes <= 0 || lanes > INT_MAX || rows <= 0 || rows > kMaxRows ||
      cols <= 0 || static_cast<long>(rows) * cols > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  seq_sum_kernel<<<static_cast<unsigned>(lanes), kThreads,
                   rows * sizeof(float), stream>>>(x, rows, cols, out);
  return static_cast<int>(cudaGetLastError());
}
