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
// Bound on an H100 SXM: it reads 4 bytes a partial and writes 4 a lane.
// At the main path's largest grid (270 lanes of 90 x 160 8x8-block
// partials of an HD anchor frame) that is 15.6 MB, about 4.6 us at 3.35
// TB/s.  The order makes each lane a chain of C + R dependent adds (a row,
// then the row totals), which no layout shortens: 250 adds at 90 x 160,
// about 0.5 us at 4 cycles an add and 1.98 GHz.  Large grids are bound by
// bytes; the small ones by that chain and by the latency of a load.
//
// Design.  A block owns whole lanes, a run of consecutive rows of the
// flat (L * R, C) grid: several lanes where lanes are short (one thread a
// (lane, row), so the (S, 1, T) grids of a few lanes fill a warp), else
// one.  The Python side chooses that layout (kernels/seq_sum/ops.py:plan)
// and the launch checks it.
// - Staging: a tile of the block's rows is one contiguous run of x (all
//   of C, or a part of one row), kept in shared memory as it lies in x,
//   each row rounded up to 16 bytes.  Where C is a multiple of 4 and x is
//   16-byte aligned, thread 0 brings the whole tile in with one bulk copy
//   (cp.async.bulk: the TMA unit streams it) that completes on an
//   mbarrier; elsewhere (odd widths, misaligned x) the block copies it
//   with 4-byte cp.async, neighbouring threads on neighbouring addresses,
//   and waits once.  A block with more rows than a tile holds (or rows
//   wider than one) walks them in tiles through two buffers, bringing in
//   the next tile while it scans this one.
// - Scan: thread t adds row t of the tile from +0.0, left to right, 16
//   bytes a shared-memory read, the next 4 reads in flight while this
//   step's 16 adds run.  Rows an even number of 16-byte chunks apart
//   would put the eight threads of a quarter warp reading the same chunk
//   of eight rows on one bank group; there thread t runs (t mod 8) chunks
//   behind (reading -0.0 before its row starts and after it ends, an
//   exact no-op on any sum), so the eight read eight bank groups.  A row
//   split into column tiles keeps its sum in the thread's register.
// - Row totals: each thread writes its row's total to the block's shared
//   memory.  Then one thread a lane adds the lane's R totals in row order
//   from +0.0 and writes the lane's sum, with the rows' scan: each lane's
//   totals start on a 16-byte boundary.
// Every add is __fadd_rn: the sum is exactly IEEE round-to-nearest adds in
// the reference's order, plus adds of -0.0, with nothing that nvcc could
// contract or reorder (there are no products to fuse, and __fadd_rn is
// never reassociated).

#include <atomic>
#include <climits>
#include <cstdint>
#include <mutex>

#include "common.cuh"

namespace {

// ops.py's limits, checked at every launch
constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 227 * 1024;
// the row totals of a lane live in shared memory: at most 48 KB
constexpr int kMaxRows = 48 * 1024 / 4;
// a scan's reads a step, loaded while the step before adds
constexpr int kChunks = 4;
// the most chunks a thread runs behind: quarter-warp threads - 1
constexpr int kSkew = 7;

// the dynamic shared memory the kernel may take on each device, above
// the 48 KB it takes without opting in
constexpr int kMaxDevices = 64;
std::atomic<int> smem_opt_in[kMaxDevices];
std::mutex smem_opt_in_mutex;  // so that the opt-in only ever grows

struct Plan {
  int lanes_per_cta;  // whole lanes a block
  int tile_rows;      // rows staged at once, one thread each
  int tile_cols;      // columns staged at once (C, or a multiple of 4)
  int stride;         // a staged row in floats: tile_cols rounded up to 4
  int buffers;        // 2 where a block has more than one tile
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16) from global src to shared
// dst, both 16-byte aligned, completing on bar, which it arms with the
// byte count.  The fence orders the block's earlier reads of dst (behind
// the barrier that freed the buffer) before the copy's writes.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Copy rows [row0, row0 + rows), columns [col0, col0 + cols) of the flat
// grid into buf, 4 bytes a copy, neighbouring threads on neighbouring
// addresses, as one group.  The (row, column) of each next copy is
// stepped on, not divided out.
__device__ __forceinline__ void copy4(const float* __restrict__ x, long row0,
                                      int rows, int C, int col0, int cols,
                                      float* buf, int stride) {
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  const int dr = blockDim.x / cols, dc = blockDim.x % cols;
  for (; r < rows; r += dr) {
    cp_async4(buf + r * stride + c, x + (row0 + r) * C + col0 + c);
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16-byte chunk k of a row of `full` chunks, -0.0 outside it
__device__ __forceinline__ float4 chunk(const float4* v, int k, int full) {
  return k >= 0 && k < full ? v[k] : make_float4(-0.f, -0.f, -0.f, -0.f);
}

// acc + row[0] + row[1] + ... + row[cols - 1], strictly in that order;
// row 16-byte aligned.  The chunks are read `skew` steps late (of `span`
// extra steps, the same for the whole warp): the adds of -0.0 around the
// row change no sum.
__device__ __forceinline__ float scan_row(const float* row, int cols,
                                          float acc, int skew, int span) {
  const float4* v = reinterpret_cast<const float4*>(row);
  const int full = cols / 4;
  const int steps = (full + span + kChunks - 1) / kChunks;
  float4 cur[kChunks];
#pragma unroll
  for (int u = 0; u < kChunks; ++u) cur[u] = chunk(v, u - skew, full);
  for (int s = 0; s < steps; ++s) {
    float4 next[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u)
      next[u] = chunk(v, (s + 1) * kChunks + u - skew, full);
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      acc = __fadd_rn(acc, cur[u].x);
      acc = __fadd_rn(acc, cur[u].y);
      acc = __fadd_rn(acc, cur[u].z);
      acc = __fadd_rn(acc, cur[u].w);
      cur[u] = next[u];
    }
  }
  for (int c = 4 * full; c < cols; ++c) acc = __fadd_rn(acc, row[c]);
  return acc;
}

__global__ void __launch_bounds__(kMaxThreads)
seq_sum_kernel(const float* __restrict__ x, long lanes, int R, int C, Plan p,
               bool bulk, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[2];  // a buffer's bulk copies
  float* totals = smem + p.buffers * p.tile_rows * p.stride;
  const long lane0 = static_cast<long>(blockIdx.x) * p.lanes_per_cta;
  const int n_lanes =
      static_cast<int>(min(static_cast<long>(p.lanes_per_cta), lanes - lane0));
  // this block's rows of the flat grid [g0, g1); row r of lane lane0 + j
  // has slot j * rpad + r in totals
  const long g0 = lane0 * R, g1 = (lane0 + n_lanes) * R;
  const int n_ct = (C + p.tile_cols - 1) / p.tile_cols;
  const int n_tiles =
      static_cast<int>((g1 - g0 + p.tile_rows - 1) / p.tile_rows) * n_ct;
  const int buf_floats = p.tile_rows * p.stride;
  const int rpad = (R + 3) & ~3;  // lane j's totals: slots j * rpad ...
  // rows an even number of chunks apart: thread t reads (t mod 8) late
  const bool skewed = p.stride / 4 % 2 == 0;
  const int skew = skewed ? threadIdx.x % (kSkew + 1) : 0;
  const int span = skewed ? kSkew : 0;

  if (bulk && threadIdx.x == 0) {
    mbar_init(smem_addr(&bars[0]), 1);
    mbar_init(smem_addr(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // tile i: row tile i / n_ct, column tile i % n_ct, in buffer i % 2; a
  // tile of several rows spans all C columns, so it is one run of x
  auto issue = [&](int i) {
    const long row0 = g0 + static_cast<long>(i / n_ct) * p.tile_rows;
    const int rows =
        static_cast<int>(min(static_cast<long>(p.tile_rows), g1 - row0));
    const int col0 = (i % n_ct) * p.tile_cols;
    const int cols = min(p.tile_cols, C - col0);
    float* buf = smem + (i & 1) * buf_floats;
    if (!bulk)
      copy4(x, row0, rows, C, col0, cols, buf, p.stride);
    else if (threadIdx.x == 0)
      bulk_load(buf, x + row0 * C + col0, 4u * rows * cols,
                smem_addr(&bars[i & 1]));
  };
  if (n_tiles > 0) issue(0);
  float acc = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    // into the other buffer, freed by the barrier that ended the last tile
    if (i + 1 < n_tiles) issue(i + 1);
    if (bulk) {
      // a buffer's n-th tile completes its barrier's n-th phase
      mbar_wait(smem_addr(&bars[i & 1]), (i >> 1) & 1);
    } else {
      if (i + 1 < n_tiles)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }
    const long row0 = g0 + static_cast<long>(i / n_ct) * p.tile_rows;
    const int ct = i % n_ct, col0 = ct * p.tile_cols;
    const int rows =
        static_cast<int>(min(static_cast<long>(p.tile_rows), g1 - row0));
    if (ct == 0) acc = 0.f;
    if (static_cast<int>(threadIdx.x) < rows) {
      acc = scan_row(smem + (i & 1) * buf_floats + threadIdx.x * p.stride,
                     min(p.tile_cols, C - col0), acc, skew, span);
      if (ct == n_ct - 1) {
        const int g = static_cast<int>(row0 - g0) + threadIdx.x;
        totals[g / R * rpad + g % R] = acc;
      }
    }
    __syncthreads();
  }
  if (static_cast<int>(threadIdx.x) < n_lanes) {
    out[lane0 + threadIdx.x] =
        scan_row(totals + threadIdx.x * rpad, R, 0.f, 0, 0);
  }
}

}  // namespace

// x: (lanes, rows, cols) f32 contiguous -> out: (lanes,) f32, with the
// layout of ops.py:plan (lanes_per_cta, tile_rows, tile_cols, threads,
// buffers).  Returns cudaErrorInvalidValue for a grid or a plan the
// kernel does not take.
extern "C" int seq_sum_launch(const float* x, long lanes, int rows, int cols,
                              int lanes_per_cta, int tile_rows, int tile_cols,
                              int threads, int buffers, float* out,
                              cudaStream_t stream) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (lanes <= 0 || lanes > INT_MAX || rows <= 0 || rows > kMaxRows ||
      cols <= 0 || static_cast<long>(rows) * cols > INT_MAX)
    return invalid;
  // a tile is one run of x: a part of one row, or whole rows
  if (lanes_per_cta < 1 || threads < kWarp || threads > kMaxThreads ||
      threads % kWarp || tile_rows < 1 || tile_rows > threads ||
      lanes_per_cta > threads || tile_cols < 1 || tile_cols > cols ||
      (tile_cols < cols && (tile_cols % 4 || tile_rows > 1)) ||
      (buffers != 1 && buffers != 2))
    return invalid;
  const Plan p{lanes_per_cta, tile_rows, tile_cols, (tile_cols + 3) & ~3,
               buffers};
  const long block_rows = static_cast<long>(lanes_per_cta) * rows;
  if (buffers == 1 && (block_rows > tile_rows || tile_cols < cols))
    return invalid;
  const long rpad = (rows + 3) & ~3;
  const long smem = 4 * (static_cast<long>(buffers) * tile_rows * p.stride +
                         lanes_per_cta * rpad);
  const long grid = (lanes + lanes_per_cta - 1) / lanes_per_cta;
  if (smem > kMaxSmem || grid > INT_MAX) return invalid;
  if (smem > 48 * 1024) {
    // opt in where this launch takes more than the device's kernel may
    // yet: once a device for a path's grids
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool kept = device < kMaxDevices;
    if (!kept || smem > smem_opt_in[device].load()) {
      std::lock_guard<std::mutex> lock(smem_opt_in_mutex);
      if (!kept || smem > smem_opt_in[device].load()) {
        e = cudaFuncSetAttribute(seq_sum_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        if (kept) smem_opt_in[device].store(static_cast<int>(smem));
      }
    }
  }
  // the bulk copy needs whole rows of 16 bytes (so that a tile lies in
  // shared memory as in x) and a 16-byte aligned x
  const bool bulk =
      cols % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  seq_sum_kernel<<<static_cast<unsigned>(grid), threads,
                   static_cast<size_t>(smem), stream>>>(x, lanes, rows, cols,
                                                        p, bulk, out);
  return static_cast<int>(cudaGetLastError());
}
