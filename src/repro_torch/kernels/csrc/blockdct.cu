// blockdct: 8x8 block DCT + quantisation, and its inverse, f32, taking its
// tiles straight from raster frames.
//
// Replaces src/repro/kernels/blockdct/kernel.py:blockdct_tiles (_kernel):
//   forward_quant: y = D x D^T, q = round(y / qtab), rec = D^T (q qtab) D
//   inverse:       rec = D^T (q qtab) D   (the decoder's half)
// Layouts: frames and rec are (F, H, W) raster, H and W multiples of 8; q is
// (F, (H/8)(W/8), 8, 8) in block order (tiles row-major over the frame).  The
// (nb, 8, 8) block form is the case F = nb, H = W = 8.  qtab is one (8, 8)
// table for every frame, or (F, 8, 8), one table a frame (qstride 64): the
// streams of a mixed-ladder batch have their own quantisers, and the anchor
// budget search its own rung a frame.  The level shift and the clamp stay
// with the caller, as in the reference.
// Oracles: repro/kernels/blockdct/ref.py:blockdct_ref and the codec's
// dct2 / quantize_with_table / idct2 (repro/codec/blockdct.py).
//
// Bound on an H100 SXM: forward_quant reads 4 bytes a pixel and writes 8
// (q and rec) and does 4 small 8x8x8 products (64 f32 operations a pixel).
// At the anchor batch of the main path (30 frames of 720x1280 = 432,000
// tiles) that is 332 MB, about 99 us at 3.35 TB/s, against 1.8 GFLOP, about
// 26 us at 67 TFLOP/s: bound by bytes.  inverse moves two thirds of that.
//
// Design, for the bytes: no block-order copy of the frames before the
// launch or of rec after it (each such copy moved as many bytes as the
// kernel reads), and no block-wide barrier.  Eight lanes own one tile and a
// warp four tiles side by side, so a warp's loads and stores cover 8 rows x
// 128 bytes of a frame.  A persistent grid of warps walks over groups of
// four tiles, the next group's rows loaded while the current one is
// computed.  D sits in 64 registers of every thread, loaded once; each
// lane's column of its tile's table in 8 (loaded once, or a group at a time
// with a table a frame: L1-resident loads).  The tile goes through the four
// products without leaving the warp:
//   rows:    lane r holds row r of x (two 16-byte loads) -> b = x D^T;
//   columns: b is transposed through a shared tile of the warp's own
//            (__syncwarp only) -> lane c holds column c of y = D b, q, and
//            z = D^T (q qtab); q is stored in block order from there (each
//            store instruction writes four whole 32-byte sectors);
//   rows:    z is transposed back -> lane r holds row r of rec = z D, stored
//            as two 16-byte stores into the raster frame.
// The inverse loads q by columns and runs the same second half, so
// inverse(q) equals the forward's rec bit for bit.
// Arithmetic as the reference's: every 8-term sum is fmaf in index order,
// an IEEE division y / qtab (not a reciprocal; built without
// --use_fast_math) and rintf, which rounds half to even like jnp.round.
// The sum order differs from XLA's, so q may differ by 1 where y / qtab lies
// within rounding of a .5 boundary.

#include <algorithm>
#include <atomic>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTilesPerWarp = 4;
// a staged tile's row pitch and the distance between a warp's staged tiles,
// in floats: the 16-byte row accesses of 8 lanes and the 4-byte column
// accesses of 32 lanes each hit distinct banks
constexpr int kPitch = 12;
constexpr int kTileStride = 8 * kPitch + 8;
constexpr int kStage = kTilesPerWarp * kTileStride;

struct Geometry {
  int H, W;   // frame size
  int nbx;    // tiles a tile row
  int nb;     // tiles a frame
  int tiles;  // F * nb
};

// Float offset of tile g's first pixel in the raster frames.
__device__ __forceinline__ long tile_origin(int g, const Geometry& geo) {
  const int f = g / geo.nb;
  const int t = g - f * geo.nb;
  const int ty = t / geo.nbx;
  const int tx = t - ty * geo.nbx;
  return (static_cast<long>(f) * geo.H + ty * 8) * geo.W + tx * 8;
}

__device__ __forceinline__ void load_row(const float* p, bool valid,
                                         float (&v)[8]) {
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (valid) {
    lo = __ldg(reinterpret_cast<const float4*>(p));
    hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load_dct(const float* __restrict__ dmat,
                                         float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(dmat) + i);
    d[4 * i] = v.x; d[4 * i + 1] = v.y; d[4 * i + 2] = v.z; d[4 * i + 3] = v.w;
  }
}

// Column c of the quantisation table of tile g's frame: the one table when
// qstride is 0, else frame g / nb's of (F, 8, 8) tables.
__device__ __forceinline__ void load_qcolumn(const float* __restrict__ qtab,
                                             int qstride, int g, bool valid,
                                             const Geometry& geo, int c,
                                             float (&qt)[8]) {
  const long base = valid ? static_cast<long>(g / geo.nb) * qstride : 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) qt[k] = __ldg(qtab + base + k * 8 + c);
}

// Second half, from lane c's column of a = q qtab: z = D^T a by columns,
// transposed through the warp's shared tile `s`, then rec = z D by rows;
// lane r stores row r of rec at `out` when `valid`.
__device__ __forceinline__ void inverse_columns(const float (&d)[64],
                                                const float (&a)[8], int j,
                                                float* s, float* out,
                                                bool valid) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(d[k * 8 + r], a[k], acc);
    s[r * kPitch + j] = acc;
  }
  __syncwarp();
  float z[8];
  {
    const float4 lo = *reinterpret_cast<const float4*>(s + j * kPitch);
    const float4 hi = *reinterpret_cast<const float4*>(s + j * kPitch + 4);
    z[0] = lo.x; z[1] = lo.y; z[2] = lo.z; z[3] = lo.w;
    z[4] = hi.x; z[5] = hi.y; z[6] = hi.z; z[7] = hi.w;
  }
  float rec[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(z[k], d[k * 8 + c], acc);
    rec[c] = acc;
  }
  if (valid) {
    float4* o = reinterpret_cast<float4*>(out);
    o[0] = make_float4(rec[0], rec[1], rec[2], rec[3]);
    o[1] = make_float4(rec[4], rec[5], rec[6], rec[7]);
  }
}

__global__ void __launch_bounds__(kThreads)
forward_quant_kernel(const float* __restrict__ frames,
                     const float* __restrict__ dmat,
                     const float* __restrict__ qtab, int qstride,
                     Geometry geo, float* __restrict__ q_out,
                     float* __restrict__ rec_out) {
  __shared__ __align__(16) float stage[kWarps][2][kStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane >> 3, j = lane & 7;  // tile of the warp's 4; row/column
  float* sb = stage[warp][0] + t * kTileStride;
  float* sz = stage[warp][1] + t * kTileStride;
  float d[64], qt[8];
  load_dct(dmat, d);

  const int groups = (geo.tiles + kTilesPerWarp - 1) / kTilesPerWarp;
  const int step = gridDim.x * kWarps;
  int grp = blockIdx.x * kWarps + warp;
  int g = grp * kTilesPerWarp + t;
  bool valid = g < geo.tiles;
  long origin = valid ? tile_origin(g, geo) : 0;
  float x[8];
  load_row(frames + origin + static_cast<long>(j) * geo.W, valid, x);
  load_qcolumn(qtab, 0, 0, false, geo, j, qt);
  for (; grp < groups; grp += step) {
    // a warp's four tiles may lie in two frames: each lane takes its own
    // tile's table
    if (qstride) load_qcolumn(qtab, qstride, g, valid, geo, j, qt);
    // the next group's rows are in flight while this group is computed
    const int g_next = (grp + step) * kTilesPerWarp + t;
    const bool valid_next = grp + step < groups && g_next < geo.tiles;
    const long origin_next = valid_next ? tile_origin(g_next, geo) : 0;
    float x_next[8];
    load_row(frames + origin_next + static_cast<long>(j) * geo.W, valid_next,
             x_next);

    // rows: lane j holds row j of x; b = x D^T
    float b[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = fmaf(x[k], d[c * 8 + k], acc);
      b[c] = acc;
    }
    reinterpret_cast<float4*>(sb + j * kPitch)[0] =
        make_float4(b[0], b[1], b[2], b[3]);
    reinterpret_cast<float4*>(sb + j * kPitch)[1] =
        make_float4(b[4], b[5], b[6], b[7]);
    __syncwarp();
    // columns: lane j holds column j of b; y = D b, q, a = q qtab
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = sb[k * kPitch + j];
    float a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = fmaf(d[r * 8 + k], b[k], acc);
      const float q = rintf(acc / qt[r]);
      if (valid) q_out[static_cast<long>(g) * 64 + r * 8 + j] = q;
      a[r] = q * qt[r];
    }
    inverse_columns(d, a, j, sz,
                    rec_out + origin + static_cast<long>(j) * geo.W, valid);

    g = g_next;
    valid = valid_next;
    origin = origin_next;
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = x_next[k];
  }
}

__device__ __forceinline__ void load_column(const float* __restrict__ q_in,
                                            int g, int j, bool valid,
                                            const float (&qt)[8],
                                            float (&a)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    a[k] = valid ? __ldg(q_in + static_cast<long>(g) * 64 + k * 8 + j) * qt[k]
                 : 0.f;
}

__global__ void __launch_bounds__(kThreads)
inverse_kernel(const float* __restrict__ q_in, const float* __restrict__ dmat,
               const float* __restrict__ qtab, int qstride, Geometry geo,
               float* __restrict__ rec_out) {
  __shared__ __align__(16) float stage[kWarps][kStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane >> 3, j = lane & 7;
  float* sz = stage[warp] + t * kTileStride;
  float d[64], qt[8];
  load_dct(dmat, d);
  load_qcolumn(qtab, 0, 0, false, geo, j, qt);

  const int groups = (geo.tiles + kTilesPerWarp - 1) / kTilesPerWarp;
  const int step = gridDim.x * kWarps;
  int grp = blockIdx.x * kWarps + warp;
  int g = grp * kTilesPerWarp + t;
  bool valid = g < geo.tiles;
  if (qstride) load_qcolumn(qtab, qstride, g, valid, geo, j, qt);
  float a[8];
  load_column(q_in, g, j, valid, qt, a);
  for (; grp < groups; grp += step) {
    const int g_next = (grp + step) * kTilesPerWarp + t;
    const bool valid_next = grp + step < groups && g_next < geo.tiles;
    float a_next[8];
    // this group's a is scaled already: qt may take the next group's table
    if (qstride) load_qcolumn(qtab, qstride, g_next, valid_next, geo, j, qt);
    load_column(q_in, g_next, j, valid_next, qt, a_next);
    const long origin = valid ? tile_origin(g, geo) : 0;
    __syncwarp();  // the previous group's reads of sz are done
    inverse_columns(d, a, j, sz,
                    rec_out + origin + static_cast<long>(j) * geo.W, valid);
    g = g_next;
    valid = valid_next;
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = a_next[k];
  }
}

// Enough warps to fill every SM of the current device at the kernel's
// occupancy, and no more than there are groups of tiles.  The resident
// block count is cached a device (cards of one machine may differ in SMs),
// in atomics because launches may come from several host threads.
constexpr int kMaxDevices = 64;

template <typename Kernel>
unsigned persistent_grid(Kernel kernel, int groups,
                         std::atomic<int>* cached) {
  int dev = 0;
  cudaGetDevice(&dev);
  int blocks = dev < kMaxDevices ? cached[dev].load(std::memory_order_relaxed)
                                 : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    blocks = std::max(1, sms * per_sm);
    if (dev < kMaxDevices) cached[dev].store(blocks, std::memory_order_relaxed);
  }
  return static_cast<unsigned>(
      std::min(blocks, (groups + kWarps - 1) / kWarps));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long>(p) & 15) == 0;
}

// The geometry of F frames of H x W, or false when the kernel does not take
// them.
bool geometry(long F, int H, int W, Geometry* geo) {
  if (F <= 0 || H <= 0 || W <= 0 || H % 8 || W % 8) return false;
  const long nb = static_cast<long>(H / 8) * (W / 8);
  if (nb > INT_MAX / 4 || F > INT_MAX / 4 / nb) return false;
  *geo = Geometry{H, W, W / 8, static_cast<int>(nb), static_cast<int>(F * nb)};
  return true;
}

}  // namespace

// frames, rec: (F, H, W) f32 raster, H and W multiples of 8; q: (F, nb, 8, 8)
// f32 in block order; dmat: (8, 8) f32; qtab: (8, 8) f32 (qstride 0) or
// (F, 8, 8), one table a frame (qstride 64).  frames, rec and dmat 16-byte
// aligned.
extern "C" int blockdct_forward_quant(const float* frames, const float* dmat,
                                      const float* qtab, int qstride, long F,
                                      int H, int W, float* q, float* rec,
                                      cudaStream_t stream) {
  static std::atomic<int> cached[kMaxDevices];
  Geometry geo;
  if (!geometry(F, H, W, &geo) || (qstride != 0 && qstride != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(frames) || !aligned16(rec) || !aligned16(dmat))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int groups = (geo.tiles + kTilesPerWarp - 1) / kTilesPerWarp;
  forward_quant_kernel<<<persistent_grid(forward_quant_kernel, groups,
                                         cached),
                         kThreads, 0, stream>>>(frames, dmat, qtab, qstride,
                                                geo, q, rec);
  return static_cast<int>(cudaGetLastError());
}

// q: (F, nb, 8, 8) f32 in block order -> rec: (F, H, W) f32 raster; qtab
// as for blockdct_forward_quant.
extern "C" int blockdct_inverse(const float* q, const float* dmat,
                                const float* qtab, int qstride, long F, int H,
                                int W, float* rec, cudaStream_t stream) {
  static std::atomic<int> cached[kMaxDevices];
  Geometry geo;
  if (!geometry(F, H, W, &geo) || (qstride != 0 && qstride != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(rec) || !aligned16(dmat))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int groups = (geo.tiles + kTilesPerWarp - 1) / kTilesPerWarp;
  inverse_kernel<<<persistent_grid(inverse_kernel, groups, cached), kThreads,
                   0, stream>>>(q, dmat, qtab, qstride, geo, rec);
  return static_cast<int>(cudaGetLastError());
}
