// motion_sad: +-R block-matching motion search over 16x16 macroblocks, in
// two strategies (exhaustive, diamond) and two storage types (f32, bf16;
// every SAD is summed in f32), over a batch of frames.
//
// Replaces src/repro/kernels/motion_sad/kernel.py:motion_sad_rows: its
// exhaustive _kernel (oracle repro/codec/motion.py:block_sad_scan) and its
// _diamond_kernel (oracle repro/codec/motion.py:block_sad_diamond), each
// with dtype=None or bf16 storage.
//
// What bounds it on an H100 SXM, at the main path's LR frame (352x640,
// R=8, 880 macroblocks):
//   exhaustive: 880 x 289 candidates x 256 px = 65.1 M abs-diff-adds
//     against 1.8 MB of cur and ref in f32.  The published 67 TFLOP/s
//     gives 1.9 us (bound by operations), but it counts an FMA as two
//     operations, and |c - w| + acc has no FMA form: it is two FADDs, at
//     one FADD a clock per FP32 lane (132 SMs x 128 lanes).  So 130 M
//     FADDs cannot issue in less than ~3.9 us at 1.98 GHz (~4.2 us at
//     1.83 GHz): the issue-rate ceiling, half the published rate.
//   diamond: 880 x 37 candidates x 256 px = 8.3 M abs-diff-adds against
//     1.8 MB in f32 (0.54 us) or 0.9 MB in bf16 (0.27 us): bound by bytes
//     on paper; in fact by the launch and the chain of its dependent
//     rounds, each a 64-term sum.
//
// No block-wide barrier runs inside either form's candidate loop or
// diamond rounds.
//
// One summation order, shared by both forms (accumulate_row, combine):
// a candidate's 256 differences fall into kSplit row groups, group g
// holding rows g, g + kSplit, g + 2 kSplit, ...; a group's partial sum
// starts at 0 and runs over its rows in order and, in each row, over the
// 16 columns in order; the SAD is the partials added in group order.  So
// every candidate's SAD is the same f32 number in both forms, and the
// diamond's SAD, the SAD of one of the exhaustive candidates, is never
// below the exhaustive one, bit for bit, on any input.
//
// Both forms stage what they search in shared memory once, in f32 (exact
// for bf16), the reference edge-replicated by clamped source indices:
// four columns a load (one 16- or 8-byte load inside the frame, clamped
// scalars at its edges), a few loads in flight a thread, no division per
// element (stage).
//
// Exhaustive form: one block covers a tile of macroblocks of one row
// (tile + 2R reference window), behind the one barrier before the search.
// A thread owns one dy, one row group and kDx = 17 consecutive dx
// candidates (a chunk; chunks start 16 apart, so two overlap by one
// candidate, which the merge makes harmless), with one accumulator per
// candidate in registers: each row it loads (16 cur values and 32 window
// values, twelve 16-byte shared loads) feeds 17 x 16 abs-diff-adds.  The
// window's row pitch is an odd number of 16-byte words, so the dy lanes of
// a quarter warp read distinct banks.  The kSplit threads of one (dy,
// chunk) are neighbouring lanes; at the end they swap partials by
// shuffle, each adds them in group order, and the first keeps its best
// candidate as one 64-bit key (SAD bits, then the dy-major index
// (dy+R)(2R+1) + dx+R) and merges it by atomicMin into its macroblock's
// key in shared memory: the least SAD, and of equal SADs the first
// candidate, as the oracles' strict < picks it.  A second barrier, and
// one thread a macroblock writes the result.  At 352x640 and R=8: 68
// threads a macroblock, 4 macroblocks a block of 288 threads, 220 blocks,
// ~3.5 warps for each SM sub-partition.  A tile past the last macroblock
// is masked, not padded with work.
//
// Diamond form: one warp per macroblock, no barrier but __syncwarp.  The
// warp stages its (16+2R)^2 window and its block in shared memory of its
// own, then runs the rounds: the centre, then for each step of
// diamond_steps(R) the 3x3 probes around the best offset found before
// that round, dy-major, each clipped to +-R.  Each lane computes one
// (probe, row group) partial, so a round's probes run at once; every lane
// then adds the partials in group order and scans the probes in dy-major
// order against the running best with a strict <, the same on every
// lane.  1 + len(steps) dependent rounds (5 at R=8).

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kSplit = 4;      // row groups of a candidate's SAD
constexpr int kDx = 17;        // dx candidates of one exhaustive thread
constexpr int kChunk = 16;     // start-to-start distance of its dx chunks
constexpr int kMaxThreads = 320;
constexpr int kMaxTile = 16;   // macroblocks of one exhaustive block
constexpr int kProbes = 9;
constexpr int kDiamondWarps = 4;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kBatch = 4;      // loads in flight a thread while staging
static_assert(MB % kSplit == 0 && 32 % kSplit == 0, "row groups");
static_assert((kProbes - 1) * kSplit <= 32, "a round's partials, one a lane");
static_assert(kDx == kChunk + 1, "chunks overlap by one candidate");

// acc[j] += |c[k] - w[j + k]| over the row's 16 columns k in order.
template <int N>
__device__ __forceinline__ void accumulate_row(float (&acc)[N],
                                               const float (&c)[MB],
                                               const float* w) {
#pragma unroll
  for (int k = 0; k < MB; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] += fabsf(c[k] - w[j + k]);
}

// A candidate's SAD from its row groups' partials, in group order.
__device__ __forceinline__ float combine(const float (&p)[kSplit]) {
  float s = p[0];
#pragma unroll
  for (int g = 1; g < kSplit; ++g) s += p[g];
  return s;
}

// N consecutive floats from 16-byte aligned shared memory
template <int N>
__device__ __forceinline__ void load_row(float (&v)[N], const float* p) {
  static_assert(N % 4 == 0, "16-byte loads");
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// Four pixels of one source row from column x, in f32, clamped to the
// frame: one 16-byte (f32) or 8-byte (bf16) load where the four lie inside
// the frame and vec says the load is aligned, else four clamped loads.
__device__ __forceinline__ void load4(float (&v)[4],
                                      const float* __restrict__ row, int x,
                                      int W, bool vec) {
  if (vec && x >= 0 && x + 4 <= W) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + x));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = row[clampi(x + u, 0, W - 1)];
  }
}
__device__ __forceinline__ void load4(float (&v)[4],
                                      const __nv_bfloat16* __restrict__ row,
                                      int x, int W, bool vec) {
  if (vec && x >= 0 && x + 4 <= W) {
    // a bf16 is the top half of the f32 of the same value
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(row + x));
    v[0] = __uint_as_float(a.x << 16);
    v[1] = __uint_as_float(a.x & 0xffff0000u);
    v[2] = __uint_as_float(a.y << 16);
    v[3] = __uint_as_float(a.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = to_f32(row[clampi(x + u, 0, W - 1)]);
  }
}

// dst[i * pitch + j] = src[clamp(y0 + i), clamp(x0 + j)] in f32 for i <
// rows, j < cols (a multiple of 4): the edge-replicated window, four
// columns a load.  Thread t of n steps through the (row, four columns)
// groups without a division in the loop, and issues kBatch loads before
// it stores, so that it waits on memory once a batch.  vec: the frame's
// rows are 16-byte aligned.
template <typename Store>
__device__ __forceinline__ void stage(float* dst, int pitch,
                                      const Store* __restrict__ src, int H,
                                      int W, int y0, int x0, int rows,
                                      int cols, bool vec, int t, int n) {
  const int groups = cols / 4, total = rows * groups;
  const int di = n / groups, dq = n - di * groups;
  int i = t / groups, q = t - i * groups;
  vec = vec && (x0 & 3) == 0;
  for (int k0 = t; k0 < total; k0 += kBatch * n) {
    float v[kBatch][4];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      at[u] = -1;
      if (k0 + u * n < total) {
        load4(v[u], src + clampi(y0 + i, 0, H - 1) * W, x0 + 4 * q, W, vec);
        at[u] = i * pitch + 4 * q;
      }
      i += di;
      q += dq;
      if (q >= groups) {
        q -= groups;
        ++i;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (at[u] >= 0)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[at[u] + e] = v[u][e];
  }
}

__host__ __device__ constexpr int n_chunks(int radius) {
  return radius ? (2 * radius + kChunk - 1) / kChunk : 1;
}

template <typename Store>
__global__ void __launch_bounds__(kMaxThreads)
motion_sad_exhaustive_kernel(const Store* __restrict__ cur,
                             const Store* __restrict__ ref, int H, int W,
                             int radius, int tile, bool vec,
                             int* __restrict__ mv, float* __restrict__ sad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbx = W / MB, nby = H / MB;
  const int tiles_x = (nbx + tile - 1) / tile;
  const int by = blockIdx.x / tiles_x, bx0 = (blockIdx.x % tiles_x) * tile;
  const size_t frame = blockIdx.y;
  cur += frame * H * W;
  ref += frame * H * W;
  mv += frame * nby * nbx * 2;
  sad += frame * nby * nbx;

  const int nch = n_chunks(radius), ndy = 2 * radius + 1;
  const int rows = MB + 2 * radius, wcols = MB * (tile + nch);
  const int wpitch = wcols + 4, cpitch = MB * tile + 4;
  float* win = reinterpret_cast<float*>(smem);
  float* cb = win + rows * wpitch;
  auto* best = reinterpret_cast<unsigned long long*>(cb + MB * cpitch);
  const int t = threadIdx.x;
  if (t < tile) best[t] = ~0ull;
  // the cur columns of a masked macroblock past the frame are clamped
  stage(win, wpitch, ref, H, W, by * MB - radius, bx0 * MB - radius, rows,
        wcols, vec, t, blockDim.x);
  stage(cb, cpitch, cur, H, W, by * MB, bx0 * MB, MB, MB * tile, vec, t,
        blockDim.x);
  __syncthreads();

  // work items: (macroblock, chunk, dy, row group), the group fastest; the
  // loop runs the same number of times on every thread, so that every
  // lane takes part in the shuffles
  const int per_mb = ndy * nch * kSplit, items = tile * per_mb;
  const int lead = (t & 31) & ~(kSplit - 1);
  for (int it0 = 0; it0 < items; it0 += blockDim.x) {
    const bool live = it0 + t < items;
    const int it = min(it0 + t, items - 1);
    const int mb = it / per_mb, rem = it % per_mb;
    const int g = rem % kSplit, q = rem / kSplit;
    const int dyi = q % ndy, ch = q / ndy;
    const float* wp = win + (g + dyi) * wpitch + MB * (mb + ch);
    const float* cp = cb + g * cpitch + MB * mb;
    float acc[kDx];
#pragma unroll
    for (int j = 0; j < kDx; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < MB / kSplit; ++i) {
      float c[MB], w[MB + kChunk];
      load_row(c, cp + i * kSplit * cpitch);
      load_row(w, wp + i * kSplit * wpitch);
      accumulate_row(acc, c, w);
    }
    unsigned long long key = ~0ull;
    const int idx0 = dyi * ndy + ch * kChunk;   // dy-major index of j = 0
    const int n_valid = min(kDx, ndy - ch * kChunk);
#pragma unroll
    for (int j = 0; j < kDx; ++j) {
      float p[kSplit];
#pragma unroll
      for (int s = 0; s < kSplit; ++s)
        p[s] = __shfl_sync(0xffffffffu, acc[j], lead + s);
      const unsigned long long k =
          (static_cast<unsigned long long>(__float_as_uint(combine(p))) << 32)
          | static_cast<unsigned>(idx0 + j);
      if (j < n_valid && k < key) key = k;
    }
    if (live && g == 0) atomicMin(&best[mb], key);
  }
  __syncthreads();
  if (t < tile && bx0 + t < nbx) {
    const unsigned long long k = best[t];
    const int idx = static_cast<int>(k & 0xffffffffu);
    const int b = by * nbx + bx0 + t;
    mv[2 * b] = idx / ndy - radius;
    mv[2 * b + 1] = idx % ndy - radius;
    sad[b] = __uint_as_float(static_cast<unsigned>(k >> 32));
  }
}

// The diamond form's window: side = 16 + 2R rows of side columns, staged
// in groups of four (cols: side rounded up to 4).  Its row pitch is 3
// more than a multiple of 32 floats: a lane (probe dy a, dx b, row group
// g) of a round at step s reads bank 3 (g + a s) + b s + const, so the 32
// lanes of a round fall in distinct banks, or on one address, at s = 1
// and 2 and nearly so above.  The block's rows are 20 floats apart, which
// puts the four row groups in distinct 16-byte banks.
constexpr int kCurPitch = MB + 4;
__host__ __device__ constexpr int diamond_cols(int radius) {
  return (MB + 2 * radius + 3) / 4 * 4;
}
__host__ __device__ constexpr int diamond_pitch(int radius) {
  return diamond_cols(radius) + ((3 - diamond_cols(radius)) & 31);
}
// floats of shared memory one warp of the diamond form uses: the window
// (rounded up to 16 bytes), the block, the round's partials
__host__ __device__ constexpr int diamond_window(int radius) {
  return ((MB + 2 * radius) * diamond_pitch(radius) + 3) / 4 * 4;
}
__host__ __device__ constexpr int diamond_floats(int radius) {
  return diamond_window(radius) + MB * kCurPitch
         + (kProbes * kSplit + 3) / 4 * 4;
}

template <typename Store>
__global__ void __launch_bounds__(kDiamondWarps * 32)
motion_sad_diamond_kernel(const Store* __restrict__ cur,
                          const Store* __restrict__ ref, int H, int W,
                          int radius, bool vec, int* __restrict__ mv,
                          float* __restrict__ sad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbx = W / MB, nb = (H / MB) * nbx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= nb) return;
  const size_t frame = blockIdx.y;
  cur += frame * H * W;
  ref += frame * H * W;
  const int by = b / nbx, bx = b % nbx;
  const int side = MB + 2 * radius, pitch = diamond_pitch(radius);
  float* win = reinterpret_cast<float*>(smem) + warp * diamond_floats(radius);
  float* cb = win + diamond_window(radius);
  float* part = cb + MB * kCurPitch;
  stage(win, pitch, ref, H, W, by * MB - radius, bx * MB - radius, side,
        diamond_cols(radius), vec, lane, 32);
  stage(cb, kCurPitch, cur, H, W, by * MB, bx * MB, MB, MB, vec, lane, 32);
  __syncwarp();

  // A round: the partials of its probes, one (probe, row group) a lane,
  // then the scan against the running best.  The centre probe of a round
  // is the running best itself: its SAD equals the best, so the strict <
  // never takes it and it is not evaluated (8 probes x kSplit = 32
  // lanes).  Round 0 evaluates the centre (0, 0) alone.
  float best = CUDART_INF_F;
  int best_y = 0, best_x = 0;
  // n (a compile-time count: 1 or 8) probes around (cy, cx) at step s
  auto probe = [&](auto n, int p, int s, int cy, int cx, int& oy, int& ox) {
    if constexpr (decltype(n)::value == 1) {
      oy = cy;
      ox = cx;
    } else {
      const int q = p + (p >= kProbes / 2);   // skip the centre, index 4
      oy = clampi(cy + (q / 3 - 1) * s, -radius, radius);
      ox = clampi(cx + (q % 3 - 1) * s, -radius, radius);
    }
  };
  auto run_round = [&](auto n, int s) {
    constexpr int kN = decltype(n)::value;
    const int cy = best_y, cx = best_x;
    if (lane < kN * kSplit) {
      const int p = lane / kSplit, g = lane % kSplit;
      int oy, ox;
      probe(n, p, s, cy, cx, oy, ox);
      const float* wp = win + (g + oy + radius) * pitch + ox + radius;
      float acc[1] = {0.f};
#pragma unroll
      for (int i = 0; i < MB / kSplit; ++i) {
        float c[MB];
        load_row(c, cb + (g + i * kSplit) * kCurPitch);
        accumulate_row(acc, c, wp + i * kSplit * pitch);
      }
      part[lane] = acc[0];
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < kN; ++p) {
      float q[kSplit];
#pragma unroll
      for (int g = 0; g < kSplit; ++g) q[g] = part[p * kSplit + g];
      const float v = combine(q);
      int oy, ox;
      probe(n, p, s, cy, cx, oy, ox);
      if (v < best) {
        best = v;
        best_y = oy;
        best_x = ox;
      }
    }
    __syncwarp();   // every lane has read the partials before the next round
  };
  run_round(std::integral_constant<int, 1>{}, 0);
  int step = 1;
  while (2 * step <= radius) step *= 2;
  for (; step >= 1; step /= 2)
    run_round(std::integral_constant<int, kProbes - 1>{}, step);
  if (lane == 0) {
    const size_t o = frame * nb + b;
    mv[2 * o] = best_y;
    mv[2 * o + 1] = best_x;
    sad[o] = best;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  return 0;
}

template <typename Store>
int launch_exhaustive(const void* cur, const void* ref, int frames, int H,
                      int W, int radius, int* mv, float* sad,
                      cudaStream_t stream) {
  const int nbx = W / MB, nby = H / MB, nch = n_chunks(radius);
  const int per_mb = (2 * radius + 1) * nch * kSplit;
  const int tile =
      std::max(1, std::min({kMaxTile, nbx, kMaxThreads / per_mb}));
  const int threads = std::min(kMaxThreads, (tile * per_mb + 31) / 32 * 32);
  const size_t smem =
      sizeof(float) * ((MB + 2 * radius) * (MB * (tile + nch) + 4)
                       + MB * (MB * tile + 4))
      + sizeof(unsigned long long) * tile;
  const bool vec = aligned16(cur) && aligned16(ref);
  auto kernel = motion_sad_exhaustive_kernel<Store>;
  if (const int err = set_smem(kernel, smem)) return err;
  const dim3 grid(nby * ((nbx + tile - 1) / tile), frames);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const Store*>(cur),
                                          static_cast<const Store*>(ref), H,
                                          W, radius, tile, vec, mv, sad);
  return static_cast<int>(cudaGetLastError());
}

template <typename Store>
int launch_diamond(const void* cur, const void* ref, int frames, int H, int W,
                   int radius, int* mv, float* sad, cudaStream_t stream) {
  const int nb = (H / MB) * (W / MB);
  const size_t per_warp = sizeof(float) * diamond_floats(radius);
  const int warps = static_cast<int>(std::max<size_t>(
      1, std::min<size_t>(kDiamondWarps, kMaxSmem / per_warp)));
  const size_t smem = per_warp * warps;
  const bool vec = aligned16(cur) && aligned16(ref);
  auto kernel = motion_sad_diamond_kernel<Store>;
  if (const int err = set_smem(kernel, smem)) return err;
  const dim3 grid((nb + warps - 1) / warps, frames);
  kernel<<<grid, 32 * warps, smem, stream>>>(static_cast<const Store*>(cur),
                                             static_cast<const Store*>(ref),
                                             H, W, radius, vec, mv, sad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cur, ref: (frames, H, W) in the storage type (f32, or bf16 when bf16 !=
// 0), H and W multiples of 16.  diamond: 0 exhaustive, 1 diamond.  mv:
// (frames, H/16, W/16, 2) int32 (dy, dx), sad: (frames, H/16, W/16) f32.
extern "C" int motion_sad_launch(const void* cur, const void* ref, int frames,
                                 int H, int W, int radius, int diamond,
                                 int bf16, int* mv, float* sad,
                                 cudaStream_t stream) {
  if (H % MB || W % MB || H <= 0 || W <= 0 || radius < 0 || frames <= 0
      || frames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return diamond
               ? launch_diamond<__nv_bfloat16>(cur, ref, frames, H, W, radius,
                                               mv, sad, stream)
               : launch_exhaustive<__nv_bfloat16>(cur, ref, frames, H, W,
                                                  radius, mv, sad, stream);
  return diamond ? launch_diamond<float>(cur, ref, frames, H, W, radius, mv,
                                         sad, stream)
                 : launch_exhaustive<float>(cur, ref, frames, H, W, radius,
                                            mv, sad, stream);
}
