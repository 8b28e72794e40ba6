// blockdct: 8x8 block DCT + quantisation, and its inverse, f32.
//
// Replaces src/repro/kernels/blockdct/kernel.py:blockdct_tiles (_kernel):
//   forward_quant: y = D x D^T, q = round(y / qtab), rec = D^T (q qtab) D
//   inverse:       rec = D^T (q qtab) D   (the decoder's half)
// Oracles: repro/kernels/blockdct/ref.py:blockdct_ref and the codec's
// dct2 / quantize_with_table / idct2 (repro/codec/blockdct.py).
//
// Bound on an H100 SXM: forward_quant reads 256 B and writes 512 B per
// block and does 4 small 8x8x8 products (4096 f32 operations).  At the
// anchor batch of the main path (30 frames of 720x1280 = 432,000 blocks)
// that is 332 MB, about 99 us at 3.35 TB/s, against 1.8 GFLOP, about
// 26 us at 67 TFLOP/s: bound by bytes.  inverse moves two thirds of that.
//
// Design: one 8x8 block per 64 threads, four blocks per 256-thread CUDA
// block, so each thread loads and stores one coefficient and the loads and
// stores are coalesced.  D and qtab sit in shared memory, the block and
// its partial product too; no value is read twice from device memory.
// The arithmetic follows the reference: an IEEE division y / qtab (not a
// reciprocal; built without --use_fast_math) and rintf, which rounds half
// to even like jnp.round.  Each product sums its 8 terms in index order
// with fmaf; the sum order differs from XLA's, so q may differ by 1 where
// y / qtab lies within rounding of a .5 boundary.

#include "common.cuh"

namespace {

constexpr int kBlocksPerCta = 4;
constexpr int kThreads = 64 * kBlocksPerCta;

struct Tiles {
  float D[64];
  float QT[64];
  float a[kBlocksPerCta][64];
  float b[kBlocksPerCta][64];
};

// rec[r][c] = sum_k D[k][r] (sum_j deq[k][j] D[j][c]), deq already in a[lb].
__device__ __forceinline__ float inverse_block(Tiles& s, int lb, int r,
                                               int c) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc = fmaf(s.a[lb][r * 8 + k], s.D[k * 8 + c], acc);
  s.b[lb][r * 8 + c] = acc;
  __syncthreads();
  acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc = fmaf(s.D[k * 8 + r], s.b[lb][k * 8 + c], acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
forward_quant_kernel(const float* __restrict__ x, const float* __restrict__ dmat,
                     const float* __restrict__ qtab, long nb,
                     float* __restrict__ q_out, float* __restrict__ rec_out) {
  __shared__ Tiles s;
  const int t = threadIdx.x, lb = t / 64, e = t % 64, r = e / 8, c = e % 8;
  const long i = static_cast<long>(blockIdx.x) * kThreads + t;
  const bool valid = i < nb * 64;
  if (t < 64) {
    s.D[t] = dmat[t];
    s.QT[t] = qtab[t];
  }
  s.a[lb][e] = valid ? x[i] : 0.f;
  __syncthreads();
  // b = x D^T, then y = D b
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc = fmaf(s.a[lb][r * 8 + k], s.D[c * 8 + k], acc);
  s.b[lb][e] = acc;
  __syncthreads();
  acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc = fmaf(s.D[r * 8 + k], s.b[lb][k * 8 + c], acc);
  const float qt = s.QT[e];
  const float q = rintf(acc / qt);
  s.a[lb][e] = q * qt;  // every read of a[lb] was before the last barrier
  __syncthreads();
  const float rec = inverse_block(s, lb, r, c);
  if (valid) {
    q_out[i] = q;
    rec_out[i] = rec;
  }
}

__global__ void __launch_bounds__(kThreads)
inverse_kernel(const float* __restrict__ q_in, const float* __restrict__ dmat,
               const float* __restrict__ qtab, long nb,
               float* __restrict__ rec_out) {
  __shared__ Tiles s;
  const int t = threadIdx.x, lb = t / 64, e = t % 64, r = e / 8, c = e % 8;
  const long i = static_cast<long>(blockIdx.x) * kThreads + t;
  const bool valid = i < nb * 64;
  if (t < 64) {
    s.D[t] = dmat[t];
    s.QT[t] = qtab[t];
  }
  __syncthreads();
  s.a[lb][e] = valid ? q_in[i] * s.QT[e] : 0.f;
  __syncthreads();
  const float rec = inverse_block(s, lb, r, c);
  if (valid) rec_out[i] = rec;
}

unsigned grid_for(long nb) {
  return static_cast<unsigned>((nb + kBlocksPerCta - 1) / kBlocksPerCta);
}

}  // namespace

// blocks, q, rec: (nb, 8, 8) f32; dmat, qtab: (8, 8) f32.
extern "C" int blockdct_forward_quant(const float* blocks, const float* dmat,
                                      const float* qtab, long nb, float* q,
                                      float* rec, cudaStream_t stream) {
  if (nb <= 0 || grid_for(nb) > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  forward_quant_kernel<<<grid_for(nb), kThreads, 0, stream>>>(
      blocks, dmat, qtab, nb, q, rec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int blockdct_inverse(const float* q, const float* dmat,
                                const float* qtab, long nb, float* rec,
                                cudaStream_t stream) {
  if (nb <= 0 || grid_for(nb) > 0x7fffffffu)
    return static_cast<int>(cudaErrorInvalidValue);
  inverse_kernel<<<grid_for(nb), kThreads, 0, stream>>>(q, dmat, qtab, nb,
                                                         rec);
  return static_cast<int>(cudaGetLastError());
}
