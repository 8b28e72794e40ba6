// flash_attention: online-softmax attention forward, causal and/or sliding
// window, GQA, over the model layout q (B, Sq, H, D), k/v (B, Sk, Hk, D),
// f32 or bf16 storage, output in q's storage type.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:flash_attention_fwd
// (_fwd_kernel); oracle repro/kernels/flash_attention/ref.py:attention_ref.
// Semantics kept from _fwd_kernel:
//   - q, k, v are rounded to bf16 (also when stored as f32); S = q k^T is
//     taken on the tensor cores with f32 sums and scaled by 1/sqrt(D) in
//     f32; the softmax weights p are rounded to bf16 before P V; the row
//     sums l, the maxima m and the accumulator stay in f32;
//   - masks come from global positions: k_pos < Sk, q_pos < Sq, k_pos <=
//     q_pos when causal, q_pos - k_pos < window when windowed; a masked
//     score is -1e30, not -inf: a row whose first tile is all masked gets
//     m = -1e30 and p = exp(0) = 1, and that mass is wiped out by
//     corr = exp(-1e30 - m) = 0 once a valid key arrives (with -inf the
//     row would compute exp(-inf + inf) = NaN); the output is
//     acc / max(l, 1e-30);
//   - the kv head of query head h is h * Hk / H; K and V are never
//     repeated.
//   - expf, not __expf, and IEEE division: no fast math.
// Tiles that the causal or window mask blanks for every row of the block
// are skipped. That gives the same result: a fully masked tile leaves m,
// l and acc as they were when a valid key came before it, and any
// spurious mass it adds before one is wiped out when one arrives (every
// row with q_pos < Sq has one under a causal mask: key 0, and with a
// window its own position). Only a row with no valid key at all (a
// non-causal window with q_pos - window >= Sk) differs: it gets zeros,
// where the reference averages the masked keys.
//
// Bound on an H100 SXM: at the LM path's shape (B=2, H=32, Hk=8, S=4096,
// D=64, bf16, causal) the unmasked pairs need 4 * B * H * D * S(S+1)/2 =
// 137 GFLOP, 0.14 ms at 989 TFLOP/s, against 0.016 ms to move q, k, v and
// o once: bound by operations.
//
// Design (simple, not yet fast): one block of four warps per (64-row q
// tile, head, batch); each warp owns 16 q rows and holds their q
// fragments in registers for the whole k loop. K and V tiles of 64 keys
// are staged in shared memory as bf16, rows padded by 8 values so the
// fragment loads hit 32 distinct banks. Both products are mma.sync
// m16n8k16 bf16 with f32 accumulators; the S accumulator of one 16-key
// step is the A operand of P V after rounding, without going through
// shared memory. Each thread keeps m and l for its two rows (reduced over
// the four threads of a row with shuffles). No cp.async, TMA or wgmma,
// and no overlap of the next tile's load with this tile's products: that
// is for a later speed pass. q tiles are issued last-first so the causal
// blocks with the most tiles start first.

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kBlockM = 64;  // q rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per k tile
constexpr int kWarps = kBlockM / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;      // bf16 values of padding per shared row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a (16x16, row major) * b (16x8, column major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two neighbouring values as one packed bf16 pair
__device__ __forceinline__ uint32_t load_pair(const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  return pack_bf16(x.x, x.y);
}
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// eight neighbouring values (16-byte aligned) into shared memory as bf16
__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      __nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void load8(const float* src, __nv_bfloat16* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  uint4 out;
  out.x = pack_bf16(a.x, a.y);
  out.y = pack_bf16(a.z, a.w);
  out.z = pack_bf16(b.x, b.y);
  out.w = pack_bf16(b.z, b.w);
  *reinterpret_cast<uint4*>(dst) = out;
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// max and sum over the four threads that hold one row's values
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int Hk, int causal, int window, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockN][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockN][D + kPad];

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h * Hk / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row / column pair
  const long q_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(Hk) * D;
  const T* qb = q + (static_cast<long>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<long>(b) * Sk * Hk + hk) * D;
  const T* vb = v + (static_cast<long>(b) * Sk * Hk + hk) * D;
  T* ob = o + (static_cast<long>(b) * Sq * H + h) * D;

  const int q_first = q_tile * kBlockM;
  const int q_last = min(q_first + kBlockM, Sq) - 1;
  const int r_lo = q_first + warp * 16 + g;  // this thread's two rows
  const int r_hi = r_lo + 8;

  // q as the A operand of D/16 k-steps: (row, col) pairs (g, 2t), (g+8,
  // 2t), (g, 2t+8), (g+8, 2t+8) of each 16x16 step; rows past Sq are 0
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r_lo < Sq ? load_pair(qb + r_lo * q_stride + c) : 0u;
    qf[kk][1] = r_hi < Sq ? load_pair(qb + r_hi * q_stride + c) : 0u;
    qf[kk][2] = r_lo < Sq ? load_pair(qb + r_lo * q_stride + c + 8) : 0u;
    qf[kk][3] = r_hi < Sq ? load_pair(qb + r_hi * q_stride + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

  // the k tiles that some row of this block may see
  int j_begin = 0, j_end = (Sk + kBlockN - 1) / kBlockN;
  if (causal) j_end = min(j_end, q_last / kBlockN + 1);
  if (window > 0) j_begin = max(0, q_first - window + 1) / kBlockN;

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBlockN * (D / 8); i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      if (k0 + r < Sk) {
        load8(kb + (k0 + r) * kv_stride + c, &ks[r][c]);
        load8(vb + (k0 + r) * kv_stride + c, &vs[r][c]);
      } else {  // past Sk: zeros, so 0 * p never meets a stray NaN
        *reinterpret_cast<uint4*>(&ks[r][c]) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(&vs[r][c]) = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();

    // S = q k^T: n-tile nt holds keys k0 + 8 nt + (2t, 2t+1) of rows
    // (g, g+8) as s[nt][0..1] and s[nt][2..3]
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &ks[nt * 8 + g][kk * 16 + 2 * t];
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = e < 2 ? r_lo : r_hi;
        const int kp = k0 + nt * 8 + 2 * t + (e & 1);
        const bool ok = kp < Sk && qp < Sq && (!causal || kp <= qp) &&
                        (window <= 0 || qp - kp < window);
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float corr_lo = expf(m_lo - mn_lo);
    const float corr_hi = expf(m_hi - mn_hi);
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn_lo);
      s[nt][1] = expf(s[nt][1] - mn_lo);
      s[nt][2] = expf(s[nt][2] - mn_hi);
      s[nt][3] = expf(s[nt][3] - mn_hi);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
    l_lo = l_lo * corr_lo + quad_sum(sum_lo);
    l_hi = l_hi * corr_hi + quad_sum(sum_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr_lo;
      acc[dt][1] *= corr_lo;
      acc[dt][2] *= corr_hi;
      acc[dt][3] *= corr_hi;
    }

    // acc += bf16(p) v, 16 keys a step: the S fragments of n-tiles 2kk
    // and 2kk+1 are exactly the A fragment of the step
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int kr = kk * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int c = dt * 8 + g;
        mma_bf16(acc[dt], a, pack2(vs[kr][c], vs[kr + 1][c]),
                 pack2(vs[kr + 8][c], vs[kr + 9][c]));
      }
    }
  }

  const float dl = fmaxf(l_lo, 1e-30f), dh = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r_lo < Sq)
      store_pair(ob + r_lo * q_stride + c, acc[dt][0] / dl, acc[dt][1] / dl);
    if (r_hi < Sq)
      store_pair(ob + r_hi * q_stride + c, acc[dt][2] / dh, acc[dt][3] / dh);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hk, int causal,
                   int window, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<D, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hk, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Sk, Hk, D); contiguous, 16-byte aligned,
// all f32 (bf16 = 0) or all bf16 (bf16 = 1); D 64 or 128; H a multiple of
// Hk; window < 1 means none; scale = 1 / sqrt(D).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int Hk, int D,
                                      int causal, int window, int bf16,
                                      float scale, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hk <= 0 || H % Hk ||
      H > 65535 || B > 65535 || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err;
  if (D == 64)
    err = bf16 ? launch<64, __nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hk,
                                           causal, window, scale, stream)
               : launch<64, float>(q, k, v, o, B, Sq, Sk, H, Hk, causal,
                                   window, scale, stream);
  else
    err = bf16 ? launch<128, __nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, Hk,
                                            causal, window, scale, stream)
               : launch<128, float>(q, k, v, o, B, Sq, Sk, H, Hk, causal,
                                    window, scale, stream);
  return static_cast<int>(err);
}
