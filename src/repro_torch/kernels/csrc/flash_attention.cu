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
//   - masks come from global positions: k_pos < Sk, k_pos <= q_pos when
//     causal, q_pos - k_pos < window when windowed (rows past Sq are
//     computed and not stored); a masked score is -1e30, not -inf: a row
//     whose first tile is all masked gets m = -1e30 and p = exp(0) = 1,
//     and that mass is wiped out by corr = exp(-1e30 - m) = 0 once a
//     valid key arrives (with -inf the row would compute exp(-inf + inf)
//     = NaN); the output is acc / max(l, 1e-30);
//   - the kv head of query head h is h * Hk / H; K and V are never
//     repeated.
//   - expf, not __expf, and IEEE division: no fast math.
// Tiles that the causal or window mask blanks for every row of the block
// are skipped, and the rows past Sk of the last tile are zeros. That
// gives the same result: a fully masked tile leaves m, l and acc as they
// were when a valid key came before it, and any spurious mass it adds
// before one is wiped out when one arrives (every row with q_pos < Sq has
// one under a causal mask: key 0, and with a window its own position).
// Only a row with no valid key at all (a non-causal window with q_pos -
// window >= Sk) differs: it gets zeros or the mean of V over the masked
// tiles its block visits, where the reference averages all masked keys.
//
// Bound on an H100 SXM: at the LM path's shape (B=2, H=32, Hk=8, S=4096,
// D=64, bf16, causal) the unmasked pairs need 4 * B * H * D * S(S+1)/2 =
// 137 GFLOP, 0.14 ms at 989 TFLOP/s, against 0.016 ms to move q, k, v and
// o once: bound by operations. The softmax is the other half of the
// work: 0.54 G scores a layer at B=2, each a scale, a max, a
// subtraction, an expf (a MUFU ex2 inside a longer exact sequence) and
// an add, all issued by the same warps. Timed with a part left out
// (tools/flash_ablation.py), the softmax alone takes ~95 % of the
// kernel's time and the products with their loads under half of it: the
// kernel is bound by the softmax's instructions and by its serial chain
// with the products; the accurate expf accounts for about half of its gap
// to PyTorch's scaled_dot_product_attention. So the design keeps the
// tensor cores fed from a ring without stalling the softmax, and tests
// positions only in the tiles a mask cuts.
//
// Design of the bf16 forms (Hopper, sm_90a): one block of three
// warpgroups per (128-row q tile, head, batch). Warpgroup 0 is the
// producer: it gives up registers (setmaxnreg 24) and one of its threads
// issues TMA loads, the q tile once and then the block's K and V tiles of
// 128 keys into a ring of kStages stages, each stage with a full and an
// empty mbarrier. The tensor maps are 4-D, (D, heads, S, B) with a box of
// 64 columns x 1 head x 128 rows x 1 batch, so TMA zero-fills the rows
// past Sq or Sk inside one batch (the ragged tail) and never reads the
// next batch's rows; a row of D = 128 (256 bytes) is two 64-column boxes
// (panels), each in the 128-byte swizzle. Warpgroups 1 and 2 are the
// consumers (setmaxnreg 240), 64 q rows each: S = q k^T is wgmma
// m64n128k16 with q and k both from shared memory, K-major, stepping the
// descriptors 32 bytes inside a panel and a panel across; p, rounded to
// bf16 pairs in registers, is the A operand of O += P V (wgmma m64nDk16,
// A from registers), whose B operand is the V tile as it lies in shared
// memory, MN-major, with the transpose bit set: no transpose pass. The
// two consumers run the same loop on different rows, so one's softmax
// overlaps the other's products on the SM's tensor cores, and the
// producer has the next tiles in flight meanwhile. Only the tiles at the
// causal diagonal, the window's edge or the ragged end test positions;
// the others skip the predicate. q tiles are issued longest first (the
// q tile is the slowest grid dimension, counted down). FA3's
// intra-warpgroup overlap (the next tile's S issued before this tile's
// softmax) with the consumers taking turns at the tensor cores, and a
// third consumer warpgroup at D = 64, were built and measured: neither
// made the kernel faster (ptxas sank the exponentials below the wait for
// P V), so each consumer runs the plain loop.
//
// The f32-storage form keeps the first design (not on any path; TMA
// cannot round f32 to bf16 on the way into shared memory): one block of
// four warps per (64-row q tile, head, batch), each warp holding its 16
// q rows' fragments in registers; K and V tiles of 64 keys staged in
// shared memory as bf16 by plain loads, rows padded by 8 values; both
// products mma.sync m16n8k16 bf16 with f32 accumulators. Both designs
// count under the one "flash_attention" launch counter.
//
// The CUDA driver's cuTensorMapEncodeTiled is taken through
// cudaGetDriverEntryPointByVersion, so the library does not link
// libcuda; the three maps are encoded on the host at every call.

#include <cuda.h>  // CUtensorMap and its enums (types only)

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
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

// ---------------------------------------------------------------------
// The f32-storage form: mma.sync m16n8k16.

namespace f32form {

constexpr int kBlockM = 64;  // q rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per k tile
constexpr int kWarps = kBlockM / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;      // bf16 values of padding per shared row

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

// eight neighbouring values (16-byte aligned) into shared memory as bf16
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Sk, int H, int Hk, int causal, int window, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockN][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockN][D + kPad];

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h * Hk / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row / column pair
  const long q_stride = static_cast<long>(H) * D;
  const long kv_stride = static_cast<long>(Hk) * D;
  const float* qb = q + (static_cast<long>(b) * Sq * H + h) * D;
  const float* kb = k + (static_cast<long>(b) * Sk * Hk + hk) * D;
  const float* vb = v + (static_cast<long>(b) * Sk * Hk + hk) * D;
  float* ob = o + (static_cast<long>(b) * Sq * H + h) * D;

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
      *reinterpret_cast<float2*>(ob + r_lo * q_stride + c) =
          make_float2(acc[dt][0] / dl, acc[dt][1] / dl);
    if (r_hi < Sq)
      *reinterpret_cast<float2*>(ob + r_hi * q_stride + c) =
          make_float2(acc[dt][2] / dh, acc[dt][3] / dh);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hk, int causal,
                   int window, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, Hk,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace f32form

// ---------------------------------------------------------------------
// The bf16 forms: TMA, mbarriers, wgmma, warp specialisation.

namespace hopper {

constexpr int kBlockM = 128;  // q rows per block: 64 per consumer warpgroup
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kStages = 2;    // K/V ring depth
constexpr int kThreads = 3 * 128;  // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
// one panel: 128 rows of 64 bf16 values (128 bytes, one swizzle span)
constexpr uint32_t kPanelBytes = 128 * 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (D / 64) * kPanelBytes;
}
// the q tile and kStages K and V tiles, the mbarriers (q, full[kStages],
// empty[kStages]) and room to align the start to 1024 bytes (the swizzle
// pattern's period)
template <int D>
__host__ __device__ constexpr uint32_t smem_bytes() {
  return (1 + 2 * kStages) * tile_bytes<D>() + 8 * (1 + 2 * kStages) + 1024;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// one arrival that also announces the bytes the TMA loads will deliver
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// box (c0.., c1, c2.., c3) of a 4-D tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// a wgmma shared-memory descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the accumulators are written by the asynchronous product: keep the
// compiler from moving their reads above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) (+)= a (64 x 16, shared, K-major) b (16 x 128, shared,
// K-major); accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) += a (64 x 16, registers) b (16 x N, shared, MN-major:
// the transpose bit), N = 64 or 128
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F8

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(__grid_constant__ const CUtensorMap tq,
                 __grid_constant__ const CUtensorMap tk,
                 __grid_constant__ const CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                 int Hk, int causal, int window, float scale) {
  constexpr int kPanels = D / 64;
  constexpr uint32_t kTile = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_smem =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t k_smem = q_smem + kTile;             // + stage * kTile
  const uint32_t v_smem = k_smem + kStages * kTile;   // + stage * kTile
  const uint32_t q_full = v_smem + kStages * kTile;
  const uint32_t full = q_full + 8;                   // + 8 * stage
  const uint32_t empty = full + 8 * kStages;          // + 8 * stage

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int hk = h * Hk / H;
  const int q_first = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int q_last = min(q_first + kBlockM, Sq) - 1;
  // the k tiles that some row of this block may see
  int j_begin = 0, j_end = (Sk + kBlockN - 1) / kBlockN;
  if (causal) j_end = min(j_end, q_last / kBlockN + 1);
  if (window > 0) j_begin = max(0, q_first - window + 1) / kBlockN;
  const int n_tiles = max(0, j_end - j_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kTile);
      for (int p = 0; p < kPanels; ++p)
        tma_load(q_smem + p * kPanelBytes, &tq, q_full, 64 * p, h, q_first,
                 b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        // stage s was last filled for tile n - kStages: wait until both
        // consumers released it
        if (n >= kStages) mbar_wait(empty + 8 * s, (n / kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * kTile);
        const int k0 = (j_begin + n) * kBlockN;
        for (int p = 0; p < kPanels; ++p) {
          tma_load(k_smem + s * kTile + p * kPanelBytes, &tk, full + 8 * s,
                   64 * p, hk, k0, b);
          tma_load(v_smem + s * kTile + p * kPanelBytes, &tv, full + 8 * s,
                   64 * p, hk, k0, b);
        }
      }
    }
  } else {
    // consumers: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // accumulator row / column pair
    const int wg_first = q_first + 64 * cw;
    const int r_lo = wg_first + 16 * warp + g;  // this thread's two rows
    const int r_hi = r_lo + 8;

    // S: key 8c + 2t + (e & 1) of row (e < 2 ? g : g + 8) in s[4c + e];
    // acc: column 8c + 2t + (e & 1) likewise
    float s[kBlockN / 2], acc[D / 2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;

    // q (this warpgroup's 64 rows) as the A operand, step kk of 16 columns
    uint64_t qd[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      qd[kk] = desc_sw128(q_smem + (kk / 4) * kPanelBytes + cw * 64 * 128 +
                              (kk % 4) * 32,
                          16, 1024);
    mbar_wait(q_full, 0);
    __syncwarp();

    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % kStages;
      const int k0 = (j_begin + n) * kBlockN;
      const uint32_t ks = k_smem + st * kTile, vs = v_smem + st * kTile;
      mbar_wait(full + 8 * st, (n / kStages) & 1);
      __syncwarp();

      // S = q k^T over D / 16 steps
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(s, qd[kk],
                      desc_sw128(ks + (kk / 4) * kPanelBytes + (kk % 4) * 32,
                                 16, 1024),
                      kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) s[i] *= scale;
      // positions are tested only where a mask cuts this warpgroup's
      // part of the tile: the ragged end, the causal diagonal, the
      // window's far edge
      const bool edge = k0 + kBlockN > Sk ||
                        (causal && k0 + kBlockN - 1 > wg_first) ||
                        (window > 0 && wg_first + 63 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const int qp = (i & 2) ? r_hi : r_lo;
          const int kp = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          const bool ok = kp < Sk && (!causal || kp <= qp) &&
                          (window <= 0 || qp - kp < window);
          if (!ok) s[i] = kNegInf;
        }
      }

      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int c = 0; c < kBlockN / 8; ++c) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[4 * c], s[4 * c + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[4 * c + 2], s[4 * c + 3]));
      }
      const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
      const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
      const float corr_lo = expf(m_lo - mn_lo);
      const float corr_hi = expf(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      // l is kept per thread (its part of the row) and summed over the
      // quad at the end
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int c = 0; c < kBlockN / 8; ++c) {
        s[4 * c] = expf(s[4 * c] - mn_lo);
        s[4 * c + 1] = expf(s[4 * c + 1] - mn_lo);
        s[4 * c + 2] = expf(s[4 * c + 2] - mn_hi);
        s[4 * c + 3] = expf(s[4 * c + 3] - mn_hi);
        sum_lo += s[4 * c] + s[4 * c + 1];
        sum_hi += s[4 * c + 2] + s[4 * c + 3];
      }
      l_lo = l_lo * corr_lo + sum_lo;
      l_hi = l_hi * corr_hi + sum_hi;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        acc[4 * c] *= corr_lo;
        acc[4 * c + 1] *= corr_lo;
        acc[4 * c + 2] *= corr_hi;
        acc[4 * c + 3] *= corr_hi;
      }

      // acc += bf16(p) v over 16 keys a step: the S accumulator of keys
      // 16kk..16kk+15 is, rounded to bf16 pairs, the step's A fragment
      uint32_t pa[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs(acc, pa[kk], desc_sw128(vs + kk * 16 * 128, kPanelBytes,
                                         1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    const float dl = fmaxf(quad_sum(l_lo), 1e-30f);
    const float dh = fmaxf(quad_sum(l_hi), 1e-30f);
    const long row = static_cast<long>(H) * D;
    __nv_bfloat16* ob = o + (static_cast<long>(b) * Sq * H + h) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (r_lo < Sq)
        *reinterpret_cast<uint32_t*>(ob + r_lo * row + 8 * c) =
            pack_bf16(acc[4 * c] / dl, acc[4 * c + 1] / dl);
      if (r_hi < Sq)
        *reinterpret_cast<uint32_t*>(ob + r_hi * row + 8 * c) =
            pack_bf16(acc[4 * c + 2] / dh, acc[4 * c + 3] / dh);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the CUDA driver's cuTensorMapEncodeTiled, looked up once
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the 4-D map (D, heads, S, B) of a bf16 tensor in the model layout, its
// box one 64-column panel of 128 rows of one head in one batch, loaded in
// the 128-byte swizzle; rows past S read as zeros
bool head_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int D,
              int heads, int S, int B) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * D * heads;  // bytes
  const cuuint64_t strides[3] = {2ull * D, row, row * S};
  const cuuint32_t box[4] = {64, 1, 128, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int Hk, int causal,
                   int window, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encoder();
  if (!encode) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, encode, q, D, H, Sq, B) ||
      !head_map(&tk, encode, k, D, Hk, Sk, B) ||
      !head_map(&tv, encode, v, D, Hk, Sk, B))
    return cudaErrorInvalidValue;
  constexpr uint32_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, Hk, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace hopper

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Sk, Hk, D); contiguous, 16-byte aligned,
// all f32 (bf16 = 0) or all bf16 (bf16 = 1); D 64 or 128; H a multiple of
// Hk; Sq at most 65535 * 64 (the grid's q tiles); window < 1 means none;
// scale = 1 / sqrt(D).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int Hk, int D,
                                      int causal, int window, int bf16,
                                      float scale, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hk <= 0 || H % Hk ||
      H > 65535 || B > 65535 || (D != 64 && D != 128) ||
      static_cast<long>(B) * H > 0x7fffffffL || Sq > 65535 * 64)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err;
  if (bf16)
    err = D == 64 ? hopper::launch<64>(q, k, v, o, B, Sq, Sk, H, Hk, causal,
                                       window, scale, stream)
                  : hopper::launch<128>(q, k, v, o, B, Sq, Sk, H, Hk, causal,
                                        window, scale, stream);
  else
    err = D == 64 ? f32form::launch<64>(q, k, v, o, B, Sq, Sk, H, Hk, causal,
                                        window, scale, stream)
                  : f32form::launch<128>(q, k, v, o, B, Sq, Sk, H, Hk,
                                         causal, window, scale, stream);
  return static_cast<int>(err);
}
