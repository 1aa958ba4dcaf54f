// Flash-attention backward for Hopper (sm_90a): two kernels, each bound to
// PyTorch through a plain C entry point (ctypes).
//
// Replaces the TPU Pallas kernels
//   image_editing_framework_tpu/ops/flash_attention.py:387 _bwd_dq_kernel
//   image_editing_framework_tpu/ops/flash_attention.py:540 _bwd_dq_kernel_t
//       -> flash_bwd_dq (launched by _bwd_impl:476 / _bwd_impl_t:643)
//   image_editing_framework_tpu/ops/flash_attention.py:430 _bwd_dkv_kernel
//   image_editing_framework_tpu/ops/flash_attention.py:593 _bwd_dkv_kernel_t
//       -> flash_bwd_dkv
// The transposed TPU kernels compute the same function as the classic ones
// in a layout that exists for the TPU's 128-lane padding, so on Hopper each
// pair is one kernel. With P = exp(Q K^T * scale + bias - lse) recomputed per
// tile from the forward's saved lse, and di = rowsum(O * dO) in f32 (a plain
// torch op outside the kernels, as in JAX):
//
//   dS = P * (dO V^T - di) * scale
//   dQ = dS K                       (flash_bwd_dq: a block per 64 queries,
//                                    looping over key tiles)
//   dV = P^T dO,  dK = dS^T Q       (flash_bwd_dkv: a block per 64 keys,
//                                    looping over query tiles)
//
// Every block owns its outputs, so there are no atomics and two runs give the
// same bits; the price is that both kernels compute S and dP (14 N^2 d
// products where the whole backward needs 10). The bias gets no gradient
// (the JAX VJP gives it a zero cotangent). bf16 inputs: bf16 products with
// f32 accumulation; dS is rounded to K's dtype before dS K and to Q's before
// dS^T Q, and P to dO's before P^T dO, as the TPU kernels round
// (flash_attention.py:420-423, :456-468). f32 inputs: true f32 products on
// the CUDA cores, never TF32. Keys at or beyond Nk and queries at or beyond
// Nq contribute nothing. A row whose lse is -inf (every logit -inf) gets
// P = 0 and zero gradients, where the JAX kernel gives NaN. With a bias,
// s - lse is formed before any scaling by log2 e: NEG_INF (-0.7 * f32 max)
// times log2 e would overflow; without one, log2 e is folded into the scale.
//
// What bounds it on the card: at SD1.5's 4096-token sites (8 heads, d = 40)
// the backward's five products are ~54 GFLOP per image against ~21 MB of
// q/k/v/o/dO/dq/dk/dv traffic in bf16, far above the H100's ~295 FLOP/byte
// ridge: tensor-core operations bound it, and next the exponentials (one
// MUFU op per score). The bf16 design is the forward's (flash_fwd.cu), on
// the helpers of hopper.cuh:
//   * wgmma. The two score products of a tile (S and dP, or S^T and dP^T)
//     read both operands from shared memory, K-major (SS). The products
//     that accumulate a gradient take their A operand from registers (RS):
//     the S/dP accumulator, turned into dS (or P^T, dS^T) and packed to
//     bf16, is the A fragment, with no transpose, because the dK/dV kernel
//     computes S^T = K Q^T with keys as the rows. Their B operand (K in
//     dS K, dO in P^T dO, Q in dS^T Q) has d contiguous: MN-major, read with
//     the transpose bit from the same swizzled copy the SS product reads.
//   * Warp specialisation. A producer warp issues TMA copies: the block's
//     own 64-row tiles once (Q and dO, or K and V), then the other side's
//     tiles into a ring of kStages stages on mbarriers (full: transaction
//     bytes; empty: one arrival per consumer warp). A stage also carries
//     the tile's per-row vector (dQ: the keys' bias; dK/dV: the queries'
//     lse and di), which the producer warp's lanes copy.
//   * One consumer warpgroup of 64 rows per block and two blocks an SM
//     (setmaxnreg 24 / 232): NTI runs at batch 1, where SDXL's 1024-token
//     sites give 320 blocks of 64 rows (160 of 128), so the last wave is
//     finer, and the two blocks of an SM overlap one's exponentials with the
//     other's products. At d = 160 (small sites) one block an SM, 255
//     registers, and tiles of 64 keys (dq) or 32 queries (dkv): dK and dV
//     alone are 160 f32 registers a thread.
//   * Rank-4 tensor maps (D, N, H, B) over the operands' own strides, so
//     head-split views and dO in autograd's layout are read as they are;
//     TMA's zero fill pads d to DP and fills ragged tails, whose P is set to
//     0. d is cut into column blocks of one swizzle row (W = 64, 32 or 16:
//     80 -> 5 x 16, 160 -> 5 x 32); d = 40 runs the 64-column kernels
//     (bf16_dp), faster than 3 x 16.
//   * In dQ the exponentials of P run while dP = dO V^T is still on the
//     tensor cores (S and dP are two wgmma groups); in dK/dV that measured
//     slower, and one group holds both.
// Within a warpgroup the exponentials still serialise with the gradient
// products; ping-pong scheduling and persistent blocks are not done.

#include <math.h>

#include "hopper.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;  // (B, Nk) f32, or null
  const float* lse;   // (B, H, Nq) f32 contiguous
  const float* di;    // (B, H, Nq) f32 contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, H, Nq, Nk, D;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long do_sb, do_sh, do_sn;
  long long dq_sb, dq_sh, dq_sn;
  long long dk_sb, dk_sh, dk_sn;
  long long dv_sb, dv_sh, dv_sn;
  float scale;
};

// exp(x - lse), 0 for a row whose every logit is -inf.
__device__ __forceinline__ float prob(float x, float lse) {
  return lse == -INFINITY ? 0.f : exp2f((x - lse) * kLog2e);
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed tiles, one consumer warpgroup and one producer warp

constexpr int kRows = 64;        // output rows per block: one consumer warpgroup
constexpr int kDqBK = 128;       // keys per K/V tile of dq up to d = 80
constexpr int kDqBKWide = 64;    // ... at d = 160
constexpr int kDkvBQ = 64;       // queries per Q/dO tile of dK/dV up to d = 80
constexpr int kDkvBQWide = 32;   // ... at d = 160
constexpr int kStages = 2;       // depth of the ring
constexpr int kWG = 128;         // threads per warpgroup
constexpr int kThreads = 2 * kWG;  // the consumer warpgroup, then the producer's
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 232;  // two blocks an SM: 2 * (24 + 232) * 128 = 65536
// Arrivals that fill a stage: the producer warp's 32 lanes, each after its
// share of the stage's per-row vector (bias, or lse and di), and its lane 0
// once more with the stage's TMA transaction bytes. TMA could not copy those
// vectors: a row of lse starts at any element, and a box whose start is not
// 16-byte aligned never completed.
constexpr int kFullArrivals = 33;

template <int DP>
struct Cols {
  // One swizzle row holds W bf16; d is split into DP / W column blocks of
  // W, each one TMA box and one (rows x W) stretch of shared memory.
  static constexpr int W = DP % 64 == 0 ? 64 : DP % 32 == 0 ? 32 : 16;
  static constexpr int SW = 2 * W;  // swizzle bytes: 128, 64 or 32
  static constexpr int NCB = DP / W;
  static constexpr uint64_t kLayout = W == 64 ? 1 : W == 32 ? 2 : 3;  // wgmma descriptor swizzle code
  static constexpr int BLOCKS = DP > 80 ? 1 : 2;  // blocks an SM
};

template <int DP>
struct DqTile : Cols<DP> {
  static constexpr int BK = DP > 80 ? kDqBKWide : kDqBK;
  static constexpr int ROW_BYTES = kRows * DP * 2;  // Q or dO
  static constexpr int KV_BYTES = BK * DP * 2;      // K or V, one stage
  static constexpr int BIAS_BYTES = BK * 4;         // the keys' bias, one stage
  // tiles (1024-byte aligned), the bias, then the mbarriers: Q/dO, full[kStages], empty[kStages]
  static constexpr int SMEM =
      1024 + 2 * ROW_BYTES + kStages * (2 * KV_BYTES + BIAS_BYTES) + 8 * (1 + 2 * kStages);
};

template <int DP>
struct DkvTile : Cols<DP> {
  static constexpr int BQ = DP > 80 ? kDkvBQWide : kDkvBQ;
  static constexpr int ROW_BYTES = kRows * DP * 2;  // K or V
  static constexpr int QT_BYTES = BQ * DP * 2;      // Q or dO, one stage
  static constexpr int STAT_BYTES = BQ * 4;         // lse or di, one stage
  // tiles, then lse/di, then the mbarriers: K/V, full[kStages], empty[kStages]
  static constexpr int SMEM =
      1024 + 2 * ROW_BYTES + 2 * kStages * (QT_BYTES + STAT_BYTES) + 8 * (1 + 2 * kStages);
};

// The 64 x (16 J) accumulator x rounded to bf16 as the A fragments of its J
// 16-deep steps: accumulator n-tiles 2j and 2j + 1 are exactly step j.
template <int J>
__device__ __forceinline__ void to_frags(uint32_t (&a)[J][4], const float (&x)[8 * J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = pack_bf16(x[8 * j + 2 * e], x[8 * j + 2 * e + 1]);
  }
}

// Rows r0 and r0 + 8 of a warp's slice of a 64 x DP f32 accumulator
// (element 4 n + 2 r + c: row r0 + 8 r, column 8 n + 2 t4 + c) to bf16.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long sn, const float (&acc)[DP / 2], int r0,
                                           int nrows, int d, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= nrows) continue;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int c = n * 8 + t4 * 2;
      if (c < d)
        *reinterpret_cast<uint32_t*>(out + row * sn + c) = pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    }
  }
}

template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads, Cols<DP>::BLOCKS)
    bwd_dq_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, Params p) {
  using T = DqTile<DP>;
  constexpr int BK = T::BK, W = T::W, SW = T::SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sq = smem_u32(base);      // Q: NCB blocks of (64 x W)
  const uint32_t sdo = sq + T::ROW_BYTES;  // dO, the same
  const uint32_t skv = sdo + T::ROW_BYTES;  // stage s: K at skv + 2 s KV_BYTES, V after it; NCB blocks of (BK x W)
  const int biases = 2 * T::ROW_BYTES + 2 * kStages * T::KV_BYTES;  // stage s: the bias at + s BIAS_BYTES
  const uint32_t qbar = sq + biases + kStages * T::BIAS_BYTES;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * kStages;  // stage s: + 8 s

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * kRows;
  const int ntiles = (p.Nk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, kFullArrivals);
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWG) {
    // ---- producer warp: lane 0 issues every TMA copy, all lanes copy the bias
    if constexpr (T::BLOCKS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int lane = threadIdx.x - kWG;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(qbar, 2 * T::ROW_BYTES);
#pragma unroll
        for (int j = 0; j < T::NCB; ++j) {
          tma_load(sq + j * kRows * SW, &tq, j * W, q0, h, b, qbar);
          tma_load(sdo + j * kRows * SW, &tdo, j * W, q0, h, b, qbar);
        }
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        float bv[BK / 32];  // this lane's keys of the tile: lane + 32 j
#pragma unroll
        for (int j = 0; j < BK / 32; ++j) {
          const int col = t * BK + lane + 32 * j;
          bv[j] = HAS_BIAS && col < p.Nk ? __ldg(p.bias + static_cast<long long>(b) * p.Nk + col) : 0.f;
        }
        if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
        const uint32_t ks = skv + 2 * s * T::KV_BYTES, vs = ks + T::KV_BYTES, bar = full0 + 8 * s;
        if (lane == 0) {
          mbar_expect_tx(bar, 2 * T::KV_BYTES);
#pragma unroll
          for (int j = 0; j < T::NCB; ++j) {
            tma_load(ks + j * BK * SW, &tk, j * W, t * BK, h, b, bar);
            tma_load(vs + j * BK * SW, &tv, j * W, t * BK, h, b, bar);
          }
        }
        if constexpr (HAS_BIAS) {
          float* bs = reinterpret_cast<float*>(base + biases + s * T::BIAS_BYTES);
#pragma unroll
          for (int j = 0; j < BK / 32; ++j) bs[lane + 32 * j] = bv[j];
        }
        mbar_arrive(bar);
      }
    }
  } else {
    // ---- consumer warpgroup: query rows [q0, q0 + 64)
    if constexpr (T::BLOCKS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    const long long bh = blockIdx.y;
    // Per row: lse (+inf where it is -inf, so that P = 0 below), -lse log2 e,
    // and di * scale: P = 2^(s sl2 - lse log2 e) without a bias,
    // e^(s scale + bias - lse) with one; dS = P (dP scale - di scale).
    float lse[2], nl[2], di[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const float l = row < p.Nq ? __ldg(p.lse + bh * p.Nq + row) : -INFINITY;
      lse[r] = l == -INFINITY ? INFINITY : l;
      nl[r] = -lse[r] * kLog2e;
      di[r] = row < p.Nq ? __ldg(p.di + bh * p.Nq + row) * p.scale : 0.f;
    }
    const float sl2 = p.scale * kLog2e;

    // S/dP accumulator element i: row r0 + 8 ((i >> 1) & 1), column 8 (i / 4) + 2 t4 + (i & 1)
    float sacc[BK / 2], dpacc[BK / 2], dq[DP / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = dpacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

    mbar_wait(qbar, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages, kb = t * BK;
      const uint32_t ks = skv + 2 * s * T::KV_BYTES, vs = ks + T::KV_BYTES;
      const float* bias_s = reinterpret_cast<const float*>(base + biases + s * T::BIAS_BYTES);
      mbar_wait(full0 + 8 * s, (t / kStages) & 1);

      // S = Q K^T and dP = dO V^T, all K-major, one group each: a 16-deep
      // step inside a swizzle row is a 32-byte start offset, the next column
      // block the next stretch
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk * 16 / W) * kRows * SW + (kk * 16 % W) * 2;
        const int koff = (kk * 16 / W) * BK * SW + (kk * 16 % W) * 2;
        wgmma_ss(sacc, smem_desc(sq + off, 16, 8 * SW, T::kLayout), smem_desc(ks + koff, 16, 8 * SW, T::kLayout),
                 kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk * 16 / W) * kRows * SW + (kk * 16 % W) * 2;
        const int koff = (kk * 16 / W) * BK * SW + (kk * 16 % W) * 2;
        wgmma_ss(dpacc, smem_desc(sdo + off, 16, 8 * SW, T::kLayout), smem_desc(vs + koff, 16, 8 * SW, T::kLayout),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      keep(sacc);

      // P into sacc while dP runs; the bias is per key (column)
      const bool ragged = kb + BK > p.Nk;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int c = n * 8 + t4 * 2;
        float2 b2 = make_float2(0.f, 0.f);
        if constexpr (HAS_BIAS) b2 = *reinterpret_cast<const float2*>(bias_s + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool out = ragged && kb + c + e >= p.Nk;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * n + 2 * r + e;
            float pr;
            if constexpr (HAS_BIAS)
              pr = ex2((fmaf(sacc[i], p.scale, e ? b2.y : b2.x) - lse[r]) * kLog2e);
            else
              pr = ex2(fmaf(sacc[i], sl2, nl[r]));
            sacc[i] = out ? 0.f : pr;
          }
        }
      }
      wgmma_wait_all();
      keep(dpacc);
      // dS into sacc
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sacc[i] *= fmaf(dpacc[i], p.scale, -di[(i >> 1) & 1]);
      uint32_t ds[BK / 16][4];
      to_frags(ds, sacc);  // dS rounded to K's dtype

      // dQ += dS K: K is MN-major (d contiguous); a 16-key step is 16 rows
      // of the tile, the next column block of d is LBO away
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wgmma_rs(dq, ds[j], smem_desc(ks + j * 16 * SW, BK * SW, 8 * SW, T::kLayout));
      wgmma_commit();
      wgmma_wait_all();
      keep(dq);
      keep(ds);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    store_rows<DP>(static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh, p.dq_sn, dq, r0, p.Nq, p.D, t4);
  }
}

template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads, Cols<DP>::BLOCKS)
    bwd_dkv_bf16(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo, Params p) {
  using T = DkvTile<DP>;
  constexpr int BQ = T::BQ, W = T::W, SW = T::SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sk = smem_u32(base);     // K: NCB blocks of (64 x W)
  const uint32_t sv = sk + T::ROW_BYTES;  // V, the same
  const uint32_t sqd = sv + T::ROW_BYTES;  // stage s: Q at sqd + 2 s QT_BYTES, dO after it; NCB blocks of (BQ x W)
  const int stats = 2 * T::ROW_BYTES + 2 * kStages * T::QT_BYTES;  // stage s: lse at + 2 s STAT_BYTES, di after it
  const uint32_t kvbar = sk + stats + 2 * kStages * T::STAT_BYTES;
  const uint32_t full0 = kvbar + 8, empty0 = full0 + 8 * kStages;  // stage s: + 8 s

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int k0 = blockIdx.x * kRows;
  const int ntiles = (p.Nq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, kFullArrivals);
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWG) {
    // ---- producer warp: lane 0 issues every TMA copy, all lanes copy lse and di
    if constexpr (T::BLOCKS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int lane = threadIdx.x - kWG;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * T::ROW_BYTES);
#pragma unroll
        for (int j = 0; j < T::NCB; ++j) {
          tma_load(sk + j * kRows * SW, &tk, j * W, k0, h, b, kvbar);
          tma_load(sv + j * kRows * SW, &tv, j * W, k0, h, b, kvbar);
        }
      }
      const long long row0 = static_cast<long long>(blockIdx.y) * p.Nq;  // this head's first row of lse and di
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        float lse_v[BQ / 32], di_v[BQ / 32];  // this lane's queries of the tile: lane + 32 j
#pragma unroll
        for (int j = 0; j < BQ / 32; ++j) {
          const int q = t * BQ + lane + 32 * j;
          lse_v[j] = q < p.Nq ? __ldg(p.lse + row0 + q) : 0.f;
          di_v[j] = q < p.Nq ? __ldg(p.di + row0 + q) : 0.f;
        }
        if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
        const uint32_t qs = sqd + 2 * s * T::QT_BYTES, dos = qs + T::QT_BYTES, bar = full0 + 8 * s;
        if (lane == 0) {
          mbar_expect_tx(bar, 2 * T::QT_BYTES);
#pragma unroll
          for (int j = 0; j < T::NCB; ++j) {
            tma_load(qs + j * BQ * SW, &tq, j * W, t * BQ, h, b, bar);
            tma_load(dos + j * BQ * SW, &tdo, j * W, t * BQ, h, b, bar);
          }
        }
        float* st = reinterpret_cast<float*>(base + stats + 2 * s * T::STAT_BYTES);
#pragma unroll
        for (int j = 0; j < BQ / 32; ++j) {
          st[lane + 32 * j] = lse_v[j];
          st[BQ + lane + 32 * j] = di_v[j];
        }
        mbar_arrive(bar);
      }
    }
  } else {
    // ---- consumer warpgroup: key rows [k0, k0 + 64)
    if constexpr (T::BLOCKS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = k0 + warp * 16 + g;  // this thread's keys: r0 and r0 + 8
    float kbias[2] = {0.f, 0.f};
    if constexpr (HAS_BIAS) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        kbias[r] = r0 + 8 * r < p.Nk ? __ldg(p.bias + static_cast<long long>(b) * p.Nk + r0 + 8 * r) : 0.f;
    }
    const float sl2 = p.scale * kLog2e;

    // S^T/dP^T accumulator element i: key r0 + 8 ((i >> 1) & 1), query 8 (i / 4) + 2 t4 + (i & 1)
    float sacc[BQ / 2], dpacc[BQ / 2], dv[DP / 2], dk[DP / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sacc[i] = dpacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dv[i] = dk[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages, qb = t * BQ;
      const uint32_t qs = sqd + 2 * s * T::QT_BYTES, dos = qs + T::QT_BYTES;
      const float* lse_s = reinterpret_cast<const float*>(base + stats + 2 * s * T::STAT_BYTES);
      const float* di_s = lse_s + BQ;
      mbar_wait(full0 + 8 * s, (t / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T, all K-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk * 16 / W) * kRows * SW + (kk * 16 % W) * 2;
        const int qoff = (kk * 16 / W) * BQ * SW + (kk * 16 % W) * 2;
        wgmma_ss(sacc, smem_desc(sk + off, 16, 8 * SW, T::kLayout), smem_desc(qs + qoff, 16, 8 * SW, T::kLayout),
                 kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk * 16 / W) * kRows * SW + (kk * 16 % W) * 2;
        const int qoff = (kk * 16 / W) * BQ * SW + (kk * 16 % W) * 2;
        wgmma_ss(dpacc, smem_desc(sv + off, 16, 8 * SW, T::kLayout), smem_desc(dos + qoff, 16, 8 * SW, T::kLayout),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(sacc);
      keep(dpacc);

      // P^T into sacc, dS^T into dpacc; lse and di are per query (column)
      const bool ragged = qb + BQ > p.Nq;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const int c = n * 8 + t4 * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 d2 = *reinterpret_cast<const float2*>(di_s + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = e ? l2.y : l2.x;
          const float lsafe = l == -INFINITY ? INFINITY : l;  // P = 0 for a query with no key
          const float nl = -lsafe * kLog2e, dis = (e ? d2.y : d2.x) * p.scale;
          const bool out = ragged && qb + c + e >= p.Nq;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * n + 2 * r + e;
            float pr;
            if constexpr (HAS_BIAS)
              pr = ex2((fmaf(sacc[i], p.scale, kbias[r]) - lsafe) * kLog2e);
            else
              pr = ex2(fmaf(sacc[i], sl2, nl));
            if (out) pr = 0.f;
            sacc[i] = pr;
            dpacc[i] = pr * fmaf(dpacc[i], p.scale, -dis);
          }
        }
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      to_frags(pa, sacc);   // P^T rounded to dO's dtype
      to_frags(da, dpacc);  // dS^T rounded to Q's dtype

      // dV += P^T dO and dK += dS^T Q: dO and Q MN-major, a 16-query step is
      // 16 rows of the tile
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) wgmma_rs(dv, pa[j], smem_desc(dos + j * 16 * SW, BQ * SW, 8 * SW, T::kLayout));
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) wgmma_rs(dk, da[j], smem_desc(qs + j * 16 * SW, BQ * SW, 8 * SW, T::kLayout));
      wgmma_commit();
      wgmma_wait_all();
      keep(dv);
      keep(dk);
      keep(pa);
      keep(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    store_rows<DP>(static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh, p.dv_sn, dv, r0, p.Nk, p.D, t4);
    store_rows<DP>(static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh, p.dk_sn, dk, r0, p.Nk, p.D, t4);
  }
}

// ---------------------------------------------------------------------------
// f32: exact products on the CUDA cores, one thread per output row. Loops
// stay rolled: this path checks numerics in f32 and is not on the bf16 main
// path, and full unrolling over DP multiplies build time.

constexpr int kSR = 64;  // output rows (threads) per block
constexpr int kST = 32;  // rows of the streamed side per shared-memory tile

template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(kSR) bwd_dq_f32(Params p) {
  __shared__ float ks[kST][DP];
  __shared__ float vs[kST][DP];
  __shared__ float bs[kST];

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int row = blockIdx.x * kSR + threadIdx.x;
  const bool in = row < p.Nq;
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dop = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  float q[DP], dout[DP], acc[DP];
  for (int d = 0; d < DP; ++d) {
    q[d] = in && d < p.D ? qp[row * p.q_sn + d] : 0.f;
    dout[d] = in && d < p.D ? dop[row * p.do_sn + d] : 0.f;
    acc[d] = 0.f;
  }
  const float lse = in ? p.lse[static_cast<long long>(bh) * p.Nq + row] : -INFINITY;
  const float di = in ? p.di[static_cast<long long>(bh) * p.Nq + row] : 0.f;

  for (int kb = 0; kb < p.Nk; kb += kST) {
    __syncthreads();
    for (int i = threadIdx.x; i < kST * DP; i += kSR) {
      const int r = i / DP, c = i % DP;
      const bool ok = kb + r < p.Nk && c < p.D;
      ks[r][c] = ok ? kp[(kb + r) * p.k_sn + c] : 0.f;
      vs[r][c] = ok ? vp[(kb + r) * p.v_sn + c] : 0.f;
    }
    if constexpr (HAS_BIAS) {
      for (int i = threadIdx.x; i < kST; i += kSR)
        bs[i] = kb + i < p.Nk ? p.bias[b * p.Nk + kb + i] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kST; ++j) {
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DP; ++d) {
        x = fmaf(q[d], ks[j][d], x);
        dp = fmaf(dout[d], vs[j][d], dp);
      }
      x *= p.scale;
      if constexpr (HAS_BIAS) x += bs[j];
      const float pj = kb + j < p.Nk ? prob(x, lse) : 0.f;
      const float ds = pj * (dp - di) * p.scale;
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
  }
  if (!in) return;
  float* out = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh + row * p.dq_sn;
  for (int d = 0; d < p.D; ++d) out[d] = acc[d];
}

template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(kSR) bwd_dkv_f32(Params p) {
  __shared__ float qs[kST][DP];
  __shared__ float dos[kST][DP];
  __shared__ float lses[kST];
  __shared__ float dis[kST];

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int key = blockIdx.x * kSR + threadIdx.x;
  const bool in = key < p.Nk;
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dop = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  float kr[DP], vr[DP], dk[DP], dv[DP];
  for (int d = 0; d < DP; ++d) {
    kr[d] = in && d < p.D ? kp[key * p.k_sn + d] : 0.f;
    vr[d] = in && d < p.D ? vp[key * p.v_sn + d] : 0.f;
    dk[d] = dv[d] = 0.f;
  }
  float kbias = 0.f;
  if constexpr (HAS_BIAS) kbias = in ? p.bias[b * p.Nk + key] : 0.f;

  for (int qb = 0; qb < p.Nq; qb += kST) {
    __syncthreads();
    for (int i = threadIdx.x; i < kST * DP; i += kSR) {
      const int r = i / DP, c = i % DP;
      const bool ok = qb + r < p.Nq && c < p.D;
      qs[r][c] = ok ? qp[(qb + r) * p.q_sn + c] : 0.f;
      dos[r][c] = ok ? dop[(qb + r) * p.do_sn + c] : 0.f;
    }
    for (int i = threadIdx.x; i < kST; i += kSR) {
      const bool ok = qb + i < p.Nq;
      lses[i] = ok ? p.lse[static_cast<long long>(bh) * p.Nq + qb + i] : -INFINITY;
      dis[i] = ok ? p.di[static_cast<long long>(bh) * p.Nq + qb + i] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kST; ++i) {
      float x = 0.f, dp = 0.f;
      for (int d = 0; d < DP; ++d) {
        x = fmaf(kr[d], qs[i][d], x);
        dp = fmaf(vr[d], dos[i][d], dp);
      }
      const float pi = in ? prob(x * p.scale + kbias, lses[i]) : 0.f;
      const float ds = pi * (dp - dis[i]) * p.scale;
      for (int d = 0; d < DP; ++d) {
        dv[d] = fmaf(pi, dos[i][d], dv[d]);
        dk[d] = fmaf(ds, qs[i][d], dk[d]);
      }
    }
  }
  if (!in) return;
  float* dkp = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh + key * p.dk_sn;
  float* dvp = static_cast<float*>(p.dv) + b * p.dv_sb + h * p.dv_sh + key * p.dv_sn;
  for (int d = 0; d < p.D; ++d) {
    dkp[d] = dk[d];
    dvp[d] = dv[d];
  }
}

// ---------------------------------------------------------------------------
// dispatch

// Dynamic shared memory above 48 KB is opted into once per instantiation.
template <typename Kernel>
cudaError_t size_smem(Kernel kernel, int smem, bool& sized) {
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  return cudaSuccess;
}

template <int DP, bool HAS_BIAS>
cudaError_t launch_dq_bf16(const Params& p, cudaStream_t stream) {
  using T = DqTile<DP>;
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map(&tq, p.q, p.B, p.H, p.Nq, p.D, p.q_sb, p.q_sh, p.q_sn, T::W, kRows) ||
      !make_map(&tdo, p.dout, p.B, p.H, p.Nq, p.D, p.do_sb, p.do_sh, p.do_sn, T::W, kRows) ||
      !make_map(&tk, p.k, p.B, p.H, p.Nk, p.D, p.k_sb, p.k_sh, p.k_sn, T::W, T::BK) ||
      !make_map(&tv, p.v, p.B, p.H, p.Nk, p.D, p.v_sb, p.v_sh, p.v_sn, T::W, T::BK))
    return cudaErrorInvalidValue;
  auto kernel = bwd_dq_bf16<DP, HAS_BIAS>;
  static bool sized = false;
  const cudaError_t err = size_smem(kernel, T::SMEM, sized);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.Nq + kRows - 1) / kRows, p.B * p.H), kThreads, T::SMEM, stream>>>(tq, tdo, tk, tv, p);
  return cudaSuccess;
}

template <int DP, bool HAS_BIAS>
cudaError_t launch_dkv_bf16(const Params& p, cudaStream_t stream) {
  using T = DkvTile<DP>;
  CUtensorMap tk, tv, tq, tdo;
  if (!make_map(&tk, p.k, p.B, p.H, p.Nk, p.D, p.k_sb, p.k_sh, p.k_sn, T::W, kRows) ||
      !make_map(&tv, p.v, p.B, p.H, p.Nk, p.D, p.v_sb, p.v_sh, p.v_sn, T::W, kRows) ||
      !make_map(&tq, p.q, p.B, p.H, p.Nq, p.D, p.q_sb, p.q_sh, p.q_sn, T::W, T::BQ) ||
      !make_map(&tdo, p.dout, p.B, p.H, p.Nq, p.D, p.do_sb, p.do_sh, p.do_sn, T::W, T::BQ))
    return cudaErrorInvalidValue;
  auto kernel = bwd_dkv_bf16<DP, HAS_BIAS>;
  static bool sized = false;
  const cudaError_t err = size_smem(kernel, T::SMEM, sized);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.Nk + kRows - 1) / kRows, p.B * p.H), kThreads, T::SMEM, stream>>>(tk, tv, tq, tdo, p);
  return cudaSuccess;
}

// The bf16 kernels' padded head dim: d up to 48 runs the 64-column kernels
// (one 128-byte swizzle row): 48 columns in three 32-byte swizzle rows ran
// 15% (dQ) and 8% (dK/dV) slower at SD1.5's 4096-token sites, d = 40.
constexpr int bf16_dp(int dp) { return dp == 48 ? 64 : dp; }

template <bool DKV, int DP>
cudaError_t launch_dp(const Params& p, int is_bf16, cudaStream_t stream) {
  const bool has_bias = p.bias != nullptr;
  if (!is_bf16) {
    const dim3 grid(((DKV ? p.Nk : p.Nq) + kSR - 1) / kSR, p.B * p.H);
    if constexpr (DKV) {
      if (has_bias) bwd_dkv_f32<DP, true><<<grid, kSR, 0, stream>>>(p);
      else bwd_dkv_f32<DP, false><<<grid, kSR, 0, stream>>>(p);
    } else {
      if (has_bias) bwd_dq_f32<DP, true><<<grid, kSR, 0, stream>>>(p);
      else bwd_dq_f32<DP, false><<<grid, kSR, 0, stream>>>(p);
    }
    return cudaSuccess;
  }
  constexpr int BP = bf16_dp(DP);
  if constexpr (DKV) {
    return has_bias ? launch_dkv_bf16<BP, true>(p, stream) : launch_dkv_bf16<BP, false>(p, stream);
  } else {
    return has_bias ? launch_dq_bf16<BP, true>(p, stream) : launch_dq_bf16<BP, false>(p, stream);
  }
}

template <bool DKV>
int launch(const Params& p, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((p.D + 15) / 16 * 16) {
    case 16: err = launch_dp<DKV, 16>(p, is_bf16, s); break;
    case 32: err = launch_dp<DKV, 32>(p, is_bf16, s); break;
    case 48: err = launch_dp<DKV, 48>(p, is_bf16, s); break;
    case 64: err = launch_dp<DKV, 64>(p, is_bf16, s); break;
    case 80: err = launch_dp<DKV, 80>(p, is_bf16, s); break;
    default: err = launch_dp<DKV, 160>(p, is_bf16, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Head dims the kernels are built for, padded to a multiple of 16, as the
// forward: 16/32 (test shapes), 48 (SD1.5 d=40), 64, 80, 160.
int flash_bwd_supports(int d) {
  const int dp = (d + 15) / 16 * 16;
  return d % 8 == 0 && (dp == 16 || dp == 32 || dp == 48 || dp == 64 ||
                        dp == 80 || dp == 160);
}

// Dynamic shared memory of one bf16 block of flash_bwd_dq (dkv = 0) or
// flash_bwd_dkv (dkv = 1) at head dim d (supported d only).
int flash_bwd_smem_bytes(int d, int dkv) {
  switch (bf16_dp((d + 15) / 16 * 16)) {
    case 16: return dkv ? DkvTile<16>::SMEM : DqTile<16>::SMEM;
    case 32: return dkv ? DkvTile<32>::SMEM : DqTile<32>::SMEM;
    case 64: return dkv ? DkvTile<64>::SMEM : DqTile<64>::SMEM;
    case 80: return dkv ? DkvTile<80>::SMEM : DqTile<80>::SMEM;
    default: return dkv ? DkvTile<160>::SMEM : DqTile<160>::SMEM;
  }
}

// Both entries launch on `stream` and return the CUDA error code: 1
// (cudaErrorInvalidValue) for an unsupported head dim or operands that no
// tensor map can describe, else cudaGetLastError(). Strides are in
// elements; the head dim is contiguous. lse and di are (B, H, Nq) f32
// contiguous.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const float* bias, const float* lse, const float* di, void* dq,
                 int B, int H, int Nq, int Nk, int D,
                 long long q_sb, long long q_sh, long long q_sn,
                 long long k_sb, long long k_sh, long long k_sn,
                 long long v_sb, long long v_sh, long long v_sn,
                 long long do_sb, long long do_sh, long long do_sn,
                 long long dq_sb, long long dq_sh, long long dq_sn,
                 float scale, int is_bf16, void* stream) {
  if (!flash_bwd_supports(D)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.bias = bias, p.lse = lse, p.di = di, p.dq = dq;
  p.B = B, p.H = H, p.Nq = Nq, p.Nk = Nk, p.D = D;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_sn = q_sn;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_sn = k_sn;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_sn = v_sn;
  p.do_sb = do_sb, p.do_sh = do_sh, p.do_sn = do_sn;
  p.dq_sb = dq_sb, p.dq_sh = dq_sh, p.dq_sn = dq_sn;
  p.scale = scale;
  return launch<false>(p, is_bf16, stream);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const float* bias, const float* lse, const float* di, void* dk,
                  void* dv, int B, int H, int Nq, int Nk, int D,
                  long long q_sb, long long q_sh, long long q_sn,
                  long long k_sb, long long k_sh, long long k_sn,
                  long long v_sb, long long v_sh, long long v_sn,
                  long long do_sb, long long do_sh, long long do_sn,
                  long long dk_sb, long long dk_sh, long long dk_sn,
                  long long dv_sb, long long dv_sh, long long dv_sn,
                  float scale, int is_bf16, void* stream) {
  if (!flash_bwd_supports(D)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q, p.k = k, p.v = v, p.dout = dout, p.bias = bias, p.lse = lse, p.di = di;
  p.dk = dk, p.dv = dv;
  p.B = B, p.H = H, p.Nq = Nq, p.Nk = Nk, p.D = D;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_sn = q_sn;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_sn = k_sn;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_sn = v_sn;
  p.do_sb = do_sb, p.do_sh = do_sh, p.do_sn = do_sn;
  p.dk_sb = dk_sb, p.dk_sh = dk_sh, p.dk_sn = dk_sn;
  p.dv_sb = dv_sb, p.dv_sh = dv_sh, p.dv_sn = dv_sn;
  p.scale = scale;
  return launch<true>(p, is_bf16, stream);
}

}  // extern "C"
