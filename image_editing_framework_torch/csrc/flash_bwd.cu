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
//   dQ = dS K                       (flash_bwd_dq: one block per 64 queries,
//                                    looping over 64-key tiles)
//   dV = P^T dO,  dK = dS^T Q       (flash_bwd_dkv: one block per 64 keys,
//                                    looping over 64-query tiles)
//
// Every block owns its outputs, so there are no atomics and two runs give the
// same bits. The bias gets no gradient (the JAX VJP gives it a zero
// cotangent). bf16 inputs: bf16 products with f32 accumulation
// (mma.sync.m16n8k16); dS is rounded to K's dtype before dS K and to Q's
// before dS^T Q, and P to dO's before P^T dO, as the TPU kernels round
// (flash_attention.py:420-423, :456-468). f32 inputs: true f32 products on
// the CUDA cores, never TF32. Keys at or beyond Nk and queries at or beyond
// Nq contribute nothing. A row whose lse is -inf (every logit -inf) gets
// P = 0 and zero gradients, where the JAX kernel gives NaN. s - lse is formed
// before any scaling by log2 e: NEG_INF (-0.7 * f32 max) times log2 e would
// overflow.
//
// What bounds it on the card: at SD1.5's 4096-token sites (8 heads, d = 40)
// the backward's five products are ~54 GFLOP per image against ~21 MB of
// q/k/v/o/dO/dq/dk/dv traffic in bf16, far above the H100's ~295 FLOP/byte
// ridge: tensor-core operations bound it. The design keeps every (N, N)
// tile (S, P, dP, dS) in registers, in the accumulator layout that mma.sync
// takes back as its A operand: the dK/dV kernel computes S^T = K Q^T with
// keys as the MMA rows, so P^T and dS^T feed P^T dO and dS^T Q with no
// transpose. Each block stages its own 64-row operand tiles in shared memory
// once and streams the other side's tiles, so device memory sees each input
// about once per block row. The two kernels recompute S and dP each (14
// N^2 d products where the bound counts 10), the price of having no atomics.
// Register pressure at d = 160: the dK/dV kernel's two 16 x 160 f32
// accumulators would take 160 registers a thread, so at d > 80 the dK
// accumulator lives in shared memory (thread-private, one read-modify-write
// per 8-column tile and query tile). wgmma, TMA and warp specialisation,
// which reach the card's full tensor rate, are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

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
// bf16: tensor cores through mma.sync.m16n8k16

constexpr int kTile = 64;  // rows per block and per streamed tile: 4 warps x 16
constexpr int kThreads = 128;
constexpr int kNT = kTile / 8;   // 8-column accumulator tiles across a tile
constexpr int kKS = kTile / 16;  // 16-deep k-steps across a tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + kTile) of a (nrows, d) matrix with row stride sn into a
// (kTile, DP + 8) shared tile, zero outside; 16-byte chunks (d % 8 == 0).
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long sn, int row0, int nrows,
                                          int d) {
  constexpr int LDS = DP + 8, CHUNKS = DP / 8;
  for (int i = threadIdx.x; i < kTile * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + r < nrows && c < d)
      x = *reinterpret_cast<const uint4*>(src + (row0 + r) * sn + c);
    *reinterpret_cast<uint4*>(&dst[r * LDS + c]) = x;
  }
}

// c[n] = A[arow, arow + 16) . B[n*8, n*8 + 8)^T over DP columns, both
// operands row-major shared tiles: the warp's 16 rows against 64 rows.
template <int DP>
__device__ __forceinline__ void rows_x_rows_t(float (&c)[kNT][4],
                                              const __nv_bfloat16* a_tile,
                                              const __nv_bfloat16* b_tile,
                                              int arow, int g, int t) {
  constexpr int LDS = DP + 8;
#pragma unroll
  for (int n = 0; n < kNT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int s = 0; s < DP / 16; ++s) {
    const __nv_bfloat16* ap = a_tile + (arow + g) * LDS + s * 16 + t * 2;
    const uint32_t a[4] = {lds32(ap), lds32(ap + 8 * LDS), lds32(ap + 8),
                           lds32(ap + 8 * LDS + 8)};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const __nv_bfloat16* bp = b_tile + (n * 8 + g) * LDS + s * 16 + t * 2;
      mma_bf16(c[n], a, lds32(bp), lds32(bp + 8));
    }
  }
}

// The 16 x 64 accumulator set x as the A fragments of its four k-steps,
// rounded to bf16: n-tiles 2j and 2j+1 are exactly k-step j.
__device__ __forceinline__ void to_frags(uint32_t (&a)[kKS][4],
                                         const float (&x)[kNT][4]) {
#pragma unroll
  for (int j = 0; j < kKS; ++j) {
    a[j][0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    a[j][1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    a[j][2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    a[j][3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
  }
}

// c += X . T[:, d*8, d*8 + 8): X given as A fragments over the tile's 64
// rows (the contraction), T a row-major (64, LDS) shared tile.
template <int LDS>
__device__ __forceinline__ void mma_cols(float (&c)[4],
                                         const uint32_t (&a)[kKS][4],
                                         const __nv_bfloat16* tile, int d,
                                         int g, int t) {
#pragma unroll
  for (int j = 0; j < kKS; ++j) {
    const __nv_bfloat16* tc = tile + (j * 16 + t * 2) * LDS + d * 8 + g;
    mma_bf16(c, a[j], pack_raw(tc[0], tc[LDS]), pack_raw(tc[8 * LDS], tc[9 * LDS]));
  }
}

// Rows r0 and r0 + 8 of a warp's (16, DP) f32 accumulator to bf16.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long sn,
                                           const float (&acc)[DP / 8][4],
                                           int r0, int nrows, int d, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= nrows) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + t * 2;
      if (c < d)
        *reinterpret_cast<uint32_t*>(out + row * sn + c) =
            pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

template <int DP>
constexpr int dq_smem_bytes() {
  return 4 * kTile * (DP + 8) * 2 + kTile * 4;
}

template <int DP>
constexpr int dkv_smem_bytes() {
  return 4 * kTile * (DP + 8) * 2 + 2 * kTile * 4 +
         (DP > 80 ? kThreads * (DP / 8) * 16 : 0);
}

template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads) bwd_dq_bf16(Params p) {
  constexpr int LDS = DP + 8, DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kTile * LDS;
  __nv_bfloat16* ks = dos + kTile * LDS;
  __nv_bfloat16* vs = ks + kTile * LDS;
  float* bs = reinterpret_cast<float*>(vs + kTile * LDS);

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wrow = warp * 16;
  const int q0 = blockIdx.x * kTile;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile<DP>(qs, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh,
                p.q_sn, q0, p.Nq, p.D);
  load_tile<DP>(dos, static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh,
                p.do_sn, q0, p.Nq, p.D);
  float lse[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    const bool in = row < p.Nq;
    lse[r] = in ? p.lse[static_cast<long long>(bh) * p.Nq + row] : -INFINITY;
    di[r] = in ? p.di[static_cast<long long>(bh) * p.Nq + row] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kb = 0; kb < p.Nk; kb += kTile) {
    __syncthreads();  // the previous K/V tile is no longer read
    load_tile<DP>(ks, kp, p.k_sn, kb, p.Nk, p.D);
    load_tile<DP>(vs, vp, p.v_sn, kb, p.Nk, p.D);
    if constexpr (HAS_BIAS) {
      for (int i = threadIdx.x; i < kTile; i += kThreads)
        bs[i] = kb + i < p.Nk ? p.bias[b * p.Nk + kb + i] : 0.f;
    }
    __syncthreads();

    float s[kNT][4], dp[kNT][4];
    rows_x_rows_t<DP>(s, qs, ks, wrow, g, t);   // S = Q K^T
    rows_x_rows_t<DP>(dp, dos, vs, wrow, g, t);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t * 2 + (e & 1), r = e >> 1;
        float x = s[n][e] * p.scale;
        if constexpr (HAS_BIAS) x += bs[col];
        const float pe = kb + col < p.Nk ? prob(x, lse[r]) : 0.f;
        s[n][e] = pe * (dp[n][e] - di[r]) * p.scale;  // dS
      }
    }
    uint32_t a[kKS][4];
    to_frags(a, s);  // dS rounded to K's dtype
#pragma unroll
    for (int j = 0; j < DT; ++j) mma_cols<LDS>(acc[j], a, ks, j, g, t);
  }
  store_rows<DP>(static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh, p.dq_sn,
                 acc, q0 + wrow + g, p.Nq, p.D, t);
}

template <int DP, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads) bwd_dkv_bf16(Params p) {
  constexpr int LDS = DP + 8, DT = DP / 8;
  constexpr bool kDkShared = DP > 80;  // see the register note at the top
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile * LDS;
  __nv_bfloat16* qs = vs + kTile * LDS;
  __nv_bfloat16* dos = qs + kTile * LDS;
  float* lses = reinterpret_cast<float*>(dos + kTile * LDS);
  float* dis = lses + kTile;
  // thread-private dK accumulator: [8-column tile][thread] float4s
  float4* dks = reinterpret_cast<float4*>(dis + kTile) + threadIdx.x;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wrow = warp * 16;
  const int k0 = blockIdx.x * kTile;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dop = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;

  load_tile<DP>(ks, static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh,
                p.k_sn, k0, p.Nk, p.D);
  load_tile<DP>(vs, static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh,
                p.v_sn, k0, p.Nk, p.D);
  bool kin[2];
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wrow + g + 8 * r;
    kin[r] = key < p.Nk;
    kbias[r] = 0.f;
    if constexpr (HAS_BIAS) kbias[r] = kin[r] ? p.bias[b * p.Nk + key] : 0.f;
  }
  float dv[DT][4], dk[kDkShared ? 1 : DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  if constexpr (kDkShared) {
    for (int j = 0; j < DT; ++j) dks[j * kThreads] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int j = 0; j < DT; ++j) dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
  }

  for (int qb = 0; qb < p.Nq; qb += kTile) {
    __syncthreads();  // the previous Q/dO tile is no longer read
    load_tile<DP>(qs, qp, p.q_sn, qb, p.Nq, p.D);
    load_tile<DP>(dos, dop, p.do_sn, qb, p.Nq, p.D);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = qb + i < p.Nq;
      lses[i] = in ? p.lse[static_cast<long long>(bh) * p.Nq + qb + i] : -INFINITY;
      dis[i] = in ? p.di[static_cast<long long>(bh) * p.Nq + qb + i] : 0.f;
    }
    __syncthreads();

    float s[kNT][4], dp[kNT][4];
    rows_x_rows_t<DP>(s, ks, qs, wrow, g, t);  // S^T = K Q^T: keys are rows
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t * 2 + (e & 1), r = e >> 1;
        s[n][e] = kin[r] ? prob(s[n][e] * p.scale + kbias[r], lses[col]) : 0.f;
      }
    }
    uint32_t a[kKS][4];
    to_frags(a, s);  // P^T rounded to dO's dtype
#pragma unroll
    for (int j = 0; j < DT; ++j) mma_cols<LDS>(dv[j], a, dos, j, g, t);

    rows_x_rows_t<DP>(dp, vs, dos, wrow, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t * 2 + (e & 1);
        s[n][e] = s[n][e] * (dp[n][e] - dis[col]) * p.scale;  // dS^T
      }
    }
    to_frags(a, s);  // dS^T rounded to Q's dtype
    if constexpr (kDkShared) {
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const float4 c4 = dks[j * kThreads];
        float c[4] = {c4.x, c4.y, c4.z, c4.w};
        mma_cols<LDS>(c, a, qs, j, g, t);
        dks[j * kThreads] = make_float4(c[0], c[1], c[2], c[3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < DT; ++j) mma_cols<LDS>(dk[j], a, qs, j, g, t);
    }
  }

  const int r0 = k0 + wrow + g;
  store_rows<DP>(static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + h * p.dv_sh, p.dv_sn,
                 dv, r0, p.Nk, p.D, t);
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  if constexpr (kDkShared) {
    float acc[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const float4 c4 = dks[j * kThreads];
      acc[j][0] = c4.x, acc[j][1] = c4.y, acc[j][2] = c4.z, acc[j][3] = c4.w;
    }
    store_rows<DP>(dkp, p.dk_sn, acc, r0, p.Nk, p.D, t);
  } else {
    store_rows<DP>(dkp, p.dk_sn, dk, r0, p.Nk, p.D, t);
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

template <typename Kernel>
void launch_bf16(Kernel kernel, dim3 grid, int smem, const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return;  // the error stays for cudaGetLastError
  kernel<<<grid, kThreads, smem, stream>>>(p);
}

template <int DP, bool HAS_BIAS>
void launch_dq(const Params& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    launch_bf16(bwd_dq_bf16<DP, HAS_BIAS>, dim3((p.Nq + kTile - 1) / kTile, p.B * p.H),
                dq_smem_bytes<DP>(), p, stream);
  } else {
    bwd_dq_f32<DP, HAS_BIAS><<<dim3((p.Nq + kSR - 1) / kSR, p.B * p.H), kSR, 0, stream>>>(p);
  }
}

template <int DP, bool HAS_BIAS>
void launch_dkv(const Params& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    launch_bf16(bwd_dkv_bf16<DP, HAS_BIAS>, dim3((p.Nk + kTile - 1) / kTile, p.B * p.H),
                dkv_smem_bytes<DP>(), p, stream);
  } else {
    bwd_dkv_f32<DP, HAS_BIAS><<<dim3((p.Nk + kSR - 1) / kSR, p.B * p.H), kSR, 0, stream>>>(p);
  }
}

template <bool DKV, int DP>
void launch_dp(const Params& p, int is_bf16, cudaStream_t stream) {
  const bool has_bias = p.bias != nullptr;
  if constexpr (DKV) {
    if (has_bias) launch_dkv<DP, true>(p, is_bf16, stream);
    else launch_dkv<DP, false>(p, is_bf16, stream);
  } else {
    if (has_bias) launch_dq<DP, true>(p, is_bf16, stream);
    else launch_dq<DP, false>(p, is_bf16, stream);
  }
}

template <bool DKV>
int launch(const Params& p, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((p.D + 15) / 16 * 16) {
    case 16: launch_dp<DKV, 16>(p, is_bf16, s); break;
    case 32: launch_dp<DKV, 32>(p, is_bf16, s); break;
    case 48: launch_dp<DKV, 48>(p, is_bf16, s); break;
    case 64: launch_dp<DKV, 64>(p, is_bf16, s); break;
    case 80: launch_dp<DKV, 80>(p, is_bf16, s); break;
    default: launch_dp<DKV, 160>(p, is_bf16, s); break;
  }
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

// Both entries launch on `stream` and return cudaGetLastError();
// 1 (cudaErrorInvalidValue) for an unsupported head dim. Strides are in
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
