// Flash-attention forward for Hopper (sm_90a), bound to PyTorch through a
// plain C entry point (ctypes).
//
// Replaces the TPU Pallas kernels
//   image_editing_framework_tpu/ops/flash_attention.py:76  _fwd_kernel
//       (+ :136 _fwd_kernel_nolse, launched by _fwd_impl:146)
//   image_editing_framework_tpu/ops/flash_attention.py:205 _fwd_kernel_t
//       (+ :276 _fwd_kernel_t_nolse, launched by _fwd_impl_t:286)
// Both compute one function; the transposed layout of the second exists only
// for the TPU's 128-lane padding, so on Hopper they are one kernel:
//
//   O[b,h]  = softmax(Q[b,h] K[b,h]^T * scale + bias[b]) V[b,h]
//   lse[b,h] = m + log(l)                      (optional, f32)
//
// by online softmax over key tiles. Scores and softmax statistics are f32.
// bf16 inputs: bf16 products with f32 accumulation on the tensor cores, and
// the unnormalised probabilities are rounded to bf16 before P.V, as the TPU
// kernel does (flash_attention.py:118-121). f32 inputs: true f32 products on
// the CUDA cores (never TF32). Keys at or beyond Nk do not exist for the
// softmax. A row whose every key has a -inf logit has l == 0 and returns 0.
// NEG_INF (-0.7 * f32 max) is a finite logit: a row masked by it everywhere
// gets equal weights, as softmax gives.
//
// What bounds it on the card: at the SDXL 4096-token sites (batch 4, 10
// heads, d=64) one call does ~172 GFLOP against ~84 MB of Q/K/V/O traffic,
// ~2000 FLOP per byte, far above the H100's ~295 FLOP/byte ridge: the kernel
// is bound by tensor-core operations, and next by the softmax's exponentials
// (one MUFU op per score: at d=64 the SM's 16 ex2 a clock take as long as
// the two products at the full tensor rate). The bf16 path reaches the
// tensor cores' full rate only through wgmma fed from shared memory, with
// copies that overlap the math:
//   * Tensor cores through wgmma. S = Q K^T reads both operands from shared
//     memory (SS); O += P V takes P from registers (RS): the S accumulator,
//     packed to bf16, is the A fragment. V is the B operand with d
//     contiguous, MN-major, read with the transpose bit.
//   * Warp specialisation. One producer warp issues TMA copies of the
//     block's Q tile (once) and of K/V tiles into a ring of kStages stages;
//     mbarriers say that a stage has arrived (transaction bytes) and that
//     the consumer warpgroups are done with it. Two consumer warpgroups own
//     64 query rows each and share every K/V tile: 128 queries per block
//     (one warpgroup, 64 queries, at d = 160, whose sites are small).
//     setmaxnreg moves registers from the producer to the consumers.
//   * Rank-4 tensor maps (D, N, H, B) over the operands' own strides, so the
//     UNet's head-split views are read as they are. TMA's zero fill pads d
//     to DP and fills the ragged query and key tails; keys >= Nk still get
//     a -inf score (a zero key scores 0). Each DP is split into column
//     blocks of one swizzle row (W = 64, 32 or 16 bf16: 128-, 64- or 32-byte
//     swizzle), one TMA box each.
//   * Softmax in registers, four threads per row as the wgmma accumulator
//     lays rows out; without a bias log2(e) is folded into the scale, with
//     one the logits stay in natural units so that NEG_INF stays finite.
// Within a warpgroup the softmax still serialises with both products; the
// two warpgroups overlap each other's. Ping-pong scheduling, overlapping the
// next QK^T with the softmax, persistent blocks and clusters are not done.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // (B, Nk) f32, or null
  void* o;
  float* lse;  // (B, H, Nq) f32 contiguous, or null
  int B, H, Nq, Nk, D;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed tiles, one producer warp and two consumer warpgroups

constexpr int kBK = 128;      // keys per K/V tile up to d = 80
constexpr int kBKWide = 64;   // keys per K/V tile at d = 160 (O alone is 80 f32 a thread)
constexpr int kStages = 2;    // depth of the K/V ring
constexpr int kWG = 128;      // threads per warpgroup; a consumer warpgroup owns 64 query rows
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // two consumers: 24 * 128 + 240 * 256 <= 65536

template <int DP>
struct Tile {
  // Two consumer warpgroups share each K/V tile up to d = 80. At d = 160
  // one does: its sites are small (256 and 64 tokens) and 128-query blocks
  // would leave half the SMs idle.
  static constexpr int WGS = DP > 80 ? 1 : 2;
  static constexpr int BQ = 64 * WGS;            // query rows per block
  static constexpr int THREADS = kWG * (WGS + 1);  // consumers first, then the producer
  static constexpr int BK = DP > 80 ? kBKWide : kBK;
  // One swizzle row holds W bf16; d is split into NCB column blocks of W,
  // each one TMA box and one (rows x W) stretch of shared memory.
  static constexpr int W = DP % 64 == 0 ? 64 : DP % 32 == 0 ? 32 : 16;
  static constexpr int SW = 2 * W;  // swizzle bytes: 128, 64 or 32
  static constexpr int NCB = DP / W;
  static constexpr uint64_t kLayout = W == 64 ? 1 : W == 32 ? 2 : 3;  // wgmma descriptor swizzle code
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;  // K or V, one stage
  // tiles (1024-byte aligned), then the mbarriers: Q, full[kStages], empty[kStages]
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * kStages * KV_BYTES + 8 * (1 + 2 * kStages);
};

template <int DP, bool HAS_BIAS, bool WANT_LSE>
__global__ void __launch_bounds__(Tile<DP>::THREADS, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, Params p) {
  using T = Tile<DP>;
  constexpr int BK = T::BK, W = T::W, SW = T::SW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;  // Q: NCB blocks of (BQ x W)
  const uint32_t skv = sq + T::Q_BYTES;  // stage s: K at skv + 2 s KV_BYTES, V after it; NCB blocks of (BK x W)
  const uint32_t qbar = skv + 2 * kStages * T::KV_BYTES;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * kStages;  // stage s: + 8 s

  const int wg = threadIdx.x / kWG;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * T::BQ;
  const int ntiles = (p.Nk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * T::WGS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == T::WGS) {
    // ---- producer: one thread issues every copy
    if constexpr (T::WGS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == T::WGS * kWG) {
      mbar_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int j = 0; j < T::NCB; ++j) tma_load(sq + j * T::BQ * SW, &tq, j * W, q0, h, b, qbar);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * s, (t / kStages - 1) & 1);
        const uint32_t ks = skv + 2 * s * T::KV_BYTES, vs = ks + T::KV_BYTES, bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * T::KV_BYTES);
#pragma unroll
        for (int j = 0; j < T::NCB; ++j) {
          tma_load(ks + j * BK * SW, &tk, j * W, t * BK, h, b, bar);
          tma_load(vs + j * BK * SW, &tv, j * W, t * BK, h, b, bar);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
    if constexpr (T::WGS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % kWG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + wg * 64 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
    // with a bias the logits stay in natural units (NEG_INF * log2(e) would
    // overflow); without one they are in log2 units
    const float unit = HAS_BIAS ? kLog2e : 1.f;
    const float xscale = HAS_BIAS ? p.scale : p.scale * kLog2e;
    const float* bias = HAS_BIAS ? p.bias + static_cast<long long>(b) * p.Nk : nullptr;

    // S accumulator element i: row r0 + 8 ((i >> 1) & 1), column 8 (i / 4) + 2 t4 + (i & 1)
    float sacc[BK / 2], oacc[DP / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // per-thread partial row sums (quad-reduced at the end)

    mbar_wait(qbar, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages, kb = t * BK;
      const uint32_t ks = skv + 2 * s * T::KV_BYTES, vs = ks + T::KV_BYTES;
      mbar_wait(full0 + 8 * s, (t / kStages) & 1);

      // S = Q K^T: both K-major; a 16-deep step inside a swizzle row is a
      // 32-byte start offset, the next column block the next stretch
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = kk * 16;
        const uint64_t da =
            smem_desc(sq + (c / W) * T::BQ * SW + wg * 64 * SW + (c % W) * 2, 16, 8 * SW, T::kLayout);
        const uint64_t db = smem_desc(ks + (c / W) * BK * SW + (c % W) * 2, 16, 8 * SW, T::kLayout);
        wgmma_ss(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      keep(sacc);

      const bool ragged = kb + BK > p.Nk;
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = kb + (i / 4) * 8 + t4 * 2 + (i & 1);
        float x;
        if constexpr (HAS_BIAS)
          x = fmaf(sacc[i], xscale, col < p.Nk ? __ldg(bias + col) : 0.f);
        else
          x = sacc[i] * xscale;
        if (ragged && col >= p.Nk) x = -INFINITY;
        sacc[i] = x;
        mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], x);
      }
      float alpha[2], msafe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float mn = fmaxf(m[r], mt[r]);
        msafe[r] = mn == -INFINITY ? 0.f : mn;
        alpha[r] = ex2((m[r] - msafe[r]) * unit);
        m[r] = mn;
        l[r] *= alpha[r];
      }
      // P, rounded to bf16: n-tiles 2j and 2j + 1 of S are the A fragment
      // of the j-th 16-key step of P V
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 8 * j + 4 * half;
          const float p0 = ex2((sacc[i] - msafe[0]) * unit), p1 = ex2((sacc[i + 1] - msafe[0]) * unit);
          const float p2 = ex2((sacc[i + 2] - msafe[1]) * unit), p3 = ex2((sacc[i + 3] - msafe[1]) * unit);
          l[0] += p0 + p1;
          l[1] += p2 + p3;
          pa[j][2 * half] = pack_bf16(p0, p1);
          pa[j][2 * half + 1] = pack_bf16(p2, p3);
        }
      }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        oacc[4 * n] *= alpha[0];
        oacc[4 * n + 1] *= alpha[0];
        oacc[4 * n + 2] *= alpha[1];
        oacc[4 * n + 3] *= alpha[1];
      }

      // O += P V: V is MN-major (d contiguous); a 16-key step is 16 rows of
      // the tile, the next column block of d is LBO away
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_rs(oacc, pa[j], smem_desc(vs + j * 16 * SW, BK * SW, 8 * SW, T::kLayout));
      wgmma_commit();
      wgmma_wait_all();
      keep(oacc);
      keep(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
    }
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= p.Nq) continue;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int c = n * 8 + t4 * 2;
        if (c < p.D)
          *reinterpret_cast<uint32_t*>(op + row * p.o_sn + c) =
              pack_bf16(oacc[4 * n + 2 * r] * inv[r], oacc[4 * n + 2 * r + 1] * inv[r]);
      }
      if constexpr (WANT_LSE) {
        if (t4 == 0) {
          const float lg = fmaxf(l[r], 1e-37f);
          p.lse[(static_cast<long long>(b) * p.H + h) * p.Nq + row] =
              HAS_BIAS ? m[r] + logf(lg) : (m[r] + log2f(lg)) * kLn2;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: exact products on the CUDA cores, one thread per query row

constexpr int kSQ = 64;  // query rows (threads) per block
constexpr int kSK = 32;  // keys per shared-memory tile

template <int DP, bool HAS_BIAS, bool WANT_LSE>
__global__ void __launch_bounds__(kSQ) flash_fwd_f32(Params p) {
  // Loops stay rolled: this path checks numerics in f32 and is not on the
  // bf16 main path, and full unrolling over DP x kSK multiplies build time.
  __shared__ float ks[kSK][DP];
  __shared__ float vs[kSK][DP];
  __shared__ float bs[kSK];

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int row = blockIdx.x * kSQ + threadIdx.x;
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  float q[DP], acc[DP], s[kSK];
  for (int d = 0; d < DP; ++d) {
    q[d] = row < p.Nq && d < p.D ? qp[row * p.q_sn + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int kb = 0; kb < p.Nk; kb += kSK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kSK * DP; i += kSQ) {
      const int r = i / DP, c = i % DP;
      const bool in = kb + r < p.Nk && c < p.D;
      ks[r][c] = in ? kp[(kb + r) * p.k_sn + c] : 0.f;
      vs[r][c] = in ? vp[(kb + r) * p.v_sn + c] : 0.f;
    }
    if constexpr (HAS_BIAS) {
      for (int i = threadIdx.x; i < kSK; i += kSQ)
        bs[i] = kb + i < p.Nk ? p.bias[b * p.Nk + kb + i] : 0.f;
    }
    __syncthreads();

    float mt = -INFINITY;
    for (int j = 0; j < kSK; ++j) {
      float x = 0.f;
      for (int d = 0; d < DP; ++d) x = fmaf(q[d], ks[j][d], x);
      x *= p.scale;
      if constexpr (HAS_BIAS) x += bs[j];
      if (kb + j >= p.Nk) x = -INFINITY;
      s[j] = x;
      mt = fmaxf(mt, x);
    }
    const float mn = fmaxf(m, mt);
    const float msafe = mn == -INFINITY ? 0.f : mn;
    const float alpha = expf(m - msafe);
    m = mn;
    l *= alpha;
    for (int d = 0; d < DP; ++d) acc[d] *= alpha;
    for (int j = 0; j < kSK; ++j) {
      const float pj = expf(s[j] - msafe);
      l += pj;
      for (int d = 0; d < DP; ++d) acc[d] = fmaf(pj, vs[j][d], acc[d]);
    }
  }

  if (row >= p.Nq) return;
  const float inv = l == 0.f ? 0.f : 1.f / l;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_sn;
  for (int d = 0; d < p.D; ++d) op[d] = acc[d] * inv;
  if constexpr (WANT_LSE)
    p.lse[(static_cast<long long>(b) * p.H + h) * p.Nq + row] =
        m + logf(fmaxf(l, 1e-37f));
}

// ---------------------------------------------------------------------------
// dispatch

template <int DP, bool HAS_BIAS, bool WANT_LSE>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  using T = Tile<DP>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, p.B, p.H, p.Nq, p.D, p.q_sb, p.q_sh, p.q_sn, T::W, T::BQ) ||
      !make_map(&tk, p.k, p.B, p.H, p.Nk, p.D, p.k_sb, p.k_sh, p.k_sn, T::W, T::BK) ||
      !make_map(&tv, p.v, p.B, p.H, p.Nk, p.D, p.v_sb, p.v_sh, p.v_sn, T::W, T::BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_bf16<DP, HAS_BIAS, WANT_LSE>;
  static bool sized = false;  // dynamic shared memory above 48 KB is opted into once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid((p.Nq + T::BQ - 1) / T::BQ, p.B * p.H);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(tq, tk, tv, p);
  return cudaSuccess;
}

template <int DP, bool HAS_BIAS, bool WANT_LSE>
cudaError_t launch(const Params& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch_bf16<DP, HAS_BIAS, WANT_LSE>(p, stream);
  dim3 grid((p.Nq + kSQ - 1) / kSQ, p.B * p.H);
  flash_fwd_f32<DP, HAS_BIAS, WANT_LSE><<<grid, kSQ, 0, stream>>>(p);
  return cudaSuccess;
}

template <int DP>
cudaError_t launch_dp(const Params& p, int is_bf16, cudaStream_t stream) {
  const bool has_bias = p.bias != nullptr, want_lse = p.lse != nullptr;
  if (has_bias && want_lse) return launch<DP, true, true>(p, is_bf16, stream);
  if (has_bias) return launch<DP, true, false>(p, is_bf16, stream);
  if (want_lse) return launch<DP, false, true>(p, is_bf16, stream);
  return launch<DP, false, false>(p, is_bf16, stream);
}

}  // namespace

extern "C" {

// Head dims the kernel is built for, padded to a multiple of 16:
// 16/32 (test shapes), 48 (SD1.5 d=40), 64 (SD2.1/SDXL), 80, 160 (SD1.5).
int flash_fwd_supports(int d) {
  const int dp = (d + 15) / 16 * 16;
  return d % 8 == 0 && (dp == 16 || dp == 32 || dp == 48 || dp == 64 ||
                        dp == 80 || dp == 160);
}

// Dynamic shared memory of one bf16 block at head dim d (supported d only).
int flash_fwd_smem_bytes(int d) {
  switch ((d + 15) / 16 * 16) {
    case 16: return Tile<16>::SMEM;
    case 32: return Tile<32>::SMEM;
    case 48: return Tile<48>::SMEM;
    case 64: return Tile<64>::SMEM;
    case 80: return Tile<80>::SMEM;
    default: return Tile<160>::SMEM;
  }
}

// Launches on `stream` and returns the CUDA error code: 1
// (cudaErrorInvalidValue) for an unsupported head dim or operands that no
// tensor map can describe, else cudaGetLastError(). All strides are in
// elements; the head dim is contiguous.
int flash_fwd(const void* q, const void* k, const void* v, const float* bias,
              void* o, float* lse, int B, int H, int Nq, int Nk, int D,
              long long q_sb, long long q_sh, long long q_sn, long long k_sb,
              long long k_sh, long long k_sn, long long v_sb, long long v_sh,
              long long v_sn, long long o_sb, long long o_sh, long long o_sn,
              float scale, int is_bf16, void* stream) {
  if (!flash_fwd_supports(D)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    bias, o,    lse,  B,    H,    Nq,   Nk,   D,
           q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh,
           o_sn, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((D + 15) / 16 * 16) {
    case 16: err = launch_dp<16>(p, is_bf16, s); break;
    case 32: err = launch_dp<32>(p, is_bf16, s); break;
    case 48: err = launch_dp<48>(p, is_bf16, s); break;
    case 64: err = launch_dp<64>(p, is_bf16, s); break;
    case 80: err = launch_dp<80>(p, is_bf16, s); break;
    default: err = launch_dp<160>(p, is_bf16, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
