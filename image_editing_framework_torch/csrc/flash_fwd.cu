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
// bf16 inputs: bf16 products with f32 accumulation (mma.sync), and the
// unnormalised probabilities are rounded to bf16 before P.V, as the TPU
// kernel does (flash_attention.py:118-121). f32 inputs: true f32 products on
// the CUDA cores (never TF32). Keys at or beyond Nk do not exist for the
// softmax. A row whose every key has a -inf logit has l == 0 and returns 0.
// NEG_INF (-0.7 * f32 max) is a finite logit: a row masked by it everywhere
// gets equal weights, as softmax gives.
//
// What bounds it on the card: at the SD1.5 4096-token sites (batch 4, 8
// heads, d=40) one call does ~86 GFLOP against ~42 MB of Q/K/V/O traffic in
// bf16, ~2000 FLOP per byte, far above the H100's ~295 FLOP/byte ridge: the
// kernel is bound by tensor-core operations. The design keeps the (N, N)
// score matrix out of device memory (registers only), keeps each block's Q
// fragments in registers for the whole key loop and stages K/V tiles in
// shared memory once per 64 queries, so device-memory traffic stays near the
// one-read-per-input bound. It uses mma.sync m16n8k16 (the simple route);
// wgmma, TMA and warp specialisation, which reach the card's full tensor
// rate, are left for a later change.

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
// bf16: tensor cores through mma.sync.m16n8k16

constexpr int kBQ = 64;  // query rows per block: 4 warps x 16 rows
constexpr int kBK = 64;  // keys per shared-memory tile
constexpr int kThreads = 128;

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

// Two neighbouring bf16 of one row (col even, D even), zero outside.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              long long sn, int row, int col,
                                              int nrows, int d) {
  if (row >= nrows || col >= d) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * sn + col);
}

template <int DP, bool HAS_BIAS, bool WANT_LSE>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Params p) {
  constexpr int LDS = DP + 8;  // padded row: conflict-free fragment reads
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = kBK / 8;  // score n-tiles per warp
  constexpr int DT = DP / 8;   // output n-tiles per warp
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * LDS];
  __shared__ float bs[kBK];

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kBQ + warp * 16 + g;  // rows r0 and r0 + 8
  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const int c = s * 16 + t * 2;
    qf[s][0] = load_pair(qp, p.q_sn, r0, c, p.Nq, p.D);
    qf[s][1] = load_pair(qp, p.q_sn, r0 + 8, c, p.Nq, p.D);
    qf[s][2] = load_pair(qp, p.q_sn, r0, c + 8, p.Nq, p.D);
    qf[s][3] = load_pair(qp, p.q_sn, r0 + 8, c + 8, p.Nq, p.D);
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums (quad-reduced at the end)

  for (int kb = 0; kb < p.Nk; kb += kBK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kBK * CHUNKS; i += kThreads) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (kb + r < p.Nk && c < p.D) {
        kv = *reinterpret_cast<const uint4*>(kp + (kb + r) * p.k_sn + c);
        vv = *reinterpret_cast<const uint4*>(vp + (kb + r) * p.v_sn + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * LDS + c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r * LDS + c]) = vv;
    }
    if constexpr (HAS_BIAS) {
      for (int i = threadIdx.x; i < kBK; i += kThreads)
        bs[i] = kb + i < p.Nk ? p.bias[b * p.Nk + kb + i] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = &ks[(n * 8 + g) * LDS + t * 2];
#pragma unroll
      for (int st = 0; st < KSTEPS; ++st) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + st * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + st * 16 + 8);
        mma_bf16(s[n], qf[st], b0, b1);
      }
    }

    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + t * 2 + (e & 1);
        float x = s[n][e] * p.scale;
        if constexpr (HAS_BIAS) x += bs[col];
        if (kb + col >= p.Nk) x = -INFINITY;
        s[n][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float alpha[2], msafe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);
      msafe[r] = mn == -INFINITY ? 0.f : mn;
      alpha[r] = exp2f((m[r] - msafe[r]) * kLog2e);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f((s[n][e] - msafe[e >> 1]) * kLog2e);
        l[e >> 1] += pe;
        s[n][e] = pe;
      }
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V; the score accumulators of n-tiles 2j, 2j+1 are exactly the
    // A fragment of k-step j. P is rounded to bf16 here.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const __nv_bfloat16* v0 = &vs[(j * 16 + t * 2) * LDS + g];
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const __nv_bfloat16* vc = v0 + d * 8;
        const uint32_t b0 = pack_raw(vc[0], vc[LDS]);
        const uint32_t b1 = pack_raw(vc[8 * LDS], vc[9 * LDS]);
        mma_bf16(acc[d], a, b0, b1);
      }
    }
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
    for (int d = 0; d < DT; ++d) {
      const int c = d * 8 + t * 2;
      if (c < p.D) {
        *reinterpret_cast<uint32_t*>(op + row * p.o_sn + c) =
            pack_bf16(acc[d][2 * r] * inv[r], acc[d][2 * r + 1] * inv[r]);
      }
    }
    if constexpr (WANT_LSE) {
      if (t == 0)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Nq + row] =
            m[r] + logf(fmaxf(l[r], 1e-37f));
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
void launch(const Params& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    dim3 grid((p.Nq + kBQ - 1) / kBQ, p.B * p.H);
    flash_fwd_bf16<DP, HAS_BIAS, WANT_LSE><<<grid, kThreads, 0, stream>>>(p);
  } else {
    dim3 grid((p.Nq + kSQ - 1) / kSQ, p.B * p.H);
    flash_fwd_f32<DP, HAS_BIAS, WANT_LSE><<<grid, kSQ, 0, stream>>>(p);
  }
}

template <int DP>
void launch_dp(const Params& p, int is_bf16, cudaStream_t stream) {
  const bool has_bias = p.bias != nullptr, want_lse = p.lse != nullptr;
  if (has_bias && want_lse) launch<DP, true, true>(p, is_bf16, stream);
  else if (has_bias) launch<DP, true, false>(p, is_bf16, stream);
  else if (want_lse) launch<DP, false, true>(p, is_bf16, stream);
  else launch<DP, false, false>(p, is_bf16, stream);
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

// Launches on `stream` and returns cudaGetLastError(); 1 (cudaErrorInvalidValue)
// for an unsupported head dim. All strides are in elements; the head dim is
// contiguous.
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
  switch ((D + 15) / 16 * 16) {
    case 16: launch_dp<16>(p, is_bf16, s); break;
    case 32: launch_dp<32>(p, is_bf16, s); break;
    case 48: launch_dp<48>(p, is_bf16, s); break;
    case 64: launch_dp<64>(p, is_bf16, s); break;
    case 80: launch_dp<80>(p, is_bf16, s); break;
    default: launch_dp<160>(p, is_bf16, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
