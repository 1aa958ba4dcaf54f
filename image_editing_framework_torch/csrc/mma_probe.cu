// Tile-shape probe for Hopper (sm_90a), bound to PyTorch through a plain C
// entry point (ctypes): what the two attention products cost on the tensor
// cores through mma.sync.m16n8k16, per operand layout in shared memory.
//
// Replaces the TPU Pallas kernel
//   tools/bench_attn_layouts.py:57 _probe_kernel  (launched by _probe:83)
// which computes, for bf16 operands a and b and a contraction of one dim of
// each,
//
//   acc = sum_{i < iters} sum(dot(a_i, b_i)),      f32 accumulation,
//
// where the smaller operand (a on a tie) is rescaled every iteration,
// x_i = bf16(f32(x) * (1 + 1e-9 * i)), so that no iteration's product can be
// hoisted out of the loop, and the running sum keeps every product live.
//
// Here every block computes the whole of acc on its own and writes it to
// out[blockIdx.x], so a launch of one block per SM times the card at load.
// The TPU kernel holds both operands and the 512 x 512 f32 product in VMEM;
// one SM holds neither (the product is 1 MB, the operands up to 640 KB), so
// the block keeps the rescaled smaller operand resident in shared memory,
// streams the other one through a 64-row tile buffer from device memory
// (in practice the L2: every block reads the same few hundred KB), and sums
// each 16 x UN piece of the product as soon as its k loop ends. The rounding
// points are the TPU kernel's: the scale is f32 arithmetic on an int32 i, the
// rescaled operand is rounded to bf16 once per iteration, products run on
// the tensor cores with f32 accumulation. The order of the f32 sum is the
// kernel's own: each thread keeps a running sum over its accumulator
// fragments, and the block adds the threads' sums at the end.
//
// Layouts: an operand whose contraction dim is contiguous in shared memory
// feeds ldmatrix as it lies; one whose contraction dim is strided feeds
// ldmatrix.trans. The lhs is always the mma's A operand (16 rows), the rhs
// its B operand (8 columns), as in the flash kernels (Q.K^T, P.V and the
// backward's transposed products).
//
// What bounds it: 2*M*N*K operations per iteration and block on data that
// never leaves the chip, so the bound is the bf16 tensor peak divided among
// the SMs. The reading includes the shared-memory fragment loads, the
// rescale and the tile copies, which is what a flash kernel pays around
// its mma instructions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;  // rows of the streamed operand per tile
constexpr int kPad = 8;        // bf16 of padding per shared-memory row
constexpr int kMaxSmem = 232448;

struct Params {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  float* out;
  int M, N, K;     // the product's extents: out[m, n] = sum_k A(m, k) B(n, k)
  int Mp, Np, Kp;  // padded: K and the resident rows to 16, streamed rows to 64
  int iters;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Address this lane gives ldmatrix.x4 for the A fragment of rows m0..m0+15,
// k0..k0+15. Stored [m][k] (TRANS = false) the four 8x8 matrices are (m, k),
// (m+8, k), (m, k+8), (m+8, k+8); stored [k][m] the same four, read through
// ldmatrix.trans.
template <bool TRANS>
__device__ __forceinline__ uint32_t a_frag_addr(const __nv_bfloat16* s, int ld,
                                                int m0, int k0, int lane) {
  const int mat = lane >> 3, r = lane & 7;
  const int m = m0 + (mat & 1) * 8, k = k0 + (mat >> 1) * 8;
  return TRANS ? smem_u32(s + (k + r) * ld + m) : smem_u32(s + (m + r) * ld + k);
}

// The same for the B fragments of two n-tiles, n0..n0+15: registers 0, 1 are
// the first tile's (k, k+8), registers 2, 3 the second's.
template <bool TRANS>
__device__ __forceinline__ uint32_t b_frag_addr(const __nv_bfloat16* s, int ld,
                                                int n0, int k0, int lane) {
  const int mat = lane >> 3, r = lane & 7;
  const int n = n0 + (mat >> 1) * 8, k = k0 + (mat & 1) * 8;
  return TRANS ? smem_u32(s + (k + r) * ld + n) : smem_u32(s + (n + r) * ld + k);
}

// Copy rows row0.. and columns col0.. of a row-major (rows x cols) array into
// shared memory in 16-byte chunks, zero beyond the array. SCALED: each value
// goes through f32, times scale, and back to bf16.
template <bool SCALED>
__device__ __forceinline__ void load_rect(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, int rows,
                                          int cols, int row0, int nrows,
                                          int col0, int ncols, float scale) {
  const int chunks = ncols / 8;
  for (int i = threadIdx.x; i < nrows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows && col0 + c < cols) {
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * cols + col0 + c);
      if constexpr (SCALED) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          h[j] = __floats2bfloat162_rn(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// A_TRANS / B_TRANS: the operand is stored [k][rows] (contraction dim
// strided) rather than [rows][k]. A_RES: the lhs is the resident (smaller,
// rescaled) operand and the rhs is streamed; else the other way round. UN:
// columns of the product one warp accumulates at a time (16 or 32).
template <bool A_TRANS, bool B_TRANS, bool A_RES, int UN>
__global__ void __launch_bounds__(kThreads) mma_probe_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool R_TRANS = A_RES ? A_TRANS : B_TRANS;
  constexpr bool T_TRANS = A_RES ? B_TRANS : A_TRANS;
  const __nv_bfloat16* rsrc = A_RES ? p.a : p.b;
  const __nv_bfloat16* tsrc = A_RES ? p.b : p.a;
  const int r_rows = A_RES ? p.M : p.N, r_rows_p = A_RES ? p.Mp : p.Np;
  const int t_rows = A_RES ? p.N : p.M, t_rows_p = A_RES ? p.Np : p.Mp;
  // shared-memory row strides, in elements
  const int r_ld = (R_TRANS ? r_rows_p : p.Kp) + kPad;
  const int t_ld = (T_TRANS ? kTileRows : p.Kp) + kPad;
  __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ts = rs + (R_TRANS ? p.Kp : r_rows_p) * r_ld;
  const __nv_bfloat16* as = A_RES ? rs : ts;
  const __nv_bfloat16* bs = A_RES ? ts : rs;
  const int a_ld = A_RES ? r_ld : t_ld, b_ld = A_RES ? t_ld : r_ld;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // pieces of the product per streamed tile: 16 rows x UN columns each
  const int n_groups = (A_RES ? kTileRows : p.Np) / UN;
  const int units = (A_RES ? p.Mp : kTileRows) / 16 * n_groups;
  float sum = 0.f;

  for (int it = 0; it < p.iters; ++it) {
    // 1 + 1e-9 * i in f32, two roundings (no fused multiply-add)
    const float scale = __fadd_rn(1.0f, __fmul_rn(1e-9f, static_cast<float>(it)));
    __syncthreads();  // the last iteration's reads of the resident operand are over
    if (R_TRANS)
      load_rect<true>(rs, r_ld, rsrc, p.K, r_rows, 0, p.Kp, 0, r_rows_p, scale);
    else
      load_rect<true>(rs, r_ld, rsrc, r_rows, p.K, 0, r_rows_p, 0, p.Kp, scale);

    for (int t0 = 0; t0 < t_rows_p; t0 += kTileRows) {
      __syncthreads();  // the previous tile is no longer read
      if (T_TRANS)
        load_rect<false>(ts, t_ld, tsrc, p.K, t_rows, 0, p.Kp, t0, kTileRows, 1.f);
      else
        load_rect<false>(ts, t_ld, tsrc, t_rows, p.K, t0, kTileRows, 0, p.Kp, 1.f);
      __syncthreads();

      for (int u = warp; u < units; u += kWarps) {
        const int m0 = (u / n_groups) * 16, n0 = (u % n_groups) * UN;
        float acc[UN / 8][4];
#pragma unroll
        for (int n = 0; n < UN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        for (int k0 = 0; k0 < p.Kp; k0 += 16) {
          uint32_t af[4];
          ldmatrix_x4<A_TRANS>(af, a_frag_addr<A_TRANS>(as, a_ld, m0, k0, lane));
#pragma unroll
          for (int np = 0; np < UN / 16; ++np) {
            uint32_t bf[4];
            ldmatrix_x4<B_TRANS>(bf, b_frag_addr<B_TRANS>(bs, b_ld, n0 + np * 16, k0, lane));
            mma_bf16(acc[2 * np], af, bf[0], bf[1]);
            mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < UN / 8; ++n) sum += (acc[n][0] + acc[n][1]) + (acc[n][2] + acc[n][3]);
      }
    }
  }

  __shared__ float warp_sums[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    p.out[blockIdx.x] = total;
  }
}

template <bool A_TRANS, bool B_TRANS, bool A_RES, int UN>
cudaError_t launch(const Params& p, int blocks, size_t smem, cudaStream_t stream) {
  auto kernel = mma_probe_kernel<A_TRANS, B_TRANS, A_RES, UN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int round_up(int x, int to) { return (x + to - 1) / to * to; }

}  // namespace

extern "C" {

// out[blk] = sum_{i < iters} sum_{m, n} sum_k A_i(m, k) B_i(n, k) for every
// blk < blocks. a is stored (M, K) row-major, or (K, M) with a_trans; b is
// stored (N, K), or (K, N) with b_trans. The operand with fewer rows (a on a
// tie) is the one rescaled. Supported: both plain, both transposed, or a
// plain with b transposed and N < M; the streamed operand's rows a multiple
// of 64; M, N, K multiples of 8. Launches on `stream` and returns
// cudaGetLastError(); 1 (cudaErrorInvalidValue) for anything unsupported.
int mma_probe(const void* a, const void* b, float* out, int a_trans, int b_trans,
              int M, int N, int K, int iters, int blocks, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0 || K <= 0 || M % 8 || N % 8 || K % 8 || iters < 0 || blocks <= 0)
    return invalid;
  const bool a_res = M <= N;
  if ((a_res ? N : M) % kTileRows) return invalid;
  const int Kp = round_up(K, 16);
  Params p{static_cast<const __nv_bfloat16*>(a),
           static_cast<const __nv_bfloat16*>(b),
           out, M, N, K,
           a_res ? round_up(M, 16) : M, a_res ? N : round_up(N, 16), Kp, iters};
  const bool r_trans = a_res ? a_trans : b_trans, t_trans = a_res ? b_trans : a_trans;
  const int r_rows_p = a_res ? p.Mp : p.Np;
  const size_t r_elems = r_trans ? static_cast<size_t>(Kp) * (r_rows_p + kPad)
                                 : static_cast<size_t>(r_rows_p) * (Kp + kPad);
  const size_t t_elems = t_trans ? static_cast<size_t>(Kp) * (kTileRows + kPad)
                                 : static_cast<size_t>(kTileRows) * (Kp + kPad);
  const size_t smem = (r_elems + t_elems) * sizeof(__nv_bfloat16);
  if (smem > kMaxSmem) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!a_trans && !b_trans && a_res) err = launch<false, false, true, 32>(p, blocks, smem, s);
  else if (a_trans && b_trans && a_res) err = launch<true, true, true, 32>(p, blocks, smem, s);
  else if (!a_trans && b_trans && !a_res && p.Np % 32 == 0) err = launch<false, true, false, 32>(p, blocks, smem, s);
  else if (!a_trans && b_trans && !a_res) err = launch<false, true, false, 16>(p, blocks, smem, s);
  else return invalid;
  return static_cast<int>(err);
}

}  // extern "C"
