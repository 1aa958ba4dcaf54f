// Tile-shape probe for Hopper (sm_90a), bound to PyTorch through a plain C
// entry point (ctypes): what the two attention products cost on the tensor
// cores through wgmma on TMA-fed shared-memory tiles, per operand layout.
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
// Every block computes the whole of acc on its own and writes it to
// out[blockIdx.x], so a launch of one block per SM times the card at load.
// The rounding points are the TPU kernel's: the scale is f32 arithmetic on an
// int32 i with no fused multiply-add, the rescaled operand is rounded to bf16
// once per iteration, products run on the tensor cores with f32
// accumulation. The order of the f32 sum is the kernel's own.
//
// What bounds it: 2*M*N*K operations per iteration and block on data that
// stays on the chip, so the bound is the bf16 tensor peak divided among the
// SMs. The design keeps the tensor cores fed and takes the rescale and the
// copies off their critical path:
//   * Every layout is one wgmma form, out[m, n] = sum_k A(m, k) B(n, k)
//     with both operands in shared memory (SS). An operand whose
//     contraction dim is contiguous in memory is K-major, one whose
//     contraction dim is strided is MN-major (the transpose bit); nothing is
//     transposed on the way in.
//   * Two plans (probe_plan on the host, mirrored by the tool's
//     bench_attn_layouts.plan):
//       S  (the scores, K small): the unscaled operand b is B, resident in
//          shared memory for the whole launch; the rescaled a is A and
//          streams in 64-row chunks through a 4-slot ring. Each chunk is
//          multiplied by all of B in 128-column pieces summed into one
//          accumulator.
//       PV (the weighted sum, K = 512): the unscaled operand (P) is A and
//          streams in 64-deep K chunks, all its rows per chunk (64 KB); the
//          rescaled one (V or V^T) is B, its matching 64 rows of K in the
//          same slot; 2-3 slots. When both are stored plain (pv_sub:
//          a = V^T, b = P), the sum of the transposed product is taken
//          (A = b, B = a), so that the 64-row side is P's 512 and not d.
//     Every tile is as TMA writes it with the 128-byte swizzle, in blocks
//     64 bf16 wide. The tiles start zeroed and TMA's boxes cover only the
//     arrays where they are narrower than a box (40 wide at d = 40), so K =
//     40 reads as 48 with zeros and no copy of the tool's 12 cases pays for
//     TMA's zero fill (on V's 40 columns it had made pv_lane at d = 40 29%
//     slower).
//   * Warp specialisation: one producer warp issues every TMA copy (B
//     resident, and per slot the rescaled operand's original values and
//     P's chunk, each on an mbarrier of its own); one rescale warpgroup
//     scales and rounds each slot's rescaled piece in place once it has
//     landed, while two consumer warpgroups run wgmma on the slots before
//     it. A consumer sums its accumulator into a running f32 sum after every
//     slot (any split of the sum is legal: only the total is kept) and
//     frees the slot.
//   * No accumulator outlives a slot: every role fits the 128 registers a
//     thread has at 512 threads, and no setmaxnreg is needed.
// Not done: thread-block clusters with TMA multicast of P's chunks in the PV
// plan (every SM reads all of P from the L2 every iteration: 512 KB, 69 MB
// per iteration across 132 SMs).

#include "hopper.cuh"

namespace {

constexpr int kWG = 128;             // threads per warpgroup
constexpr int kThreads = 4 * kWG;    // consumers 0 and 1, the rescale warpgroup, the producer
constexpr int kChunk = 64;           // S: rows of A per slot; PV: depth of K per slot
constexpr int kPiece = 128;          // S: product columns per wgmma
constexpr int kRingS = 4;            // S: slots in the ring
constexpr int kMaxRingPV = 4;        // PV: at most this many slots
constexpr int kMaxSmem = 232448 - 64;  // dynamic shared memory of one block (the static rest: warp sums)

enum { kS = 0, kPV = 1 };

// How the product is laid onto wgmma; see the header and probe_plan.
struct Plan {
  int cls;      // kS or kPV
  int a_is_b;   // A is the stored b and B the stored a: the transposed product
  int ta, tb;   // A / B MN-major
  int m, n, k;  // out = sum A(m, k) B(n, k)
  int kp;       // K padded: to 16 (S), to kChunk (PV)
  int np;       // B's rows padded: to kPiece (S), to the wgmma width (PV)
  int ring;     // slots
  int smem;     // dynamic shared memory bytes
};

struct Params {
  float* out;
  int iters;
  Plan plan;
  int tx_res, tx_r, tx_u;  // TMA bytes: S's resident B; per step the rescaled piece and PV's A
};

// Every tile is laid out as TMA writes it with the 128-byte swizzle: column
// blocks 64 bf16 wide, each (rows x 64), one 128-byte row per row. A K-major
// tile's blocks run along K (the last partly used where K is not a multiple
// of 64), an MN-major one's along M or N with K as the rows. wgmma reads any
// 16-deep step inside a block (descriptor layout code 1).
__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One box of a rank-2 tensor map at (column c0, row c1) into shared memory;
// completes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

__device__ __forceinline__ uint4 ld_shared(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// D (+)= A B^T from shared memory: m64n32k16; TA / TB: A / B MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

// D (+)= A B^T from shared memory: m64n40k16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[20], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19}, "
      "%20, %21, p, 1, 1, %23, %24;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

// D (+)= A B^T from shared memory: m64n48k16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[24], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

// D (+)= A B^T from shared memory: m64n64k16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

// D (+)= A B^T from shared memory: m64n128k16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB)
      : "memory");
}

// The bf16 values in bytes [lo, lo + bytes) of shared memory, times scale
// and rounded to bf16, in place (the layout, swizzle included, is TMA's and
// stays as it is). Run by the 128 threads of the rescale warpgroup.
__device__ __forceinline__ void rescale_in_place(uint32_t lo, uint32_t bytes, float scale, int tid) {
  constexpr int kBatch = 4;
  for (uint32_t o0 = 16 * tid; o0 < bytes; o0 += 16 * kWG * kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (o0 + 16 * kWG * j < bytes) v[j] = ld_shared(lo + o0 + 16 * kWG * j);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (o0 + 16 * kWG * j >= bytes) break;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        h[e] = __floats2bfloat162_rn(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
      }
      st_shared(lo + o0 + 16 * kWG * j, v[j]);
    }
  }
}

// 1 + 1e-9 * i in f32, two roundings (no fused multiply-add)
__device__ __forceinline__ float iter_scale(int it) {
  return __fadd_rn(1.0f, __fmul_rn(1e-9f, static_cast<float>(it)));
}

template <int N>
__device__ __forceinline__ float sum_acc(const float (&acc)[N]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) s[i % 4] += acc[i];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// CLS: the plan (kS or kPV); TA / TB: A / B MN-major; NP: the wgmma's
// width (kPiece in the S plan, the padded rows of the rescaled B in PV).
// tu: tensor map of the unscaled operand (B in S, A in PV); tr: of the
// rescaled one (A in S, B in PV).
template <int CLS, int TA, int TB, int NP>
__global__ void __launch_bounds__(kThreads, 1)
    mma_probe_kernel(const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap tr,
                     const Params p) {
  const Plan& q = p.plan;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float warp_sums[8];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  // S: B resident at base (np x kp), then the ring of A chunks (64 x kp);
  // PV: the ring at base, each slot A (m x 64) then B (np x 64 K-major, or
  // 64 x np in blocks of 64 MN-major).
  // S: the K extent a tile holds (K-major: whole blocks; MN-major: kp rows)
  const int kw = TA ? q.kp : round_up(q.kp, 64);
  // PV: the rows (K-major) or columns (MN-major, whole blocks) of B
  constexpr int b_rows = TB ? round_up(NP, 64) : NP;
  const uint32_t res_bytes = CLS == kS ? q.np * kw * 2 : 0;
  const uint32_t a_bytes = CLS == kS ? kChunk * kw * 2 : q.m * kChunk * 2;
  const uint32_t b_bytes = CLS == kS ? 0 : b_rows * kChunk * 2;
  const uint32_t slot_bytes = a_bytes + b_bytes;
  const uint32_t rb = base, ring = base + res_bytes;
  // the rescaled piece of a slot: S all of it (A), PV the part after A (B)
  const uint32_t r_off = CLS == kS ? 0 : a_bytes, r_bytes = CLS == kS ? a_bytes : b_bytes;
  // barriers: B resident; per slot the rescaled piece copied (TMA bytes),
  // PV's A copied (TMA bytes), the piece rescaled (the rescale threads), the
  // slot free (one arrival per consumer warp)
  const uint32_t rbar = ring + q.ring * slot_bytes, full0 = rbar + 8, afull0 = full0 + 8 * q.ring,
                 ready0 = afull0 + 8 * q.ring, empty0 = ready0 + 8 * q.ring;
  // S: each 64-row chunk of A is one step, consumed by one warpgroup in
  // turn; PV: each 64-deep K chunk is one step, consumed by both
  const int steps_per_iter = CLS == kS ? (q.m + kChunk - 1) / kChunk : q.kp / kChunk;
  const int steps = p.iters * steps_per_iter;
  // the warpgroup's index, warp-uniform as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0), tid = threadIdx.x % kWG;

  // Every tile starts at zero. TMA's boxes cover only the arrays (where an
  // array is narrower than a box's 64, the box is as narrow), so what a tile
  // holds beyond them (K past 40, B's rows past n) stays zero: zero fill by
  // TMA costs it time in every slot.
  for (uint32_t a = base + 16 * threadIdx.x; a < rbar; a += 16 * kThreads) st_shared(a, make_uint4(0, 0, 0, 0));
  fence_async_shared();
  if (threadIdx.x == 0) {
    mbar_init(rbar, 1);
    for (int s = 0; s < q.ring; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(afull0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kWG);
      mbar_init(empty0 + 8 * s, CLS == kS ? 4 : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 3) {
    // ---- producer: one thread issues every copy (the boxes' sizes are
    // the tensor maps'; p.tx_* count their bytes)
    if (tid != 0) return;
    if (CLS == kS) {
      // B, once: K-major in blocks of (np x 64), or MN-major in blocks of
      // (kp x 64); rows of B from n on are not copied
      mbar_expect_tx(rbar, p.tx_res);
      if (TB == 0) {
        for (int j = 0; j < kw / 64; ++j)
          for (int r = 0; r < q.n; r += 64) tma_load_2d(rb + (j * q.np + r) * 128, &tu, j * 64, r, rbar);
      } else {
        for (int j = 0; j < q.n / 64; ++j) tma_load_2d(rb + j * q.kp * 128, &tu, j * 64, 0, rbar);
      }
    }
    for (int g = 0; g < steps; ++g) {
      const int s = g % q.ring, j = g % steps_per_iter;
      if (g >= q.ring) mbar_wait(empty0 + 8 * s, (g / q.ring - 1) & 1);
      const uint32_t slot = ring + s * slot_bytes, bar = full0 + 8 * s, abar = afull0 + 8 * s;
      mbar_expect_tx(bar, p.tx_r);
      if (CLS == kS) {
        // the original rows j*64.. of A (K-major: a box per 64 of K) or its
        // columns j*64.. (MN-major: one box of kp x 64)
        if (TA == 0) {
          for (int c = 0; c < kw / 64; ++c) tma_load_2d(slot + c * kChunk * 128, &tr, c * 64, j * kChunk, bar);
        } else {
          tma_load_2d(slot, &tr, j * kChunk, 0, bar);
        }
      } else {
        // B's original rows of the 64-deep K chunk first (K-major: one box
        // of np x 64; MN-major: a box per 64 of np), so that its rescale
        // overlaps A's copy; then A's chunk, all m rows
        if (TB == 0) {
          tma_load_2d(slot + a_bytes, &tr, j * kChunk, 0, bar);
        } else {
          for (int c = 0; c < b_rows / 64; ++c)
            tma_load_2d(slot + a_bytes + c * kChunk * 128, &tr, c * 64, j * kChunk, bar);
        }
        mbar_expect_tx(abar, p.tx_u);
        for (int r = 0; r < q.m; r += 64) tma_load_2d(slot + r * 128, &tu, j * kChunk, r, abar);
      }
    }
  } else if (wg == 2) {
    // ---- rescale warpgroup: each step's rescaled piece, in place
    for (int g = 0; g < steps; ++g) {
      const int s = g % q.ring;
      const uint32_t slot = ring + s * slot_bytes;
      mbar_wait(full0 + 8 * s, (g / q.ring) & 1);
      rescale_in_place(slot + r_off, r_bytes, iter_scale(g / steps_per_iter), tid);
      fence_async_shared();  // the writes, visible to the tensor cores' reads
      mbar_arrive(ready0 + 8 * s);
    }
  } else {
    // ---- consumers
    const int warp = tid / 32, lane = tid % 32;
    // each step's first wgmma starts the accumulator (scale-d 0): it is
    // never written by other instructions, which would serialise the wgmmas
    float acc[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
    float sum = 0.f;

    if (CLS == kS) {
      mbar_wait(rbar, 0);
      for (int g = wg; g < steps; g += 2) {
        const int s = g % q.ring;
        const uint32_t slot = ring + s * slot_bytes;
        mbar_wait(ready0 + 8 * s, (g / q.ring) & 1);
        wgmma_fence();
        for (int piece = 0; piece < q.np / kPiece; ++piece) {
          for (int kk = 0; kk < q.kp / 16; ++kk) {
            const int c = kk * 16;
            const uint64_t da = TA == 0 ? smem_desc(slot + (c / 64) * kChunk * 128 + (c % 64) * 2, 16, 1024, 1)
                                        : smem_desc(slot + c * 128, q.kp * 128, 1024, 1);
            const uint64_t db =
                TB == 0 ? smem_desc(rb + ((c / 64) * q.np + piece * kPiece) * 128 + (c % 64) * 2, 16, 1024, 1)
                        : smem_desc(rb + 2 * piece * q.kp * 128 + c * 128, q.kp * 128, 1024, 1);
            wgmma<TA, TB>(acc, da, db, piece > 0 || kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        keep(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
        sum += sum_acc(acc);
      }
    } else {
      for (int g = 0; g < steps; ++g) {
        const int s = g % q.ring;
        const uint32_t slot = ring + s * slot_bytes;
        mbar_wait(afull0 + 8 * s, (g / q.ring) & 1);
        mbar_wait(ready0 + 8 * s, (g / q.ring) & 1);
        wgmma_fence();
        int first = 1;
        for (int t = wg; t < q.m / 64; t += 2) {
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk) {
            const uint64_t da = smem_desc(slot + t * 64 * 128 + kk * 32, 16, 1024, 1);
            const uint64_t db = TB == 0 ? smem_desc(slot + a_bytes + kk * 32, 16, 1024, 1)
                                        : smem_desc(slot + a_bytes + kk * 16 * 128, kChunk * 128, 1024, 1);
            wgmma<0, TB>(acc, da, db, !first);
            first = 0;
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        keep(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
        if (!first) sum += sum_acc(acc);
      }
    }

#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) warp_sums[wg * 4 + warp] = sum;
    consumers_sync();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int i = 0; i < 8; ++i) total += warp_sums[i];
      p.out[blockIdx.x] = total;
    }
  }
}

// The PV plan's wgmma width for a B of n rows: the smallest of the
// kernel's instantiations that holds them; 0 if none.
int pv_width(int n) {
  const int widths[5] = {32, 40, 48, 64, 128};
  for (int w : widths)
    if (w >= n) return w;
  return 0;
}

// Bytes of shared memory for the barriers: rbar, then full, afull, ready and
// empty per slot.
int barrier_bytes(int ring) { return 8 * (1 + 4 * ring); }

// The plan for a probe of a (M, K) [or (K, M) with a_trans] and b (N, K)
// [or (K, N)]; false for what the kernel does not take.
bool probe_plan(int a_trans, int b_trans, int M, int N, int K, Plan* out) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 8 || N % 8 || K % 8) return false;
  const bool a_res = M <= N;  // a is the rescaled operand
  if ((a_res ? N : M) % 64) return false;
  Plan q{};
  if (a_trans == b_trans) {
    if (!a_res) return false;
    // S: a (rescaled) is A in 64-row chunks, b is B, resident
    q = Plan{kS, 0, a_trans, b_trans, M, N, K, round_up(K, 16), round_up(N, kPiece), kRingS, 0};
    const int kw = a_trans ? q.kp : round_up(q.kp, 64);
    q.smem = 1024 + q.np * kw * 2 + q.ring * kChunk * kw * 2 + barrier_bytes(q.ring);
    if (q.smem <= kMaxSmem && q.kp <= 256) {
      *out = q;
      return true;
    }
    if (a_trans) return false;
    // PV, the transposed product: b (unscaled) is A, a (rescaled) is B, both K-major
    q = Plan{kPV, 1, 0, 0, N, M, K, round_up(K, kChunk), pv_width(M), 0, 0};
  } else {
    if (a_trans || a_res) return false;
    // PV: a (unscaled) is A, K-major; b (rescaled) is B, MN-major
    q = Plan{kPV, 0, 0, 1, M, N, K, round_up(K, kChunk), pv_width(N), 0, 0};
  }
  if (q.np == 0) return false;
  const int slot = (q.m + (q.tb ? round_up(q.np, 64) : q.np)) * kChunk * 2;
  q.ring = (kMaxSmem - 1024 - barrier_bytes(kMaxRingPV)) / slot;
  if (q.ring > kMaxRingPV) q.ring = kMaxRingPV;
  if (q.ring < 2) return false;
  q.smem = 1024 + q.ring * slot + barrier_bytes(q.ring);
  *out = q;
  return true;
}

// A rank-2 map over a row-major (rows, cols) bf16 array with the 128-byte
// swizzle, boxes min(64, cols) wide and min(box_rows, rows) high, so that a
// box reaches past the array only where the array is ragged; *box_bytes:
// the bytes one box delivers.
bool make_map_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, int* box_bytes) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint32_t bc = cols < 64 ? cols : 64, br = rows < box_rows ? rows : box_rows;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {bc, br};
  const cuuint32_t unit[2] = {1, 1};
  *box_bytes = static_cast<int>(bc * br * 2);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CLS, int TA, int TB, int NP>
cudaError_t launch(const CUtensorMap& tu, const CUtensorMap& tr, const Params& p, int blocks, cudaStream_t stream) {
  auto kernel = mma_probe_kernel<CLS, TA, TB, NP>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.plan.smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, p.plan.smem, stream>>>(tu, tr, p);
  return cudaGetLastError();
}

template <int TB>
cudaError_t launch_pv(const CUtensorMap& tu, const CUtensorMap& tr, const Params& p, int blocks,
                      cudaStream_t stream) {
  switch (p.plan.np) {
    case 32: return launch<kPV, 0, TB, 32>(tu, tr, p, blocks, stream);
    case 40: return launch<kPV, 0, TB, 40>(tu, tr, p, blocks, stream);
    case 48: return launch<kPV, 0, TB, 48>(tu, tr, p, blocks, stream);
    case 64: return launch<kPV, 0, TB, 64>(tu, tr, p, blocks, stream);
    default: return launch<kPV, 0, TB, 128>(tu, tr, p, blocks, stream);
  }
}

}  // namespace

extern "C" {

// The plan for these operands (see the header): fills out[0..10] with cls,
// a_is_b, ta, tb, m, n, k, kp, np, ring, smem and returns 1, or returns 0
// for what mma_probe refuses.
int mma_probe_plan(int a_trans, int b_trans, int M, int N, int K, int* out) {
  Plan q;
  if (!probe_plan(a_trans, b_trans, M, N, K, &q)) return 0;
  const int v[11] = {q.cls, q.a_is_b, q.ta, q.tb, q.m, q.n, q.k, q.kp, q.np, q.ring, q.smem};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 1;
}

// out[blk] = sum_{i < iters} sum_{m, n} sum_k A_i(m, k) B_i(n, k) for every
// blk < blocks. a is stored (M, K) row-major, or (K, M) with a_trans; b is
// stored (N, K), or (K, N) with b_trans. The operand with fewer rows (a on a
// tie) is the one rescaled. Supported: both plain, both transposed, or a
// plain with b transposed and N < M; the larger operand's rows a multiple of
// 64; M, N, K multiples of 8; what the plan fits into one SM's shared memory
// (mma_probe_plan). Launches on `stream` and returns cudaGetLastError(); 1
// (cudaErrorInvalidValue) for anything unsupported.
int mma_probe(const void* a, const void* b, float* out, int a_trans, int b_trans, int M, int N, int K, int iters,
              int blocks, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  Plan q;
  if (iters < 0 || blocks <= 0 || !probe_plan(a_trans, b_trans, M, N, K, &q)) return invalid;
  Params p{out, iters, q, 0, 0, 0};
  // rank-2 tensor maps of the unscaled and the rescaled operand, boxes as
  // the kernel's producer copies them
  CUtensorMap tu, tr;
  int bu = 0, br = 0;
  bool mapped;
  if (q.cls == kS) {
    if (a_trans) {  // b stored (K, N), a stored (K, M): one box of K rows per 64 columns
      mapped = make_map_2d(&tu, b, K, N, q.kp, &bu) && make_map_2d(&tr, a, K, M, q.kp, &br);
      p.tx_res = N / 64 * bu;
      p.tx_r = br;
    } else {  // b (N, K), a (M, K): a box per 64 rows and 64 of K
      const int kblocks = round_up(q.kp, 64) / 64;
      mapped = make_map_2d(&tu, b, N, K, 64, &bu) && make_map_2d(&tr, a, M, K, 64, &br);
      p.tx_res = kblocks * (N / 64) * bu;
      p.tx_r = kblocks * br;
    }
  } else {
    // A: the stored b (N, K) in the transposed product, else a (M, K)
    mapped = make_map_2d(&tu, q.a_is_b ? b : a, q.m, K, 64, &bu);
    p.tx_u = q.m / 64 * bu;
    if (q.a_is_b) {  // B = a (M, K): one box of its rows per K chunk
      mapped = mapped && make_map_2d(&tr, a, M, K, q.np, &br);
      p.tx_r = br;
    } else {  // B = b stored (K, N): a box per 64 columns of np
      mapped = mapped && make_map_2d(&tr, b, K, N, 64, &br);
      p.tx_r = round_up(q.np, 64) / 64 * br;
    }
  }
  if (!mapped) return invalid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q.cls == kS)
    err = a_trans ? launch<kS, 1, 1, kPiece>(tu, tr, p, blocks, s) : launch<kS, 0, 0, kPiece>(tu, tr, p, blocks, s);
  else
    err = q.tb ? launch_pv<1>(tu, tr, p, blocks, s) : launch_pv<0>(tu, tr, p, blocks, s);
  return static_cast<int>(err);
}

}  // extern "C"
