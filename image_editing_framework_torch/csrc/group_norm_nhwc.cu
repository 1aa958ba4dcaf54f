// GroupNorm, with the SiLU that follows it fused in, over channels-last
// (NHWC) activations, for Hopper (sm_90a), bound to PyTorch through a plain C
// entry point (ctypes).
//
// Replaces no TPU kernel: the JAX package's GroupNorm is plain jnp code that
// XLA fuses with its SiLU. On the card the port's convolutions run cuDNN's
// NHWC kernels, and PyTorch's own GroupNorm takes NCHW only, so the UNet and
// the VAE kept NCHW activations and paid a layout conversion around every
// convolution, plus separate passes for the statistics, the normalisation
// and the SiLU. This kernel lets the activations stay channels-last.
//
//   y[n, p, c] = act(gamma[c] * (x[n, p, c] - mean[n, g]) * rstd[n, g] + beta[c])
//   g = c / (C / G), act = SiLU or the identity; mean, rstd over the group's
//   HW x C/G values, biased variance, f32 statistics.
//
// What bounds it on the card: a handful of operations per element against
// 2-4 bytes read and written, far below the H100's ~295 FLOP/byte ridge, so
// memory traffic alone: the bound is one read of x and one write of y at
// 3.35 TB/s. The design moves as few bytes as it can in two passes:
//   * Statistics: blocks over (row splits, samples) read whole pixel rows, C
//     channels contiguous, 16 bytes a thread, so a block streams one
//     contiguous chunk. A thread keeps one 16-byte channel slice (8 bf16 or
//     4 f32 channels) for all its rows and accumulates per-channel sums of
//     x - K and (x - K)^2 in f32, K the group's first value of the sample (a
//     shift against cancellation in E[x^2] - E[x]^2). Channel-by-channel
//     accumulators make the group boundaries irrelevant in the loop: C/G is
//     10, 20, 30, 40, 60, 80 in the UNets and 4-16 in the VAE, and a 16-byte
//     slice may straddle two groups. The block folds its rows, then its
//     channels into groups, in shared memory and writes one partial per
//     (sample, group, split); no atomics.
//   * Apply: each block first sums its sample's partials into each group's
//     mean and rstd (a warp a group, its lanes over the splits, f64, in a
//     fixed order: a separate kernel for it cost a launch and a serial
//     latency), one block a sample writes them out for the backward; then
//     one more read of x, one write of y, in the same 16-byte width,
//     y = act((x - mean) * gamma * rstd + beta): the mean taken off first,
//     so a group whose values are all near its mean keeps its digits. Its
//     threads walk their rows backwards, so each block first rereads the
//     rows the statistics read last, which L2 (50 MB) may still hold.
// Two reads and one write of the activation, where moments, normalise and
// SiLU as separate passes read it five times and write it three.
//
// Backward (dx; dgamma and dbeta when asked), the forward's output
// recomputed from x and not saved, dz = dy * silu'(z):
//   dx = rstd * (gamma * dz - mean_g(gamma * dz) - xhat * mean_g(gamma * dz * xhat))
//   dgamma = sum_{n, p} dz * xhat,  dbeta = sum_{n, p} dz
// in two passes over (x, dy), as the forward: per-channel sums of dz * xhat
// and dz, folded into per-group partials with gamma; then dx, its blocks
// summing the partials first as the apply does. The per-channel sums of each
// (sample, split) are kept for dgamma and dbeta, which a third small kernel
// sums over the samples and splits.
//
// The tile follows the shape: a block is V x R threads (rounded up to whole
// warps), V = C / (16 bytes) channel slices by R rows (R = 256 / V, at least
// 1 and at most HW); the splits per sample make one wave of the blocks the
// card holds at once (from the kernels' occupancy), so each block pays its
// prologue and fold once, and give each thread at least four rows. bf16 or
// f32 (one dtype for x, y, gamma, beta).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kTargetThreads = 256;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSplits = 128;
constexpr int kMinRowsPerThread = 4;
constexpr size_t kMaxFoldSmem = 48 * 1024;  // the default dynamic shared memory a block may ask for

struct Geo {
  int N, HW, C, G, cg;  // cg = C / G
  int V, R;             // 16-byte channel slices a row; rows a block covers at once
  int S, rows;          // splits a sample; rows a split
  int threads;          // V * R rounded up to whole warps
};

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
};

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + __expf(-z)); }

// This thread's channel slice, first row and row range of the split.
struct Slot {
  int c0, row, end;
};

__device__ __forceinline__ Slot slot(const Geo& g, int vec, int split) {
  const int t = threadIdx.x;
  const int begin = split * g.rows, end = min(g.HW, begin + g.rows);
  // a thread past V * R (the rounding to whole warps) takes no row
  return Slot{(t % g.V) * vec, t < g.V * g.R ? begin + t / g.V : end, end};
}

// The last row of a thread's rows s.row, s.row + R, ... below s.end (below
// s.row where it has none): a second pass walks them backwards.
__device__ __forceinline__ int last_row(const Slot& s, int R) {
  return s.row < s.end ? s.row + (s.end - 1 - s.row) / R * R : s.row - 1;
}

// A second pass's (split, sample): the grid in reverse, so where the grid is
// more than one wave its first blocks reread the rows the first pass read
// last.
__device__ __forceinline__ int2 reversed_block(const Geo& g) {
  return make_int2(g.S - 1 - static_cast<int>(blockIdx.x), g.N - 1 - static_cast<int>(blockIdx.y));
}

// Folds the block's per-thread channel sums a[], b[] (one slice each) into
// per-channel totals in shared memory (row 0 of each [R][C] array).
template <int VN>
__device__ __forceinline__ void fold_rows(const Geo& g, float* sa, float* sb, const float (&a)[VN],
                                          const float (&b)[VN], int c0) {
  const int r = threadIdx.x / g.V;
  if (r < g.R) {
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      sa[r * g.C + c0 + j] = a[j];
      sb[r * g.C + c0 + j] = b[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < g.C; c += blockDim.x) {
    float ta = 0.f, tb = 0.f;
    for (int rr = 0; rr < g.R; ++rr) {
      ta += sa[rr * g.C + c];
      tb += sb[rr * g.C + c];
    }
    sa[c] = ta;
    sb[c] = tb;
  }
  __syncthreads();
}

// Each group's partials of sample n summed in f64 in a fixed order: a warp
// takes a group, its lanes the splits lane, lane + 32, ..., then a shuffle
// tree; f(group, sum of the first partial, sum of the second) runs on lane 0.
// Every thread of the block calls it (whole warps).
template <typename F>
__device__ __forceinline__ void reduce_groups(const Geo& g, const float* __restrict__ part, int n, F&& f) {
  const int lane = threadIdx.x & 31;
  for (int grp = threadIdx.x >> 5; grp < g.G; grp += blockDim.x >> 5) {
    const float* p = part + (static_cast<size_t>(n) * g.G + grp) * g.S * 2;
    double a = 0.0, b = 0.0;
    for (int s = lane; s < g.S; s += 32) {
      a += p[2 * s];
      b += p[2 * s + 1];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) f(grp, a, b);
  }
}

// ------------------------------------------------------------------ forward

template <typename T>
__global__ void gn_stats(const T* __restrict__ x, float* __restrict__ part, Geo g) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ float smem[];
  const Slot s = slot(g, VN, blockIdx.x);
  const T* xn = x + static_cast<size_t>(blockIdx.y) * g.HW * g.C;
  float shift[VN], sum[VN], sq[VN];
#pragma unroll
  for (int j = 0; j < VN; ++j) {
    shift[j] = to_f(xn[(s.c0 + j) / g.cg * g.cg]);
    sum[j] = sq[j] = 0.f;
  }
  auto add = [&](const float (&v)[VN]) {
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      const float d = v[j] - shift[j];
      sum[j] += d;
      sq[j] = fmaf(d, d, sq[j]);
    }
  };
  int row = s.row;
  for (; row + 3 * g.R < s.end; row += 4 * g.R) {
    float v0[VN], v1[VN], v2[VN], v3[VN];
    load16(xn + static_cast<size_t>(row) * g.C + s.c0, v0);
    load16(xn + static_cast<size_t>(row + g.R) * g.C + s.c0, v1);
    load16(xn + static_cast<size_t>(row + 2 * g.R) * g.C + s.c0, v2);
    load16(xn + static_cast<size_t>(row + 3 * g.R) * g.C + s.c0, v3);
    add(v0);
    add(v1);
    add(v2);
    add(v3);
  }
  for (; row < s.end; row += g.R) {
    float v0[VN];
    load16(xn + static_cast<size_t>(row) * g.C + s.c0, v0);
    add(v0);
  }
  float* sa = smem;
  float* sb = smem + g.R * g.C;
  fold_rows<VN>(g, sa, sb, sum, sq, s.c0);
  for (int grp = threadIdx.x; grp < g.G; grp += blockDim.x) {
    float ta = 0.f, tb = 0.f;
    for (int c = grp * g.cg; c < (grp + 1) * g.cg; ++c) {
      ta += sa[c];
      tb += sb[c];
    }
    float* p = part + ((static_cast<size_t>(blockIdx.y) * g.G + grp) * g.S + blockIdx.x) * 2;
    p[0] = ta;
    p[1] = tb;
  }
}

template <typename T, bool SILU>
__global__ void gn_apply(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ beta,
                         const float* __restrict__ part, float* __restrict__ mean, float* __restrict__ rstd,
                         T* __restrict__ y, Geo g, float eps) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ float smem[];  // this sample's mean[G], rstd[G]
  const int2 blk = reversed_block(g);
  const Slot s = slot(g, VN, blk.x);
  const int n = blk.y;
  const size_t base = static_cast<size_t>(n) * g.HW * g.C + s.c0;
  const double count = static_cast<double>(g.HW) * g.cg;
  reduce_groups(g, part, n, [&](int grp, double a, double b) {
    // the sums are of x - K, K the group's first value (gn_stats)
    const double mu = a / count, var = fmax(b / count - mu * mu, 0.0);
    const float m = static_cast<float>(to_f(x[static_cast<size_t>(n) * g.HW * g.C + grp * g.cg]) + mu);
    const float r = static_cast<float>(1.0 / sqrt(var + eps));
    smem[grp] = m;
    smem[g.G + grp] = r;
    if (blk.x == 0) {
      mean[n * g.G + grp] = m;
      rstd[n * g.G + grp] = r;
    }
  });
  __syncthreads();
  float mu[VN], scale[VN], shift[VN];
#pragma unroll
  for (int j = 0; j < VN; ++j) {
    const int c = s.c0 + j, grp = c / g.cg;
    mu[j] = smem[grp];
    scale[j] = to_f(gamma[c]) * smem[g.G + grp];
    shift[j] = to_f(beta[c]);
  }
  auto apply = [&](float (&v)[VN]) {
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      const float z = fmaf(v[j] - mu[j], scale[j], shift[j]);
      v[j] = SILU ? z * sigmoid(z) : z;
    }
  };
  // rows backwards, four at a time
  int row = last_row(s, g.R);
  for (; row - 3 * g.R >= s.row; row -= 4 * g.R) {
    float v0[VN], v1[VN], v2[VN], v3[VN];
    const size_t o0 = base + static_cast<size_t>(row) * g.C, step = static_cast<size_t>(g.R) * g.C;
    load16(x + o0, v0);
    load16(x + o0 - step, v1);
    load16(x + o0 - 2 * step, v2);
    load16(x + o0 - 3 * step, v3);
    apply(v0);
    apply(v1);
    apply(v2);
    apply(v3);
    store16(y + o0, v0);
    store16(y + o0 - step, v1);
    store16(y + o0 - 2 * step, v2);
    store16(y + o0 - 3 * step, v3);
  }
  for (; row >= s.row; row -= g.R) {
    float v0[VN];
    const size_t o0 = base + static_cast<size_t>(row) * g.C;
    load16(x + o0, v0);
    apply(v0);
    store16(y + o0, v0);
  }
}

// ----------------------------------------------------------------- backward

// Per-channel constants of a thread's slice for the backward.
template <int VN>
struct Chan {
  float mu[VN], rs[VN], ga[VN], be[VN];
};

template <typename T, int VN>
__device__ __forceinline__ Chan<VN> chan(const Geo& g, int c0, int n, const T* gamma, const T* beta,
                                         const float* mean, const float* rstd) {
  Chan<VN> k;
#pragma unroll
  for (int j = 0; j < VN; ++j) {
    const int c = c0 + j, grp = n * g.G + c / g.cg;
    k.mu[j] = mean[grp];
    k.rs[j] = rstd[grp];
    k.ga[j] = to_f(gamma[c]);
    k.be[j] = to_f(beta[c]);
  }
  return k;
}

// xhat and dz of one element: dz = dy * silu'(z) with SiLU, else dy.
template <bool SILU>
__device__ __forceinline__ void dz_of(float xv, float dyv, float mu, float rs, float ga, float be, float& xh,
                                      float& dz) {
  xh = (xv - mu) * rs;
  if (SILU) {
    const float z = fmaf(ga, xh, be);
    const float sg = sigmoid(z);
    dz = dyv * sg * fmaf(z, 1.f - sg, 1.f);
  } else {
    dz = dyv;
  }
}

template <typename T, bool SILU>
__global__ void gn_bwd_sums(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ gamma,
                            const T* __restrict__ beta, const float* __restrict__ mean,
                            const float* __restrict__ rstd, float* __restrict__ part, float* __restrict__ chans,
                            Geo g) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ float smem[];
  const Slot s = slot(g, VN, blockIdx.x);
  const Chan<VN> k = chan<T, VN>(g, s.c0, blockIdx.y, gamma, beta, mean, rstd);
  const size_t base = static_cast<size_t>(blockIdx.y) * g.HW * g.C + s.c0;
  float p[VN], q[VN];  // sums of dz * xhat and of dz
#pragma unroll
  for (int j = 0; j < VN; ++j) p[j] = q[j] = 0.f;
  auto add = [&](const float (&xv)[VN], const float (&dv)[VN]) {
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      float xh, dz;
      dz_of<SILU>(xv[j], dv[j], k.mu[j], k.rs[j], k.ga[j], k.be[j], xh, dz);
      p[j] = fmaf(dz, xh, p[j]);
      q[j] += dz;
    }
  };
  int row = s.row;
  for (; row + g.R < s.end; row += 2 * g.R) {
    float x0[VN], x1[VN], d0[VN], d1[VN];
    const size_t o0 = base + static_cast<size_t>(row) * g.C, o1 = o0 + static_cast<size_t>(g.R) * g.C;
    load16(x + o0, x0);
    load16(dy + o0, d0);
    load16(x + o1, x1);
    load16(dy + o1, d1);
    add(x0, d0);
    add(x1, d1);
  }
  if (row < s.end) {
    float x0[VN], d0[VN];
    const size_t o0 = base + static_cast<size_t>(row) * g.C;
    load16(x + o0, x0);
    load16(dy + o0, d0);
    add(x0, d0);
  }
  float* sp = smem;
  float* sq = smem + g.R * g.C;
  fold_rows<VN>(g, sp, sq, p, q, s.c0);
  if (chans != nullptr) {
    float* out = chans + (static_cast<size_t>(blockIdx.y) * g.S + blockIdx.x) * 2 * g.C;
    for (int c = threadIdx.x; c < g.C; c += blockDim.x) {
      out[c] = sp[c];
      out[g.C + c] = sq[c];
    }
  }
  for (int grp = threadIdx.x; grp < g.G; grp += blockDim.x) {
    float ta = 0.f, tb = 0.f;  // sums of gamma * dz and of gamma * dz * xhat
    for (int c = grp * g.cg; c < (grp + 1) * g.cg; ++c) {
      const float ga = to_f(gamma[c]);
      ta = fmaf(ga, sq[c], ta);
      tb = fmaf(ga, sp[c], tb);
    }
    float* o = part + ((static_cast<size_t>(blockIdx.y) * g.G + grp) * g.S + blockIdx.x) * 2;
    o[0] = ta;
    o[1] = tb;
  }
}

// dx, each block first summing its sample's partials of gn_bwd_sums into
// c1 = mean_g(gamma * dz) and c2 = mean_g(gamma * dz * xhat) per group.
template <typename T, bool SILU>
__global__ void gn_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ gamma,
                          const T* __restrict__ beta, const float* __restrict__ mean,
                          const float* __restrict__ rstd, const float* __restrict__ part, T* __restrict__ dx,
                          Geo g) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ float smem[];  // this sample's c1[G], c2[G]
  const int2 blk = reversed_block(g);
  const Slot s = slot(g, VN, blk.x);
  const int n = blk.y;
  const double count = static_cast<double>(g.HW) * g.cg;
  reduce_groups(g, part, n, [&](int grp, double a, double b) {
    smem[grp] = static_cast<float>(a / count);
    smem[g.G + grp] = static_cast<float>(b / count);
  });
  __syncthreads();
  const Chan<VN> k = chan<T, VN>(g, s.c0, n, gamma, beta, mean, rstd);
  float c1[VN], c2[VN];
#pragma unroll
  for (int j = 0; j < VN; ++j) {
    const int grp = (s.c0 + j) / g.cg;
    c1[j] = smem[grp];
    c2[j] = smem[g.G + grp];
  }
  const size_t base = static_cast<size_t>(n) * g.HW * g.C + s.c0;
  // rows backwards, as the apply walks them
  for (int row = last_row(s, g.R); row >= s.row; row -= g.R) {
    float xv[VN], dv[VN];
    const size_t o = base + static_cast<size_t>(row) * g.C;
    load16(x + o, xv);
    load16(dy + o, dv);
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      float xh, dz;
      dz_of<SILU>(xv[j], dv[j], k.mu[j], k.rs[j], k.ga[j], k.be[j], xh, dz);
      xv[j] = k.rs[j] * (k.ga[j] * dz - c1[j] - xh * c2[j]);
    }
    store16(dx + o, xv);
  }
}

// dgamma[c] = sum over (n, split) of the kept sums of dz * xhat; dbeta of dz.
template <typename T>
__global__ void gn_bwd_params(const float* __restrict__ chans, T* __restrict__ dgamma, T* __restrict__ dbeta,
                              Geo g) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= g.C) return;
  float a = 0.f, b = 0.f;
  for (int r = 0; r < g.N * g.S; ++r) {
    a += chans[static_cast<size_t>(r) * 2 * g.C + c];
    b += chans[static_cast<size_t>(r) * 2 * g.C + g.C + c];
  }
  dgamma[c] = static_cast<T>(a);
  dbeta[c] = static_cast<T>(b);
}

// ------------------------------------------------------------------- host

size_t fold_smem(const Geo& g) { return 2u * g.R * g.C * sizeof(float); }
size_t group_smem(const Geo& g) { return 2u * g.G * sizeof(float); }

// Blocks of `threads` the card holds at once for both forward passes (the
// fewer of the two kernels' occupancies, times the SMs), cached per shape of
// block; 0 where the runtime cannot say. The backward takes the same grid,
// in as many waves as its larger register count asks: it runs far less often.
template <typename T>
int resident_blocks(int threads, size_t fold, size_t group) {
  static std::mutex lock;
  static std::map<std::tuple<int, size_t, size_t>, int> known;
  std::lock_guard<std::mutex> hold(lock);
  const auto key = std::make_tuple(threads, fold, group);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  int dev = 0, sms = 0, first = 0, second = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&first, gn_stats<T>, threads, fold) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&second, gn_apply<T, true>, threads, group)) {
    cudaGetLastError();  // clear it: the launch that follows reports its own
    return 0;
  }
  return known[key] = sms * (first < second ? first : second);
}

// The geometry of a shape, or false where the kernel does not take it.
bool plan(int N, int HW, int C, int G, int is_bf16, Geo* g) {
  const int vec = is_bf16 ? 8 : 4;
  if (N < 1 || N > 65535 || HW < 1 || C < vec || G < 1 || C % G || C % vec || C / vec > kMaxThreads) return false;
  g->N = N;
  g->HW = HW;
  g->C = C;
  g->G = G;
  g->cg = C / G;
  g->V = C / vec;
  g->R = g->V >= kTargetThreads ? 1 : kTargetThreads / g->V;
  if (g->R > HW) g->R = HW;
  g->threads = (g->V * g->R + 31) / 32 * 32;
  if (fold_smem(*g) > kMaxFoldSmem) return false;
  const int resident = is_bf16 ? resident_blocks<__nv_bfloat16>(g->threads, fold_smem(*g), group_smem(*g))
                               : resident_blocks<float>(g->threads, fold_smem(*g), group_smem(*g));
  const int per_sample = resident > 0 ? resident / N : 1;
  const int most = (HW + kMinRowsPerThread * g->R - 1) / (kMinRowsPerThread * g->R);
  int S = per_sample < most ? per_sample : most;
  if (S > kMaxSplits) S = kMaxSplits;
  if (S < 1) S = 1;
  g->rows = (HW + S - 1) / S;
  g->S = (HW + g->rows - 1) / g->rows;  // no empty split
  return true;
}

template <typename T>
cudaError_t forward(const Geo& g, const void* x, const void* gamma, const void* beta, void* y, float* mean,
                    float* rstd, float* work, float eps, int silu, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const dim3 grid(g.S, g.N), block(g.threads);
  gn_stats<T><<<grid, block, fold_smem(g), stream>>>(xt, work, g);
  const T* gt = static_cast<const T*>(gamma);
  const T* bt = static_cast<const T*>(beta);
  auto apply = silu ? gn_apply<T, true> : gn_apply<T, false>;
  apply<<<grid, block, group_smem(g), stream>>>(xt, gt, bt, work, mean, rstd, static_cast<T*>(y), g, eps);
  return cudaGetLastError();
}

template <typename T, bool SILU>
cudaError_t backward(const Geo& g, const T* x, const T* dy, const T* gamma, const T* beta, const float* mean,
                     const float* rstd, T* dx, T* dgamma, T* dbeta, float* work, cudaStream_t stream) {
  float* part = work;
  float* chans = dgamma != nullptr ? part + static_cast<size_t>(g.N) * g.G * g.S * 2 : nullptr;
  const dim3 grid(g.S, g.N), block(g.threads);
  gn_bwd_sums<T, SILU><<<grid, block, fold_smem(g), stream>>>(x, dy, gamma, beta, mean, rstd, part, chans, g);
  gn_bwd_dx<T, SILU><<<grid, block, group_smem(g), stream>>>(x, dy, gamma, beta, mean, rstd, part, dx, g);
  if (chans != nullptr) gn_bwd_params<T><<<(g.C + 255) / 256, 256, 0, stream>>>(chans, dgamma, dbeta, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward_t(const Geo& g, const void* x, const void* dy, const void* gamma, const void* beta,
                       const float* mean, const float* rstd, void* dx, void* dgamma, void* dbeta, float* work,
                       int silu, cudaStream_t stream) {
  auto run = silu ? backward<T, true> : backward<T, false>;
  return run(g, static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(gamma),
             static_cast<const T*>(beta), mean, rstd, static_cast<T*>(dx), static_cast<T*>(dgamma),
             static_cast<T*>(dbeta), work, stream);
}

}  // namespace

extern "C" {

// The f32 workspace a shape asks for: {forward, backward without and with the
// parameters' gradients}. Returns 0 where the kernel does not take the shape:
// C not a multiple of G or of the 16-byte vector (8 bf16, 4 f32), more than
// 1024 slices a row or more than 48 KB of shared memory to fold a block's
// rows (C over 6144), or N over 65535.
int group_norm_nhwc_plan(int N, int HW, int C, int G, int is_bf16, long long* out) {
  Geo g;
  if (!plan(N, HW, C, G, is_bf16, &g)) return 0;
  const long long part = 2LL * N * G * g.S;
  out[0] = part;
  out[1] = part;
  out[2] = part + 2LL * N * g.S * C;
  return 1;
}

// y, mean (N, G) and rstd (N, G) from x; `work` holds the forward's
// workspace floats (group_norm_nhwc_plan). x and y are (N, HW, C)
// contiguous, 16-byte aligned. Launches on `stream` and returns the CUDA
// error code: 1 (cudaErrorInvalidValue) for a shape the kernel does not
// take, else cudaGetLastError().
int group_norm_nhwc_fwd(const void* x, const void* gamma, const void* beta, void* y, float* mean, float* rstd,
                        float* work, int N, int HW, int C, int G, float eps, int silu, int is_bf16,
                        void* stream) {
  Geo g;
  if (!plan(N, HW, C, G, is_bf16, &g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? forward<__nv_bfloat16>(g, x, gamma, beta, y, mean, rstd, work, eps, silu, s)
                                  : forward<float>(g, x, gamma, beta, y, mean, rstd, work, eps, silu, s);
  return static_cast<int>(err);
}

// dx from x, dy and the forward's mean and rstd; dgamma and dbeta (C,) too
// when both pointers are given (then `work` holds the larger backward
// workspace). Same layout, stream and error rules as the forward.
int group_norm_nhwc_bwd(const void* x, const void* dy, const void* gamma, const void* beta, const float* mean,
                        const float* rstd, void* dx, void* dgamma, void* dbeta, float* work, int N, int HW, int C,
                        int G, int silu, int is_bf16, void* stream) {
  Geo g;
  if (!plan(N, HW, C, G, is_bf16, &g) || (dgamma == nullptr) != (dbeta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? backward_t<__nv_bfloat16>(g, x, dy, gamma, beta, mean, rstd, dx, dgamma, dbeta, work, silu, s)
              : backward_t<float>(g, x, dy, gamma, beta, mean, rstd, dx, dgamma, dbeta, work, silu, s);
  return static_cast<int>(err);
}

}  // extern "C"
