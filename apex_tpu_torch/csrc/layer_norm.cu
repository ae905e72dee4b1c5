// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a).
//
// The forward replaces apex_tpu/ops/layer_norm.py:_ln_fwd_kernel (called
// through _ln_pallas_fwd): y = (x - mean) * rsqrt(var + eps) * w + b per row,
// with the statistics in fp32 and y in x's dtype. The backward (below)
// replaces _ln_bwd_kernel.
//
// RMSNorm is the same kernels with kRms set, which drops the mean (and, in
// the backward, mean(dyw) and dbeta). Its forward replaces _rms_fwd_kernel:
// y = x * rsqrt(mean(x^2) + eps) * w; its backward replaces _rms_bwd_kernel.
//
// What bounds it on the card: bytes. Each element is read once and written
// once and costs a handful of flops, so the least time is
// 2 * rows * hidden * sizeof(T) over the 3.35 TB/s of HBM.
//
// Both forwards take norm_fwd_row_kernel (below) wherever the row fits a
// warp's registers: it reads each row from HBM once, where the loop here
// reads it two (RMSNorm) or three (LayerNorm) times.
//
// Design: one warp per row, eight rows per 256-thread block, so a row's
// reductions are warp shuffles with no shared memory and no __syncthreads.
// Loads and stores are 16-byte vectors when the row is 16-byte aligned (any
// hidden that is a multiple of 8 bf16 or 4 fp32 elements), scalar otherwise,
// so every hidden size and row count is taken; the TPU kernel's
// hidden % 128 fallback, 8-row padding and VMEM block budget do not apply.
// Mean and variance are two passes (sum, then sum of squared deviations),
// as _ln_ref computes them; the second and third reads of a row hit L1,
// since a warp's row (at most a few KB) is still resident. The loop and the
// row kernel share their arithmetic (the per-lane order of the sums, fmaf
// for the squares, and affine below), so their outputs are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y of one element from its normalised value o = (x - mean) * rstd: times w
// where hw, plus b where hb, one FMA when both. The explicit intrinsics fix
// the rounding, so that no kernel's output depends on what the compiler
// contracts.
__device__ __forceinline__ float affine(float o, float w, float b, bool hw, bool hb) {
  if (hw && hb) return fmaf(o, w, b);
  if (hw) return __fmul_rn(o, w);
  return hb ? __fadd_rn(o, b) : o;
}

// v[0..N) = p[i * N ..], as N / 4 float4 loads (p 16-byte aligned), or 1
// where p is null.
template <int N>
__device__ __forceinline__ void load_f4(float (&v)[N], const float* __restrict__ p, int i) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float4 f = p ? reinterpret_cast<const float4*>(p)[i * (N / 4) + c]
                       : make_float4(1.f, 1.f, 1.f, 1.f);
    v[4 * c] = f.x;
    v[4 * c + 1] = f.y;
    v[4 * c + 2] = f.z;
    v[4 * c + 3] = f.w;
  }
}

// Elements of T per 16-byte vector.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// Calls f(index, value) for every element of row x[0, hidden) that this lane
// owns, reading 16-byte vectors when `vec` is set.
template <typename T, typename F>
__device__ __forceinline__ void for_row(const T* __restrict__ x, int hidden, bool vec,
                                        int lane, F f) {
  constexpr int N = Vec<T>::N;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int i = lane; i < hidden / N; i += 32) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) f(i * N + j, to_f(e[j]));
    }
  } else {
    for (int i = lane; i < hidden; i += 32) f(i, to_f(x[i]));
  }
}

// b is null when kRms is set.
template <typename T, bool kRms>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ y, int rows, int hidden,
                float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * hidden;
  T* yr = y + row * hidden;
  const bool vec = (hidden % N == 0) &&
                   ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(yr)) % 16 == 0);

  float mean = 0.f;
  if constexpr (!kRms) {
    float s = 0.f;
    for_row(xr, hidden, vec, lane, [&](int, float v) { s += v; });
    mean = warp_sum(s) / hidden;
  }
  float ss = 0.f;
  for_row(xr, hidden, vec, lane, [&](int, float v) {
    const float d = v - mean;
    ss = fmaf(d, d, ss);
  });
  const float rstd = rsqrtf(warp_sum(ss) / hidden + eps);

  auto norm = [&](int i, float v) {
    return from_f<T>(affine(__fmul_rn(v - mean, rstd), w ? w[i] : 1.f, b ? b[i] : 0.f,
                            w != nullptr, b != nullptr));
  };
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < hidden / N; i += 32) {
      uint4 raw = xv[i], out;
      const T* e = reinterpret_cast<const T*>(&raw);
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) o[j] = norm(i * N + j, to_f(e[j]));
      yv[i] = out;
    }
  } else {
    for (int i = lane; i < hidden; i += 32) yr[i] = norm(i, to_f(xr[i]));
  }
}

// LayerNorm and RMSNorm forward with the row held in registers (where
// hidden is a multiple of 8 bf16 or 4 fp32 elements, every pointer is
// 16-byte aligned and the row fits NV 16-byte vectors a lane). A warp owns a
// row: every lane issues all its loads (NV uint4, lane + 32j) before the
// first reduction, so the row is read from HBM once; the mean (LayerNorm
// only), then the sum of squared deviations, come from the registers by
// shuffles, in norm_fwd_kernel's per-lane order, and w and b come as
// float4, so y is bit-equal to norm_fwd_kernel's. At hidden 2048 bf16 that
// is 8 uint4 a lane; at 768, 3. b is null when kRms is set.
template <typename T, int NV, bool kRms>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
norm_fwd_row_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, T* __restrict__ y, int rows, int hidden,
                    float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = hidden / N;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * hidden);
  uint4 r[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (lane + 32 * j < nvec) r[j] = xv[lane + 32 * j];
  float mean = 0.f;
  if constexpr (!kRms) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < nvec) {
        const T* e = reinterpret_cast<const T*>(&r[j]);
#pragma unroll
        for (int c = 0; c < N; ++c) s += to_f(e[c]);
      }
    mean = warp_sum(s) / hidden;
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (lane + 32 * j < nvec) {
      const T* e = reinterpret_cast<const T*>(&r[j]);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const float d = to_f(e[c]) - mean;
        ss = fmaf(d, d, ss);
      }
    }
  const float rstd = rsqrtf(warp_sum(ss) / hidden + eps);
  uint4* yv = reinterpret_cast<uint4*>(y + row * hidden);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lane + 32 * j;
    if (i >= nvec) continue;
    float wv[N], bv[N];
    load_f4(wv, w, i);
    if constexpr (!kRms) load_f4(bv, b, i);
    const T* e = reinterpret_cast<const T*>(&r[j]);
    uint4 out;
    T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int c = 0; c < N; ++c)
      ov[c] = from_f<T>(affine(__fmul_rn(to_f(e[c]) - mean, rstd), wv[c], kRms ? 0.f : bv[c],
                               w != nullptr, !kRms && b != nullptr));
    yv[i] = out;
  }
}

template <typename T, bool kRms>
int launch(const void* x, const void* w, const void* b, void* y, int rows, int hidden,
           float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  norm_fwd_kernel<T, kRms><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), rows, hidden, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
//
// Replaces apex_tpu/ops/layer_norm.py:_ln_bwd_kernel (called through
// _ln_pallas_bwd). Per row, with the statistics recomputed from the saved x:
//   xhat = (x - mean) * rstd,  dyw = dy * w,
//   dx = (dyw - mean(dyw) - xhat * mean(dyw * xhat)) * rstd   (in x's dtype)
// and over all rows dgamma = sum(dy * xhat), dbeta = sum(dy) in fp32. With
// kRms (_rms_bwd_kernel) mean and mean(dyw) are 0 and there is no dbeta.
//
// What bounds it on the card: bytes. It reads x and dy and writes dx, a
// handful of flops per element, so the least time is
// 3 * rows * hidden * sizeof(T) over the 3.35 TB/s of HBM.
//
// Design. The TPU kernel carries dgamma/dbeta from one grid step to the next;
// Hopper runs blocks in no order, so the sum over rows takes two kernels and
// no float atomics (the replay tooling wants bit-stable steps, and atomics
// would add in a different order on every run):
// 1. norm_bwd_kernel: a block owns kBwdRows consecutive rows. First one warp
//    per row reduces mean, rstd, mean(dyw) and mean(dyw * xhat) into shared
//    memory (warp shuffles, as in the forward). Then the block sweeps the
//    columns, one thread per column: for each of its rows, in order, it
//    writes dx and adds dy * xhat (and dy) into registers, and at the end
//    writes the block's partial sums to a (2, blocks, hidden) fp32 scratch
//    ((blocks, hidden) with kRms) the wrapper allocates. The second read of
//    the block's rows mostly hits L1/L2 (kBwdRows * hidden * 2 * sizeof(T)
//    bytes).
// 2. norm_bwd_sum_kernel: per column, sums the blocks' partials in a fixed
//    order (8 strided groups, then the 8 group sums in order).
// Every row count and hidden size works; there is no padding. The RMSNorm
// and LayerNorm backwards take rms_bwd_row_kernel and ln_bwd_row_kernel
// (below) in place of step 1 wherever the rows fit a warp's registers: they
// read x and dy from HBM once, where norm_bwd_kernel reads x three times
// with scalar loads of dy, then both again for its column sweep, whose
// strided loads use 2 or 4 bytes of each line they fetch and whose 32 rows
// of 2048 bf16 (256 KB) no longer fit L1.

constexpr int kBwdRows = 32;
constexpr int kBwdThreads = 256;

template <typename T, bool kRms>
__global__ void __launch_bounds__(kBwdThreads)
norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                int rows, int hidden, float eps) {
  __shared__ float s_mean[kBwdRows], s_rstd[kBwdRows], s_m1[kBwdRows], s_m2[kBwdRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long r0 = (long)blockIdx.x * kBwdRows;
  const int nr = (int)(rows - r0 < kBwdRows ? rows - r0 : kBwdRows);

  for (int r = warp; r < nr; r += kBwdThreads / 32) {
    const T* xr = x + (r0 + r) * hidden;
    const T* dyr = dy + (r0 + r) * hidden;
    const bool vec = (hidden % Vec<T>::N == 0) &&
                     (reinterpret_cast<uintptr_t>(xr) % 16 == 0);
    float mean = 0.f;
    if constexpr (!kRms) {
      float s = 0.f;
      for_row(xr, hidden, vec, lane, [&](int, float v) { s += v; });
      mean = warp_sum(s) / hidden;
    }
    float ss = 0.f;
    for_row(xr, hidden, vec, lane, [&](int, float v) {
      const float d = v - mean;
      ss += d * d;
    });
    const float rstd = rsqrtf(warp_sum(ss) / hidden + eps);
    float a = 0.f, c = 0.f;
    for_row(xr, hidden, vec, lane, [&](int i, float v) {
      const float dyw = to_f(dyr[i]) * (w ? w[i] : 1.f);
      if constexpr (!kRms) a += dyw;
      c += dyw * ((v - mean) * rstd);
    });
    if constexpr (!kRms) a = warp_sum(a);
    c = warp_sum(c);
    if (lane == 0) {
      s_mean[r] = mean;
      s_rstd[r] = rstd;
      s_m1[r] = a / hidden;
      s_m2[r] = c / hidden;
    }
  }
  __syncthreads();

  float* part_g = part + (long)blockIdx.x * hidden;
  float* part_b = part + ((long)gridDim.x + blockIdx.x) * hidden;  // LayerNorm only
  for (int col = threadIdx.x; col < hidden; col += kBwdThreads) {
    const float wc = w ? w[col] : 1.f;
    float g = 0.f, bb = 0.f;
    for (int r = 0; r < nr; ++r) {
      const long off = (r0 + r) * hidden + col;
      const float xhat = (to_f(x[off]) - s_mean[r]) * s_rstd[r];
      const float d = to_f(dy[off]);
      dx[off] = from_f<T>((d * wc - s_m1[r] - xhat * s_m2[r]) * s_rstd[r]);
      g += d * xhat;
      if constexpr (!kRms) bb += d;
    }
    part_g[col] = g;
    if constexpr (!kRms) part_b[col] = bb;
  }
}

// out[k][col] = sum over blocks of part[k][block][col], k = 0 (dgamma), 1 (dbeta).
// A block owns 32 columns; its 8 warps each sum every 8th block's row.
__global__ void __launch_bounds__(256)
norm_bwd_sum_kernel(const float* __restrict__ part, int blocks, int hidden,
                    float* __restrict__ out) {
  __shared__ float red[8][33];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const float* p = part + (long)blockIdx.y * blocks * hidden;
  float s = 0.f;
  if (col < hidden)
    for (int b = grp; b < blocks; b += 8) s += p[(long)b * hidden + col];
  red[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && col < hidden) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][lane];
    out[(long)blockIdx.y * hidden + col] = t;
  }
}

// RMSNorm backward with its rows held in registers (rms_norm_bwd where
// hidden is a multiple of the vector, every pointer is 16-byte aligned and
// a row fits NV <= kMaxBwdRowVecs vectors a lane). A block of kRowBwdWarps
// warps owns kBwdRows consecutive rows, as norm_bwd_kernel's blocks do, and
// each warp kBwdRows / kRowBwdWarps of them, in order. For a row, every lane
// issues all its loads of x and dy (NV uint4 each, lane + 32j) before the
// first shuffle, reduces sum(x^2), then sum(dyw * xhat) from the registers
// (norm_bwd_kernel's per-lane order and rounding), and writes dx as 16-byte
// vectors: x and dy are read once and dx written once. Each lane adds
// dy * xhat for its own columns into fp32 registers over its warp's rows;
// the warps' sums then meet in shared memory, column-major, and are added in
// warp order into the block's (hidden,) partial, which norm_bwd_sum_kernel
// sums over the blocks. No atomics: a repeat call is bit-equal. At hidden
// 2048 bf16, x and dy are 32 + 32 registers a lane and the sums 64.
constexpr int kRowBwdWarps = 4;
constexpr int kMaxBwdRowVecs = 8;

template <typename T, int NV>
__global__ void __launch_bounds__(kRowBwdWarps * 32)
rms_bwd_row_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                   int rows, int hidden, float eps) {
  constexpr int N = Vec<T>::N, RW = kBwdRows / kRowBwdWarps, COLS = 32 * NV * N;
  __shared__ __align__(16) float red[kRowBwdWarps * COLS];  // each warp's column sums
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = hidden / N;
  const long r0 = (long)blockIdx.x * kBwdRows + warp * RW;
  float g[NV][N];  // dgamma of the lane's columns over the warp's rows
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int c = 0; c < N; ++c) g[j][c] = 0.f;

  for (int r = 0; r < RW && r0 + r < rows; ++r) {
    const long off = (r0 + r) * hidden;
    const uint4* xv = reinterpret_cast<const uint4*>(x + off);
    const uint4* dv = reinterpret_cast<const uint4*>(dy + off);
    uint4 xr[NV], dr[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < nvec) {
        xr[j] = xv[lane + 32 * j];
        dr[j] = dv[lane + 32 * j];
      }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < nvec) {
        const T* e = reinterpret_cast<const T*>(&xr[j]);
#pragma unroll
        for (int c = 0; c < N; ++c) ss = fmaf(to_f(e[c]), to_f(e[c]), ss);
      }
    const float rstd = rsqrtf(warp_sum(ss) / hidden + eps);
    float cs = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < nvec) {
        float wv[N];
        load_f4(wv, w, lane + 32 * j);
        const T* e = reinterpret_cast<const T*>(&xr[j]);
        const T* de = reinterpret_cast<const T*>(&dr[j]);
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const float xh = __fmul_rn(to_f(e[c]), rstd), d = to_f(de[c]);
          cs = fmaf(w ? __fmul_rn(d, wv[c]) : d, xh, cs);
          g[j][c] = fmaf(d, xh, g[j][c]);
        }
      }
    const float m2 = warp_sum(cs) / hidden;
    uint4* ov = reinterpret_cast<uint4*>(dx + off);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + 32 * j;
      if (i >= nvec) continue;
      float wv[N];
      load_f4(wv, w, i);
      const T* e = reinterpret_cast<const T*>(&xr[j]);
      const T* de = reinterpret_cast<const T*>(&dr[j]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const float xh = __fmul_rn(to_f(e[c]), rstd), d = to_f(de[c]);
        o[c] = from_f<T>(__fmul_rn(fmaf(-xh, m2, w ? __fmul_rn(d, wv[c]) : d), rstd));
      }
      ov[i] = out;
    }
  }

  float* mine = red + warp * COLS;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      reinterpret_cast<float4*>(mine)[(lane + 32 * j) * (N / 4) + c] =
          make_float4(g[j][4 * c], g[j][4 * c + 1], g[j][4 * c + 2], g[j][4 * c + 3]);
  __syncthreads();
  float* pb = part + (long)blockIdx.x * hidden;
  for (int col = threadIdx.x; col < hidden; col += kRowBwdWarps * 32) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kRowBwdWarps; ++k) sum += red[k * COLS + col];
    pb[col] = sum;
  }
}

// LayerNorm backward with its rows held in registers (layer_norm_bwd where
// hidden is a multiple of the vector, every pointer is 16-byte aligned and
// a row fits NV <= kMaxLnBwdRowVecs vectors a lane): #4's design with
// LayerNorm's mean and dbeta. A block of W warps (below) owns kBwdRows
// consecutive rows (the partial layout of norm_bwd_kernel), each warp
// kBwdRows / W of them, in order. For a row, every lane issues
// all its loads of x and dy (NV uint4 each, lane + 32j) before the first
// shuffle; the mean, then the sum of squared deviations (two passes, as
// _ln_ref), then sum(dyw) and sum(dyw * xhat) (their shuffles interleaved)
// come from the registers, and dx is written once as 16-byte vectors. Each
// lane adds dy * xhat and dy for its own columns into fp32 registers over
// its warp's rows; the warps' sums then meet in shared memory (W * 32 * NV
// * N floats, reused for dgamma, then dbeta) and are
// added in warp order into the block's two (hidden,) partials, which
// norm_bwd_sum_kernel sums over the blocks. No atomics: a repeat call is
// bit-equal.
//
// Occupancy. At GPT-2's (8192, 768) bf16 there are 256 blocks for 132 SMs,
// and blocks run two an SM. Where x, dy and the two sums fit in
// 8 * NV + 2 * NV * N <= 96 registers a lane (72 at NV = 3, 768 bf16), a
// block has eight warps of four rows each under a cap of 128 registers a
// thread: one wave, 16 warps an SM, each with its whole row's loads in
// flight. Wider rows take four warps of eight rows (8 warps an SM, up to
// 255 registers a thread), which at 1600 and 2048 bf16 ran 11% and 6%
// faster than eight warps at one block an SM. Every NV up to
// kMaxLnBwdRowVecs compiles with no spills (nvcc -Xptxas -v).
constexpr int kMaxLnBwdRowVecs = 8;

template <typename T, int NV>
struct LnBwdRow {
  static constexpr int kRegs = 8 * NV + 2 * NV * Vec<T>::N;
  static constexpr int kWarps = kRegs <= 96 ? 8 : 4;
  static constexpr int kCols = 32 * NV * Vec<T>::N;  // a warp's columns
};

// Every warp's NV x N column sums c into red, then into the block's
// (hidden,) partial out, each column the sum over the warps in order.
template <typename T, int NV>
__device__ __forceinline__ void block_col_sum(float* red, const float (&c)[NV][Vec<T>::N],
                                              float* __restrict__ out, int hidden) {
  constexpr int N = Vec<T>::N, COLS = LnBwdRow<T, NV>::kCols, W = LnBwdRow<T, NV>::kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float4* mine = reinterpret_cast<float4*>(red + warp * COLS);
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      mine[(lane + 32 * j) * (N / 4) + q] =
          make_float4(c[j][4 * q], c[j][4 * q + 1], c[j][4 * q + 2], c[j][4 * q + 3]);
  __syncthreads();
  for (int col = threadIdx.x; col < hidden; col += W * 32) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) sum += red[k * COLS + col];
    out[col] = sum;
  }
  __syncthreads();  // red is written again by the next call
}

template <typename T, int NV>
__global__ void __launch_bounds__(LnBwdRow<T, NV>::kWarps * 32, 2)
ln_bwd_row_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                  int rows, int hidden, float eps) {
  constexpr int N = Vec<T>::N, W = LnBwdRow<T, NV>::kWarps, RW = kBwdRows / W;
  __shared__ __align__(16) float red[W * LnBwdRow<T, NV>::kCols];  // <= 32 KB
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = hidden / N;
  const long r0 = (long)blockIdx.x * kBwdRows + warp * RW;
  float g[NV][N], bs[NV][N];  // dgamma, dbeta of the lane's columns over the warp's rows
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int c = 0; c < N; ++c) g[j][c] = bs[j][c] = 0.f;

  for (int r = 0; r < RW && r0 + r < rows; ++r) {
    const long off = (r0 + r) * hidden;
    const uint4* xv = reinterpret_cast<const uint4*>(x + off);
    const uint4* dv = reinterpret_cast<const uint4*>(dy + off);
    uint4 xr[NV], dr[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < nvec) {
        xr[j] = xv[lane + 32 * j];
        dr[j] = dv[lane + 32 * j];
      }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < nvec) {
        const T* e = reinterpret_cast<const T*>(&xr[j]);
#pragma unroll
        for (int c = 0; c < N; ++c) s += to_f(e[c]);
      }
    const float mean = warp_sum(s) / hidden;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < nvec) {
        const T* e = reinterpret_cast<const T*>(&xr[j]);
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const float d = to_f(e[c]) - mean;
          ss = fmaf(d, d, ss);
        }
      }
    const float rstd = rsqrtf(warp_sum(ss) / hidden + eps);
    float a = 0.f, cs = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < nvec) {
        float wv[N];
        load_f4(wv, w, lane + 32 * j);
        const T* e = reinterpret_cast<const T*>(&xr[j]);
        const T* de = reinterpret_cast<const T*>(&dr[j]);
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const float xh = __fmul_rn(to_f(e[c]) - mean, rstd), d = to_f(de[c]);
          const float dyw = w ? __fmul_rn(d, wv[c]) : d;
          a += dyw;
          cs = fmaf(dyw, xh, cs);
          g[j][c] = fmaf(d, xh, g[j][c]);
          bs[j][c] += d;
        }
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      cs += __shfl_xor_sync(0xffffffffu, cs, o);
    }
    const float m1 = a / hidden, m2 = cs / hidden;
    uint4* ov = reinterpret_cast<uint4*>(dx + off);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = lane + 32 * j;
      if (i >= nvec) continue;
      float wv[N];
      load_f4(wv, w, i);
      const T* e = reinterpret_cast<const T*>(&xr[j]);
      const T* de = reinterpret_cast<const T*>(&dr[j]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const float xh = __fmul_rn(to_f(e[c]) - mean, rstd), d = to_f(de[c]);
        const float dyw = w ? __fmul_rn(d, wv[c]) : d;
        o[c] = from_f<T>(__fmul_rn(fmaf(-xh, m2, dyw - m1), rstd));
      }
      ov[i] = out;
    }
  }

  block_col_sum<T, NV>(red, g, part + (long)blockIdx.x * hidden, hidden);
  block_col_sum<T, NV>(red, bs, part + ((long)gridDim.x + blockIdx.x) * hidden, hidden);
}

// The fixed-order sums of the `sums` (blocks, hidden) partials, once the
// kernel that wrote them has launched.
int launch_sum(float* part, float* out, int blocks, int hidden, int sums, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_bwd_sum_kernel<<<dim3((hidden + 31) / 32, sums), 256, 0, stream>>>(part, blocks, hidden,
                                                                        out);
  return (int)cudaGetLastError();
}

template <typename T, bool kRms>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx, float* part,
               float* out, int rows, int hidden, float eps, cudaStream_t stream) {
  const int blocks = (rows + kBwdRows - 1) / kBwdRows;
  norm_bwd_kernel<T, kRms><<<blocks, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, hidden, eps);
  return launch_sum(part, out, blocks, hidden, kRms ? 1 : 2, stream);
}

template <typename T, int NV>
int launch_rms_bwd_row(const void* x, const void* w, const void* dy, void* dx, float* part,
                       float* out, int rows, int hidden, float eps, cudaStream_t stream) {
  const int blocks = (rows + kBwdRows - 1) / kBwdRows;
  rms_bwd_row_kernel<T, NV><<<blocks, kRowBwdWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, hidden, eps);
  return launch_sum(part, out, blocks, hidden, 1, stream);
}

template <typename T, int NV>
int launch_ln_bwd_row(const void* x, const void* w, const void* dy, void* dx, float* part,
                      float* out, int rows, int hidden, float eps, cudaStream_t stream) {
  const int blocks = (rows + kBwdRows - 1) / kBwdRows;
  ln_bwd_row_kernel<T, NV><<<blocks, LnBwdRow<T, NV>::kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, hidden, eps);
  return launch_sum(part, out, blocks, hidden, 2, stream);
}

// ln_bwd_row_kernel at the least NV >= per_lane (per_lane <= kMaxLnBwdRowVecs).
template <typename T, int NV = 1>
int launch_ln_bwd_rows(int per_lane, const void* x, const void* w, const void* dy, void* dx,
                       float* part, float* out, int rows, int hidden, float eps,
                       cudaStream_t s) {
  if constexpr (NV < kMaxLnBwdRowVecs) {
    if (per_lane > NV)
      return launch_ln_bwd_rows<T, NV + 1>(per_lane, x, w, dy, dx, part, out, rows, hidden,
                                           eps, s);
  }
  return launch_ln_bwd_row<T, NV>(x, w, dy, dx, part, out, rows, hidden, eps, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The LayerNorm backward: the register-resident rows where the shape
// allows, else norm_bwd_kernel (hidden not a multiple of the vector, an
// unaligned pointer, or more than kMaxLnBwdRowVecs vectors a lane).
template <typename T>
int launch_ln_bwd(const void* x, const void* w, const void* dy, void* dx, float* part,
                  float* out, int rows, int hidden, float eps, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  const int per_lane = (hidden / N + 31) / 32;
  if (hidden % N != 0 || !aligned16(x) || !aligned16(w) || !aligned16(dy) || !aligned16(dx) ||
      per_lane > kMaxLnBwdRowVecs)
    return launch_bwd<T, false>(x, w, dy, dx, part, out, rows, hidden, eps, s);
  return launch_ln_bwd_rows<T>(per_lane, x, w, dy, dx, part, out, rows, hidden, eps, s);
}

// The RMSNorm backward: the register-resident rows where the shape allows,
// else norm_bwd_kernel (hidden not a multiple of the vector, an unaligned
// pointer, or more than kMaxBwdRowVecs vectors a lane).
template <typename T>
int launch_rms_bwd(const void* x, const void* w, const void* dy, void* dx, float* part,
                   float* out, int rows, int hidden, float eps, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  const int per_lane = (hidden / N + 31) / 32;
  if (hidden % N != 0 || !aligned16(x) || !aligned16(w) || !aligned16(dy) || !aligned16(dx) ||
      per_lane > kMaxBwdRowVecs)
    return launch_bwd<T, true>(x, w, dy, dx, part, out, rows, hidden, eps, s);
  if (per_lane <= 1) return launch_rms_bwd_row<T, 1>(x, w, dy, dx, part, out, rows, hidden, eps, s);
  if (per_lane <= 2) return launch_rms_bwd_row<T, 2>(x, w, dy, dx, part, out, rows, hidden, eps, s);
  if (per_lane <= 4) return launch_rms_bwd_row<T, 4>(x, w, dy, dx, part, out, rows, hidden, eps, s);
  return launch_rms_bwd_row<T, 8>(x, w, dy, dx, part, out, rows, hidden, eps, s);
}

// The forwards: the register-resident row where the shape allows, else
// the loop of norm_fwd_kernel (hidden not a multiple of the vector, an
// unaligned pointer, or more than kMaxRowVecs vectors a lane).
constexpr int kMaxRowVecs = 16;  // 64 registers a lane: hidden <= 4096 bf16

template <typename T, int NV, bool kRms>
int launch_row(const void* x, const void* w, const void* b, void* y, int rows, int hidden,
               float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  norm_fwd_row_kernel<T, NV, kRms><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), rows, hidden, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool kRms>
int launch_fwd(const void* x, const void* w, const void* b, void* y, int rows, int hidden,
               float eps, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  const int per_lane = (hidden / N + 31) / 32;
  if (hidden % N != 0 || !aligned16(x) || !aligned16(y) || !aligned16(w) || !aligned16(b) ||
      per_lane > kMaxRowVecs)
    return launch<T, kRms>(x, w, b, y, rows, hidden, eps, s);
  if (per_lane <= 1) return launch_row<T, 1, kRms>(x, w, b, y, rows, hidden, eps, s);
  if (per_lane <= 2) return launch_row<T, 2, kRms>(x, w, b, y, rows, hidden, eps, s);
  if (per_lane <= 4) return launch_row<T, 4, kRms>(x, w, b, y, rows, hidden, eps, s);
  if (per_lane <= 8) return launch_row<T, 8, kRms>(x, w, b, y, rows, hidden, eps, s);
  return launch_row<T, kMaxRowVecs, kRms>(x, w, b, y, rows, hidden, eps, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. w and b are fp32 (hidden,) or null.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                              int rows, int hidden, float eps, int dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float, false>(x, w, b, y, rows, hidden, eps, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16, false>(x, w, b, y, rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The forwards' loop (norm_fwd_kernel) on any input, where layer_norm_fwd
// and rms_norm_fwd would take the register-resident row: the card checks
// hold the row bit-equal to it. rms: 0 = LayerNorm, 1 = RMSNorm (b unused).
extern "C" int norm_fwd_loop(const void* x, const void* w, const void* b, void* y, int rows,
                             int hidden, float eps, int rms, int dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rms ? launch<float, true>(x, w, nullptr, y, rows, hidden, eps, s)
               : launch<float, false>(x, w, b, y, rows, hidden, eps, s);
  if (dtype == 1)
    return rms ? launch<__nv_bfloat16, true>(x, w, nullptr, y, rows, hidden, eps, s)
               : launch<__nv_bfloat16, false>(x, w, b, y, rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}

// x, dy, dx: (rows, hidden) in the dtype's type; w: fp32 (hidden,) or null
// (then w = 1). part: fp32 scratch of (2, part_blocks, hidden) with
// part_blocks = ceil(rows / 32); out: fp32 (2, hidden) = (dgamma, dbeta).
// Returns the cudaError_t of the launches (0 = success). With `loop` set,
// the loop (norm_bwd_kernel) runs whatever the shape.
static int ln_bwd(const void* x, const void* w, const void* dy, void* dx, void* part,
                  void* out, int rows, int hidden, int part_blocks, float eps, int dtype,
                  bool loop, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hidden <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (part_blocks != (rows + kBwdRows - 1) / kBwdRows) return (int)cudaErrorInvalidValue;
  if (rows == 0)
    return (int)cudaMemsetAsync(out, 0, 2 * sizeof(float) * (size_t)hidden, s);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return loop ? launch_bwd<float, false>(x, w, dy, dx, p, o, rows, hidden, eps, s)
                : launch_ln_bwd<float>(x, w, dy, dx, p, o, rows, hidden, eps, s);
  if (dtype == 1)
    return loop ? launch_bwd<__nv_bfloat16, false>(x, w, dy, dx, p, o, rows, hidden, eps, s)
                : launch_ln_bwd<__nv_bfloat16>(x, w, dy, dx, p, o, rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int layer_norm_bwd(const void* x, const void* w, const void* dy, void* dx,
                              void* part, void* out, int rows, int hidden, int part_blocks,
                              float eps, int dtype, void* stream) {
  return ln_bwd(x, w, dy, dx, part, out, rows, hidden, part_blocks, eps, dtype, false, stream);
}

// layer_norm_bwd through the loop on any input, where layer_norm_bwd would
// take the register-resident rows: the card checks and timings compare the
// two.
extern "C" int layer_norm_bwd_loop(const void* x, const void* w, const void* dy, void* dx,
                                   void* part, void* out, int rows, int hidden,
                                   int part_blocks, float eps, int dtype, void* stream) {
  return ln_bwd(x, w, dy, dx, part, out, rows, hidden, part_blocks, eps, dtype, true, stream);
}

// dtype: 0 = float32, 1 = bfloat16. w is fp32 (hidden,) or null (w = 1).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, int rows, int hidden,
                            float eps, int dtype, void* stream) {
  if (rows == 0) return 0;
  if (hidden <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float, true>(x, w, nullptr, y, rows, hidden, eps, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16, true>(x, w, nullptr, y, rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}

// x, dy, dx: (rows, hidden) in the dtype's type; w: fp32 (hidden,) or null
// (then w = 1). part: fp32 scratch of (part_blocks, hidden) with
// part_blocks = ceil(rows / 32); out: fp32 (hidden,) = dgamma.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* dy, void* dx,
                            void* part, void* out, int rows, int hidden, int part_blocks,
                            float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hidden <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (part_blocks != (rows + kBwdRows - 1) / kBwdRows) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaMemsetAsync(out, 0, sizeof(float) * (size_t)hidden, s);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_rms_bwd<float>(x, w, dy, dx, p, o, rows, hidden, eps, s);
  if (dtype == 1)
    return launch_rms_bwd<__nv_bfloat16>(x, w, dy, dx, p, o, rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}
