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
// RMSNorm's forward takes rms_fwd_row_kernel (below) wherever the row fits
// a warp's registers: it reads each row from HBM once, where the loop here
// reads it twice.
//
// Design: one warp per row, eight rows per 256-thread block, so a row's
// reductions are warp shuffles with no shared memory and no __syncthreads.
// Loads and stores are 16-byte vectors when the row is 16-byte aligned (any
// hidden that is a multiple of 8 bf16 or 4 fp32 elements), scalar otherwise,
// so every hidden size and row count is taken; the TPU kernel's
// hidden % 128 fallback, 8-row padding and VMEM block budget do not apply.
// Mean and variance are two passes (sum, then sum of squared deviations),
// as _ln_ref computes them; the second and third reads of a row hit L1,
// since a warp's row (at most a few KB) is still resident.

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
    ss += d * d;
  });
  const float rstd = rsqrtf(warp_sum(ss) / hidden + eps);

  auto norm = [&](int i, float v) {
    float o = (v - mean) * rstd;
    if (w) o *= w[i];
    if (b) o += b[i];
    return from_f<T>(o);
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

// RMSNorm forward with the row held in registers (rms_norm_fwd when hidden
// is a multiple of 8 bf16 or 4 fp32 elements, the pointers are 16-byte
// aligned and the row fits NV 16-byte vectors a lane). A warp owns a row:
// every lane issues all its loads (NV uint4, lane + 32j) before the sum of
// squares, reduces it by shuffles, and normalises from the registers, so
// the row is read from HBM once; w comes as float4. At hidden 2048 bf16 that
// is 8 uint4 a lane.
template <typename T, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rms_fwd_row_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                   int rows, int hidden, float eps) {
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
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (lane + 32 * j < nvec) {
      const T* e = reinterpret_cast<const T*>(&r[j]);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float v = to_f(e[i]);
        ss += v * v;
      }
    }
  const float rstd = rsqrtf(warp_sum(ss) / hidden + eps);
  uint4* yv = reinterpret_cast<uint4*>(y + row * hidden);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = lane + 32 * j;
    if (i >= nvec) continue;
    float wv[N];
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 f = w ? reinterpret_cast<const float4*>(w)[i * (N / 4) + c]
                         : make_float4(1.f, 1.f, 1.f, 1.f);
      wv[4 * c] = f.x;
      wv[4 * c + 1] = f.y;
      wv[4 * c + 2] = f.z;
      wv[4 * c + 3] = f.w;
    }
    const T* e = reinterpret_cast<const T*>(&r[j]);
    uint4 out;
    T* ov = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int c = 0; c < N; ++c) ov[c] = from_f<T>(to_f(e[c]) * rstd * wv[c]);
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
// Every row count and hidden size works; there is no padding.

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

template <typename T, bool kRms>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx, float* part,
               float* out, int rows, int hidden, float eps, cudaStream_t stream) {
  const int blocks = (rows + kBwdRows - 1) / kBwdRows;
  norm_bwd_kernel<T, kRms><<<blocks, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, hidden, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hidden + 31) / 32, kRms ? 1 : 2);
  norm_bwd_sum_kernel<<<grid, 256, 0, stream>>>(part, blocks, hidden, out);
  return (int)cudaGetLastError();
}

// The RMSNorm forward: the register-resident row where the shape allows,
// else the loop of norm_fwd_kernel (hidden not a multiple of the vector, an
// unaligned pointer, or more than kMaxRowVecs vectors a lane).
constexpr int kMaxRowVecs = 16;  // 64 registers a lane: hidden <= 4096 bf16

template <typename T, int NV>
int launch_row(const void* x, const void* w, void* y, int rows, int hidden, float eps,
               cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rms_fwd_row_kernel<T, NV><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y), rows, hidden,
      eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rms(const void* x, const void* w, void* y, int rows, int hidden, float eps,
               cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int per_lane = (hidden / N + 31) / 32;
  if (hidden % N != 0 || !aligned(x) || !aligned(y) || !aligned(w) || per_lane > kMaxRowVecs)
    return launch<T, true>(x, w, nullptr, y, rows, hidden, eps, s);
  if (per_lane <= 1) return launch_row<T, 1>(x, w, y, rows, hidden, eps, s);
  if (per_lane <= 2) return launch_row<T, 2>(x, w, y, rows, hidden, eps, s);
  if (per_lane <= 4) return launch_row<T, 4>(x, w, y, rows, hidden, eps, s);
  if (per_lane <= 8) return launch_row<T, 8>(x, w, y, rows, hidden, eps, s);
  return launch_row<T, kMaxRowVecs>(x, w, y, rows, hidden, eps, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. w and b are fp32 (hidden,) or null.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                              int rows, int hidden, float eps, int dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, false>(x, w, b, y, rows, hidden, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16, false>(x, w, b, y, rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}

// x, dy, dx: (rows, hidden) in the dtype's type; w: fp32 (hidden,) or null
// (then w = 1). part: fp32 scratch of (2, part_blocks, hidden) with
// part_blocks = ceil(rows / 32); out: fp32 (2, hidden) = (dgamma, dbeta).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int layer_norm_bwd(const void* x, const void* w, const void* dy, void* dx,
                              void* part, void* out, int rows, int hidden, int part_blocks,
                              float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hidden <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (part_blocks != (rows + kBwdRows - 1) / kBwdRows) return (int)cudaErrorInvalidValue;
  if (rows == 0)
    return (int)cudaMemsetAsync(out, 0, 2 * sizeof(float) * (size_t)hidden, s);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_bwd<float, false>(x, w, dy, dx, p, o, rows, hidden, eps, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, false>(x, w, dy, dx, p, o, rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. w is fp32 (hidden,) or null (w = 1).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, int rows, int hidden,
                            float eps, int dtype, void* stream) {
  if (rows == 0) return 0;
  if (hidden <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_rms<float>(x, w, y, rows, hidden, eps, s);
  if (dtype == 1) return launch_rms<__nv_bfloat16>(x, w, y, rows, hidden, eps, s);
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
  if (dtype == 0) return launch_bwd<float, true>(x, w, dy, dx, p, o, rows, hidden, eps, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16, true>(x, w, dy, dx, p, o, rows, hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}
