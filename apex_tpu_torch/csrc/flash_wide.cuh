// Flash attention past head_dim 256 (the wide route): the pieces that the
// forward (flash_attention.cu, flash_fwd_wide) and the backward
// (flash_attention_bwd.cu, flash_bwd_dq_wide and flash_bwd_dkv_wide) share.
//
// Past 256 the register file holds neither a row's fp32 accumulator nor its
// Q fragments, and no fixed tile of the whole head_dim fits shared memory
// for every d. So each block owns OC of the output's head_dim columns (of o,
// dq, or dk and dv), and ceil(d / OC) blocks share one tile of rows, the
// split the bf16 dk/dv kernel makes at d = 256 (the FlashAttention-2 route).
// Each of them computes the score products of its tile (q.k and, in the
// backward, dO.v) over the whole head_dim, accumulated over HC-wide chunks
// of it that pass through shared memory one after another (wide_dot). The
// products are scalar FMAs in fp32 in both dtypes: bf16 inputs are widened
// as they are staged, and p and ds are rounded to the input dtype only as
// the operands of the later products, as in the other kernels. Inputs are
// read element by element, so any d works, a multiple of 8 or not. Thread
// (tr, tc) = (t / 8, t % 8) of the block's 128 owns rows tr * RP.. and the
// columns tc + 8j of each tile, as in the scalar fp32 kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace flash_wide {

using namespace flash_mma;

constexpr int HC = 64;      // head_dim columns of a staged chunk
constexpr int HS = HC + 1;  // a chunk's row stride in floats (no bank read twice)

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: p and ds as operands
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return widen(narrow<T>(x));
}

// dst[r][c] = src[row0 + r][c0 + c] for r < ROWS, c < W, widened to fp32 into
// a tile of row stride LDS floats; zero past the rows' or the head_dim's
// edge. src rows hold d elements.
template <typename T, int ROWS, int W, int LDS>
__device__ __forceinline__ void load_cols(float* dst, const T* __restrict__ src, long long row0,
                                          long long nrows, int c0, int d) {
  for (int e = threadIdx.x; e < ROWS * W; e += kThreads) {
    const int r = e / W, c = e % W;
    dst[r * LDS + c] =
        (row0 + r < nrows && c0 + c < d) ? widen(src[(row0 + r) * d + c0 + c]) : 0.f;
  }
}

// out[i][j] = a[a0 + tr * RP + i] . b[b0 + tc + 8j] over the whole head_dim,
// for RA rows of a (of na) and RB rows of b (of nb): HC columns at a time
// through sA (RA x HS floats) and sB (RB x HS). Rows past na or nb score 0.
// Every thread of the block takes part; on return sA and sB may be reused
// after a __syncthreads().
template <typename T, int RA, int RB>
__device__ __forceinline__ void wide_dot(const T* __restrict__ a, long long a0, long long na,
                                         const T* __restrict__ b, long long b0, long long nb,
                                         int d, float* sA, float* sB, int tr, int tc,
                                         float (&out)[RA / 16][RB / 8]) {
  constexpr int RP = RA / 16, CP = RB / 8;
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < CP; ++j) out[i][j] = 0.f;
  for (int c0 = 0; c0 < d; c0 += HC) {
    __syncthreads();  // the previous chunk (or the caller's tiles) is read no more
    load_cols<T, RA, HC, HS>(sA, a, a0, na, c0, d);
    load_cols<T, RB, HC, HS>(sB, b, b0, nb, c0, d);
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < HC; ++cc) {
      float x[RP], y[CP];
#pragma unroll
      for (int i = 0; i < RP; ++i) x[i] = sA[(tr * RP + i) * HS + cc];
#pragma unroll
      for (int j = 0; j < CP; ++j) y[j] = sB[(tc + 8 * j) * HS + cc];
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < CP; ++j) out[i][j] = fmaf(x[i], y[j], out[i][j]);
    }
  }
}

}  // namespace flash_wide
