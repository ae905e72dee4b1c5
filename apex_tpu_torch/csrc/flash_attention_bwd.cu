// Flash-attention backward for Hopper (sm_90a): two kernels.
//
// flash_bwd_dq_kernel replaces apex_tpu/ops/attention.py:_flash_bwd_dq_kernel
// and flash_bwd_dkv_kernel replaces _flash_bwd_dkv_kernel (both called through
// _flash_bwd). Both recompute the probabilities from the forward's fp32
// log-sum-exp instead of storing them (the standard flash recompute):
//   p  = exp(q.k * scale - lse)          (0 where masked)
//   dp = dO.v,  ds = p * (dp - delta) * scale,   delta = rowsum(dO * o)
//   dq = ds.k,  dk = ds^T.q,  dv = p^T.dO
// delta is computed by the caller in plain torch, as _flash_bwd computes it
// outside its kernels. Same contract as the forward (flash_attention.cu):
// causal and sliding-window bands bottom-right aligned (query row r sits at
// key position r + sk - sq, so sq != sk is handled), the int32 (b, sk)
// key-padding row (1 = padded), GQA with kv row = bh / group. A row whose
// keys are all masked has lse = +1e30, so exp(s - 1e30) = 0 and it adds
// nothing to dq, dk or dv. Like the TPU kernels, p is rounded to the input
// dtype before p^T.dO and ds before the dq and dk products; scores, dp and
// every accumulator are fp32.
//
// What bounds it on the card: operations. About 5 products of
// sq * sk * d multiply-adds per head (the score recompute twice, dp twice,
// dq, dk, dv; halved by the causal skip) against roughly 4 reads of q, k,
// v, dO and 3 writes; this first version computes with scalar fp32 FMAs from
// shared memory, far below the tensor-core bound. It is the exact, simple
// baseline that an mma.sync / wgmma version will be measured against.
//
// Design. 128 threads per block; tiles of 64 query rows by 64 keys, staged
// in shared memory as fp32; thread (tr, tc) = (t / 8, t % 8) owns 4 rows and
// the columns tc + 8j, as in the forward.
// - dq: grid (q tiles, batch*heads). The block keeps its Q and dO tiles and
//   loops over the key tiles in its causal/window band, accumulating dq in
//   registers; dq is written once.
// - dk/dv: grid (key tiles, batch*kv_heads). The block keeps its K and V
//   tiles and loops, for each query head of its GQA group in turn, over the
//   query tiles in the band that sees its keys (the transpose of the dq
//   band, _q_band in the JAX package). dk and dv accumulate over the whole
//   group in registers and are written once: no per-q-head partials, no
//   atomics, and a fixed summation order, so repeated calls are bit-equal.
// Ragged sq and sk edges are masked in both kernels; head_dim <= 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kB = 64;       // query rows and keys per tile
constexpr int RP = kB / 16;  // rows per thread
constexpr int CP = kB / 8;   // tile columns per thread

__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }
__device__ __forceinline__ long long lmax(long long a, long long b) { return a > b ? a : b; }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T and back (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <int DMAX> struct Smem {
  static constexpr int S = DMAX + 1;  // row stride of a (64, head_dim) tile
  static constexpr int PS = kB + 1;   // row stride of a (64, 64) tile
  // dq: Q, dO, K, V tiles, dS, lse, delta
  static constexpr size_t dq_bytes = (4 * kB * S + kB * PS + 2 * kB) * sizeof(float);
  // dk/dv: K, V, Q, dO tiles, P, dS, lse, delta
  static constexpr size_t dkv_bytes = (4 * kB * S + 2 * kB * PS + 2 * kB) * sizeof(float);
};

// dst[r][c] = src[row0 + r][c] for the 64 rows of a tile (zero past the
// edges), src rows of d elements.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long row0,
                                          long long nrows, int d) {
  for (int e = threadIdx.x; e < kB * DMAX; e += kThreads) {
    const int r = e / DMAX, c = e % DMAX;
    dst[r * (DMAX + 1) + c] =
        (row0 + r < nrows && c < d) ? to_f(src[(row0 + r) * d + c]) : 0.f;
  }
}

// out[i][j] = sum over dd of A[tr*RP + i][dd] * B[tc + 8j][dd]
template <int DMAX>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int d, int tr, int tc,
                                         float (&out)[RP][CP]) {
  constexpr int S = DMAX + 1;
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < CP; ++j) out[i][j] = 0.f;
  for (int dd = 0; dd < d; ++dd) {
    float a[RP], b[CP];
#pragma unroll
    for (int i = 0; i < RP; ++i) a[i] = A[(tr * RP + i) * S + dd];
#pragma unroll
    for (int j = 0; j < CP; ++j) b[j] = B[(tc + 8 * j) * S + dd];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < CP; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

// Does query row `row` (of sq) attend key `col` (of sk)? key_ok covers the
// key-padding row and the sk edge.
__device__ __forceinline__ bool attends(long long row, long long col, bool key_ok, int sq,
                                        long long offs, int causal, int window) {
  bool keep = key_ok && row < sq;
  if (causal) {
    const long long pos = row + offs;
    keep = keep && col <= pos;
    if (window > 0) keep = keep && col > pos - window;
  }
  return keep;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dO, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ kpm,
                    T* __restrict__ dq, int sq, int sk, int d, int heads, int group,
                    float scale, int causal, int window) {
  constexpr int S = DMAX + 1, PS = kB + 1, DP = DMAX / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kB * S;
  float* sK = sdO + kB * S;
  float* sV = sK + kB * S;
  float* sDS = sV + kB * S;
  float* sL = sDS + kB * PS;
  float* sD = sL + kB;

  const int t = threadIdx.x, tr = t >> 3, tc = t & 7;
  const int q0 = blockIdx.x * kB;
  const long long bh = blockIdx.y, kvh = bh / group;
  const long long offs = (long long)sk - sq;
  const int* kpm_row = kpm ? kpm + (bh / heads) * sk : nullptr;

  load_tile<T, DMAX>(sQ, q + bh * sq * d, q0, sq, d);
  load_tile<T, DMAX>(sdO, dO + bh * sq * d, q0, sq, d);
  for (int r = t; r < kB; r += kThreads) {
    const bool in = q0 + r < sq;
    sL[r] = in ? lse[bh * sq + q0 + r] : -kNegInf;
    sD[r] = in ? delta[bh * sq + q0 + r] : 0.f;
  }

  // the key range this tile can see, as in the forward
  long long k_lo = 0, k_hi = sk;
  if (causal) {
    const long long last_row = lmin(q0 + kB, sq) - 1;
    k_hi = lmax(0, lmin(sk, last_row + offs + 1));
    if (window > 0) k_lo = lmax(0, q0 + offs - window + 1);
  }
  const int t_lo = (int)(k_lo / kB), t_hi = (int)((k_hi + kB - 1) / kB);

  float acc[RP][DP];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[i][c] = 0.f;

  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's sK/sV/sDS are no longer read
    load_tile<T, DMAX>(sK, k + kvh * sk * d, k0, sk, d);
    load_tile<T, DMAX>(sV, v + kvh * sk * d, k0, sk, d);
    __syncthreads();

    float s[RP][CP], dp[RP][CP];
    tile_dot<DMAX>(sQ, sK, d, tr, tc, s);
    tile_dot<DMAX>(sdO, sV, d, tr, tc, dp);
    bool key_ok[CP];
#pragma unroll
    for (int j = 0; j < CP; ++j) {
      const int col = k0 + tc + 8 * j;
      key_ok[j] = col < sk && (kpm_row == nullptr || kpm_row[col] == 0);
    }
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const int r = tr * RP + i;
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        const long long col = k0 + tc + 8 * j;
        float ds = 0.f;
        if (attends(q0 + r, col, key_ok[j], sq, offs, causal, window)) {
          const float p = expf(s[i][j] * scale - sL[r]);
          ds = p * (dp[i][j] - sD[r]) * scale;
        }
        sDS[r * PS + tc + 8 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

    const int kmax = min(kB, sk - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[RP], b[DP];
#pragma unroll
      for (int i = 0; i < RP; ++i) a[i] = sDS[(tr * RP + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DP; ++c) b[c] = sK[kk * S + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int row = q0 + tr * RP + i;
    if (row >= sq) continue;
    T* out = dq + (bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      const int col = tc + 8 * c;
      if (col < d) out[col] = from_f<T>(acc[i][c]);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dO, const float* __restrict__ lse,
                     const float* __restrict__ delta, const int* __restrict__ kpm,
                     T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int d,
                     int heads, int group, float scale, int causal, int window) {
  constexpr int S = DMAX + 1, PS = kB + 1, DP = DMAX / 8;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kB * S;
  float* sQ = sV + kB * S;
  float* sdO = sQ + kB * S;
  float* sP = sdO + kB * S;
  float* sDS = sP + kB * PS;
  float* sL = sDS + kB * PS;
  float* sD = sL + kB;

  const int t = threadIdx.x, tr = t >> 3, tc = t & 7;
  const int k0 = blockIdx.x * kB;
  const long long kvr = blockIdx.y;  // (batch, kv head) row of k and v
  const long long offs = (long long)sk - sq;
  const int* kpm_row = kpm ? kpm + (kvr * group / heads) * sk : nullptr;

  load_tile<T, DMAX>(sK, k + kvr * sk * d, k0, sk, d);
  load_tile<T, DMAX>(sV, v + kvr * sk * d, k0, sk, d);
  bool key_ok[CP];
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const int col = k0 + tc + 8 * j;
    key_ok[j] = col < sk && (kpm_row == nullptr || kpm_row[col] == 0);
  }

  // the query rows that can see a key of this tile (_q_band)
  long long q_lo = 0, q_hi = sq;
  if (causal) {
    q_lo = lmax(0, k0 - offs);
    if (window > 0) q_hi = lmax(0, lmin(sq, (long long)k0 + kB - 1 - offs + window));
  }
  const int t_lo = (int)(q_lo / kB), t_hi = (int)((q_hi + kB - 1) / kB);

  float acc_k[RP][DP], acc_v[RP][DP];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int c = 0; c < DP; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const long long bh = kvr * group + g;
    for (int qt = t_lo; qt < t_hi; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous tile's sQ/sdO/sP/sDS are no longer read
      load_tile<T, DMAX>(sQ, q + bh * sq * d, q0, sq, d);
      load_tile<T, DMAX>(sdO, dO + bh * sq * d, q0, sq, d);
      for (int r = t; r < kB; r += kThreads) {
        const bool in = q0 + r < sq;
        sL[r] = in ? lse[bh * sq + q0 + r] : -kNegInf;
        sD[r] = in ? delta[bh * sq + q0 + r] : 0.f;
      }
      __syncthreads();

      // scores with rows = queries tr*RP + i, columns = keys tc + 8j
      float s[RP][CP], dp[RP][CP];
      tile_dot<DMAX>(sQ, sK, d, tr, tc, s);
      tile_dot<DMAX>(sdO, sV, d, tr, tc, dp);
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int r = tr * RP + i;
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          float p = 0.f, ds = 0.f;
          if (attends(q0 + r, k0 + tc + 8 * j, key_ok[j], sq, offs, causal, window)) {
            p = expf(s[i][j] * scale - sL[r]);
            ds = p * (dp[i][j] - sD[r]) * scale;
          }
          sP[r * PS + tc + 8 * j] = round_to<T>(p);
          sDS[r * PS + tc + 8 * j] = round_to<T>(ds);
        }
      }
      __syncthreads();

      // accumulate with rows = keys tr*RP + i, columns = head dims tc + 8c
      const int qmax = min(kB, sq - q0);
      for (int qq = 0; qq < qmax; ++qq) {
        float pk[RP], dsk[RP], o[DP], qv[DP];
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          pk[i] = sP[qq * PS + tr * RP + i];
          dsk[i] = sDS[qq * PS + tr * RP + i];
        }
#pragma unroll
        for (int c = 0; c < DP; ++c) {
          o[c] = sdO[qq * S + tc + 8 * c];
          qv[c] = sQ[qq * S + tc + 8 * c];
        }
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int c = 0; c < DP; ++c) {
            acc_v[i][c] = fmaf(pk[i], o[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(dsk[i], qv[c], acc_k[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int key = k0 + tr * RP + i;
    if (key >= sk) continue;
    T* ko = dk + (kvr * sk + key) * d;
    T* vo = dv + (kvr * sk + key) * d;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      const int col = tc + 8 * c;
      if (col < d) {
        ko[col] = from_f<T>(acc_k[i][c]);
        vo[col] = from_f<T>(acc_v[i][c]);
      }
    }
  }
}

// Raises the dynamic shared-memory limit of `kernel` once per instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

struct Args {
  const void *q, *k, *v, *dO;
  const float *lse, *delta;
  const int* kpm;
  int bh, sq, sk, d, heads, group;
  float scale;
  int causal, window;
};

template <typename T, int DMAX>
int launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dq_kernel<T, DMAX>;
  const size_t smem = Smem<DMAX>::dq_bytes;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + kB - 1) / kB, a.bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), a.lse, a.delta, a.kpm, static_cast<T*>(dq), a.sq, a.sk,
      a.d, a.heads, a.group, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dkv_kernel<T, DMAX>;
  const size_t smem = Smem<DMAX>::dkv_bytes;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sk + kB - 1) / kB, a.bh / a.group);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), a.lse, a.delta, a.kpm, static_cast<T*>(dk),
      static_cast<T*>(dv), a.sq, a.sk, a.d, a.heads, a.group, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

bool bad_args(const Args& a) {
  return a.d < 1 || a.d > 128 || a.bh > 65535 || a.group < 1 || a.heads < 1 ||
         a.bh % a.group != 0 || a.sq < 0 || a.sk < 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* dO, const void* lse,
               const void* delta, const void* kpm, int bh, int sq, int sk, int d, int heads,
               int group, float scale, int causal, int window) {
  return Args{q, k, v, dO, static_cast<const float*>(lse), static_cast<const float*>(delta),
              static_cast<const int*>(kpm), bh, sq, sk, d, heads, group, scale, causal, window};
}

}  // namespace

// q, dO, dq: (bh, sq, d); k, v: (bh / group, sk, d), all in the dtype's type;
// lse, delta: fp32 (bh, sq); kpm: int32 (bh / heads, sk) or null. All
// contiguous. dtype: 0 = float32, 1 = bfloat16. window <= 0 means none (it
// applies only with causal). Returns the cudaError_t of the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                            const void* lse, const void* delta, const void* kpm, void* dq,
                            int bh, int sq, int sk, int d, int heads, int group, float scale,
                            int causal, int window, int dtype, void* stream) {
  const Args a = make_args(q, k, v, dO, lse, delta, kpm, bh, sq, sk, d, heads, group, scale,
                           causal, window);
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return d <= 64 ? launch_dq<float, 64>(a, dq, s) : launch_dq<float, 128>(a, dq, s);
  if (dtype == 1)
    return d <= 64 ? launch_dq<__nv_bfloat16, 64>(a, dq, s)
                   : launch_dq<__nv_bfloat16, 128>(a, dq, s);
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq; dk, dv: (bh / group, sk, d), each written once.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                             const void* lse, const void* delta, const void* kpm, void* dk,
                             void* dv, int bh, int sq, int sk, int d, int heads, int group,
                             float scale, int causal, int window, int dtype, void* stream) {
  const Args a = make_args(q, k, v, dO, lse, delta, kpm, bh, sq, sk, d, heads, group, scale,
                           causal, window);
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || sk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return d <= 64 ? launch_dkv<float, 64>(a, dk, dv, s) : launch_dkv<float, 128>(a, dk, dv, s);
  if (dtype == 1)
    return d <= 64 ? launch_dkv<__nv_bfloat16, 64>(a, dk, dv, s)
                   : launch_dkv<__nv_bfloat16, 128>(a, dk, dv, s);
  return (int)cudaErrorInvalidValue;
}
