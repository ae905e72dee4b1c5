// Sum of squares of a flat fp32 buffer for Hopper (sm_90a).
//
// Replaces apex_tpu/optimizers/_fused_kernels.py:_l2norm_flat_kernel (called
// through sumsq_flat): out = sum(x * x) in fp32 over x[0, n), for any n. The
// ZeRO optimizers clip with it (distributed_fused_adam's max_grad_norm) on a
// flat gradient of every parameter, 1.1e9 elements for a 1.1B model, so n and
// every offset are 64-bit: n * 4 bytes exceeds 2^31.
//
// What bounds it on the card: bytes. Each element is read once for one
// multiply-add, so the least time is 4 * n bytes over the 3.35 TB/s of HBM.
//
// Design. The TPU kernel accumulates into one SMEM cell over its sequential
// grid; Hopper runs blocks in no order, so the sum takes two kernels and no
// float atomics (a repeat call is bit-equal, which the replay tooling needs):
// 1. sumsq_partial_kernel: a fixed grid (at most kMaxBlocks blocks, so the
//    order of the sums does not depend on the card) walks x with a grid
//    stride in 16-byte float4 loads when x is 16-byte aligned (a scalar loop
//    otherwise and for the tail), four fp32 accumulators per thread; each
//    block reduces its threads in a fixed order (warp shuffles, then the
//    warps in order) and writes one partial.
// 2. sumsq_final_kernel: one block sums the partials in the same fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of v over the block's kThreads threads, in a fixed order; valid in
// thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) t += red[k];
  return t;
}

__global__ void __launch_bounds__(kThreads)
sumsq_partial_kernel(const float* __restrict__ x, long long n, int vec,
                     float* __restrict__ part) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  long long done = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      a0 += v.x * v.x;
      a1 += v.y * v.y;
      a2 += v.z * v.z;
      a3 += v.w * v.w;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) a0 += x[i] * x[i];
  const float t = block_sum((a0 + a1) + (a2 + a3));
  if (threadIdx.x == 0) part[blockIdx.x] = t;
}

__global__ void __launch_bounds__(kThreads)
sumsq_final_kernel(const float* __restrict__ part, int blocks, float* __restrict__ out) {
  float s = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kThreads) s += part[i];
  const float t = block_sum(s);
  if (threadIdx.x == 0) out[0] = t;
}

}  // namespace

// The partial-sum grid for n elements: what the caller sizes `part` by.
static int sumsq_blocks(long long n) {
  const long long per_block = (long long)kThreads * 4;
  const long long b = (n + per_block - 1) / per_block;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

// x: fp32 (n,); part: fp32 scratch of (part_blocks,) with part_blocks =
// sumsq_blocks(n); out: fp32 (). Returns the cudaError_t of the launches.
extern "C" int sumsq_flat(const void* x, long long n, void* part, int part_blocks,
                          void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || part_blocks != sumsq_blocks(n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaMemsetAsync(out, 0, sizeof(float), s);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  float* p = static_cast<float*>(part);
  sumsq_partial_kernel<<<part_blocks, kThreads, 0, s>>>(static_cast<const float*>(x), n,
                                                        vec, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sumsq_final_kernel<<<1, kThreads, 0, s>>>(p, part_blocks, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
