// Adam / AdamW update for Hopper (sm_90a).
//
// Replaces apex_tpu/optimizers/_fused_kernels.py:_adam_flat_kernel (called
// through adam_flat), the TPU form of amp_C.multi_tensor_adam. One
// elementwise pass over fp32 g, p, m, v:
//   g' = g + wd * p                          (L2 mode only: adam_w == 0)
//   m' = b1 * m + (1 - b1) * g'
//   v' = b2 * v + ((1 - b2) * g') * g'
//   u  = (m' / bc1) / (sqrt(v' / bc2) + eps)
//   u  = u + wd * p                          (AdamW mode only: adam_w == 1)
// and writes (-lr * u, m', v'); it never writes p. bc1 = 1 - b1^t and
// bc2 = 1 - b2^t are read from device memory (fp32 scalars the caller
// computes on the card from the step count), so no host sync is needed.
//
// Rounding: every operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), evaluated in the order written above,
// so nvcc cannot contract a multiply and an add into an FMA and the division
// and square root are IEEE. The result is then the same float as the plain
// PyTorch version (_adam_flat_ref), which runs each operation as its own
// correctly rounded elementwise kernel; the file needs no --fmad=false and
// must not be built with --use_fast_math.
//
// What bounds it on the card: bytes. 4 fp32 reads and 3 fp32 writes per
// element (28 bytes) for about 12 flops, so the least time is
// 28 * n bytes over the 3.35 TB/s of HBM.
//
// Design: a grid-stride loop with 16-byte (float4) loads and stores when
// all seven buffers are 16-byte aligned, and a scalar tail, so any length n
// works (the TPU kernel's CHUNK_SIZE padding is not needed; the flat engine
// keeps it only so its buffers stay interchangeable with the JAX package's).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Hyper {
  float neg_lr, b1, omb1, b2, omb2, eps, wd;
  int adam_w;
};

__device__ __forceinline__ float adam_one(float g, float p, float& m, float& v, float bc1,
                                          float bc2, const Hyper& h) {
  if (!h.adam_w && h.wd != 0.f) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps));
  if (h.adam_w && h.wd != 0.f) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  return __fmul_rn(h.neg_lr, u);
}

__global__ void __launch_bounds__(256)
adam_kernel(const float* __restrict__ g, const float* __restrict__ p,
            const float* __restrict__ m, const float* __restrict__ v,
            const float* __restrict__ bc1p, const float* __restrict__ bc2p,
            float* __restrict__ upd, float* __restrict__ m_out, float* __restrict__ v_out,
            long long n, int vec, Hyper h) {
  const float bc1 = *bc1p, bc2 = *bc2p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = tid; i < n4; i += stride) {
    const float4 g4 = reinterpret_cast<const float4*>(g)[i];
    const float4 p4 = reinterpret_cast<const float4*>(p)[i];
    float4 m4 = reinterpret_cast<const float4*>(m)[i];
    float4 v4 = reinterpret_cast<const float4*>(v)[i];
    float4 u4;
    u4.x = adam_one(g4.x, p4.x, m4.x, v4.x, bc1, bc2, h);
    u4.y = adam_one(g4.y, p4.y, m4.y, v4.y, bc1, bc2, h);
    u4.z = adam_one(g4.z, p4.z, m4.z, v4.z, bc1, bc2, h);
    u4.w = adam_one(g4.w, p4.w, m4.w, v4.w, bc1, bc2, h);
    reinterpret_cast<float4*>(upd)[i] = u4;
    reinterpret_cast<float4*>(m_out)[i] = m4;
    reinterpret_cast<float4*>(v_out)[i] = v4;
  }
  for (long long i = n4 * 4 + tid; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    upd[i] = adam_one(g[i], p[i], mi, vi, bc1, bc2, h);
    m_out[i] = mi;
    v_out[i] = vi;
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// g, p, m, v, upd, m_out, v_out: fp32 (n,), contiguous, outputs distinct from
// the inputs; bc1, bc2: fp32 scalars in device memory. neg_lr = -lr,
// omb1 = 1 - beta1 and omb2 = 1 - beta2 are passed as the caller rounds them
// to fp32. adam_w: 1 = decoupled decay (AdamW), 0 = L2 into the gradient.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int adam_update(const void* g, const void* p, const void* m, const void* v,
                           const void* bc1, const void* bc2, void* upd, void* m_out,
                           void* v_out, long long n, float neg_lr, float b1, float omb1,
                           float b2, float omb2, float eps, float wd, int adam_w,
                           void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int vec = aligned16(g) && aligned16(p) && aligned16(m) && aligned16(v) &&
                  aligned16(upd) && aligned16(m_out) && aligned16(v_out);
  const long long work = vec ? (n + 3) / 4 : n;
  const long long want = (work + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  const Hyper h{neg_lr, b1, omb1, b2, omb2, eps, wd, adam_w};
  adam_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(p),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2),
      static_cast<float*>(upd), static_cast<float*>(m_out), static_cast<float*>(v_out), n, vec,
      h);
  return (int)cudaGetLastError();
}
