// Warp-level building blocks for tensor-core kernels on Hopper: cp.async
// copies into shared memory, ldmatrix loads of 8 x 8 bf16 matrices, and
// mma.sync m16n8k16 with bf16 operands and fp32 accumulators. All are
// sm_80 instructions and valid under -gencode arch=compute_90a,code=sm_90a.
// Below them, the tile loader and mask rules that the flash forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) share.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
// - A (16 x 16, row-major), four registers of two bf16 each: a0 = (g, 2t..2t+1),
//   a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..);
// - B (16 x 8), two registers: b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g);
// - C (16 x 8, fp32): c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..2t+1).
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16 in
// pairs, are the A fragment of the 16 x 16 matrix they form (pack_bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros instead
// (no byte read) when !in. dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes, as cp_async16.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// waits until at most N committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives its (g, 2t..2t+1) pair.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// As ldmatrix_x4, each matrix transposed: register i receives (2t..2t+1, g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a.b: a 16 x 16 and b 16 x 8 in bf16, c 16 x 8 in fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (ex2.approx, about 2 ulp; results
// below 2^-126 flush to zero)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// lo and hi rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragments from a row-major bf16 tile of row stride LD (elements):
// the A operand of the 16 x 16 block at rows r0.., columns c0..
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                       int c0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// the B operands of two 8-column tiles when the tile's rows r0..r0+15 are
// n and its columns c0..c0+15 are k: {r0, r1} for n r0..r0+7, {r2, r3}
// for n r0+8..r0+15
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* tile, int r0,
                                          int c0, int lane) {
  ldmatrix_x4(b, tile + (r0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 + ((lane >> 3) & 1) * 8);
}

// the B operands of two 8-column tiles when the tile's rows r0..r0+15 are
// k and its columns c0..c0+15 are n: {r0, r1} for n c0..c0+7, {r2, r3}
// for n c0+8..c0+15
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int r0,
                                          int c0, int lane) {
  ldmatrix_x4_trans(b,
                    tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8);
}

// ---- shared by the flash forward and backward kernels ------------------------

constexpr float kNegInf = -1e30f;  // a masked score (the TPU kernels' _NEG_INF)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;  // 4 warps a block
constexpr int kB = 64;         // rows (queries or keys) of a tile

__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }
__device__ __forceinline__ long long lmax(long long a, long long b) { return a > b ? a : b; }

// Does query row `row` (of sq) attend key `col` (of sk)? key_ok covers the
// key-padding row and the sk edge. Causal and the window are bottom-right
// aligned: row r sits at key position r + offs, offs = sk - sq.
__device__ __forceinline__ bool attends(int row, int col, bool key_ok, int sq, int offs,
                                        int causal, int window) {
  bool keep = key_ok && row < sq;
  if (causal) {
    const int pos = row + offs;
    keep = keep && col <= pos;
    if (window > 0) keep = keep && col > pos - window;
  }
  return keep;
}

// The 64-key tiles [first, last) that query rows [q0, q0 + rows) can see.
__device__ __forceinline__ void key_band(int q0, int sq, int sk, long long offs, int causal,
                                         int window, int& first, int& last, int rows = kB) {
  long long k_lo = 0, k_hi = sk;
  if (causal) {
    const long long last_row = lmin(q0 + rows, sq) - 1;
    k_hi = lmax(0, lmin(sk, last_row + offs + 1));
    if (window > 0) k_lo = lmax(0, q0 + offs - window + 1);
  }
  first = (int)(k_lo / kB);
  last = (int)((k_hi + kB - 1) / kB);
}

// Rows [row0, row0 + 64) of a (nrows, d) bf16 matrix into a tile of row
// stride DMAX + 8 (16 bytes of padding, so that ldmatrix reads no bank
// twice), zero past either edge: 16-byte cp.async when vec, else element
// by element. All THREADS threads of the block take part.
template <int DMAX, int THREADS = kThreads>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* __restrict__ src,
                                               long long row0, long long nrows, int d, bool vec) {
  constexpr int LD = DMAX + 8, CH = DMAX / 8;
  if (vec) {
    for (int e = threadIdx.x; e < kB * CH; e += THREADS) {
      const int r = e / CH, c = (e % CH) * 8;
      const bool in = row0 + r < nrows && c < d;
      cp_async16(dst + r * LD + c, in ? src + (row0 + r) * d + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < kB * DMAX; e += THREADS) {
      const int r = e / DMAX, c = e % DMAX;
      dst[r * LD + c] =
          (row0 + r < nrows && c < d) ? src[(row0 + r) * d + c] : __float2bfloat16(0.f);
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

}  // namespace flash_mma
