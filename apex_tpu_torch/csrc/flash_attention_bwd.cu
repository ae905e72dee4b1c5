// Flash-attention backward for Hopper (sm_90a): two kernels.
//
// flash_bwd_dq replaces apex_tpu/ops/attention.py:_flash_bwd_dq_kernel and
// flash_bwd_dkv replaces _flash_bwd_dkv_kernel (both called through
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
// every accumulator are fp32; dq, dk and dv are each written once.
//
// What bounds it on the card: operations. dq does 3 products of
// 2 * pairs * d flops (scores, dp, dq) and dk/dv 4 (scores, dp, dk, dv),
// where pairs are the (query, key) pairs the masks keep; the bytes (q, k,
// v, dO, lse, delta read, the gradients written) weigh far less. At Llama
// training's q (4,32,2048,64) over k, v (4,4,2048,64), causal, that is
// 0.104 + 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak, but 3.6 ms at
// the 67 TFLOP/s of fp32 FMAs: a kernel without tensor cores cannot come
// near it.
//
// bf16, the training dtype: tensor cores. Every product is an
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulators, fed by
// ldmatrix from bf16 tiles in shared memory (flash_mma.cuh). Tiles of 64
// rows arrive by 16-byte cp.async, double-buffered, so that the next tile
// loads while the current one is computed; rows are padded by 16 bytes, so
// ldmatrix reads no bank twice. 4 warps per block, 16 rows each:
// - dk/dv: the block owns 64 keys (each warp 16). For every query head of
//   its GQA group and every 64-query tile in the band, each warp computes,
//   16 queries at a time, S^T = K.Q^T and dP^T = V.dO^T. P^T and dS^T then
//   come out as accumulator fragments whose rows are the warp's keys;
//   rounded to bf16 in registers they are directly the A operands of
//   dV += P^T.dO and dK += dS^T.Q, with dO and Q read by ldmatrix.trans.
//   P and dS never touch shared memory. dk and dv accumulate in registers
//   in a fixed order and are written once: no atomics, and a repeated call
//   is bit-equal. Under a causal mask the first keys see the most queries,
//   so key tiles run along the grid's slow dimension and the longest blocks
//   start first. Few blocks over a long group leave the card waiting on
//   the longest ones at the end, so the caller may split the group over
//   `splits` blocks: each writes fp32 partials, and sum_splits adds them in
//   split order.
// - dq: the block owns 64 queries, with each warp's Q and dO rows in
//   registers; per 16-key chunk S = Q.K^T and dP = dO.V^T give dS in
//   registers as the A operand of dQ += dS.K (K by ldmatrix.trans). Query
//   tiles are issued last-to-first: the last queries see the most keys.
// Masks are tested per fragment element from the lane's (query, key), and
// only in the 16 x 16 chunks that cross an edge of the band, of sq or sk,
// or that have key padding; 64-row tiles and a warp's chunks outside the
// band are skipped. exp is ex2.approx. head_dim is zero-padded up to 64,
// 128 or 256, and only the 16-wide steps that hold data are computed, so
// d = 32, 80, 160 and 256 all work; a head_dim that is not a multiple of
// 8, or an input that is not 16-byte aligned, is loaded element by element
// instead of by cp.async.
// At d = 256 the register file sets the shape (MmaSmem<256> is 199 KB, one
// block an SM): dk/dv's two accumulators would be 256 registers a thread,
// so the block's outputs are 128 of the head_dim columns (Dkv::DC), two
// blocks share a key tile, and each computes S^T and dP^T over the whole
// head_dim for its half (the FlashAttention-2 route); dq reads its Q and dO
// fragments from shared memory at each step instead of holding them.
// Sizing (d <= 64): 2 resident and 2 x 2 streamed tiles of 64 x 72 bf16 and
// 1 KB of lse/delta rows, 56 KB of shared memory a block. Latency limits
// the rate more than issue does, so the registers are capped at 128 a
// thread for 4 blocks (16 warps) an SM: the dk/dv kernel reads its K and V
// fragments from shared memory for each chunk rather than keeping them in
// registers.
//
// fp32, the parity dtype (the card-against-CPU checks and fp32 decode):
// the first version's scalar FMA kernels on fp32 tiles in shared memory,
// 128 threads, thread (tr, tc) = (t / 8, t % 8) owning BR / 16 rows and the
// columns tc + 8j, over tiles of BR = 64 rows (32 at d = 256, whose four
// 64-row fp32 tiles would not fit 227 KB). TF32 tensor cores would keep
// about 3 decimal digits and break the 1e-4 tolerance those checks hold.
//
// head_dim > 256, both dtypes: flash_bwd_dq_wide and flash_bwd_dkv_wide,
// scalar FMAs over 64-wide chunks of head_dim, each block owning 128 of
// dq's or 64 of dk's and dv's columns (flash_wide.cuh). No model the port
// reads goes past 256: this route is written to be right, not fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"
#include "flash_wide.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash_mma;

// The 64-query tiles [first, last) that can see a key of [k0, k0 + 64)
// (_q_band in the JAX package).
__device__ __forceinline__ void query_band(int k0, int sq, long long offs, int causal, int window,
                                           int& first, int& last) {
  long long q_lo = 0, q_hi = sq;
  if (causal) {
    q_lo = lmax(0, k0 - offs);
    if (window > 0) q_hi = lmax(0, lmin(sq, (long long)k0 + kB - 1 - offs + window));
  }
  first = (int)(q_lo / kB);
  last = (int)((q_hi + kB - 1) / kB);
}

// ---- bf16: tensor cores -----------------------------------------------------

template <int DMAX> struct MmaSmem {
  static constexpr int LD = DMAX + 8;   // bf16 row stride: 16 bytes of padding
  static constexpr int TILE = kB * LD;  // bf16 elements of one 64-row tile
  // 2 resident tiles, 2 stages of 2 streamed tiles, 2 stages of 64 lse and
  // 64 delta values
  static constexpr size_t bytes = 6 * TILE * sizeof(bf16) + 4 * kB * sizeof(float);
};

// lse and delta of query rows [row0, row0 + 64) of one head (base = its
// first row) into dst[0..64) and dst[64..128), zero past sq.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ lse,
                                          const float* __restrict__ delta, long long base,
                                          int row0, int sq) {
  for (int e = threadIdx.x; e < 2 * kB; e += kThreads) {
    const int r = e % kB;
    const bool in = row0 + r < sq;
    cp_async4(dst + e, (e < kB ? lse : delta) + (in ? base + row0 + r : 0), in);
  }
}

// p and ds of one (query, key) pair from its score s and its dp, with the
// query's lse l and delta dl: p = exp(s * scale - l) where kept, else 0,
// and ds = p * (dp - dl) * scale.
__device__ __forceinline__ void grad_probs(float s, float dp, float l, float dl, bool keep,
                                           float sl2, float scale, float& p, float& ds) {
  p = keep ? exp2_approx(fmaf(s, sl2, -l * kLog2e)) : 0.f;
  ds = p * (dp - dl) * scale;
}

// The dk/dv kernel's outputs: DC head_dim columns of dk and dv a block
// (all of them up to d = 128), so NC blocks share a key tile.
template <int DMAX> struct Dkv {
  static constexpr int DC = DMAX < 128 ? DMAX : 128;
  static constexpr int NC = DMAX / DC;
};

template <int DMAX>
__device__ __forceinline__ void
flash_bwd_dkv_mma_tile(int k0, const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dO,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ kpm, bf16* __restrict__ dk, bf16* __restrict__ dv,
                       float* __restrict__ part, int sq, int sk, int d, int heads, int group,
                       float scale, int causal, int window, int vec) {
  using Sm = MmaSmem<DMAX>;
  constexpr int LD = Sm::LD, KS = DMAX / 16;  // 16-wide steps over head_dim
  constexpr int NC = Dkv<DMAX>::NC, KC = Dkv<DMAX>::DC / 16;  // KC: the outputs' steps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + Sm::TILE;
  bf16* sQ = sV + Sm::TILE;        // 2 stages
  bf16* sdO = sQ + 2 * Sm::TILE;   // 2 stages
  float* sRows = reinterpret_cast<float*>(sdO + 2 * Sm::TILE);  // 2 stages of lse, delta

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kw = (threadIdx.x >> 5) * 16;  // the warp's first key in the tile
  const long long kvr = blockIdx.x / NC;  // (batch, kv head) row of k and v
  const int c0 = (int)(blockIdx.x % NC) * KC;  // the block's first output step
  const int offs = sk - sq;
  const int* kpm_row = kpm ? kpm + (kvr * group / heads) * sk : nullptr;
  const int kd = (d + 15) / 16;
  const float sl2 = scale * kLog2e;

  int t_lo, t_hi;
  query_band(k0, sq, offs, causal, window, t_lo, t_hi);
  const int nqt = t_hi > t_lo ? t_hi - t_lo : 0;
  // the block's split of the group: query heads [g0, g0 + gs)
  const int gs = group / gridDim.y, g0 = blockIdx.y * gs;
  const int n_iter = gs * nqt;  // (query head, query tile) pairs, head-major

  auto issue = [&](int it) {
    const int s = it & 1;
    const long long bh = kvr * group + g0 + it / nqt;
    const int q0 = (t_lo + it % nqt) * kB;
    load_tile_bf16<DMAX>(sQ + s * Sm::TILE, q + bh * sq * d, q0, sq, d, vec);
    load_tile_bf16<DMAX>(sdO + s * Sm::TILE, dO + bh * sq * d, q0, sq, d, vec);
    load_rows(sRows + s * 2 * kB, lse, delta, bh * sq, q0, sq);
  };
  load_tile_bf16<DMAX>(sK, k + kvr * sk * d, k0, sk, d, vec);
  load_tile_bf16<DMAX>(sV, v + kvr * sk * d, k0, sk, d, vec);
  if (n_iter > 0) issue(0);
  cp_async_commit();

  // the lane's two keys: fragment rows g and g + 8 of the warp's 16
  const int key_a = k0 + kw + g, key_b = key_a + 8;
  const bool ok_a = key_a < sk && (kpm_row == nullptr || kpm_row[key_a] == 0);
  const bool ok_b = key_b < sk && (kpm_row == nullptr || kpm_row[key_b] == 0);
  const bool warp_live = k0 + kw < sk;

  float acc_k[2 * KC][4], acc_v[2 * KC][4];  // 8-column tiles over the outputs
#pragma unroll
  for (int n = 0; n < 2 * KC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int s = it & 1;
    if (it + 1 < n_iter) issue(it + 1);  // its stage was last read in it - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* tQ = sQ + s * Sm::TILE;
    const bf16* tdO = sdO + s * Sm::TILE;
    const float* tL = sRows + s * 2 * kB;
    const float* tD = tL + kB;
    const int q0 = (t_lo + it % nqt) * kB;

#pragma unroll 1
    for (int c = 0; c < kB / 16 && warp_live; ++c) {
      const int qc = q0 + c * 16;
      if (qc >= sq) break;
      // every key of the warp after every query of the chunk, or before its window
      if (causal && (k0 + kw > qc + 15 + offs ||
                     (window > 0 && k0 + kw + 15 <= qc + offs - window)))
        continue;
      // S^T = K.Q^T and dP^T = V.dO^T, keys x 16 queries
      float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk < kd) {
          uint32_t a[4], b[4];
          load_a<LD>(a, sK, kw, kk * 16, lane);
          load_b_nk<LD>(b, tQ, c * 16, kk * 16, lane);
          mma_bf16(st[0], a, b[0], b[1]);
          mma_bf16(st[1], a, b[2], b[3]);
          load_a<LD>(a, sV, kw, kk * 16, lane);
          load_b_nk<LD>(b, tdO, c * 16, kk * 16, lane);
          mma_bf16(dpt[0], a, b[0], b[1]);
          mma_bf16(dpt[1], a, b[2], b[3]);
        }
      }
      // P^T and dS^T in registers, rounded to bf16: the A operands below.
      // Only a chunk that crosses an edge (of the band, of sq or sk, or
      // with key padding) tests its pairs one by one.
      const bool edge = kpm_row != nullptr || qc + 16 > sq || k0 + kw + 16 > sk ||
                        (causal && (k0 + kw + 15 > qc + offs ||
                                    (window > 0 && k0 + kw <= qc + 15 + offs - window)));
      uint32_t pa[4], dsa[4];
      auto probs = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c * 16 + j * 8 + 2 * t + (e & 1);  // query in the tile
            bool keep = true;
            if constexpr (decltype(masked)::value)
              keep = attends(q0 + qi, e < 2 ? key_a : key_b, e < 2 ? ok_a : ok_b, sq, offs,
                             causal, window);
            grad_probs(st[j][e], dpt[j][e], tL[qi], tD[qi], keep, sl2, scale, p[e], ds[e]);
          }
          pa[2 * j] = pack_bf16(p[0], p[1]);
          pa[2 * j + 1] = pack_bf16(p[2], p[3]);
          dsa[2 * j] = pack_bf16(ds[0], ds[1]);
          dsa[2 * j + 1] = pack_bf16(ds[2], ds[3]);
        }
      };
      if (edge)
        probs(std::true_type{});
      else
        probs(std::false_type{});
      // dV += P^T.dO, dK += dS^T.Q over the chunk's 16 queries
#pragma unroll
      for (int np = 0; np < KC; ++np) {
        if (c0 + np < kd) {
          uint32_t b[4];
          load_b_kn<LD>(b, tdO, c * 16, (c0 + np) * 16, lane);
          mma_bf16(acc_v[2 * np], pa, b[0], b[1]);
          mma_bf16(acc_v[2 * np + 1], pa, b[2], b[3]);
          load_b_kn<LD>(b, tQ, c * 16, (c0 + np) * 16, lane);
          mma_bf16(acc_k[2 * np], dsa, b[0], b[1]);
          mma_bf16(acc_k[2 * np + 1], dsa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage s is read no more before issue(it + 2) fills it
  }
  cp_async_wait<0>();  // nothing left in flight (a block with no tile in its band)

#pragma unroll
  for (int n = 0; n < 2 * KC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = e < 2 ? key_a : key_b;
      const int col = c0 * 16 + n * 8 + 2 * t + (e & 1);
      if (key < sk && col < d) {
        const long long i = (kvr * sk + key) * d + col;
        if (part == nullptr) {
          dk[i] = __float2bfloat16(acc_k[n][e]);
          dv[i] = __float2bfloat16(acc_v[n][e]);
        } else {  // fp32 partials of split y: part[2y] for dk, part[2y + 1] for dv
          const long long n_out = (long long)(gridDim.x / NC) * sk * d;
          part[2 * blockIdx.y * n_out + i] = acc_k[n][e];
          part[(2 * blockIdx.y + 1) * n_out + i] = acc_v[n][e];
        }
      }
    }
}

// Each block walks key tiles blockIdx.z, + gridDim.z, ... (the grid holds at
// most 65535 on z); at least 4 blocks an SM at d <= 64 (128 registers a
// thread), 2 at d <= 128.
template <int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX <= 64 ? 4 : 2)
flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dO,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ kpm, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  float* __restrict__ part, int sq, int sk, int d, int heads, int group,
                  float scale, int causal, int window, int vec) {
  const int n_tiles = (sk + kB - 1) / kB;
  for (int tile = blockIdx.z; tile < n_tiles; tile += gridDim.z) {
    if (tile != (int)blockIdx.z) __syncthreads();  // the last tile's smem is free
    flash_bwd_dkv_mma_tile<DMAX>(tile * kB, q, k, v, dO, lse, delta, kpm, dk, dv, part, sq, sk, d,
                                 heads, group, scale, causal, window, vec);
  }
}

template <int DMAX>
__device__ __forceinline__ void
flash_bwd_dq_mma_tile(int q0, const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ kpm, bf16* __restrict__ dq, int sq, int sk, int d,
                      int heads, int group, float scale, int causal, int window, int vec) {
  using Sm = MmaSmem<DMAX>;
  constexpr int LD = Sm::LD, KS = DMAX / 16;
  constexpr bool QREG = DMAX <= 128;  // Q and dO fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + Sm::TILE;
  bf16* sK = sdO + Sm::TILE;      // 2 stages
  bf16* sV = sK + 2 * Sm::TILE;   // 2 stages

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long bh = blockIdx.x, kvh = bh / group;
  const int offs = sk - sq;
  const int* kpm_row = kpm ? kpm + (bh / heads) * sk : nullptr;
  const int kd = (d + 15) / 16;
  const float sl2 = scale * kLog2e;

  int t_lo, t_hi;
  key_band(q0, sq, sk, offs, causal, window, t_lo, t_hi);
  const int n_iter = t_hi > t_lo ? t_hi - t_lo : 0;

  auto issue = [&](int it) {
    const int s = it & 1;
    const int k0 = (t_lo + it) * kB;
    load_tile_bf16<DMAX>(sK + s * Sm::TILE, k + kvh * sk * d, k0, sk, d, vec);
    load_tile_bf16<DMAX>(sV + s * Sm::TILE, v + kvh * sk * d, k0, sk, d, vec);
  };
  load_tile_bf16<DMAX>(sQ, q + bh * sq * d, q0, sq, d, vec);
  load_tile_bf16<DMAX>(sdO, dO + bh * sq * d, q0, sq, d, vec);
  if (n_iter > 0) issue(0);
  cp_async_commit();

  // the lane's two query rows: fragment rows g and g + 8 of the warp's 16
  const int qw = q0 + (threadIdx.x >> 5) * 16;
  const int row[2] = {qw + g, qw + g + 8};
  float l[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = row[i] < sq ? lse[bh * sq + row[i]] : 0.f;
    dl[i] = row[i] < sq ? delta[bh * sq + row[i]] : 0.f;
  }
  const bool warp_live = qw < sq;

  float acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[KS][4], of[KS][4];

  for (int it = 0; it < n_iter; ++it) {
    const int s = it & 1;
    if (it + 1 < n_iter) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (QREG && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        load_a<LD>(qf[kk], sQ, qw - q0, kk * 16, lane);
        load_a<LD>(of[kk], sdO, qw - q0, kk * 16, lane);
      }
    }
    const bf16* tK = sK + s * Sm::TILE;
    const bf16* tV = sV + s * Sm::TILE;
    const int k0 = (t_lo + it) * kB;

#pragma unroll 1
    for (int c = 0; c < kB / 16 && warp_live; ++c) {
      const int kc = k0 + c * 16;
      if (kc >= sk || (causal && kc > qw + 15 + offs)) break;
      if (causal && window > 0 && kc + 15 <= qw + offs - window) continue;
      // S = Q.K^T and dP = dO.V^T, 16 queries x 16 keys
      float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk < kd) {
          uint32_t b[4], qs[4], os[4];
          if constexpr (!QREG) {
            load_a<LD>(qs, sQ, qw - q0, kk * 16, lane);
            load_a<LD>(os, sdO, qw - q0, kk * 16, lane);
          }
          const uint32_t(&qa)[4] = QREG ? qf[kk] : qs;
          const uint32_t(&oa)[4] = QREG ? of[kk] : os;
          load_b_nk<LD>(b, tK, c * 16, kk * 16, lane);
          mma_bf16(sc[0], qa, b[0], b[1]);
          mma_bf16(sc[1], qa, b[2], b[3]);
          load_b_nk<LD>(b, tV, c * 16, kk * 16, lane);
          mma_bf16(dp[0], oa, b[0], b[1]);
          mma_bf16(dp[1], oa, b[2], b[3]);
        }
      }
      // dS in registers, rounded to bf16: the A operand below (pairs
      // tested one by one only in a chunk that crosses an edge)
      const bool edge = kpm_row != nullptr || qw + 16 > sq || kc + 16 > sk ||
                        (causal && (kc + 15 > qw + offs ||
                                    (window > 0 && kc <= qw + 15 + offs - window)));
      uint32_t dsa[4];
      auto probs = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kc + j * 8 + 2 * t + (e & 1), i = e >> 1;
            bool keep = true;
            if constexpr (decltype(masked)::value)
              keep = attends(row[i], col,
                             col < sk && (kpm_row == nullptr || kpm_row[col] == 0), sq, offs,
                             causal, window);
            float p;
            grad_probs(sc[j][e], dp[j][e], l[i], dl[i], keep, sl2, scale, p, ds[e]);
          }
          dsa[2 * j] = pack_bf16(ds[0], ds[1]);
          dsa[2 * j + 1] = pack_bf16(ds[2], ds[3]);
        }
      };
      if (edge)
        probs(std::true_type{});
      else
        probs(std::false_type{});
      // dQ += dS.K over the chunk's 16 keys
#pragma unroll
      for (int np = 0; np < KS; ++np) {
        if (np < kd) {
          uint32_t b[4];
          load_b_kn<LD>(b, tK, c * 16, np * 16, lane);
          mma_bf16(acc[2 * np], dsa, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], dsa, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e >> 1];
      const int col = n * 8 + 2 * t + (e & 1);
      if (r < sq && col < d) dq[(bh * sq + r) * d + col] = __float2bfloat16(acc[n][e]);
    }
}

// Each block walks query tiles blockIdx.y, + gridDim.y, ... (the grid holds
// at most 65535 on y), the longest causal tiles first; at least 4 blocks an
// SM at d <= 64 (128 registers a thread), 2 at d <= 128.
template <int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX <= 64 ? 4 : 2)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dO,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ kpm, bf16* __restrict__ dq, int sq, int sk, int d,
                 int heads, int group, float scale, int causal, int window, int vec) {
  const int n_tiles = (sq + kB - 1) / kB;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    if (tile != (int)blockIdx.y) __syncthreads();  // the last tile's smem is free
    flash_bwd_dq_mma_tile<DMAX>((n_tiles - 1 - tile) * kB, q, k, v, dO, lse, delta, kpm, dq, sq, sk,
                                d, heads, group, scale, causal, window, vec);
  }
}

// dk and dv = the sum of the splits' fp32 partials, in split order
__global__ void sum_splits(const float* __restrict__ part, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, long long n, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int z = 0; z < splits; ++z) {
      a += part[2 * z * n + i];
      b += part[(2 * z + 1) * n + i];
    }
    dk[i] = __float2bfloat16(a);
    dv[i] = __float2bfloat16(b);
  }
}

// ---- fp32: scalar FMAs ------------------------------------------------------

// The scalar kernels' tiles: BR rows of queries or keys (32 at d = 256,
// where four fp32 tiles of 64 rows would pass 227 KB); thread (tr, tc)
// owns tile rows tr * RP.. and tile columns tc + 8j.
template <int DMAX> struct Scalar {
  static constexpr int BR = DMAX <= 128 ? kB : kB / 2;
  static constexpr int RP = BR / 16;  // rows per thread
  static constexpr int CP = BR / 8;   // tile columns per thread
  static constexpr int S = DMAX + 1;  // row stride of a (BR, head_dim) tile
  static constexpr int PS = BR + 1;   // row stride of a (BR, BR) tile
  // dq: Q, dO, K, V tiles, dS, lse, delta
  static constexpr size_t dq_bytes = (4 * BR * S + BR * PS + 2 * BR) * sizeof(float);
  // dk/dv: K, V, Q, dO tiles, P, dS, lse, delta
  static constexpr size_t dkv_bytes = (4 * BR * S + 2 * BR * PS + 2 * BR) * sizeof(float);
};

// dst[r][c] = src[row0 + r][c] for the BR rows of a tile (zero past the
// edges), src rows of d elements.
template <int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long row0, long long nrows, int d) {
  for (int e = threadIdx.x; e < Scalar<DMAX>::BR * DMAX; e += kThreads) {
    const int r = e / DMAX, c = e % DMAX;
    dst[r * (DMAX + 1) + c] = (row0 + r < nrows && c < d) ? src[(row0 + r) * d + c] : 0.f;
  }
}

// out[i][j] = sum over dd of A[tr*RP + i][dd] * B[tc + 8j][dd]
template <int DMAX>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int d, int tr, int tc,
                                         float (&out)[Scalar<DMAX>::RP][Scalar<DMAX>::CP]) {
  constexpr int S = DMAX + 1, RP = Scalar<DMAX>::RP, CP = Scalar<DMAX>::CP;
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

template <int DMAX>
__device__ __forceinline__ void
flash_bwd_dq_kernel_tile(int q0, const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dO,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ kpm, float* __restrict__ dq, int sq, int sk, int d,
                         int heads, int group, float scale, int causal, int window) {
  using Sc = Scalar<DMAX>;
  constexpr int BR = Sc::BR, RP = Sc::RP, CP = Sc::CP, S = Sc::S, PS = Sc::PS, DP = DMAX / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BR * S;
  float* sK = sdO + BR * S;
  float* sV = sK + BR * S;
  float* sDS = sV + BR * S;
  float* sL = sDS + BR * PS;
  float* sD = sL + BR;

  const int t = threadIdx.x, tr = t >> 3, tc = t & 7;
  const long long bh = blockIdx.x, kvh = bh / group;  // x holds 2^31 - 1 blocks
  const long long offs = (long long)sk - sq;
  const int* kpm_row = kpm ? kpm + (bh / heads) * sk : nullptr;

  load_tile<DMAX>(sQ, q + bh * sq * d, q0, sq, d);
  load_tile<DMAX>(sdO, dO + bh * sq * d, q0, sq, d);
  for (int r = t; r < BR; r += kThreads) {
    const bool in = q0 + r < sq;
    sL[r] = in ? lse[bh * sq + q0 + r] : -kNegInf;
    sD[r] = in ? delta[bh * sq + q0 + r] : 0.f;
  }

  int t_lo, t_hi;
  key_band(q0, sq, sk, offs, causal, window, t_lo, t_hi, BR);

  float acc[RP][DP];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[i][c] = 0.f;

  // the band's 64-key tiles, BR keys at a time
  for (int k0 = t_lo * kB; k0 < t_hi * kB && k0 < sk; k0 += BR) {
    __syncthreads();  // the previous tile's sK/sV/sDS are no longer read
    load_tile<DMAX>(sK, k + kvh * sk * d, k0, sk, d);
    load_tile<DMAX>(sV, v + kvh * sk * d, k0, sk, d);
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
        sDS[r * PS + tc + 8 * j] = ds;
      }
    }
    __syncthreads();

    const int kmax = min(BR, sk - k0);
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
    float* out = dq + (bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      const int col = tc + 8 * c;
      if (col < d) out[col] = acc[i][c];
    }
  }
}

// Each block walks query tiles blockIdx.y, + gridDim.y, ... (at most 65535
// on y).
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ kpm, float* __restrict__ dq, int sq, int sk, int d,
                    int heads, int group, float scale, int causal, int window) {
  const int n_tiles = (sq + Scalar<DMAX>::BR - 1) / Scalar<DMAX>::BR;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    if (tile != (int)blockIdx.y) __syncthreads();  // the last tile's smem is free
    flash_bwd_dq_kernel_tile<DMAX>(tile * Scalar<DMAX>::BR, q, k, v, dO, lse, delta, kpm, dq, sq,
                                   sk, d, heads, group, scale, causal, window);
  }
}

template <int DMAX>
__device__ __forceinline__ void
flash_bwd_dkv_kernel_tile(int k0, const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dO,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ kpm, float* __restrict__ dk,
                          float* __restrict__ dv, int sq, int sk, int d, int heads, int group,
                          float scale, int causal, int window) {
  using Sc = Scalar<DMAX>;
  constexpr int BR = Sc::BR, RP = Sc::RP, CP = Sc::CP, S = Sc::S, PS = Sc::PS, DP = DMAX / 8;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BR * S;
  float* sQ = sV + BR * S;
  float* sdO = sQ + BR * S;
  float* sP = sdO + BR * S;
  float* sDS = sP + BR * PS;
  float* sL = sDS + BR * PS;
  float* sD = sL + BR;

  const int t = threadIdx.x, tr = t >> 3, tc = t & 7;
  const long long kvr = blockIdx.x;  // (batch, kv head) row of k and v
  const long long offs = (long long)sk - sq;
  const int* kpm_row = kpm ? kpm + (kvr * group / heads) * sk : nullptr;

  load_tile<DMAX>(sK, k + kvr * sk * d, k0, sk, d);
  load_tile<DMAX>(sV, v + kvr * sk * d, k0, sk, d);
  bool key_ok[CP];
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    const int col = k0 + tc + 8 * j;
    key_ok[j] = col < sk && (kpm_row == nullptr || kpm_row[col] == 0);
  }

  // the 64-query tiles that see a key of [k0, k0 + 64), BR queries at a time
  int t_lo, t_hi;
  query_band(k0, sq, offs, causal, window, t_lo, t_hi);

  float acc_k[RP][DP], acc_v[RP][DP];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int c = 0; c < DP; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const long long bh = kvr * group + g;
    for (int q0 = t_lo * kB; q0 < t_hi * kB && q0 < sq; q0 += BR) {
      __syncthreads();  // the previous tile's sQ/sdO/sP/sDS are no longer read
      load_tile<DMAX>(sQ, q + bh * sq * d, q0, sq, d);
      load_tile<DMAX>(sdO, dO + bh * sq * d, q0, sq, d);
      for (int r = t; r < BR; r += kThreads) {
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
          sP[r * PS + tc + 8 * j] = p;
          sDS[r * PS + tc + 8 * j] = ds;
        }
      }
      __syncthreads();

      // accumulate with rows = keys tr*RP + i, columns = head dims tc + 8c
      const int qmax = min(BR, sq - q0);
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
    float* ko = dk + (kvr * sk + key) * d;
    float* vo = dv + (kvr * sk + key) * d;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      const int col = tc + 8 * c;
      if (col < d) {
        ko[col] = acc_k[i][c];
        vo[col] = acc_v[i][c];
      }
    }
  }
}

// Each block walks key tiles blockIdx.y, + gridDim.y, ... (at most 65535
// on y).
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kpm, float* __restrict__ dk, float* __restrict__ dv,
                     int sq, int sk, int d, int heads, int group, float scale, int causal,
                     int window) {
  const int n_tiles = (sk + Scalar<DMAX>::BR - 1) / Scalar<DMAX>::BR;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    if (tile != (int)blockIdx.y) __syncthreads();  // the last tile's smem is free
    flash_bwd_dkv_kernel_tile<DMAX>(tile * Scalar<DMAX>::BR, q, k, v, dO, lse, delta, kpm, dk, dv,
                                    sq, sk, d, heads, group, scale, causal, window);
  }
}

// ---- head_dim > 256, both dtypes: scalar FMAs over head_dim chunks ----------
//
// flash_wide.cuh sets out the route. dq: block (blockIdx.x, tile, blockIdx.z)
// owns 64 query rows of one head and the dq columns [c_out, c_out + OC),
// c_out = blockIdx.z * OC; per 64-key tile in the band it forms s = q.k and
// dp = dO.v over the whole head_dim (wide_dot), ds (rounded to T) into
// shared memory, then dq += ds.k over k's OC columns of the tile. dk/dv:
// block x = (kv row, column block), y = split, z = key tile; for each query
// head of its split of the group and each 64-query tile in the band, s and
// dp as above, p and ds (rounded to T) into shared memory, then dv += p^T.dO
// and dk += ds^T.q over the OC columns of dO and q. With splits > 1 each
// split writes fp32 partials that sum_splits adds, as in the bf16 kernel.

constexpr int kWidePS = kB + 1;  // row stride of a (64, 64) tile

// dq: two staged chunks, ds, k's OC columns, lse and delta
constexpr size_t wide_dq_bytes(int oc) {
  return (2 * kB * flash_wide::HS + kB * kWidePS + kB * oc + 2 * kB) * sizeof(float);
}
// dk/dv: two staged chunks, p, ds, q's and dO's OC columns, lse and delta
constexpr size_t wide_dkv_bytes(int oc) {
  return (2 * kB * flash_wide::HS + 2 * kB * kWidePS + 2 * kB * oc + 2 * kB) * sizeof(float);
}

template <typename T, int OC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dO, const float* __restrict__ lse,
                  const float* __restrict__ delta, const int* __restrict__ kpm,
                  T* __restrict__ dq, int sq, int sk, int d, int heads, int group, float scale,
                  int causal, int window) {
  using namespace flash_wide;
  constexpr int RP = kB / 16, CP = kB / 8, DP = OC / 8, PS = kWidePS;
  extern __shared__ float smem[];
  float* sA = smem;
  float* sB = sA + kB * HS;
  float* sDS = sB + kB * HS;
  float* sKo = sDS + kB * PS;
  float* sL = sKo + kB * OC;
  float* sD = sL + kB;

  const int t = threadIdx.x, tr = t >> 3, tc = t & 7;
  const long long bh = blockIdx.x, kvh = bh / group;
  const int c_out = (int)blockIdx.z * OC;
  const long long offs = (long long)sk - sq;
  const int* kpm_row = kpm ? kpm + (bh / heads) * sk : nullptr;
  const T* qb = q + bh * sq * d;
  const T* dob = dO + bh * sq * d;
  const T* kb = k + kvh * sk * d;
  const T* vb = v + kvh * sk * d;
  const int n_tiles = (sq + kB - 1) / kB;

  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int q0 = tile * kB;
    __syncthreads();  // the last tile's sL and sD are read no more
    for (int r = t; r < kB; r += kThreads) {
      const bool in = q0 + r < sq;
      sL[r] = in ? lse[bh * sq + q0 + r] : -kNegInf;
      sD[r] = in ? delta[bh * sq + q0 + r] : 0.f;
    }
    int t_lo, t_hi;
    key_band(q0, sq, sk, offs, causal, window, t_lo, t_hi);

    float acc[RP][DP];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[i][c] = 0.f;

    for (int k0 = t_lo * kB; k0 < t_hi * kB && k0 < sk; k0 += kB) {
      float s[RP][CP], dp[RP][CP];
      wide_dot<T, kB, kB>(qb, q0, sq, kb, k0, sk, d, sA, sB, tr, tc, s);
      wide_dot<T, kB, kB>(dob, q0, sq, vb, k0, sk, d, sA, sB, tr, tc, dp);
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int r = tr * RP + i;
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          const int col = k0 + tc + 8 * j;
          const bool key_ok = col < sk && (kpm_row == nullptr || kpm_row[col] == 0);
          float ds = 0.f;
          if (attends(q0 + r, col, key_ok, sq, (int)offs, causal, window)) {
            const float p = expf(s[i][j] * scale - sL[r]);
            ds = p * (dp[i][j] - sD[r]) * scale;
          }
          sDS[r * PS + tc + 8 * j] = round_to<T>(ds);
        }
      }
      load_cols<T, kB, OC, OC>(sKo, kb, k0, sk, c_out, d);
      __syncthreads();

      const int kmax = min(kB, sk - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[RP], b[DP];
#pragma unroll
        for (int i = 0; i < RP; ++i) a[i] = sDS[(tr * RP + i) * PS + kk];
#pragma unroll
        for (int c = 0; c < DP; ++c) b[c] = sKo[kk * OC + tc + 8 * c];
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
        const int col = c_out + tc + 8 * c;
        if (col < d) out[col] = narrow<T>(acc[i][c]);
      }
    }
  }
}

template <typename T, int OC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dO, const float* __restrict__ lse,
                   const float* __restrict__ delta, const int* __restrict__ kpm,
                   T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part, int sq,
                   int sk, int d, int heads, int group, float scale, int causal, int window) {
  using namespace flash_wide;
  constexpr int RP = kB / 16, CP = kB / 8, DP = OC / 8, PS = kWidePS;
  extern __shared__ float smem[];
  float* sA = smem;
  float* sB = sA + kB * HS;
  float* sP = sB + kB * HS;
  float* sDS = sP + kB * PS;
  float* sQo = sDS + kB * PS;
  float* sdOo = sQo + kB * OC;
  float* sL = sdOo + kB * OC;
  float* sD = sL + kB;

  const int t = threadIdx.x, tr = t >> 3, tc = t & 7;
  const int nc = (d + OC - 1) / OC;
  const long long kvr = blockIdx.x / nc;  // (batch, kv head) row of k and v
  const int c_out = (int)(blockIdx.x % nc) * OC;
  const long long offs = (long long)sk - sq;
  const int* kpm_row = kpm ? kpm + (kvr * group / heads) * sk : nullptr;
  const T* kb = k + kvr * sk * d;
  const T* vb = v + kvr * sk * d;
  const int gs = group / gridDim.y, g0 = blockIdx.y * gs;  // the block's split of the group
  const int n_tiles = (sk + kB - 1) / kB;

  for (int tile = blockIdx.z; tile < n_tiles; tile += gridDim.z) {
    const int k0 = tile * kB;
    int t_lo, t_hi;
    query_band(k0, sq, offs, causal, window, t_lo, t_hi);
    float acc_k[RP][DP], acc_v[RP][DP];  // rows: keys tr * RP + i
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int c = 0; c < DP; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

    for (int gi = g0; gi < g0 + gs; ++gi) {
      const long long bh = kvr * group + gi;
      const T* qb = q + bh * sq * d;
      const T* dob = dO + bh * sq * d;
      for (int q0 = t_lo * kB; q0 < t_hi * kB && q0 < sq; q0 += kB) {
        // rows: queries tr * RP + i; columns: keys tc + 8j
        float s[RP][CP], dp[RP][CP];
        wide_dot<T, kB, kB>(qb, q0, sq, kb, k0, sk, d, sA, sB, tr, tc, s);
        wide_dot<T, kB, kB>(dob, q0, sq, vb, k0, sk, d, sA, sB, tr, tc, dp);
        for (int r = t; r < kB; r += kThreads) {
          const bool in = q0 + r < sq;
          sL[r] = in ? lse[bh * sq + q0 + r] : -kNegInf;
          sD[r] = in ? delta[bh * sq + q0 + r] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          const int r = tr * RP + i;
#pragma unroll
          for (int j = 0; j < CP; ++j) {
            const int col = k0 + tc + 8 * j;
            const bool key_ok = col < sk && (kpm_row == nullptr || kpm_row[col] == 0);
            float p = 0.f, ds = 0.f;
            if (attends(q0 + r, col, key_ok, sq, (int)offs, causal, window)) {
              p = expf(s[i][j] * scale - sL[r]);
              ds = p * (dp[i][j] - sD[r]) * scale;
            }
            sP[r * PS + tc + 8 * j] = round_to<T>(p);
            sDS[r * PS + tc + 8 * j] = round_to<T>(ds);
          }
        }
        load_cols<T, kB, OC, OC>(sQo, qb, q0, sq, c_out, d);
        load_cols<T, kB, OC, OC>(sdOo, dob, q0, sq, c_out, d);
        __syncthreads();

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
            o[c] = sdOo[qq * OC + tc + 8 * c];
            qv[c] = sQo[qq * OC + tc + 8 * c];
          }
#pragma unroll
          for (int i = 0; i < RP; ++i)
#pragma unroll
            for (int c = 0; c < DP; ++c) {
              acc_v[i][c] = fmaf(pk[i], o[c], acc_v[i][c]);
              acc_k[i][c] = fmaf(dsk[i], qv[c], acc_k[i][c]);
            }
        }
        __syncthreads();  // sL, sD, sP and sDS are read no more
      }
    }

    const long long n_out = (long long)(gridDim.x / nc) * sk * d;
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const int key = k0 + tr * RP + i;
      if (key >= sk) continue;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        const int col = c_out + tc + 8 * c;
        if (col >= d) continue;
        const long long at = (kvr * sk + key) * d + col;
        if (part != nullptr) {
          part[2 * blockIdx.y * n_out + at] = acc_k[i][c];
          part[(2 * blockIdx.y + 1) * n_out + at] = acc_v[i][c];
        } else {
          dk[at] = narrow<T>(acc_k[i][c]);
          dv[at] = narrow<T>(acc_v[i][c]);
        }
      }
    }
  }
}

// ---- launch -----------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dO;
  const float *lse, *delta;
  const int* kpm;
  int bh, sq, sk, d, heads, group;
  float scale;
  int causal, window;
};

// may the bf16 kernels load q, k, v and dO by 16-byte cp.async?
int vectorised(const Args& a) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return a.d % 8 == 0 && aligned(a.q) && aligned(a.k) && aligned(a.v) && aligned(a.dO);
}

template <typename T> const T* ptr(const void* p) { return static_cast<const T*>(p); }

// blocks along y or z for n rows in tiles of `tile`: one a tile up to the
// grid's 65535, past which each block walks several
unsigned tile_blocks(int n, int tile) {
  const int tiles = (n + tile - 1) / tile;
  return (unsigned)(tiles < 65535 ? tiles : 65535);
}

template <int DMAX>
int launch_dq_mma(const Args& a, void* dq, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dq_mma<DMAX>;
  const size_t smem = MmaSmem<DMAX>::bytes;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.bh, tile_blocks(a.sq, kB));
  kernel<<<grid, kThreads, smem, stream>>>(
      ptr<bf16>(a.q), ptr<bf16>(a.k), ptr<bf16>(a.v), ptr<bf16>(a.dO), a.lse, a.delta, a.kpm,
      static_cast<bf16*>(dq), a.sq, a.sk, a.d, a.heads, a.group, a.scale, a.causal, a.window,
      vectorised(a));
  return (int)cudaGetLastError();
}

// The grid's slow dimension is the key tile, so the first (under a causal
// mask, the longest) tiles start first; a (batch, kv head) row's NC
// column blocks are neighbours along x. With splits > 1, sum_splits then
// adds the partials.
template <int DMAX>
int launch_dkv_mma(const Args& a, void* dk, void* dv, float* work, int splits,
                   cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dkv_mma<DMAX>;
  const size_t smem = MmaSmem<DMAX>::bytes;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)(a.bh / a.group) * Dkv<DMAX>::NC;
  const dim3 grid((unsigned)rows, splits, tile_blocks(a.sk, kB));
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<grid, kThreads, smem, stream>>>(
      ptr<bf16>(a.q), ptr<bf16>(a.k), ptr<bf16>(a.v), ptr<bf16>(a.dO), a.lse, a.delta, a.kpm,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), splits > 1 ? work : nullptr, a.sq, a.sk,
      a.d, a.heads, a.group, a.scale, a.causal, a.window, vectorised(a));
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = (long long)(a.bh / a.group) * a.sk * a.d;
    sum_splits<<<1024, 256, 0, stream>>>(work, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                         n, splits);
  }
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dq_kernel<DMAX>;
  const size_t smem = Scalar<DMAX>::dq_bytes;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  constexpr int BR = Scalar<DMAX>::BR;
  const dim3 grid(a.bh, tile_blocks(a.sq, BR));
  kernel<<<grid, kThreads, smem, stream>>>(
      ptr<float>(a.q), ptr<float>(a.k), ptr<float>(a.v), ptr<float>(a.dO), a.lse, a.delta, a.kpm,
      static_cast<float*>(dq), a.sq, a.sk, a.d, a.heads, a.group, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_dkv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_bwd_dkv_kernel<DMAX>;
  const size_t smem = Scalar<DMAX>::dkv_bytes;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  constexpr int BR = Scalar<DMAX>::BR;
  const dim3 grid(a.bh / a.group, tile_blocks(a.sk, BR));
  kernel<<<grid, kThreads, smem, stream>>>(
      ptr<float>(a.q), ptr<float>(a.k), ptr<float>(a.v), ptr<float>(a.dO), a.lse, a.delta, a.kpm,
      static_cast<float*>(dk), static_cast<float*>(dv), a.sq, a.sk, a.d, a.heads, a.group,
      a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

// head_dim > 256 (flash_bwd_dq_wide), either dtype: ceil(d / OC) column
// blocks along z.
template <typename T>
int launch_dq_wide(const Args& a, void* dq, cudaStream_t stream) {
  constexpr int OC = 128;
  static bool done = false;
  auto kernel = flash_bwd_dq_wide<T, OC>;
  const size_t smem = wide_dq_bytes(OC);
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const int nc = (a.d + OC - 1) / OC;
  if (nc > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(a.bh, tile_blocks(a.sq, kB), nc);
  kernel<<<grid, kThreads, smem, stream>>>(
      ptr<T>(a.q), ptr<T>(a.k), ptr<T>(a.v), ptr<T>(a.dO), a.lse, a.delta, a.kpm,
      static_cast<T*>(dq), a.sq, a.sk, a.d, a.heads, a.group, a.scale, a.causal, a.window);
  return (int)cudaGetLastError();
}

// head_dim > 256 (flash_bwd_dkv_wide): a (batch, kv head) row's column
// blocks are neighbours along x, the splits along y, the key tiles along z;
// with splits > 1, sum_splits adds the partials (bf16 only).
template <typename T>
int launch_dkv_wide(const Args& a, void* dk, void* dv, float* work, int splits,
                    cudaStream_t stream) {
  constexpr int OC = 64;
  static bool done = false;
  auto kernel = flash_bwd_dkv_wide<T, OC>;
  const size_t smem = wide_dkv_bytes(OC);
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)(a.bh / a.group) * ((a.d + OC - 1) / OC);
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)rows, splits, tile_blocks(a.sk, kB));
  kernel<<<grid, kThreads, smem, stream>>>(
      ptr<T>(a.q), ptr<T>(a.k), ptr<T>(a.v), ptr<T>(a.dO), a.lse, a.delta, a.kpm,
      static_cast<T*>(dk), static_cast<T*>(dv), splits > 1 ? work : nullptr, a.sq, a.sk, a.d,
      a.heads, a.group, a.scale, a.causal, a.window);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = (long long)(a.bh / a.group) * a.sk * a.d;
    sum_splits<<<1024, 256, 0, stream>>>(work, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                         n, splits);
  }
  return (int)cudaGetLastError();
}

bool bad_args(const Args& a) {
  return a.d < 1 || a.bh < 0 || a.group < 1 || a.heads < 1 ||
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
// contiguous. d >= 1; bh rides the grids' x dimension (any int),
// the query and key tiles y and z (any number: past 65535 a block walks
// several). dtype: 0 =
// float32 (scalar kernels), 1 = bfloat16 (tensor cores). window <= 0 means
// none (it applies only with causal). Returns the cudaError_t of the
// launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                            const void* lse, const void* delta, const void* kpm, void* dq,
                            int bh, int sq, int sk, int d, int heads, int group, float scale,
                            int causal, int window, int dtype, void* stream) {
  const Args a = make_args(q, k, v, dO, lse, delta, kpm, bh, sq, sk, d, heads, group, scale,
                           causal, window);
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 256 && dtype == 0) return launch_dq_wide<float>(a, dq, s);
  if (d > 256 && dtype == 1) return launch_dq_wide<bf16>(a, dq, s);
  if (dtype == 0) {
    if (d <= 64) return launch_dq<64>(a, dq, s);
    return d <= 128 ? launch_dq<128>(a, dq, s) : launch_dq<256>(a, dq, s);
  }
  if (dtype == 1) {
    if (d <= 64) return launch_dq_mma<64>(a, dq, s);
    return d <= 128 ? launch_dq_mma<128>(a, dq, s) : launch_dq_mma<256>(a, dq, s);
  }
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq; dk, dv: (bh / group, sk, d), each written once. bf16
// only: `splits` (a divisor of group) blocks share each group, each
// summing its group / splits query heads into fp32 partials in `work`
// (2 * splits * (bh / group) * sk * d floats, unused when splits == 1),
// which a second pass adds in split order. fp32 takes splits == 1.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                             const void* lse, const void* delta, const void* kpm, void* dk,
                             void* dv, void* work, int bh, int sq, int sk, int d, int heads,
                             int group, int splits, float scale, int causal, int window,
                             int dtype, void* stream) {
  const Args a = make_args(q, k, v, dO, lse, delta, kpm, bh, sq, sk, d, heads, group, scale,
                           causal, window);
  if (bad_args(a) || splits < 1 || group % splits != 0 || splits > 65535 ||
      (splits > 1 && (dtype != 1 || work == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || sk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (d > 256 && dtype == 0) return launch_dkv_wide<float>(a, dk, dv, w, 1, s);
  if (d > 256 && dtype == 1) return launch_dkv_wide<bf16>(a, dk, dv, w, splits, s);
  if (dtype == 0) {
    if (d <= 64) return launch_dkv<64>(a, dk, dv, s);
    return d <= 128 ? launch_dkv<128>(a, dk, dv, s) : launch_dkv<256>(a, dk, dv, s);
  }
  if (dtype == 1) {
    if (d <= 64) return launch_dkv_mma<64>(a, dk, dv, w, splits, s);
    return d <= 128 ? launch_dkv_mma<128>(a, dk, dv, w, splits, s)
                    : launch_dkv_mma<256>(a, dk, dv, w, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}
