// Flash-attention forward for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/attention.py:_flash_fwd_kernel (called through
// _flash_fwd): online-softmax attention that writes o in q's dtype and the
// fp32 log-sum-exp. Same contract as the TPU kernel: causal block skip,
// sliding-window band, int32 (b, sk) key-padding row (1 = padded), GQA with
// kv row = bh / group, scores masked to -1e30, softmax statistics and the
// accumulator in fp32, l summed from the fp32 p, P rounded to V's dtype
// only as the operand of P.V, and a row whose keys are all masked writes
// o = 0 and lse = +1e30. Causal is bottom-right aligned (a query row r sits
// at key position r + sk - sq), the convention of causal_mask, so sq != sk
// needs no separate path; ragged sq/sk edges are masked in the kernel (the
// TPU's sq % bq == 0 rule is a tiling rule, not semantics), and K/V stream
// through shared memory, so there is no K/V residency limit.
//
// What bounds it on the card: operations for prefill and training
// (4 * d flops per (query, key) pair the masks keep), bytes for decode
// (sq = 1: each kept K/V element is read once for two flops per query head).
//
// bf16 prefill and training (sq > 1), flash_fwd_mma: tensor cores, in the
// design of the backward (flash_attention_bwd.cu) and with its helpers
// (flash_mma.cuh). Each warp owns 16 query rows (the M of mma.m16n8k16),
// read once into registers as A fragments by ldmatrix; a block of 8 warps
// (4 at d = 128) shares K and V tiles of 64 keys, which 16-byte cp.async
// copies into shared memory three stages ahead. Per tile each warp computes
// S = Q.K^T on mma_bf16 into fp32 C fragments and runs the online softmax
// on the fragments: a row's max and sum are trees over the lane's values
// and two shuffles over the 4 lanes that hold the row, the scale goes into
// the exp (p = 2^(s * scale * log2(e) - m), one FFMA and one ex2.approx),
// and masks are tested only in the 16 x 16 chunks that cross the causal
// diagonal, the window's lower edge, ragged sq/sk or key padding. The C
// fragments of P, packed to bf16 in pairs, are directly the A fragment of
// O += P.V, with V's B fragments from ldmatrix.trans: P never goes to
// shared memory. lse goes back to natural-log units (m * ln 2 + log l),
// because the backward reads it as exp(s * scale - lse). Query tiles are
// issued last-to-first (under a causal mask the last see the most keys),
// and a GQA group's query heads sit on neighbouring blockIdx.x, so that
// their shared K/V tiles are read from L2. The kernel is bound by latency
// rather than by the tensor cores (PERF.md, PR 5), so registers are capped
// at 128 a thread for 16 warps an SM, and the product loops are
// straight-line code: head_dim 64, 128 and 256 have their own
// instantiations with a compile-time step count; another head_dim up to
// 256 is zero-padded to the next of them and only the 16-wide steps
// that hold data are computed. At d = 256 a warp's fp32 accumulator alone
// is 128 registers a thread, so Q does not sit in registers there: it
// keeps a tile of shared memory of its own, and each 16-wide step reads
// its A fragment by ldmatrix; K and V take two stages, one 4-warp block
// an SM (165 KB). A head_dim that is not a
// multiple of 8, or an input that is not 16-byte aligned, is loaded element
// by element instead of by cp.async.
//
// bf16 decode (sq = 1, the engine's step), flash_decode_mma: bound by the
// bytes of the cache, so the design is about reading each kept K/V byte
// once and filling the card at small batch. One block serves one (batch,
// kv head) pair, and its 16 fragment rows are that kv head's query heads
// (8 at Llama's 32/4, 1 at GPT-2; a group of more than 16 takes several
// blocks), so each K/V tile is read once for the whole group. The pair's
// 64-key tiles are split over gridDim.y blocks (the split count comes from
// the shapes alone, ops/attention.py:_decode_splits). A block first reads
// the key-padding row of its tiles and skips every tile it pads wholly
// (a lane's unwritten future) without reading its K or V; the live tiles
// stream through shared memory by cp.async, double-buffered, and warp w
// takes keys 16w..16w+15 of each tile on the tensor cores, with its own
// online-softmax state. The four warps' states merge through shared memory
// in warp order. The splits of a pair run as one thread-block cluster (at
// most 8 blocks): each leaves its partial (unnormalised o, the row max m
// and the row sum l) in its shared memory, and the blocks read them over
// distributed shared memory and merge them in split order, each block a
// share of the columns, so a repeat call is bit-equal and no second kernel
// or global scratch is needed (a second kernel over fp32 partials in
// global memory cost about a third of the step). A state whose keys
// were all masked (a dead warp or split) adds nothing; a row with no kept
// key anywhere writes o = 0 and lse = +1e30. At d = 256 the same design
// keeps Q in registers beside the accumulator (253-255 registers, no
// spills) with 132 KB of K/V stages: one block an SM.
//
// fp32, the parity dtype (the card-against-CPU checks and fp32 serving):
// the first version's scalar FMA kernel, flash_fwd_kernel. TF32 tensor
// cores would keep about 3 decimal digits and break its 1e-4 checks.
//
// head_dim > 256, both dtypes, prefill and decode: flash_fwd_wide, scalar
// FMAs over 64-wide chunks of head_dim, each block owning 128 of the
// output's columns (flash_wide.cuh); bf16 decode keeps its splits, merged
// in a cluster as above. No model the port reads goes past 256, so this
// route is written to be right, not fast (its times are in PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "flash_wide.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace flash_mma;

constexpr float kMasked = kNegInf * kLog2e;  // a masked score, in the log2 domain
constexpr int kLiveTiles = 128;  // 64-key tiles a decode block tests for liveness at once
constexpr int kMaxSplits = 8;    // the portable cluster size

// ---- bf16: tensor cores -----------------------------------------------------

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Reduces v[0..N) into v[0] pairwise (depth log2 N, not N: the chains of
// one lane's row are the softmax's latency).
template <int N, typename Op>
__device__ __forceinline__ float tree(float (&v)[N], Op op) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n) v[n] = op(v[n], v[n + w]);
  return v[0];
}

// One online-softmax step of a warp's 16 rows over NT 8-key C fragments s
// of raw scores q.k, -inf where a mask drops the pair (only when `masked`):
// m (the row max of scaled scores in the log2 domain, the same in the 4
// lanes of a row) and l (this lane's partial row sum) of rows g and g + 8
// are updated, the NA accumulator fragments rescaled, and s becomes p. The
// scale goes into the exp, p = 2^(s * sl2 - m), as one FFMA (the row max of
// s * sl2 is sl2 times that of s). A masked pair scores -1e30 as in the TPU
// kernel: its p is 2^(kMasked - m), 0 once the row has a kept key, 1 before
// (the spurious sum that a later kept key's rescale by 0 removes, or that
// marks the row dead).
template <int NT, int NA>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                             float (&acc)[NA][4], float sl2, bool masked) {
  float alpha[2], nm[2], pm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) v[n] = fmaxf(s[n][2 * i], s[n][2 * i + 1]);
    const float mx = fmaxf(m[i], quad_max(tree(v, [](float a, float b) { return fmaxf(a, b); })) * sl2);
    alpha[i] = exp2_approx(m[i] - mx);
    m[i] = mx;
    nm[i] = -mx;
    pm[i] = masked ? exp2_approx(kMasked - mx) : 0.f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[n][e];
      s[n][e] = exp2_approx(fmaf(x, sl2, nm[e >> 1]));
      if (masked && x == -CUDART_INF_F) s[n][e] = pm[e >> 1];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) v[n] = s[n][2 * i] + s[n][2 * i + 1];
    l[i] = l[i] * alpha[i] + tree(v, [](float a, float b) { return a + b; });
  }
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
}

// O += P.V for one 16-key chunk: p0, p1 are the C fragments of its two
// 8-key halves, the rows of tV at r0.. its keys.
template <int KS, int LD>
__device__ __forceinline__ void add_pv(float (&acc)[2 * KS][4], const float (&p0)[4],
                                       const float (&p1)[4], const bf16* tV, int r0, int kd,
                                       int lane) {
  const uint32_t pa[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                          pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
#pragma unroll
  for (int np = 0; np < KS; ++np) {
    if (np < kd) {
      uint32_t b[4];
      load_b_kn<LD>(b, tV, r0, np * 16, lane);
      mma_bf16(acc[2 * np], pa, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
    }
  }
}

template <int DMAX> struct FwdSmem {
  static constexpr int LD = DMAX + 8;   // bf16 row stride: 16 bytes of padding
  static constexpr int TILE = kB * LD;  // bf16 elements of one 64-row tile
  // decode: 2 stages of K and V, later each warp's and the block's m and l
  // of 16 rows and each warp's acc
  static constexpr size_t stage_bytes = 4 * TILE * sizeof(bf16);
  static constexpr size_t merge_bytes = (2 * 4 * 16 + 2 * 16 + 4 * 16 * DMAX) * sizeof(float);
  static constexpr size_t decode_bytes = stage_bytes > merge_bytes ? stage_bytes : merge_bytes;
};

// The prefill kernel's shape, chosen by timing variants on the card
// (PERF.md, PR 5). The kernel is bound by latency, so the warps an SM count
// most: a warp owns one m16 tile of query rows (two would share every K and
// V fragment, but need 250 registers, and 8 such warps an SM ran slower
// than 16 of one tile). WARPS: warps a block, which share each K/V tile
// (8 at d <= 64, faster than 4 at the training shapes, where the time
// goes, though 4 fill a short prefill's grid better; 4 at d = 128). NS:
// K/V stages in flight (3; 4 was no faster); Q is read into registers at
// the first tile, so it lands in the last stage's slot. Two blocks an SM cap the registers
// at 128 a thread at d <= 64: 16 warps an SM. QREG: Q in registers (up to
// d = 128); at d = 256 it stays in a tile of its own after two K/V stages,
// and one block an SM leaves a thread 255 registers.
template <int DMAX> struct Prefill {
  static constexpr int WARPS = DMAX <= 64 ? 8 : 4;
  static constexpr bool QREG = DMAX <= 128;
  static constexpr int NS = QREG ? 3 : 2;
  static constexpr int BLOCKS = QREG ? 2 : 1;  // blocks an SM, for __launch_bounds__
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;  // query rows a block owns
  static constexpr size_t bytes = (NS * 2 + (QREG ? 0 : 1)) * FwdSmem<DMAX>::TILE * sizeof(bf16);
  static_assert(QREG ? NS >= 3 && BQ <= 2 * kB : BQ <= kB,
                "Q must fit the last stage's K and V tiles, or its own tile");
};

// KD: the 16-wide head_dim steps that hold data when d fills DMAX (a
// compile-time trip count, so the product loops carry no test; that test
// cost a quarter of the kernel's time, PERF.md), or 0 for a zero-padded
// head_dim, whose steps are counted at run time.
template <int DMAX, int KD>
__global__ void __launch_bounds__(Prefill<DMAX>::THREADS, Prefill<DMAX>::BLOCKS)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const int* __restrict__ kpm, bf16* __restrict__ o, float* __restrict__ lse, int sq,
              int sk, int d, int heads, int group, float scale, int causal, int window, int vec,
              int tile0) {
  using Sm = FwdSmem<DMAX>;
  constexpr int LD = Sm::LD, KS = DMAX / 16;  // 16-wide steps over head_dim
  constexpr int BQ = Prefill<DMAX>::BQ, NS = Prefill<DMAX>::NS, TH = Prefill<DMAX>::THREADS;
  constexpr bool QREG = Prefill<DMAX>::QREG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: K at s * 2 * TILE, V after it; Q in the last stage at first
  // (QREG), else in its own tile after the stages
  bf16* sKV = reinterpret_cast<bf16*>(smem_raw);
  bf16* sQ = sKV + (QREG ? NS - 1 : NS) * 2 * Sm::TILE;

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // tile tile0 + blockIdx.y of the launches, the longest causal tiles first
  const int q0 = ((sq + BQ - 1) / BQ - 1 - tile0 - (int)blockIdx.y) * BQ;
  const long long bh = blockIdx.x, kvh = bh / group;
  const int offs = sk - sq;
  const int* kpm_row = kpm ? kpm + (bh / heads) * sk : nullptr;
  const int kd = KD > 0 ? KD : (d + 15) / 16;
  const float sl2 = scale * kLog2e;

  int t_lo, t_hi;
  key_band(q0, sq, sk, offs, causal, window, t_lo, t_hi, BQ);
  const int n_iter = t_hi > t_lo ? t_hi - t_lo : 0;

  // tile it into stage it % NS; one commit group per tile, even an empty one
  auto issue = [&](int it) {
    if (it < n_iter) {
      bf16* st = sKV + (it % NS) * 2 * Sm::TILE;
      const int k0 = (t_lo + it) * kB;
      load_tile_bf16<DMAX, TH>(st, k + kvh * sk * d, k0, sk, d, vec);
      load_tile_bf16<DMAX, TH>(st + Sm::TILE, v + kvh * sk * d, k0, sk, d, vec);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int r = 0; r < BQ; r += kB)
    load_tile_bf16<DMAX, TH>(sQ + r * LD, q + bh * sq * d, q0 + r, sq, d, vec);
#pragma unroll
  for (int it = 0; it < NS - 1; ++it) issue(it);  // Q goes with tile 0's group

  // the warp's 16 query rows; the lane's are rows g and g + 8 of them
  const int qw = q0 + (threadIdx.x >> 5) * 16;
  const bool warp_live = qw < sq;

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[KS][4];

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<NS - 2>();  // tile it has landed
    __syncthreads();          // and every warp is done with tile it - 1
    if (QREG && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) load_a<LD>(qf[kk], sQ, qw - q0, kk * 16, lane);
      __syncthreads();  // Q's slot is free for tile NS - 1
    }
    issue(it + NS - 1);  // into the stage tile it - 1 used
    const bf16* tK = sKV + (it % NS) * 2 * Sm::TILE;
    const bf16* tV = tK + Sm::TILE;
    const int k0 = (t_lo + it) * kB;
    // a tile wholly after the warp's last row, or before its first row's
    // window, is skipped
    const bool warp_sees =
        !causal || (k0 <= qw + 15 + offs && (window <= 0 || k0 + kB - 1 > qw + offs - window));
    if (!warp_live || !warp_sees) continue;

    // S = Q.K^T, 16 queries x 64 keys: 8 C fragments of 8 keys. (Two
    // online-softmax steps of 32 keys a tile, which could overlap one
    // half's softmax with the other's mma, ran 7% slower.)
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < kd) {
        uint32_t qs[4];
        if constexpr (!QREG) load_a<LD>(qs, sQ, qw - q0, kk * 16, lane);
        const uint32_t(&qa)[4] = QREG ? qf[kk] : qs;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          uint32_t b[4];
          load_b_nk<LD>(b, tK, nb * 16, kk * 16, lane);
          mma_bf16(sc[2 * nb], qa, b[0], b[1]);
          mma_bf16(sc[2 * nb + 1], qa, b[2], b[3]);
        }
      }
    }
    // masks: pairs tested one by one only in a 16 x 16 chunk that crosses
    // an edge of the band, of sq or sk, or has key padding
    bool masked = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kc = k0 + c * 16;
      const bool edge = kpm_row != nullptr || qw + 16 > sq || kc + 16 > sk ||
                        (causal && (kc + 15 > qw + offs ||
                                    (window > 0 && kc <= qw + 15 + offs - window)));
      if (edge) {
        masked = true;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kc + j * 8 + 2 * t + (e & 1);
            if (!attends(qw + g + 8 * (e >> 1), col,
                         col < sk && (kpm_row == nullptr || kpm_row[col] == 0), sq, offs, causal,
                         window))
              sc[2 * c + j][e] = -CUDART_INF_F;
          }
      }
    }
    softmax_step(sc, m, l, acc, sl2, masked);
#pragma unroll
    for (int c = 0; c < 4; ++c) add_pv<KS, LD>(acc, sc[2 * c], sc[2 * c + 1], tV, c * 16, kd, lane);
  }
  cp_async_wait<0>();  // nothing left in flight (a block with no tile in its band)

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = fmaxf(quad_sum(l[i]), 1e-30f);
    // every key masked: zeros and the +1e30 lse sentinel, not the uniform
    // softmax the finite masked scores accumulated
    const bool dead = m[i] <= kMasked * 0.5f;
    const int r = qw + g + 8 * i;
    if (r >= sq) continue;
    bf16* orow = o + (bh * sq + r) * d;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      const int col = n * 8 + 2 * t;
      const float v0 = dead ? 0.f : acc[n][2 * i] / li;
      const float v1 = dead ? 0.f : acc[n][2 * i + 1] / li;
      if (d % 2 == 0) {
        if (col < d) *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < d) orow[col] = __float2bfloat16(v0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16(v1);
      }
    }
    if (t == 0) lse[bh * sq + r] = dead ? -kNegInf : m[i] * kLn2 + logf(li);
  }
}

// (r, c) and (r, c + 1) of a (nrows, d) bf16 matrix packed as an A-fragment
// register, zero outside it
__device__ __forceinline__ uint32_t pair_bf16(const bf16* __restrict__ x, int r, int c, int nrows,
                                              int d) {
  const bf16 zero = __float2bfloat16(0.f);
  const bf16 lo = r < nrows && c < d ? x[r * d + c] : zero;
  const bf16 hi = r < nrows && c + 1 < d ? x[r * d + c + 1] : zero;
  __nv_bfloat162 p = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Row r's o (orow) and lse from the partials of the cluster's `splits`
// blocks, merged in split order: this block's share of the columns (8-wide
// chunks j = rank, rank + splits, ...), all of a column's splits loaded at
// once; a split whose keys were all masked adds nothing.
template <int DMAX>
__device__ __forceinline__ void merge_splits(cg::cluster_group& cluster, int splits, int r, int c0,
                                             int d, float* bm, float* bl, float* wacc,
                                             bf16* __restrict__ orow, float* __restrict__ lse) {
  float ms[kMaxSplits], ws[kMaxSplits], ls[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    ms[s] = s < splits ? *cluster.map_shared_rank(bm + r, s) : kMasked;
    ls[s] = s < splits ? *cluster.map_shared_rank(bl + r, s) : 0.f;
  }
  float mx = kMasked;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) mx = fmaxf(mx, ms[s]);
  const bool dead = mx <= kMasked * 0.5f;
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    ws[s] = dead || ms[s] <= kMasked * 0.5f ? 0.f : exp2f(ms[s] - mx);
    sum += ws[s] * ls[s];
  }
  const float li = fmaxf(sum, 1e-30f);
  const int rank = cluster.block_rank();
  for (int c = c0 + 8 * rank; c < d; c += 8 * splits) {
    float as[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      as[s] = ws[s] != 0.f ? *cluster.map_shared_rank(wacc + r * DMAX + c, s) : 0.f;
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) a += ws[s] * as[s];
    orow[c] = __float2bfloat16(dead ? 0.f : a / li);
  }
  if (rank == 0 && c0 == 0) *lse = dead ? -kNegInf : mx * kLn2 + logf(li);
}

// Decode, sq = 1. Block (blockIdx.x, blockIdx.y) = ((batch, kv head) pair
// and a slice of 16 of its query heads, split); the splits of a pair form
// one thread-block cluster along y, whose blocks merge them (merge_splits).
template <int DMAX, int KD>  // KD as in flash_fwd_mma
__global__ void __launch_bounds__(kThreads, DMAX <= 64 ? 4 : 2)
flash_decode_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ kpm, bf16* __restrict__ o,
                 float* __restrict__ lse, int sk, int d, int heads, int group,
                 int tiles_per_split, float scale, int causal, int window, int vec) {
  using Sm = FwdSmem<DMAX>;
  constexpr int LD = Sm::LD, KS = DMAX / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // 2 stages
  bf16* sV = sK + 2 * Sm::TILE;                  // 2 stages
  __shared__ unsigned live[kLiveTiles / 32];

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
  const int slices = (group + 15) / 16;
  const long long pair = blockIdx.x / slices;
  const int r0 = (blockIdx.x % slices) * 16;  // the block's first query head in the group
  const int nrows = min(16, group - r0);
  const long long row0 = pair * group + r0;  // its q row (sq = 1: the bh index)
  const int* kpm_row = kpm ? kpm + (row0 / heads) * sk : nullptr;
  const int kd = KD > 0 ? KD : (d + 15) / 16;
  const float sl2 = scale * kLog2e;
  // the query sits at key position sk - 1: causal keeps every key, the
  // window the keys from k_lo on
  const int k_lo = causal && window > 0 ? max(0, sk - window) : 0;
  const int tiles = (sk + kB - 1) / kB;
  const int first = max((int)blockIdx.y * tiles_per_split, k_lo / kB);
  const int n = max(min((int)(blockIdx.y + 1) * tiles_per_split, tiles) - first, 0);
  const bf16* kb = k + pair * sk * d;
  const bf16* vb = v + pair * sk * d;

  // the block's query rows as A fragments (rows past the group are zero),
  // loaded first, so that their latency overlaps the live-tile pass
  uint32_t qf[KS][4];
  const bf16* qb = q + row0 * d;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = pair_bf16(qb, g, c, nrows, d);
    qf[kk][1] = pair_bf16(qb, g + 8, c, nrows, d);
    qf[kk][2] = pair_bf16(qb, g, c + 8, nrows, d);
    qf[kk][3] = pair_bf16(qb, g + 8, c + 8, nrows, d);
  }

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[2 * KS][4];
#pragma unroll
  for (int nn = 0; nn < 2 * KS; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
  const int kw = warp * 16;  // the warp's keys in each tile

  // the split's tiles, kLiveTiles at a time; `it` counts the tiles
  // computed, and the next goes to stage it & 1
  int it = 0;
  for (int w0 = 0; w0 < n; w0 += kLiveTiles) {
    const int nw = min(kLiveTiles, n - w0);
    const int t0 = first + w0;
    // live[j]: does tile t0 + j hold a key that the window and the
    // key-padding row keep? A tile padded wholly is never read.
    __syncthreads();  // the previous window's live[] is read no more
    if (threadIdx.x < kLiveTiles / 32) live[threadIdx.x] = 0u;
    __syncthreads();
    for (int j = warp; j < nw; j += kThreads / 32) {
      const int k0 = (t0 + j) * kB;
      bool keep = false;
      for (int e = lane; e < kB; e += 32) {
        const int col = k0 + e;
        keep = keep || (col < sk && col >= k_lo && (kpm_row == nullptr || kpm_row[col] == 0));
      }
      if (__any_sync(0xffffffffu, keep) && lane == 0) atomicOr(&live[j >> 5], 1u << (j & 31));
    }
    __syncthreads();
    auto next_live = [&](int j) {
      while (j < nw) {
        const unsigned bits = live[j >> 5] >> (j & 31);
        if (bits) return min(j + __ffs(bits) - 1, nw);
        j = (j & ~31) + 32;
      }
      return nw;
    };
    auto issue = [&](int j, int st) {
      const int k0 = (t0 + j) * kB;
      load_tile_bf16<DMAX>(sK + st * Sm::TILE, kb, k0, sk, d, vec);
      load_tile_bf16<DMAX>(sV + st * Sm::TILE, vb, k0, sk, d, vec);
    };
    int cur = next_live(0);
    if (cur < nw) issue(cur, it & 1);
    cp_async_commit();
    for (; cur < nw; ++it) {
      const int nxt = next_live(cur + 1);
      if (nxt < nw) issue(nxt, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const bf16* tK = sK + (it & 1) * Sm::TILE;
      const bf16* tV = sV + (it & 1) * Sm::TILE;
      const int kc = (t0 + cur) * kB + kw;
      if (kc < sk) {
        float sc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          if (kk < kd) {
            uint32_t b[4];
            load_b_nk<LD>(b, tK, kw, kk * 16, lane);
            mma_bf16(sc[0], qf[kk], b[0], b[1]);
            mma_bf16(sc[1], qf[kk], b[2], b[3]);
          }
        }
        const bool edge = kpm_row != nullptr || kc + 16 > sk || kc < k_lo;
        if (edge) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = kc + j * 8 + 2 * t + (e & 1);
              if (!attends(0, col, col < sk && (kpm_row == nullptr || kpm_row[col] == 0), 1,
                           sk - 1, causal, window))
                sc[j][e] = -CUDART_INF_F;
            }
        }
        softmax_step(sc, m, l, acc, sl2, edge);
        add_pv<KS, LD>(acc, sc[0], sc[1], tV, kw, kd, lane);
      }
      __syncthreads();  // stage it & 1 is read no more before the next issue fills it
      cur = nxt;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the staging area becomes the merge area

  // each warp's statistics and accumulator of its 16 rows; then the block's
  // (bm, bl, and bacc in warp 0's slot)
  float* wm = reinterpret_cast<float*>(smem_raw);  // [warp][row]
  float* wl = wm + 4 * 16;
  float* bm = wl + 4 * 16;  // [row]
  float* bl = bm + 16;
  float* wacc = bl + 16;  // [warp][row][DMAX]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    if (t == 0) {
      wm[warp * 16 + g + 8 * i] = m[i];
      wl[warp * 16 + g + 8 * i] = li;
    }
  }
#pragma unroll
  for (int nn = 0; nn < 2 * KS; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wacc[(warp * 16 + g + 8 * (e >> 1)) * DMAX + nn * 8 + 2 * t + (e & 1)] = acc[nn][e];
  __syncthreads();

  // thread (r, c0) merges row r, columns c0 + 8j, over the warps in order;
  // a warp whose keys were all masked adds nothing
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
  float mx = kMasked;
#pragma unroll
  for (int w = 0; w < 4; ++w) mx = fmaxf(mx, wm[w * 16 + r]);
  bool dead = mx <= kMasked * 0.5f;
  float wt[4], sum = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    wt[w] = dead || wm[w * 16 + r] <= kMasked * 0.5f ? 0.f : exp2f(wm[w * 16 + r] - mx);
    sum += wt[w] * wl[w * 16 + r];
  }
  for (int c = c0; c < d; c += 8) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) a += wt[w] * wacc[(w * 16 + r) * DMAX + c];
    wacc[r * DMAX + c] = a;  // read above by this thread only
  }
  if (c0 == 0) {
    bm[r] = dead ? kMasked : mx;
    bl[r] = sum;
  }

  // with splits, the cluster's blocks merge their rows from each other's
  // shared memory (merge_splits)
  const int splits = gridDim.y;
  if (splits == 1) {
    if (r < nrows) {
      const float li = fmaxf(sum, 1e-30f);
      for (int c = c0; c < d; c += 8)
        o[(row0 + r) * d + c] = __float2bfloat16(dead ? 0.f : wacc[r * DMAX + c] / li);
      if (c0 == 0) lse[row0 + r] = dead ? -kNegInf : mx * kLn2 + logf(li);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (r < nrows) merge_splits<DMAX>(cluster, splits, r, c0, d, bm, bl, wacc, o + (row0 + r) * d,
                                    lse + row0 + r);
  cluster.sync();  // each block's shared memory outlives the others' reads
}

// ---- fp32: scalar FMAs ------------------------------------------------------
//
// A block of 128 threads owns BQ query rows (64, or 16 when sq <= 16 so that
// a decode step does not pay for 63 masked rows) and streams K/V through
// shared memory in fp32 tiles of 64 keys (Smem<64, 256>: 209 KB). Thread
// (tr, tc) holds BQ/16 rows and key/output columns tc + 8j; each row's 8
// threads sit in one warp, so row max and row sum are three shuffles.

constexpr int kBK = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// Reduces over the 8 threads (consecutive lanes) that share a row.
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

template <int BQ, int DMAX> struct Smem {
  static constexpr int QS = DMAX + 1, KS = DMAX + 1, PS = kBK + 1;
  static constexpr int floats = BQ * QS + kBK * KS + kBK * DMAX + BQ * PS;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int BQ, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ kpm, T* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int d, int heads, int group, float scale, int causal,
                 int window, int tile0) {
  constexpr int RP = BQ / 16;    // rows per thread
  constexpr int CP = kBK / 8;    // score columns per thread
  constexpr int DP = DMAX / 8;   // output columns per thread
  using S = Smem<BQ, DMAX>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * S::QS;
  float* sV = sK + kBK * S::KS;
  float* sP = sV + kBK * DMAX;

  const int t = threadIdx.x, tr = t >> 3, tc = t & 7;
  const int q0 = (tile0 + (int)blockIdx.y) * BQ;
  const long long bh = blockIdx.x;  // on x, which holds 2^31 - 1 blocks
  const long long kvh = bh / group;
  const long long offs = (long long)sk - sq;
  const T* qb = q + bh * sq * d;
  const T* kb = k + kvh * sk * d;
  const T* vb = v + kvh * sk * d;
  const int* kpm_row = kpm ? kpm + (bh / heads) * sk : nullptr;

  for (int e = t; e < BQ * DMAX; e += kThreads) {
    const int r = e / DMAX, c = e % DMAX;
    sQ[r * S::QS + c] = (q0 + r < sq && c < d) ? to_f(qb[(long long)(q0 + r) * d + c]) : 0.f;
  }

  // Key range this tile can see: _causal_hi / _window_lo at key granularity.
  long long k_lo = 0, k_hi = sk;
  if (causal) {
    const long long last_row = lmin(q0 + BQ, sq) - 1;
    k_hi = lmax(0, lmin(sk, last_row + offs + 1));
    if (window > 0) k_lo = lmax(0, q0 + offs - window + 1);
  }
  const int t_lo = (int)(k_lo / kBK), t_hi = (int)((k_hi + kBK - 1) / kBK);

  float m[RP], l[RP], acc[RP][DP];
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[i][c] = 0.f;
  }

  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's sK/sV/sP are no longer read
    for (int e = t; e < kBK * DMAX; e += kThreads) {
      const int r = e / DMAX, c = e % DMAX;
      const bool in = k0 + r < sk && c < d;
      const long long g = (long long)(k0 + r) * d + c;
      sK[r * S::KS + c] = in ? to_f(kb[g]) : 0.f;
      sV[r * DMAX + c] = in ? to_f(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[RP][CP];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < CP; ++j) s[i][j] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float a[RP], b[CP];
#pragma unroll
      for (int i = 0; i < RP; ++i) a[i] = sQ[(tr * RP + i) * S::QS + dd];
#pragma unroll
      for (int j = 0; j < CP; ++j) b[j] = sK[(tc + 8 * j) * S::KS + dd];
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < CP; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    bool key_ok[CP];
#pragma unroll
    for (int j = 0; j < CP; ++j) {
      const int col = k0 + tc + 8 * j;
      key_ok[j] = col < sk && (kpm_row == nullptr || kpm_row[col] == 0);
    }
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const long long row = (long long)q0 + tr * RP + i + offs;  // key position of this query
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        const long long col = k0 + tc + 8 * j;
        bool keep = key_ok[j];
        if (causal) {
          keep = keep && col <= row;
          if (window > 0) keep = keep && col > row - window;
        }
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        sP[(tr * RP + i) * S::PS + tc + 8 * j] = to_f(from_f<T>(p));  // P in V's dtype
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kmax = min(kBK, sk - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float p[RP], vv[DP];
#pragma unroll
      for (int i = 0; i < RP; ++i) p[i] = sP[(tr * RP + i) * S::PS + kk];
#pragma unroll
      for (int c = 0; c < DP; ++c) vv[c] = sV[kk * DMAX + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int row = q0 + tr * RP + i;
    if (row >= sq) continue;
    // every key masked: zeros and the +1e30 lse sentinel, not the uniform
    // softmax the finite -1e30 scores accumulated
    const bool dead = m[i] <= kNegInf * 0.5f;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      const int col = tc + 8 * c;
      if (col < d) orow[col] = from_f<T>(dead ? 0.f : acc[i][c] / li);
    }
    if (tc == 0) lse[bh * sq + row] = dead ? -kNegInf : m[i] + logf(li);
  }
}

// ---- head_dim > 256, both dtypes: scalar FMAs over head_dim chunks ----------
//
// flash_wide.cuh sets out the route. Block (blockIdx.x, tile, blockIdx.z)
// owns BQ query rows of one head and the output columns [c_out, c_out + OC)
// of its group, c_out = (blockIdx.z / splits) * OC; per 64-key tile the
// scores come from wide_dot over the whole head_dim, the online softmax is
// the scalar kernel's, P (rounded to T) goes to shared memory, and V's OC
// columns of the tile follow it. Query tiles are walked from blockIdx.y in
// steps of gridDim.y. With splits > 1 (bf16 decode, sq = 1) the splits of
// one column block are neighbours along z and run as one cluster: split s
// takes 64-key tiles [s * per, (s + 1) * per), and the cluster merges the
// partials over distributed shared memory in split order, as
// flash_decode_mma does. The block with c_out = 0 (its rank 0) writes lse.

template <int BQ, int OC> struct WideFwd {
  // Q and K chunks, V's OC columns of a tile, P
  static constexpr int floats =
      BQ * flash_wide::HS + kBK * flash_wide::HS + kBK * OC + BQ * (kBK + 1);
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int BQ, int OC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ kpm, T* __restrict__ o, float* __restrict__ lse, int sq,
               int sk, int d, int heads, int group, float scale, int causal, int window,
               int splits, int tiles_per_split) {
  using namespace flash_wide;
  constexpr int RP = BQ / 16, CP = kBK / 8, DP = OC / 8, PS = kBK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * HS;
  float* sV = sK + kBK * HS;
  float* sP = sV + kBK * OC;

  const int t = threadIdx.x, tr = t >> 3, tc = t & 7;
  const long long bh = blockIdx.x, kvh = bh / group;
  const int split = blockIdx.z % splits;
  const int c_out = (int)(blockIdx.z / splits) * OC;
  const long long offs = (long long)sk - sq;
  const T* qb = q + bh * sq * d;
  const T* kb = k + kvh * sk * d;
  const T* vb = v + kvh * sk * d;
  const int* kpm_row = kpm ? kpm + (bh / heads) * sk : nullptr;
  const int n_tiles = (sq + BQ - 1) / BQ;

  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int q0 = tile * BQ;
    int t_lo, t_hi;
    key_band(q0, sq, sk, offs, causal, window, t_lo, t_hi, BQ);
    if (splits > 1) {
      t_lo = max(t_lo, split * tiles_per_split);
      t_hi = min(t_hi, (split + 1) * tiles_per_split);
    }

    float m[RP], l[RP], acc[RP][DP];
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[i][c] = 0.f;
    }

    for (int kt = t_lo; kt < t_hi; ++kt) {
      const int k0 = kt * kBK;
      float s[RP][CP];
      wide_dot<T, BQ, kBK>(qb, q0, sq, kb, k0, sk, d, sQ, sK, tr, tc, s);
      bool key_ok[CP];
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        const int col = k0 + tc + 8 * j;
        key_ok[j] = col < sk && (kpm_row == nullptr || kpm_row[col] == 0);
      }
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int r = tr * RP + i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          const bool keep = attends(q0 + r, k0 + tc + 8 * j, key_ok[j], sq, (int)offs, causal,
                                    window);
          s[i][j] = keep ? s[i][j] * scale : kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
        const float m_new = fmaxf(m[i], row_max(mx));
        const float alpha = expf(m[i] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          const float p = expf(s[i][j] - m_new);
          ps += p;
          sP[r * PS + tc + 8 * j] = round_to<T>(p);  // P in V's dtype
        }
        l[i] = l[i] * alpha + row_sum(ps);
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[i][c] *= alpha;
      }
      load_cols<T, kBK, OC, OC>(sV, vb, k0, sk, c_out, d);
      __syncthreads();

      const int kmax = min(kBK, sk - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float p[RP], vv[DP];
#pragma unroll
        for (int i = 0; i < RP; ++i) p[i] = sP[(tr * RP + i) * PS + kk];
#pragma unroll
        for (int c = 0; c < DP; ++c) vv[c] = sV[kk * OC + tc + 8 * c];
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int c = 0; c < DP; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
      }
    }

    if (splits == 1) {
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int row = q0 + tr * RP + i;
        if (row >= sq) continue;
        // every key masked: zeros and the +1e30 lse sentinel
        const bool dead = m[i] <= kNegInf * 0.5f;
        const float li = fmaxf(l[i], 1e-30f);
        T* orow = o + (bh * sq + row) * d;
#pragma unroll
        for (int c = 0; c < DP; ++c) {
          const int col = c_out + tc + 8 * c;
          if (col < d) orow[col] = narrow<T>(dead ? 0.f : acc[i][c] / li);
        }
        if (tc == 0 && c_out == 0) lse[bh * sq + row] = dead ? -kNegInf : m[i] + logf(li);
      }
      continue;
    }

    // splits: this block's partial (m, l, unnormalised acc) into shared
    // memory, then each block of the cluster merges a share of the elements
    __syncthreads();  // sV and sP are read no more
    float* bm = sP;       // [BQ]
    float* bl = bm + BQ;  // [BQ]
    float* bacc = sV;     // [BQ][OC]
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const int r = tr * RP + i;
      if (tc == 0) {
        bm[r] = m[i];
        bl[r] = l[i];
      }
#pragma unroll
      for (int c = 0; c < DP; ++c) bacc[r * OC + tc + 8 * c] = acc[i][c];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = (int)cluster.block_rank();
    for (int e = t + rank * kThreads; e < BQ * OC; e += kThreads * splits) {
      const int r = e / OC, c = e % OC;
      const int row = q0 + r, col = c_out + c;
      if (row >= sq) continue;
      float ms[kMaxSplits], mx = kNegInf;
#pragma unroll
      for (int z = 0; z < kMaxSplits; ++z) {
        ms[z] = z < splits ? *cluster.map_shared_rank(bm + r, z) : kNegInf;
        mx = fmaxf(mx, ms[z]);
      }
      const bool dead = mx <= kNegInf * 0.5f;
      float sum = 0.f, a = 0.f;
#pragma unroll
      for (int z = 0; z < kMaxSplits; ++z) {
        // a split whose keys were all masked adds nothing
        if (dead || ms[z] <= kNegInf * 0.5f) continue;
        const float w = expf(ms[z] - mx);
        sum += w * *cluster.map_shared_rank(bl + r, z);
        a += w * *cluster.map_shared_rank(bacc + r * OC + c, z);
      }
      const float li = fmaxf(sum, 1e-30f);
      if (col < d) o[(bh * sq + row) * d + col] = narrow<T>(dead ? 0.f : a / li);
      if (c == 0 && c_out == 0) lse[bh * sq + row] = dead ? -kNegInf : mx + logf(li);
    }
    cluster.sync();  // each block's shared memory outlives the others' reads
  }
}

// ---- launch -----------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const int* kpm;
  void* o;
  float* lse;
  int bh, sq, sk, d, heads, group;
  float scale;
  int causal, window;
};

template <typename T> const T* ptr(const void* p) { return static_cast<const T*>(p); }

// The grid holds at most 65535 blocks on y: query tiles past that run in
// further launches of the same kernel, each from tile `tile0` on (one
// launch up to 2,097,120 queries). A loop over tiles inside the kernel
// instead cost the bf16 kernel 48 bytes of register spills and 4-6% of
// its time at GPT-2's training shape (PERF.md).
template <typename Launch>
int launch_tiles(int n_tiles, Launch launch) {
  for (int tile0 = 0; tile0 < n_tiles; tile0 += 65535) {
    launch(tile0, n_tiles - tile0 < 65535 ? n_tiles - tile0 : 65535);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int BQ, int DMAX>
int launch_scalar(const Args& a, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_fwd_kernel<float, BQ, DMAX>;
  const size_t smem = Smem<BQ, DMAX>::bytes;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  return launch_tiles((a.sq + BQ - 1) / BQ, [&](int tile0, int tiles) {
    kernel<<<dim3(a.bh, tiles), kThreads, smem, stream>>>(
        ptr<float>(a.q), ptr<float>(a.k), ptr<float>(a.v), a.kpm, static_cast<float*>(a.o),
        a.lse, a.sq, a.sk, a.d, a.heads, a.group, a.scale, a.causal, a.window, tile0);
  });
}

template <int BQ>
int launch_fp32(const Args& a, cudaStream_t s) {
  if (a.d <= 64) return launch_scalar<BQ, 64>(a, s);
  return a.d <= 128 ? launch_scalar<BQ, 128>(a, s) : launch_scalar<BQ, 256>(a, s);
}

// head_dim > 256 (flash_fwd_wide), either dtype: ceil(d / OC) column
// blocks, each `splits` neighbours along z that form one cluster.
template <typename T, int BQ>
int launch_wide(const Args& a, int splits, cudaStream_t stream) {
  constexpr int OC = 128;
  static bool done = false;
  auto kernel = flash_fwd_wide<T, BQ, OC>;
  const size_t smem = WideFwd<BQ, OC>::bytes;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.sq + BQ - 1) / BQ, key_tiles = (a.sk + kBK - 1) / kBK;
  const long long z = (long long)((a.d + OC - 1) / OC) * splits;
  if (z > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.bh, tiles < 65535 ? tiles : 65535, (unsigned)z);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, ptr<T>(a.q), ptr<T>(a.k), ptr<T>(a.v), a.kpm,
                           static_cast<T*>(a.o), a.lse, a.sq, a.sk, a.d, a.heads, a.group,
                           a.scale, a.causal, a.window, splits,
                           (key_tiles + splits - 1) / splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// may the bf16 kernels load q, k and v by 16-byte cp.async?
int vectorised(const Args& a) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return a.d % 8 == 0 && aligned(a.q) && aligned(a.k) && aligned(a.v);
}

// Query tiles run along the grid's slow dimension, last first; a GQA
// group's heads are neighbours along the fast one.
template <int DMAX, int KD>
int launch_prefill(const Args& a, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_fwd_mma<DMAX, KD>;
  const size_t smem = Prefill<DMAX>::bytes;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  constexpr int BQ = Prefill<DMAX>::BQ;
  return launch_tiles((a.sq + BQ - 1) / BQ, [&](int tile0, int tiles) {
    kernel<<<dim3(a.bh, tiles), Prefill<DMAX>::THREADS, smem, stream>>>(
        ptr<bf16>(a.q), ptr<bf16>(a.k), ptr<bf16>(a.v), a.kpm, static_cast<bf16*>(a.o), a.lse,
        a.sq, a.sk, a.d, a.heads, a.group, a.scale, a.causal, a.window, vectorised(a), tile0);
  });
}

// The splits of a (batch, kv head) pair run as one cluster along y.
template <int DMAX, int KD>
int launch_decode(const Args& a, int splits, cudaStream_t stream) {
  static bool done = false;
  auto kernel = flash_decode_mma<DMAX, KD>;
  const size_t smem = FwdSmem<DMAX>::decode_bytes;
  cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.sk + kB - 1) / kB;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.bh / a.group * ((a.group + 15) / 16), splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, ptr<bf16>(a.q), ptr<bf16>(a.k), ptr<bf16>(a.v), a.kpm,
                           static_cast<bf16*>(a.o), a.lse, a.sk, a.d, a.heads, a.group,
                           (tiles + splits - 1) / splits, a.scale, a.causal, a.window,
                           vectorised(a));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q: (bh, sq, d); k, v: (bh / group, sk, d); kpm: int32 (bh / heads, sk) or
// null; o: (bh, sq, d) in q's dtype; lse: fp32 (bh, sq). All contiguous.
// d >= 1; bh rides the grid's x dimension (any int), the query tiles its y
// (65535 a launch, further launches past that; past head_dim 256 a block
// walks several instead).
// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor cores; sq = 1
// takes the decode kernel). window <= 0 means no window (the window applies
// only with causal). `splits` > 1 only for bf16 at sq = 1: the 64-key tiles
// of each (batch, kv head) pair are split over that many blocks (at most
// 8, one cluster), merged in split order. Returns the cudaError_t of the
// launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kpm, void* o,
                         void* lse, int bh, int sq, int sk, int d, int heads, int group,
                         int splits, float scale, int causal, int window, int dtype,
                         void* stream) {
  if (d < 1 || bh < 0 || group < 1 || heads < 1 || bh % group != 0 ||
      sq < 0 || sk < 0 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (dtype != 1 || sq != 1)))
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  const Args a{q, k, v, static_cast<const int*>(kpm), o, static_cast<float*>(lse), bh, sq, sk, d,
               heads, group, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (d > 256) {
    if (dtype == 0) return sq <= 16 ? launch_wide<float, 16>(a, 1, s) : launch_wide<float, 64>(a, 1, s);
    return sq <= 16 ? launch_wide<bf16, 16>(a, splits, s) : launch_wide<bf16, 64>(a, splits, s);
  }
  if (dtype == 0) return sq <= 16 ? launch_fp32<16>(a, s) : launch_fp32<64>(a, s);
  // head_dim 64, 128 and 256 fill their instantiation; others are
  // zero-padded to the next one
  if (sq == 1) {
    if (d == 64) return launch_decode<64, 4>(a, splits, s);
    if (d == 128) return launch_decode<128, 8>(a, splits, s);
    if (d == 256) return launch_decode<256, 16>(a, splits, s);
    if (d < 64) return launch_decode<64, 0>(a, splits, s);
    return d < 128 ? launch_decode<128, 0>(a, splits, s) : launch_decode<256, 0>(a, splits, s);
  }
  if (d == 64) return launch_prefill<64, 4>(a, s);
  if (d == 128) return launch_prefill<128, 8>(a, s);
  if (d == 256) return launch_prefill<256, 16>(a, s);
  if (d < 64) return launch_prefill<64, 0>(a, s);
  return d < 128 ? launch_prefill<128, 0>(a, s) : launch_prefill<256, 0>(a, s);
}
