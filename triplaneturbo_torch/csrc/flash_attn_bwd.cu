// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of the non-causal
// softmax(Q K^T / sqrt(D)) V, streamed from the saved per-row logsumexp.
//
// Replaces the Pallas kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkdv_kernel` of triplaneturbo_tpu/ops/attention_pallas.py (called
// through `_flash_bwd_impl`, the custom VJP of `fused_attention`). Same
// function: each tile recomputes P = exp(S * scale - lse), exactly 0 at keys at
// or past Lk; dP = dO V^T; dS = P o (dP - delta) with delta = rowsum(dO o O)
// computed by the caller; dq = sum dS K * scale; dk = sum dS^T Q * scale;
// dv = sum P^T dO. Sums are f32; dq, dk, dv leave in the input type.
//
// What bounds them on an H100: at the joint self-attention shape (L = 6144,
// D = 64) dq does 6 L^2 D and dk/dv 8 L^2 D FLOPs against a few L D bytes of
// operands, so both are bound by arithmetic: the tensor cores' bf16 rate, and
// at D = 64 as much the rate of exp (one per score against 4-6 D multiply-adds
// a score). The cross attention (Lk = 77) is bound by the bytes of Q, dO and dq.
//
// What the design does about it. Two kernels, one CTA per q tile (dq) or per
// kv tile (dk/dv), each looping over the other side -- the loop takes the place
// of the TPU's sequential grid axis. No CTA shares an output with another, so
// there are no atomics and reruns are bit-equal.
//
// bf16 (`flash_bwd_dq_kernel_wgmma_*`, `flash_bwd_dkdv_kernel_wgmma_*`): every
// product runs on the tensor cores through `wgmma.mma_async` (bf16 x bf16 ->
// f32 accumulators in registers), with the operands as bf16 tiles of 128-byte
// rows in the 128-byte swizzle, filled by 16-byte `cp.async` (hopper_mma.cuh).
// No score tile leaves the registers:
//   dq:    one warpgroup owns 64 query rows; Q and dO stay in shared memory,
//          K/V tiles stream through a two-stage ring. S = Q K^T and
//          dP = dO V^T read both operands K-major. P and dS are computed on
//          the accumulator fragment (lse and delta are per row, two rows a
//          thread), dS is packed to bf16 as the register A operand of
//          dq += dS K, which reads the K tile MN-major (the transpose flag).
//   dk/dv: one warpgroup owns 64 key rows; K and V stay in shared memory, Q/dO
//          tiles (and their lse and delta) stream through the ring. The
//          transposes S^T = K Q^T and dP^T = V dO^T put P^T and dS^T in the
//          accumulator layout, so dv += P^T dO and dk += dS^T Q take them
//          packed to bf16 as register A operands; the same swizzled Q and dO
//          tiles are the K-major B operands of the transposes and the
//          MN-major B operands of dk and dv. lse and delta are per column
//          here: they are staged with the tile (4-byte cp.async) and read by
//          column from shared memory.
// scale * log2(e) is folded into one multiply-add with lse * log2(e), and the
// exponential is one `ex2.approx`; scale is applied to dq and dk once, at the
// store. P and dS are rounded to bf16 before their products, as FlashAttention
// does (the JAX kernels keep them f32). The key axis is masked where the last
// tile runs past Lk (dq) and the query axis where it runs past L (dk/dv): there
// the zero-filled rows would give P = exp(-lse), which overflows for a very
// negative lse and turns 0 * inf into NaN. Rows of the output side past L or
// Lk depend only on themselves and are never written.
//
// D = 512 (the VAE mid-block attention) meets two walls: Q, dO, K and V tiles
// of 64 rows are 256 KB together, more than the 227 KB a CTA may use, and dk
// plus dv of 64 keys are 256 KB of f32 accumulators, the SM's whole register
// file. So the streamed side is 32 rows (wgmma's N = 32), single-buffered,
// with the first operand of the next tile loading under the last product of
// this one, and the output columns are split:
//   dq:    a CTA of two warpgroups owns 64 query rows; warpgroup w keeps dq's
//          columns [256 w, 256 w + 256), and each computes S and dP over the
//          full D for itself (as the forward does), 32 keys a tile.
//   dk/dv: a CTA of two warpgroups owns 64 keys and one half of D; warpgroup w
//          keeps 128 columns of dk and of dv, and each recomputes S^T and dP^T
//          over the full D, 32 queries a tile: 2.5x the least arithmetic.
//
// f32 inputs keep the register-tiled FMA bodies (`flash_bwd_*_kernel_f32`):
// they are held to 1e-4 absolute, which TF32 or bf16 products would break, and
// only the small-model comparisons and the f32 kernel cases reach them. D = 64
// uses 64 x 64 tiles (~105 KB); at D = 512 the f32 operand tiles force 16 x 32
// (dq) and 32 x 16 (dk/dv) tiles (~204 KB).

#include "hopper_mma.cuh"

// Tiling of the D = 64 tensor-core kernels: warpgroups (64 rows of the owned
// side each) a CTA, rows of the streamed side a tile, CTAs an SM the register
// budget is set for. Chosen by measurement on an H100
// (triplaneturbo_torch/tools/tune_flash_bwd.py builds this file with other values).
#ifndef FLASH_BWD_DQ_NWG
#define FLASH_BWD_DQ_NWG 1
#endif
#ifndef FLASH_BWD_DQ_BK
#define FLASH_BWD_DQ_BK 64
#endif
#ifndef FLASH_BWD_DQ_MIN_CTAS
#define FLASH_BWD_DQ_MIN_CTAS 3
#endif
#ifndef FLASH_BWD_DKDV_NWG
#define FLASH_BWD_DKDV_NWG 1
#endif
#ifndef FLASH_BWD_DKDV_BQ
#define FLASH_BWD_DKDV_BQ 64
#endif
#ifndef FLASH_BWD_DKDV_MIN_CTAS
#define FLASH_BWD_DKDV_MIN_CTAS 2
#endif

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

// dq: dS of one key tile (keys k0 .. k0 + BK) from the fragments s (S) and dp
// (dP) of a thread's two query rows, packed as the bf16 A fragments of dS K.
// nl = -lse * log2(e) and del = delta of the two rows; c = scale * log2(e).
template <int BK>
__device__ __forceinline__ void dq_tile_ds(const float (&s)[BK / 2], const float (&dp)[BK / 2],
                                           uint32_t (&ds)[BK / 4], const float (&nl)[2],
                                           const float (&del)[2], int k0, int lk, int lane4,
                                           float c) {
  float d[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int h = (i >> 1) & 1;
    d[i] = fast_exp2(fmaf(s[i], c, nl[h])) * (dp[i] - del[h]);
  }
  if (k0 + BK > lk) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (k0 + (i >> 2) * 8 + lane4 * 2 + (i & 1) >= lk) d[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) ds[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// dk/dv: P^T and dS^T of one query tile (queries q0 .. q0 + BQ) from the
// fragments st (S^T) and dpt (dP^T) of a thread's two key rows, packed as the
// bf16 A fragments of P^T dO and dS^T Q. lse and delta of the tile's queries
// are read by column from shared memory.
template <int BQ>
__device__ __forceinline__ void dkdv_tile_p_ds(const float (&st)[BQ / 2], const float (&dpt)[BQ / 2],
                                               uint32_t (&p)[BQ / 4], uint32_t (&ds)[BQ / 4],
                                               const float* lse_s, const float* del_s, int q0,
                                               int lq, int lane4, float c) {
  float pf[BQ / 2], df[BQ / 2];
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * lane4);
    const float2 d2 = *reinterpret_cast<const float2*>(del_s + 8 * j + 2 * lane4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float l = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
      pf[i] = fast_exp2(fmaf(st[i], c, -l * kLog2e));
      df[i] = pf[i] * (dpt[i] - dl);
    }
  }
  if (q0 + BQ > lq) {
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i)
      if (q0 + (i >> 2) * 8 + lane4 * 2 + (i & 1) >= lq) pf[i] = df[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BQ / 4; ++i) {
    p[i] = pack_bf16(pf[2 * i], pf[2 * i + 1]);
    ds[i] = pack_bf16(df[2 * i], df[2 * i + 1]);
  }
}

// Stage lse and delta of rows [row0, row0 + ROWS) as two float vectors at dst
// (zero past nrows), with the tile they belong to.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* __restrict__ lse,
                                          const float* __restrict__ delta, int row0, int nrows,
                                          int tid) {
  for (int idx = tid; idx < 2 * ROWS; idx += THREADS) {
    const int r = idx % ROWS, gr = row0 + r;
    const bool ok = gr < nrows;
    cp_async4(dst + idx * 4, (idx < ROWS ? lse : delta) + (ok ? gr : 0), ok ? 4 : 0);
  }
}

// D = 64 dq. NWG warpgroups a CTA, each with 64 query rows; BK keys a tile;
// K/V in a two-stage ring.
template <int NWG, int BK, int MIN_CTAS>
__global__ void __launch_bounds__(NWG * 128, MIN_CTAS)
flash_bwd_dq_kernel_wgmma_d64(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ g,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, int lq, int lk, float c, float scale) {
  constexpr int D = 64, BQ = NWG * 64, THREADS = NWG * 128;
  constexpr uint32_t KV_BYTES = BK * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sG = sQ + BQ * 128;
  const uint32_t sK = sG + BQ * 128;
  const uint32_t sV = sK + 2 * KV_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int lane4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const bf16* kb = k + bh * (size_t)lk * D;
  const bf16* vb = v + bh * (size_t)lk * D;

  load_tile<BQ, THREADS>(sQ, q + bh * (size_t)lq * D, D, q0, lq, 0, tid);
  load_tile<BQ, THREADS>(sG, g + bh * (size_t)lq * D, D, q0, lq, 0, tid);
  load_tile<BK, THREADS>(sK, kb, D, 0, lk, 0, tid);
  load_tile<BK, THREADS>(sV, vb, D, 0, lk, 0, tid);
  cp_async_commit();

  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int row[2] = {r0, r0 + 8};
  float nl[2], del[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row[h] < lq;
    nl[h] = ok ? -lse[bh * (size_t)lq + row[h]] * kLog2e : 0.f;
    del[h] = ok ? delta[bh * (size_t)lq + row[h]] : 0.f;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint64_t dQ = tile_desc(sQ + wg * 64 * 128);
  const uint64_t dG = tile_desc(sG + wg * 64 * 128);

  const int n_kv = (lk + BK - 1) / BK;
  for (int t = 0; t < n_kv; ++t) {
    // tile t has landed for every thread, and every warp is done with tile t-1
    cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();
    if (t + 1 < n_kv) {
      const uint32_t stage = ((t + 1) & 1) * KV_BYTES;
      load_tile<BK, THREADS>(sK + stage, kb, D, (t + 1) * BK, lk, 0, tid);
      load_tile<BK, THREADS>(sV + stage, vb, D, (t + 1) * BK, lk, 0, tid);
      cp_async_commit();
    }
    const uint64_t dK = tile_desc(sK + (t & 1) * KV_BYTES);
    const uint64_t dV = tile_desc(sV + (t & 1) * KV_BYTES);

    float s[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, dQ + kk * kStepKMajor, dK + kk * kStepKMajor, kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, dG + kk * kStepKMajor, dV + kk * kStepKMajor, kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    uint32_t ds[BK / 4];
    dq_tile_ds<BK>(s, dp, ds, nl, del, t * BK, lk, lane4, c);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs(acc, &ds[4 * kc], dK + kc * kStepMNMajor);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
  }
  const float mul[2] = {scale, scale};
  store_acc_block(dq + bh * (size_t)lq * D, D, acc, row, mul, lq, 0, lane4);
}

// D = 64 dk/dv. NWG warpgroups a CTA, each with 64 key rows; BQ queries a
// tile; Q/dO tiles with their lse and delta in a two-stage ring.
template <int NWG, int BQ, int MIN_CTAS>
__global__ void __launch_bounds__(NWG * 128, MIN_CTAS)
flash_bwd_dkdv_kernel_wgmma_d64(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ g,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, int lq, int lk,
                                float c, float scale) {
  constexpr int D = 64, BK = NWG * 64, THREADS = NWG * 128;
  constexpr uint32_t QG_BYTES = BQ * 128, ROW_BYTES = 2 * BQ * 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = sK + BK * 128;
  const uint32_t sQ = sV + BK * 128, sG = sQ + 2 * QG_BYTES;
  const uint32_t sR = sG + 2 * QG_BYTES;  // per stage: lse[BQ], then delta[BQ]
  const float* rows_f = reinterpret_cast<const float*>(smem_raw + (sR - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int lane4 = lane & 3;
  const int k0 = blockIdx.x * BK;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * (size_t)lq * D;
  const bf16* gb = g + bh * (size_t)lq * D;
  const float* lb = lse + bh * (size_t)lq;
  const float* db = delta + bh * (size_t)lq;

  load_tile<BK, THREADS>(sK, k + bh * (size_t)lk * D, D, k0, lk, 0, tid);
  load_tile<BK, THREADS>(sV, v + bh * (size_t)lk * D, D, k0, lk, 0, tid);
  load_tile<BQ, THREADS>(sQ, qb, D, 0, lq, 0, tid);
  load_tile<BQ, THREADS>(sG, gb, D, 0, lq, 0, tid);
  load_rows<BQ, THREADS>(sR, lb, db, 0, lq, tid);
  cp_async_commit();

  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
  const uint64_t dK = tile_desc(sK + wg * 64 * 128);
  const uint64_t dV = tile_desc(sV + wg * 64 * 128);

  const int n_q = (lq + BQ - 1) / BQ;
  for (int t = 0; t < n_q; ++t) {
    cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();
    if (t + 1 < n_q) {
      const int st = (t + 1) & 1;
      load_tile<BQ, THREADS>(sQ + st * QG_BYTES, qb, D, (t + 1) * BQ, lq, 0, tid);
      load_tile<BQ, THREADS>(sG + st * QG_BYTES, gb, D, (t + 1) * BQ, lq, 0, tid);
      load_rows<BQ, THREADS>(sR + st * ROW_BYTES, lb, db, (t + 1) * BQ, lq, tid);
      cp_async_commit();
    }
    const int st = t & 1;
    const uint64_t dQt = tile_desc(sQ + st * QG_BYTES);
    const uint64_t dGt = tile_desc(sG + st * QG_BYTES);

    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, dK + kk * kStepKMajor, dQt + kk * kStepKMajor, kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, dV + kk * kStepKMajor, dGt + kk * kStepKMajor, kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    uint32_t p[BQ / 4], ds[BQ / 4];
    const float* lse_s = rows_f + st * 2 * BQ;
    dkdv_tile_p_ds<BQ>(s, dp, p, ds, lse_s, lse_s + BQ, t * BQ, lq, lane4, c);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      wgmma_rs(acc_v, &p[4 * kc], dGt + kc * kStepMNMajor);
      wgmma_rs(acc_k, &ds[4 * kc], dQt + kc * kStepMNMajor);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc_v);
    fence_regs(acc_k);
  }
  const int r0 = k0 + wg * 64 + warp * 16 + (lane >> 2);
  const int row[2] = {r0, r0 + 8};
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
  store_acc_block(dk + bh * (size_t)lk * D, D, acc_k, row, mul_k, lk, 0, lane4);
  store_acc_block(dv + bh * (size_t)lk * D, D, acc_v, row, mul_v, lk, 0, lane4);
}

// D = 512 dq. One CTA of two warpgroups owns 64 query rows; both compute S and
// dP of the 32-key tile over the full D, warpgroup w accumulates dq's columns
// [256 w, 256 w + 256) as four 64-wide blocks. Q and dO are eight [64, 64]
// column blocks each, K and V eight [32, 64] blocks, single-buffered.
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_kernel_wgmma_d512(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ g,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dq, int lq, int lk, float c, float scale) {
  constexpr int D = 512, BQ = 64, BK = 32, THREADS = 256;
  constexpr uint32_t QB = BQ * 128, KB = BK * 128;  // one column block of Q/dO, of K/V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sG = sQ + 8 * QB;
  const uint32_t sK = sG + 8 * QB;
  const uint32_t sV = sK + 8 * KB;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int lane4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * (size_t)lq * D;
  const bf16* gb = g + bh * (size_t)lq * D;
  const bf16* kb = k + bh * (size_t)lk * D;
  const bf16* vb = v + bh * (size_t)lk * D;

  // cp.async groups in order: {Q, dO, V0}, {K0}, then {V(t+1)}, {K(t+1)} in
  // every iteration (empty past the last tile), so that "all but the newest
  // group" is V(t) and "all" is K(t) at the top of iteration t.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    load_tile<BQ, THREADS>(sQ + j * QB, qb, D, q0, lq, 64 * j, tid);
    load_tile<BQ, THREADS>(sG + j * QB, gb, D, q0, lq, 64 * j, tid);
    load_tile<BK, THREADS>(sV + j * KB, vb, D, 0, lk, 64 * j, tid);
  }
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < 8; ++j) load_tile<BK, THREADS>(sK + j * KB, kb, D, 0, lk, 64 * j, tid);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int row[2] = {r0, r0 + 8};
  float nl[2], del[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row[h] < lq;
    nl[h] = ok ? -lse[bh * (size_t)lq + row[h]] * kLog2e : 0.f;
    del[h] = ok ? delta[bh * (size_t)lq + row[h]] : 0.f;
  }
  float acc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

  const int n_kv = (lk + BK - 1) / BK;
  for (int t = 0; t < n_kv; ++t) {
    const bool more = t + 1 < n_kv;
    float s[BK / 2], dp[BK / 2];
    cp_async_wait<1>();  // V(t) (and Q, dO) landed
    fence_async_proxy();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, tile_desc(sG + (kk >> 2) * QB) + (kk & 3) * kStepKMajor,
               tile_desc(sV + (kk >> 2) * KB) + (kk & 3) * kStepKMajor, kk > 0);
    wgmma_commit();
    cp_async_wait<0>();  // K(t) landed
    fence_async_proxy();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, tile_desc(sQ + (kk >> 2) * QB) + (kk & 3) * kStepKMajor,
               tile_desc(sK + (kk >> 2) * KB) + (kk & 3) * kStepKMajor, kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(dp);
    fence_regs(s);
    __syncthreads();  // both warpgroups are done with V(t)
    if (more) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        load_tile<BK, THREADS>(sV + j * KB, vb, D, (t + 1) * BK, lk, 64 * j, tid);
    }
    cp_async_commit();

    uint32_t ds[BK / 4];
    dq_tile_ds<BK>(s, dp, ds, nl, del, t * BK, lk, lane4, c);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs(acc[j], &ds[4 * kc], tile_desc(sK + (wg * 4 + j) * KB) + kc * kStepMNMajor);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_regs(acc[j]);
    __syncthreads();  // both warpgroups are done with K(t)
    if (more) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        load_tile<BK, THREADS>(sK + j * KB, kb, D, (t + 1) * BK, lk, 64 * j, tid);
    }
    cp_async_commit();
  }
  const float mul[2] = {scale, scale};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    store_acc_block(dq + bh * (size_t)lq * D, D, acc[j], row, mul, lq, (wg * 4 + j) * 64, lane4);
}

// D = 512 dk/dv. One CTA of two warpgroups owns 64 keys and one half of D
// (blockIdx.x & 1); both compute S^T and dP^T of the 32-query tile over the
// full D, warpgroup w accumulates 128 columns of dk and of dv as two 64-wide
// blocks each. K and V are eight [64, 64] column blocks each, Q and dO eight
// [32, 64] blocks, single-buffered with the tile's lse and delta.
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_kernel_wgmma_d512(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ g,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv, int lq, int lk,
                                 float c, float scale) {
  constexpr int D = 512, BK = 64, BQ = 32, THREADS = 256;
  constexpr uint32_t KB = BK * 128, QB = BQ * 128;  // one column block of K/V, of Q/dO
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + 8 * KB;
  const uint32_t sQ = sV + 8 * KB;
  const uint32_t sG = sQ + 8 * QB;
  const uint32_t sR = sG + 8 * QB;  // lse[BQ], then delta[BQ]
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + (sR - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int lane4 = lane & 3;
  const int k0 = (blockIdx.x >> 1) * BK;
  const int cb = (blockIdx.x & 1) * 4 + wg * 2;  // this warpgroup's first 64-column block
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * (size_t)lq * D;
  const bf16* gb = g + bh * (size_t)lq * D;
  const float* lb = lse + bh * (size_t)lq;
  const float* db = delta + bh * (size_t)lq;

  // cp.async groups in order: {K, V, dO0, rows0}, {Q0}, then {dO(t+1), rows(t+1)},
  // {Q(t+1)} in every iteration (empty past the last tile).
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    load_tile<BK, THREADS>(sK + j * KB, k + bh * (size_t)lk * D, D, k0, lk, 64 * j, tid);
    load_tile<BK, THREADS>(sV + j * KB, v + bh * (size_t)lk * D, D, k0, lk, 64 * j, tid);
    load_tile<BQ, THREADS>(sG + j * QB, gb, D, 0, lq, 64 * j, tid);
  }
  load_rows<BQ, THREADS>(sR, lb, db, 0, lq, tid);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < 8; ++j) load_tile<BQ, THREADS>(sQ + j * QB, qb, D, 0, lq, 64 * j, tid);
  cp_async_commit();

  float acc_k[2][32], acc_v[2][32];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[j][i] = acc_v[j][i] = 0.f;

  const int n_q = (lq + BQ - 1) / BQ;
  for (int t = 0; t < n_q; ++t) {
    const bool more = t + 1 < n_q;
    float s[BQ / 2], dp[BQ / 2];
    cp_async_wait<1>();  // dO(t) and its rows (and K, V) landed
    fence_async_proxy();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, tile_desc(sV + (kk >> 2) * KB) + (kk & 3) * kStepKMajor,
               tile_desc(sG + (kk >> 2) * QB) + (kk & 3) * kStepKMajor, kk > 0);
    wgmma_commit();
    cp_async_wait<0>();  // Q(t) landed
    fence_async_proxy();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, tile_desc(sK + (kk >> 2) * KB) + (kk & 3) * kStepKMajor,
               tile_desc(sQ + (kk >> 2) * QB) + (kk & 3) * kStepKMajor, kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(dp);
    fence_regs(s);

    uint32_t p[BQ / 4], ds[BQ / 4];
    dkdv_tile_p_ds<BQ>(s, dp, p, ds, lse_s, lse_s + BQ, t * BQ, lq, lane4, c);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wgmma_rs(acc_v[j], &p[4 * kc], tile_desc(sG + (cb + j) * QB) + kc * kStepMNMajor);
    wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wgmma_rs(acc_k[j], &ds[4 * kc], tile_desc(sQ + (cb + j) * QB) + kc * kStepMNMajor);
    wgmma_commit();
    wgmma_wait<1>();  // dv's products are done
#pragma unroll
    for (int j = 0; j < 2; ++j) fence_regs(acc_v[j]);
    __syncthreads();  // both warpgroups are done with dO(t) and the rows
    if (more) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        load_tile<BQ, THREADS>(sG + j * QB, gb, D, (t + 1) * BQ, lq, 64 * j, tid);
      load_rows<BQ, THREADS>(sR, lb, db, (t + 1) * BQ, lq, tid);
    }
    cp_async_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < 2; ++j) fence_regs(acc_k[j]);
    __syncthreads();  // both warpgroups are done with Q(t)
    if (more) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        load_tile<BQ, THREADS>(sQ + j * QB, qb, D, (t + 1) * BQ, lq, 64 * j, tid);
    }
    cp_async_commit();
  }
  const int r0 = k0 + warp * 16 + (lane >> 2);
  const int row[2] = {r0, r0 + 8};
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    store_acc_block(dk + bh * (size_t)lk * D, D, acc_k[j], row, mul_k, lk, (cb + j) * 64, lane4);
    store_acc_block(dv + bh * (size_t)lk * D, D, acc_v[j], row, mul_v, lk, (cb + j) * 64, lane4);
  }
}

// ---------------------------------------------------------------------------
// f32: register-tiled FMA kernels
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

// Stage `rows` rows of a [n, D] matrix, starting at row0, into shared memory
// with row stride DP; rows at or past n become zeros.
template <int D, int DP>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int rows, int n,
                                           int tid) {
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * DP + c] = gr < n ? src[(size_t)gr * D + c] : 0.f;
  }
}

// acc[i][j] = sum_d A[(ay + i*A_STEP)][d] * B[(bx + j*B_STEP)][d], both row-major with stride DP.
template <int D, int DP, int SR, int SC, int A_STEP, int B_STEP>
__device__ __forceinline__ void dot_rows(const float* A, const float* B, int ay, int bx,
                                         float (&acc)[SR][SC]) {
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SC; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[SR], bv[SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
      av[i] = *reinterpret_cast<const float4*>(&A[(ay + i * A_STEP) * DP + d]);
#pragma unroll
    for (int j = 0; j < SC; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&B[(bx + j * B_STEP) * DP + d]);
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// D: head dim; BQ x BK: query x key tile; SR x SC: per-thread tile of S, dP
// and dS (BQ x BK); OR x OC: per-thread tile of the accumulator, which is
// BQ x D for dq (OUT_ROWS = BQ) and BK x D for dk/dv (OUT_ROWS = BK).
template <int D_, int BQ_, int BK_, int SR_, int SC_, int OUT_ROWS_, int OR_, int OC_>
struct Tiles {
  static constexpr int D = D_, BQ = BQ_, BK = BK_;
  static constexpr int SR = SR_, SC = SC_, OR = OR_, OC = OC_;
  static constexpr int DP = D + 4;    // padded row stride of the operand tiles (floats)
  static constexpr int BKP = BK + 4;  // padded row stride of P and dS
  static constexpr int S_COLS = BK / SC;
  static constexpr int S_ROW_STEP = BQ / SR;
  static constexpr int O_COLS = D / OC;
  static constexpr int O_ROW_STEP = OUT_ROWS_ / OR;
  static constexpr int Q_OFF = 0;
  static constexpr int G_OFF = Q_OFF + BQ * DP;
  static constexpr int K_OFF = G_OFF + BQ * DP;
  static constexpr int V_OFF = K_OFF + BK * DP;
  static constexpr int DS_OFF = V_OFF + BK * DP;
  static constexpr int P_OFF = DS_OFF + BQ * BKP;  // used by dk/dv only
  static constexpr int LSE_OFF = P_OFF + BQ * BKP;
  static constexpr int DEL_OFF = LSE_OFF + BQ;
  static constexpr int FLOATS = DEL_OFF + BQ;
  static constexpr size_t SMEM = FLOATS * sizeof(float);
  static_assert(S_ROW_STEP * S_COLS == kThreads, "S tiling must cover 256 threads");
  static_assert(O_ROW_STEP * O_COLS == kThreads, "accumulator tiling must cover 256 threads");
  static_assert(D % 4 == 0 && SMEM <= 232448, "tile shapes");
};

using DqTiles64 = Tiles<64, 64, 64, 4, 4, 64, 4, 4>;
using DqTiles512 = Tiles<512, 16, 32, 1, 2, 16, 2, 16>;
using DkvTiles64 = Tiles<64, 64, 64, 4, 4, 64, 4, 4>;
using DkvTiles512 = Tiles<512, 32, 16, 2, 1, 16, 2, 16>;

// P and dS of this thread's S tile, from the staged Q, dO, K, V, lse and delta.
// Writes dS (and P when Ps is given) to shared memory.
template <typename C>
__device__ __forceinline__ void probs_and_ds(const float* Qs, const float* Gs, const float* Ks,
                                             const float* Vs, const float* Lse, const float* Del,
                                             float* dSs, float* Ps, int q0, int k0, int lq,
                                             int lk, float scale, int tid) {
  const int sx = tid % C::S_COLS, sy = tid / C::S_COLS;
  float s[C::SR][C::SC], dp[C::SR][C::SC];
  dot_rows<C::D, C::DP, C::SR, C::SC, C::S_ROW_STEP, C::S_COLS>(Qs, Ks, sy, sx, s);
  dot_rows<C::D, C::DP, C::SR, C::SC, C::S_ROW_STEP, C::S_COLS>(Gs, Vs, sy, sx, dp);
#pragma unroll
  for (int i = 0; i < C::SR; ++i) {
    const int row = sy + i * C::S_ROW_STEP;
    const float lse = Lse[row], del = Del[row];
#pragma unroll
    for (int j = 0; j < C::SC; ++j) {
      const int col = sx + j * C::S_COLS;
      const bool valid = (k0 + col < lk) && (q0 + row < lq);
      const float p = valid ? expf(s[i][j] * scale - lse) : 0.f;
      dSs[row * C::BKP + col] = p * (dp[i][j] - del);
      if (Ps != nullptr) Ps[row * C::BKP + col] = p;
    }
  }
}

template <typename C>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int lq, int lk, float scale) {
  constexpr int D = C::D, BQ = C::BQ, BK = C::BK, DP = C::DP, BKP = C::BKP;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + C::Q_OFF;
  float* Gs = smem + C::G_OFF;
  float* Ks = smem + C::K_OFF;
  float* Vs = smem + C::V_OFF;
  float* dSs = smem + C::DS_OFF;
  float* Lse = smem + C::LSE_OFF;
  float* Del = smem + C::DEL_OFF;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const float* kb = k + bh * (size_t)lk * D;
  const float* vb = v + bh * (size_t)lk * D;

  stage_rows<D, DP>(Qs, q + bh * (size_t)lq * D, q0, BQ, lq, tid);
  stage_rows<D, DP>(Gs, g + bh * (size_t)lq * D, q0, BQ, lq, tid);
  for (int r = tid; r < BQ; r += kThreads) {
    const bool ok = q0 + r < lq;
    Lse[r] = ok ? lse[bh * (size_t)lq + q0 + r] : 0.f;
    Del[r] = ok ? delta[bh * (size_t)lq + q0 + r] : 0.f;
  }

  // this thread's tile of dq: rows oy + i*O_ROW_STEP, features ox + j*O_COLS
  const int ox = tid % C::O_COLS, oy = tid / C::O_COLS;
  float acc[C::OR][C::OC];
#pragma unroll
  for (int i = 0; i < C::OR; ++i)
#pragma unroll
    for (int j = 0; j < C::OC; ++j) acc[i][j] = 0.f;

  const int n_kv = (lk + BK - 1) / BK;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    stage_rows<D, DP>(Ks, kb, k0, BK, lk, tid);
    stage_rows<D, DP>(Vs, vb, k0, BK, lk, tid);
    __syncthreads();
    probs_and_ds<C>(Qs, Gs, Ks, Vs, Lse, Del, dSs, nullptr, q0, k0, lq, lk, scale, tid);
    __syncthreads();
    // dq += dS K
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float ds[C::OR], kv[C::OC];
#pragma unroll
      for (int i = 0; i < C::OR; ++i) ds[i] = dSs[(oy + i * C::O_ROW_STEP) * BKP + kk];
#pragma unroll
      for (int j = 0; j < C::OC; ++j) kv[j] = Ks[kk * DP + ox + j * C::O_COLS];
#pragma unroll
      for (int i = 0; i < C::OR; ++i)
#pragma unroll
        for (int j = 0; j < C::OC; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dqb = dq + bh * (size_t)lq * D;
#pragma unroll
  for (int i = 0; i < C::OR; ++i) {
    const int qr = q0 + oy + i * C::O_ROW_STEP;
    if (qr >= lq) continue;
#pragma unroll
    for (int j = 0; j < C::OC; ++j) dqb[(size_t)qr * D + ox + j * C::O_COLS] = acc[i][j] * scale;
  }
}

template <typename C>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ g,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
                          float scale) {
  constexpr int D = C::D, BQ = C::BQ, BK = C::BK, DP = C::DP, BKP = C::BKP;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + C::Q_OFF;
  float* Gs = smem + C::G_OFF;
  float* Ks = smem + C::K_OFF;
  float* Vs = smem + C::V_OFF;
  float* dSs = smem + C::DS_OFF;
  float* Ps = smem + C::P_OFF;
  float* Lse = smem + C::LSE_OFF;
  float* Del = smem + C::DEL_OFF;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * (size_t)lq * D;
  const float* gb = g + bh * (size_t)lq * D;

  stage_rows<D, DP>(Ks, k + bh * (size_t)lk * D, k0, BK, lk, tid);
  stage_rows<D, DP>(Vs, v + bh * (size_t)lk * D, k0, BK, lk, tid);

  // this thread's tile of dk and dv: key rows oy + i*O_ROW_STEP, features ox + j*O_COLS
  const int ox = tid % C::O_COLS, oy = tid / C::O_COLS;
  float acc_k[C::OR][C::OC], acc_v[C::OR][C::OC];
#pragma unroll
  for (int i = 0; i < C::OR; ++i)
#pragma unroll
    for (int j = 0; j < C::OC; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }

  const int n_q = (lq + BQ - 1) / BQ;
  for (int t = 0; t < n_q; ++t) {
    const int q0 = t * BQ;
    stage_rows<D, DP>(Qs, qb, q0, BQ, lq, tid);
    stage_rows<D, DP>(Gs, gb, q0, BQ, lq, tid);
    for (int r = tid; r < BQ; r += kThreads) {
      const bool ok = q0 + r < lq;
      Lse[r] = ok ? lse[bh * (size_t)lq + q0 + r] : 0.f;
      Del[r] = ok ? delta[bh * (size_t)lq + q0 + r] : 0.f;
    }
    __syncthreads();
    probs_and_ds<C>(Qs, Gs, Ks, Vs, Lse, Del, dSs, Ps, q0, k0, lq, lk, scale, tid);
    __syncthreads();
    // dv += P^T dO, dk += dS^T Q
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float p[C::OR], ds[C::OR], gv[C::OC], qv[C::OC];
#pragma unroll
      for (int i = 0; i < C::OR; ++i) {
        p[i] = Ps[r * BKP + oy + i * C::O_ROW_STEP];
        ds[i] = dSs[r * BKP + oy + i * C::O_ROW_STEP];
      }
#pragma unroll
      for (int j = 0; j < C::OC; ++j) {
        gv[j] = Gs[r * DP + ox + j * C::O_COLS];
        qv[j] = Qs[r * DP + ox + j * C::O_COLS];
      }
#pragma unroll
      for (int i = 0; i < C::OR; ++i)
#pragma unroll
        for (int j = 0; j < C::OC; ++j) {
          acc_v[i][j] = fmaf(p[i], gv[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(ds[i], qv[j], acc_k[i][j]);
        }
    }
    __syncthreads();
  }

  float* dkb = dk + bh * (size_t)lk * D;
  float* dvb = dv + bh * (size_t)lk * D;
#pragma unroll
  for (int i = 0; i < C::OR; ++i) {
    const int kr = k0 + oy + i * C::O_ROW_STEP;
    if (kr >= lk) continue;
#pragma unroll
    for (int j = 0; j < C::OC; ++j) {
      const size_t at = (size_t)kr * D + ox + j * C::O_COLS;
      dkb[at] = acc_k[i][j] * scale;
      dvb[at] = acc_v[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, lq, lk, d;
  cudaStream_t stream;
};

// grid_x CTAs of `threads` along the owned side, one row of them per batch-head;
// `smem` includes 1024 bytes of slack to align the tiles to the swizzle's period.
// `out` is dq, or dk and dv.
template <typename Kernel, typename... Out>
cudaError_t launch_wgmma(Kernel kern, int grid_x, int threads, size_t smem, const Args& a,
                         Out... out) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)a.d);
  kern<<<dim3(grid_x, a.bh), threads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.g), a.lse, a.delta, static_cast<bf16*>(out)..., a.lq, a.lk,
      kLog2e * scale, scale);
  return cudaGetLastError();
}

cudaError_t dq_bf16(const Args& a) {
  if (a.d == 512)
    return launch_wgmma(flash_bwd_dq_kernel_wgmma_d512, (a.lq + 63) / 64, 256,
                        1024 + 2 * 8 * 64 * 128 + 2 * 8 * 32 * 128, a, a.dq);
  if (a.d != 64) return cudaErrorInvalidValue;
  constexpr int NWG = FLASH_BWD_DQ_NWG, BK = FLASH_BWD_DQ_BK;
  return launch_wgmma(flash_bwd_dq_kernel_wgmma_d64<NWG, BK, FLASH_BWD_DQ_MIN_CTAS>,
                      (a.lq + NWG * 64 - 1) / (NWG * 64), NWG * 128,
                      1024 + 2 * NWG * 64 * 128 + 4 * BK * 128, a, a.dq);
}

cudaError_t dkdv_bf16(const Args& a) {
  if (a.d == 512)
    return launch_wgmma(flash_bwd_dkdv_kernel_wgmma_d512, 2 * ((a.lk + 63) / 64), 256,
                        1024 + 2 * 8 * 64 * 128 + 2 * 8 * 32 * 128 + 2 * 32 * 4, a, a.dk, a.dv);
  if (a.d != 64) return cudaErrorInvalidValue;
  constexpr int NWG = FLASH_BWD_DKDV_NWG, BQ = FLASH_BWD_DKDV_BQ;
  return launch_wgmma(flash_bwd_dkdv_kernel_wgmma_d64<NWG, BQ, FLASH_BWD_DKDV_MIN_CTAS>,
                      (a.lk + NWG * 64 - 1) / (NWG * 64), NWG * 128,
                      1024 + 2 * NWG * 64 * 128 + 4 * BQ * 128 + 2 * 2 * BQ * 4, a, a.dk, a.dv);
}

template <typename C>
cudaError_t launch_dq_f32(const Args& a) {
  auto kern = flash_bwd_dq_kernel_f32<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lq + C::BQ - 1) / C::BQ, a.bh);
  kern<<<grid, kThreads, C::SMEM, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.lse, a.delta,
      static_cast<float*>(a.dq), a.lq, a.lk, 1.0f / sqrtf((float)C::D));
  return cudaGetLastError();
}

template <typename C>
cudaError_t launch_dkdv_f32(const Args& a) {
  auto kern = flash_bwd_dkdv_kernel_f32<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lk + C::BK - 1) / C::BK, a.bh);
  kern<<<grid, kThreads, C::SMEM, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.lq, a.lk,
      1.0f / sqrtf((float)C::D));
  return cudaGetLastError();
}

bool bad_shape(int bh, int lq, int lk) { return bh <= 0 || lq <= 0 || lk <= 0 || bh > 65535; }

}  // namespace

// q, g (the cotangent of the output), dq: [bh, lq, d]; k, v: [bh, lk, d];
// lse, delta: [bh, lq] float32; all contiguous, q, k, v, g 16-byte aligned.
// dtype 0 = float32, 1 = bfloat16. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, void* dq, int bh, int lq,
                                 int lk, int d, int dtype, void* stream) {
  if (bad_shape(bh, lq, lk)) return (int)cudaErrorInvalidValue;
  const Args a{q,  k,       v,       g,  static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, nullptr, bh, lq, lk, d,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && d == 64) return (int)launch_dq_f32<DqTiles64>(a);
  if (dtype == 0 && d == 512) return (int)launch_dq_f32<DqTiles512>(a);
  if (dtype == 1) return (int)dq_bf16(a);
  return (int)cudaErrorInvalidValue;
}

// Same inputs; dk, dv: [bh, lk, d] in the inputs' type.
extern "C" int flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   int bh, int lq, int lk, int d, int dtype, void* stream) {
  if (bad_shape(bh, lq, lk)) return (int)cudaErrorInvalidValue;
  const Args a{q,  k,       v,  g,  static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr, dk, dv, bh, lq, lk, d,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && d == 64) return (int)launch_dkdv_f32<DkvTiles64>(a);
  if (dtype == 0 && d == 512) return (int)launch_dkdv_f32<DkvTiles512>(a);
  if (dtype == 1) return (int)dkdv_bf16(a);
  return (int)cudaErrorInvalidValue;
}
