// Flash-attention forward for Hopper (sm_90a): non-causal softmax(Q K^T / sqrt(D)) V.
//
// Replaces the Pallas kernels `_flash_kernel` and `_flash_kernel_stats` of
// triplaneturbo_tpu/ops/attention_pallas.py (called through
// `_fused_attention_fwd_impl` / `fused_attention`). Same function: scale
// 1/sqrt(D), keys at or past Lk score -1e30, running max and normalizer in
// f32, output = acc / max(l, 1e-30) cast to the input type. The stats form
// (entry point `flash_attn_fwd_stats`) also writes the per-row logsumexp
// lse = m + log(max(l, 1e-30)) in f32 and in natural log, which the backward
// kernels of flash_attn_bwd.cu read; the plain form passes no lse pointer and
// writes none.
//
// What bounds it on an H100: at the joint self-attention shapes (L = 6144,
// D = 64) the work is ~4 L^2 D FLOPs against ~4 L D bytes of operands, far
// above the card's ridge point, so it is bound by arithmetic: the tensor
// cores' bf16 rate and, at D = 64, as much the rate of exp (one per score
// against 2 D multiply-adds). The cross attention (Lk = 77) is bound by the
// bytes of Q and O and costs little more than its launch.
//
// What the bf16 design does about it (`flash_fwd_kernel_wgmma_d64`,
// `flash_fwd_kernel_wgmma_d512`):
//  * Both products run on the tensor cores through `wgmma.mma_async`
//    (m64nNk16, bf16 x bf16 -> f32 accumulators in registers). One warpgroup
//    owns 64 query rows. Q, K and V stay bf16 in shared memory as tiles of
//    128-byte rows in the 128-byte swizzle (a 64-wide bf16 row is one swizzle
//    atom; D = 512 is eight such column blocks). S = Q K^T reads K as a
//    K-major B operand; O += P V reads the V tile [keys, D] as an MN-major B
//    operand (the instruction's transpose flag).
//  * S and P never leave registers. The online softmax runs on the
//    accumulator fragment: each thread holds two rows, the row max is reduced
//    over the four lanes that share a row, the running max and normalizer
//    stay in registers (the normalizer as a per-lane partial sum, reduced once
//    at the end), O is rescaled in registers, and P, rounded to bf16, is the
//    register A operand of the second product: the accumulator layout of the
//    first product is the A-fragment layout of the second once neighbouring
//    pairs are packed. The normalizer sums the f32 exponentials, not the
//    rounded P.
//  * scale * log2(e) is folded into one multiply-add and the exponential is
//    one `ex2.approx` instruction; the running max is kept in base 2 and lse converted back with
//    lse = m * ln2 + log(l).
//  * K/V tiles go through a two-stage ring filled by 16-byte `cp.async`
//    (rows at or past Lk, and Q rows past L, are zero-filled): the loads of
//    tile t+1 are in flight while tile t is multiplied, with one barrier a
//    tile. Masking is as before: keys past Lk are set to -1e30 before the row
//    max, rows past L are never written.
//  * Tiling at D = 64, chosen by measurement: 128 keys a tile and two
//    warpgroups (128 query rows) a CTA at 128 registers a thread, so that two
//    CTAs, four warpgroups, share an SM and one warpgroup's softmax runs under
//    the others' products. Where 128-row tiles would give fewer CTAs than the
//    card has SMs, a CTA is one warpgroup (64 rows).
//  * D = 512 (the VAE mid-block) keeps a 64 x 512 f32 O tile, 256 registers a
//    thread for one warpgroup, so two warpgroups share the 64 query rows and
//    each owns 256 of O's columns. Each computes the whole S tile for itself
//    (Q K^T walked over D in 32 steps of 16), so that no score tile is
//    exchanged through shared memory. Q, K and V tiles of 64 rows are 64 KB
//    each, single-buffered; the K tile of t+1 loads under the softmax and P V
//    of t, the V tile of t+1 under Q K^T of t+1.
//
// f32 inputs keep the register-tiled FMA body (`flash_fwd_kernel_f32`): they
// are held to 1e-4 absolute, which TF32 tensor cores would break, and only the
// small-model comparisons and the f32 kernel cases reach it. It uses 64 x 64
// tiles at D = 64 (~69 KB of shared memory) and 32 x 32 at D = 512 (~203 KB).

#include "hopper_mma.cuh"

// Tiling of the D = 64 tensor-core kernel: warpgroups (64 query rows each) a
// CTA, keys a tile, CTAs an SM the register budget is set for; and the
// warpgroups a CTA where 128-row tiles would leave SMs without a CTA. Chosen by
// measurement on an H100 (triplaneturbo_torch/tools/tune_flash_fwd.py builds
// this file with other values).
#ifndef FLASH_D64_NWG
#define FLASH_D64_NWG 2
#endif
#ifndef FLASH_D64_BK
#define FLASH_D64_BK 128
#endif
#ifndef FLASH_D64_MIN_CTAS
#define FLASH_D64_MIN_CTAS 2
#endif
#ifndef FLASH_D64_SMALL_GRID_NWG
#define FLASH_D64_SMALL_GRID_NWG 1
#endif

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (the fragment layout is described in hopper_mma.cuh)
// ---------------------------------------------------------------------------

// Online softmax of one key tile on the accumulator fragment `s` of S (raw
// scores of keys k0 .. k0 + BK). c = scale * log2(e). Updates the running max
// m (base 2) and this lane's part l of the normalizer, returns the rescale
// factors of the two rows and P packed as the bf16 A fragments of P V.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], uint32_t (&p)[BK / 4],
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             int k0, int lk, int lane4, float c) {
  if (k0 + BK > lk) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + (i >> 2) * 8 + lane4 * 2 + (i & 1);
      if (col >= lk) s[i] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // every tile holds at least one key below lk, so mx is a real score
    const float m_new = fmaxf(m[h], mx[h] * c);
    alpha[h] = fast_exp2(m[h] - m_new);
    m[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float e = fast_exp2(fmaf(s[i], c, -m[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += e;
    s[i] = e;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// The normalizer of a row from its four lanes' parts; the logsumexp in natural log.
__device__ __forceinline__ float row_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return fmaxf(l, 1e-30f);
}

// D = 64. NWG warpgroups a CTA, each with 64 query rows; BK keys a tile; K/V in a two-stage ring.
template <int NWG, int BK, int MIN_CTAS>
__global__ void __launch_bounds__(NWG * 128, MIN_CTAS)
flash_fwd_kernel_wgmma_d64(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int lq, int lk, float c) {
  constexpr int D = 64, BQ = NWG * 64, THREADS = NWG * 128;
  constexpr uint32_t KV_BYTES = BK * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + BQ * 128;
  const uint32_t sV = sK + 2 * KV_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int lane4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * (size_t)lq * D;
  const bf16* kb = k + bh * (size_t)lk * D;
  const bf16* vb = v + bh * (size_t)lk * D;

  load_tile<BQ, THREADS>(sQ, qb, D, q0, lq, 0, tid);
  load_tile<BK, THREADS>(sK, kb, D, 0, lk, 0, tid);
  load_tile<BK, THREADS>(sV, vb, D, 0, lk, 0, tid);
  cp_async_commit();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint64_t dQ = tile_desc(sQ + wg * 64 * 128);

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

    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, dQ + kk * kStepKMajor, dK + kk * kStepKMajor, kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    uint32_t p[BK / 4];
    float alpha[2];
    softmax_tile<BK>(s, p, m, l, alpha, t * BK, lk, lane4, c);
    // most tiles move no row's max once a few have been seen
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }

    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs(acc, &p[4 * kc], dV + kc * kStepMNMajor);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
  }

  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  const int row[2] = {r0, r0 + 8};
  const float lsum[2] = {row_sum(l[0]), row_sum(l[1])};
  const float inv[2] = {1.f / lsum[0], 1.f / lsum[1]};
  store_acc_block(o + bh * (size_t)lq * D, D, acc, row, inv, lq, 0, lane4);
  if (lse != nullptr && lane4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < lq) lse[bh * (size_t)lq + row[h]] = m[h] * kLn2 + logf(lsum[h]);
  }
}

// D = 512. One CTA of two warpgroups owns 64 query rows; both compute the whole
// S tile (64 keys) and the softmax, warpgroup w accumulates columns
// [256 w, 256 w + 256) of O as four 64-wide blocks. Q, K, V tiles are eight
// [64, 64] column blocks each, single-buffered.
__global__ void __launch_bounds__(256, 1)
flash_fwd_kernel_wgmma_d512(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            float* __restrict__ lse, int lq, int lk, float c) {
  constexpr int D = 512, BQ = 64, BK = 64, THREADS = 256;
  constexpr uint32_t BLOCK_BYTES = 64 * 128;  // one [64, 64] column block
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + 8 * BLOCK_BYTES;
  const uint32_t sV = sK + 8 * BLOCK_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int lane4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * (size_t)lq * D;
  const bf16* kb = k + bh * (size_t)lk * D;
  const bf16* vb = v + bh * (size_t)lk * D;

  // cp.async groups in order: {Q, K0}, {V0}, then {K(t+1)}, {V(t+1)} in every
  // iteration (empty past the last tile), so that "all but the newest group"
  // is what each wait below needs.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    load_tile<BQ, THREADS>(sQ + j * BLOCK_BYTES, qb, D, q0, lq, 64 * j, tid);
    load_tile<BK, THREADS>(sK + j * BLOCK_BYTES, kb, D, 0, lk, 64 * j, tid);
  }
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < 8; ++j) load_tile<BK, THREADS>(sV + j * BLOCK_BYTES, vb, D, 0, lk, 64 * j, tid);
  cp_async_commit();

  float acc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_kv = (lk + BK - 1) / BK;
  for (int t = 0; t < n_kv; ++t) {
    const bool more = t + 1 < n_kv;
    // K(t) (and Q) landed; V(t) may still be in flight
    cp_async_wait<1>();
    fence_async_proxy();
    __syncthreads();
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BLOCK_BYTES;
      wgmma_ss(s, tile_desc(sQ + off) + (kk & 3) * kStepKMajor,
               tile_desc(sK + off) + (kk & 3) * kStepKMajor, kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    __syncthreads();  // both warpgroups are done with K(t)
    if (more) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        load_tile<BK, THREADS>(sK + j * BLOCK_BYTES, kb, D, (t + 1) * BK, lk, 64 * j, tid);
    }
    cp_async_commit();

    uint32_t p[BK / 4];
    float alpha[2];
    softmax_tile<BK>(s, p, m, l, alpha, t * BK, lk, lane4, c);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] *= alpha[(i >> 1) & 1];
    }

    // V(t) landed; K(t+1) may still be in flight
    cp_async_wait<1>();
    fence_async_proxy();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs(acc[j], &p[4 * kc],
                 tile_desc(sV + (wg * 4 + j) * BLOCK_BYTES) + kc * kStepMNMajor);
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_regs(acc[j]);
    __syncthreads();  // both warpgroups are done with V(t)
    if (more) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        load_tile<BK, THREADS>(sV + j * BLOCK_BYTES, vb, D, (t + 1) * BK, lk, 64 * j, tid);
    }
    cp_async_commit();
  }

  const int r0 = q0 + warp * 16 + (lane >> 2);
  const int row[2] = {r0, r0 + 8};
  const float lsum[2] = {row_sum(l[0]), row_sum(l[1])};
  const float inv[2] = {1.f / lsum[0], 1.f / lsum[1]};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    store_acc_block(o + bh * (size_t)lq * D, D, acc[j], row, inv, lq, (wg * 4 + j) * 64, lane4);
  if (lse != nullptr && wg == 0 && lane4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < lq) lse[bh * (size_t)lq + row[h]] = m[h] * kLn2 + logf(lsum[h]);
  }
}

template <typename Kernel>
cudaError_t launch_wgmma(Kernel kern, int threads, int bq, size_t smem, const void* q,
                         const void* k, const void* v, void* o, float* lse, int bh, int lq, int lk,
                         int d, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + bq - 1) / bq, bh);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, lq, lk, kLog2e / sqrtf((float)d));
  return cudaGetLastError();
}

template <int NWG>
cudaError_t launch_d64(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                       int lq, int lk, cudaStream_t stream) {
  constexpr int BK = FLASH_D64_BK;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024-byte period
  return launch_wgmma(flash_fwd_kernel_wgmma_d64<NWG, BK, FLASH_D64_MIN_CTAS>, NWG * 128, NWG * 64,
                      1024 + NWG * 64 * 128 + 4 * BK * 128, q, k, v, o, lse, bh, lq, lk, 64, stream);
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                          int lq, int lk, int d, cudaStream_t stream) {
  if (d == 64) {
    // a grid of large tiles that cannot give every SM a CTA takes the smaller tile
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    constexpr int BQ = FLASH_D64_NWG * 64;
    if ((long long)bh * ((lq + BQ - 1) / BQ) <= sms)
      return launch_d64<FLASH_D64_SMALL_GRID_NWG>(q, k, v, o, lse, bh, lq, lk, stream);
    return launch_d64<FLASH_D64_NWG>(q, k, v, o, lse, bh, lq, lk, stream);
  }
  if (d == 512)
    return launch_wgmma(flash_fwd_kernel_wgmma_d512, 256, 64, 1024 + 3 * 8 * 64 * 128, q, k, v, o,
                        lse, bh, lq, lk, d, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32: register-tiled FMA kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

// D: head dim; BQ x BK: query x key tile; SR x SC: per-thread tile of S;
// OR x OC: per-thread tile of O.
template <int D_, int BQ_, int BK_, int SR_, int SC_, int OR_, int OC_>
struct Tiles {
  static constexpr int D = D_, BQ = BQ_, BK = BK_;
  static constexpr int SR = SR_, SC = SC_, OR = OR_, OC = OC_;
  static constexpr int DP = D + 4;    // padded row stride of Q and K (floats)
  static constexpr int BKP = BK + 4;  // padded row stride of S
  static constexpr int S_COLS = BK / SC;  // threads along the key axis of S
  static constexpr int O_COLS = D / OC;   // threads along the feature axis of O
  static constexpr int TPR = kThreads / BQ;  // threads per row in the softmax
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * DP;
  static constexpr int V_OFF = K_OFF + BK * DP;
  static constexpr int S_OFF = V_OFF + BK * D;
  static constexpr int M_OFF = S_OFF + BQ * BKP;
  static constexpr int L_OFF = M_OFF + BQ;
  static constexpr int A_OFF = L_OFF + BQ;
  static constexpr int FLOATS = A_OFF + BQ;
  static constexpr size_t SMEM = FLOATS * sizeof(float);
  static_assert((BQ / SR) * S_COLS == kThreads, "S tiling must cover 256 threads");
  static_assert((BQ / OR) * O_COLS == kThreads, "O tiling must cover 256 threads");
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "softmax row group");
  static_assert(BK % TPR == 0 && D % 4 == 0, "tile shapes");
};

using Tiles64 = Tiles<64, 64, 64, 4, 4, 4, 4>;
using Tiles512 = Tiles<512, 32, 32, 2, 2, 4, 16>;

template <typename C>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int lq, int lk, float scale) {
  constexpr int D = C::D, BQ = C::BQ, BK = C::BK, DP = C::DP, BKP = C::BKP;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + C::Q_OFF;
  float* Ks = smem + C::K_OFF;
  float* Vs = smem + C::V_OFF;
  float* Ss = smem + C::S_OFF;
  float* Ms = smem + C::M_OFF;
  float* Ls = smem + C::L_OFF;
  float* As = smem + C::A_OFF;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * (size_t)lq * D;
  const float* kb = k + bh * (size_t)lk * D;
  const float* vb = v + bh * (size_t)lk * D;
  float* ob = o + bh * (size_t)lq * D;

  // Q tile (rows past lq are zero and never stored) and the running stats
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int qr = q0 + r;
    Qs[r * DP + c] = qr < lq ? qb[(size_t)qr * D + c] : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }

  // this thread's tiles: S rows sy + i*(BQ/SR), keys sx + j*S_COLS;
  // O rows oy + i*(BQ/OR), features ox + j*O_COLS
  const int sx = tid % C::S_COLS, sy = tid / C::S_COLS;
  const int ox = tid % C::O_COLS, oy = tid / C::O_COLS;
  constexpr int S_ROW_STEP = BQ / C::SR;
  constexpr int O_ROW_STEP = BQ / C::OR;
  float acc[C::OR][C::OC];
#pragma unroll
  for (int i = 0; i < C::OR; ++i)
#pragma unroll
    for (int j = 0; j < C::OC; ++j) acc[i][j] = 0.f;

  const int n_kv = (lk + BK - 1) / BK;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BK;
    // stage K and V (keys past lk are zero; their scores are masked below)
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int kr = k0 + r;
      const bool ok = kr < lk;
      Ks[r * DP + c] = ok ? kb[(size_t)kr * D + c] : 0.f;
      Vs[r * D + c] = ok ? vb[(size_t)kr * D + c] : 0.f;
    }
    __syncthreads();

    // S = Q K^T * scale, masked past lk
    {
      float s[C::SR][C::SC];
#pragma unroll
      for (int i = 0; i < C::SR; ++i)
#pragma unroll
        for (int j = 0; j < C::SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qv[C::SR], kv[C::SC];
#pragma unroll
        for (int i = 0; i < C::SR; ++i)
          qv[i] = *reinterpret_cast<const float4*>(&Qs[(sy + i * S_ROW_STEP) * DP + d]);
#pragma unroll
        for (int j = 0; j < C::SC; ++j)
          kv[j] = *reinterpret_cast<const float4*>(&Ks[(sx + j * C::S_COLS) * DP + d]);
#pragma unroll
        for (int i = 0; i < C::SR; ++i)
#pragma unroll
          for (int j = 0; j < C::SC; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < C::SR; ++i)
#pragma unroll
        for (int j = 0; j < C::SC; ++j) {
          const int col = sx + j * C::S_COLS;
          Ss[(sy + i * S_ROW_STEP) * BKP + col] = (k0 + col < lk) ? s[i][j] * scale : kNegInf;
        }
    }
    __syncthreads();

    // online softmax: TPR neighbouring lanes share one row
    {
      constexpr int TPR = C::TPR;
      const int r = tid / TPR, sub = tid % TPR;
      const float m_prev = Ms[r];
      float mx = kNegInf;
      for (int c = sub; c < BK; c += TPR) mx = fmaxf(mx, Ss[r * BKP + c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = sub; c < BK; c += TPR) {
        const float e = expf(Ss[r * BKP + c] - m_new);
        Ss[r * BKP + c] = e;
        sum += e;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (sub == 0) {
        const float alpha = expf(m_prev - m_new);
        As[r] = alpha;
        Ls[r] = Ls[r] * alpha + sum;
        Ms[r] = m_new;
      }
    }
    __syncthreads();

    // O = O * alpha + P V
    {
#pragma unroll
      for (int i = 0; i < C::OR; ++i) {
        const float a = As[oy + i * O_ROW_STEP];
#pragma unroll
        for (int j = 0; j < C::OC; ++j) acc[i][j] *= a;
      }
#pragma unroll 2
      for (int kk = 0; kk < BK; ++kk) {
        float p[C::OR], vv[C::OC];
#pragma unroll
        for (int i = 0; i < C::OR; ++i) p[i] = Ss[(oy + i * O_ROW_STEP) * BKP + kk];
#pragma unroll
        for (int j = 0; j < C::OC; ++j) vv[j] = Vs[kk * D + ox + j * C::O_COLS];
#pragma unroll
        for (int i = 0; i < C::OR; ++i)
#pragma unroll
          for (int j = 0; j < C::OC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < C::OR; ++i) {
    const int r = oy + i * O_ROW_STEP;
    const int qr = q0 + r;
    if (qr >= lq) continue;
    const float inv = 1.f / fmaxf(Ls[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < C::OC; ++j) ob[(size_t)qr * D + ox + j * C::O_COLS] = acc[i][j] * inv;
  }
  // the stats form: per-row logsumexp (the loop's last barrier made Ms and Ls final)
  if (lse != nullptr) {
    for (int r = tid; r < BQ; r += kThreads)
      if (q0 + r < lq) lse[bh * (size_t)lq + q0 + r] = Ms[r] + logf(fmaxf(Ls[r], 1e-30f));
  }
}

template <typename C>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                       int lq, int lk, cudaStream_t stream) {
  auto kern = flash_fwd_kernel_f32<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + C::BQ - 1) / C::BQ, bh);
  kern<<<grid, kThreads, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, lq, lk, 1.0f / sqrtf((float)C::D));
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                         int lq, int lk, int d, cudaStream_t stream) {
  if (d == 64) return launch_f32<Tiles64>(q, k, v, o, lse, bh, lq, lk, stream);
  if (d == 512) return launch_f32<Tiles512>(q, k, v, o, lse, bh, lq, lk, stream);
  return cudaErrorInvalidValue;
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int lq,
             int lk, int d, int dtype, void* stream) {
  if (bh <= 0 || lq <= 0 || lk <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_f32(q, k, v, o, lse, bh, lq, lk, d, s);
  if (dtype == 1) return (int)dispatch_bf16(q, k, v, o, lse, bh, lq, lk, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: [bh, lq, d]; k, v: [bh, lk, d], contiguous and 16-byte aligned.
// dtype 0 = float32, 1 = bfloat16. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                              int bh, int lq, int lk, int d, int dtype, void* stream) {
  return dispatch(q, k, v, o, nullptr, bh, lq, lk, d, dtype, stream);
}

// The same forward, which also writes lse [bh, lq] in float32.
extern "C" int flash_attn_fwd_stats(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int bh, int lq, int lk, int d, int dtype,
                                    void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, o, static_cast<float*>(lse), bh, lq, lk, d, dtype, stream);
}
