// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of the non-causal
// softmax(Q K^T / sqrt(D)) V, streamed from the saved per-row logsumexp.
//
// Replaces the Pallas kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkdv_kernel` of triplaneturbo_tpu/ops/attention_pallas.py (called
// through `_flash_bwd_impl`, the custom VJP of `fused_attention`). Same
// function: each tile recomputes P = exp(S * scale - lse), exactly 0 at keys at
// or past Lk; dP = dO V^T; dS = P o (dP - delta) with delta = rowsum(dO o O)
// computed by the caller; dq = sum dS K * scale; dk = sum dS^T Q * scale;
// dv = sum P^T dO. Every product and sum is f32; dq, dk, dv leave in the input
// type.
//
// What bounds them on an H100: at the joint self-attention shape (L = 6144,
// D = 64) dq does 6 L^2 D and dk/dv 8 L^2 D FLOPs against a few L D bytes of
// operands, so both are bound by arithmetic; the cross attention (Lk = 77) is
// bound by the bytes of Q, dO and dq.
//
// What this design does about it: neither the score matrix nor dS ever leaves
// the SM, and no CTA shares an output with another, so there are no atomics
// and the results are the same from run to run.
//   dq:    one CTA owns BQ query rows of one (batch, head), keeps Q, dO, lse
//          and delta in shared memory and loops over K/V tiles -- the loop
//          takes the place of the TPU's sequential grid axis.
//   dk/dv: one CTA owns BK key rows, keeps K and V in shared memory and loops
//          over Q/dO tiles.
// The products are register-tiled f32 FMA from shared memory, as in the
// forward kernel; tensor cores are left to a later change. The ragged edges
// are guarded, not padded: rows past Lq or Lk are staged as zeros, their P is
// forced to 0, and they are never written.
//
// D = 64 uses 64 x 64 tiles (~105 KB, two CTAs an SM). D = 512 (the
// VAE mid-block attention) cannot hold four 32-row f32 operand tiles in the
// 227 KB a CTA may use, so dq takes 16 query x 32 key rows (~203 KB) and dk/dv
// 32 query x 16 key rows (~204 KB), the accumulators staying in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage `rows` rows of a [n, D] matrix, starting at row0, into shared memory
// with row stride DP; rows at or past n become zeros.
template <typename T, int D, int DP>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0, int rows, int n,
                                           int tid) {
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * DP + c] = gr < n ? to_f32(src[(size_t)gr * D + c]) : 0.f;
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

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int lq, int lk,
                    float scale) {
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
  const T* kb = k + bh * (size_t)lk * D;
  const T* vb = v + bh * (size_t)lk * D;

  stage_rows<T, D, DP>(Qs, q + bh * (size_t)lq * D, q0, BQ, lq, tid);
  stage_rows<T, D, DP>(Gs, g + bh * (size_t)lq * D, q0, BQ, lq, tid);
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
    stage_rows<T, D, DP>(Ks, kb, k0, BK, lk, tid);
    stage_rows<T, D, DP>(Vs, vb, k0, BK, lk, tid);
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

  T* dqb = dq + bh * (size_t)lq * D;
#pragma unroll
  for (int i = 0; i < C::OR; ++i) {
    const int qr = q0 + oy + i * C::O_ROW_STEP;
    if (qr >= lq) continue;
#pragma unroll
    for (int j = 0; j < C::OC; ++j)
      dqb[(size_t)qr * D + ox + j * C::O_COLS] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int lq, int lk, float scale) {
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
  const T* qb = q + bh * (size_t)lq * D;
  const T* gb = g + bh * (size_t)lq * D;

  stage_rows<T, D, DP>(Ks, k + bh * (size_t)lk * D, k0, BK, lk, tid);
  stage_rows<T, D, DP>(Vs, v + bh * (size_t)lk * D, k0, BK, lk, tid);

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
    stage_rows<T, D, DP>(Qs, qb, q0, BQ, lq, tid);
    stage_rows<T, D, DP>(Gs, gb, q0, BQ, lq, tid);
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

  T* dkb = dk + bh * (size_t)lk * D;
  T* dvb = dv + bh * (size_t)lk * D;
#pragma unroll
  for (int i = 0; i < C::OR; ++i) {
    const int kr = k0 + oy + i * C::O_ROW_STEP;
    if (kr >= lk) continue;
#pragma unroll
    for (int j = 0; j < C::OC; ++j) {
      const size_t at = (size_t)kr * D + ox + j * C::O_COLS;
      dkb[at] = from_f32<T>(acc_k[i][j] * scale);
      dvb[at] = from_f32<T>(acc_v[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, lq, lk;
  cudaStream_t stream;
};

template <typename T, typename C>
cudaError_t launch_dq(const Args& a) {
  auto kern = flash_bwd_dq_kernel<T, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lq + C::BQ - 1) / C::BQ, a.bh);
  kern<<<grid, kThreads, C::SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.delta, static_cast<T*>(a.dq), a.lq, a.lk,
      1.0f / sqrtf((float)C::D));
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_dkdv(const Args& a) {
  auto kern = flash_bwd_dkdv_kernel<T, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lk + C::BK - 1) / C::BK, a.bh);
  kern<<<grid, kThreads, C::SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.lq, a.lk, 1.0f / sqrtf((float)C::D));
  return cudaGetLastError();
}

bool bad_shape(int bh, int lq, int lk) { return bh <= 0 || lq <= 0 || lk <= 0 || bh > 65535; }

}  // namespace

// q, g (the cotangent of the output), dq: [bh, lq, d]; k, v: [bh, lk, d];
// lse, delta: [bh, lq] float32; all contiguous. dtype 0 = float32,
// 1 = bfloat16. Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, void* dq, int bh, int lq,
                                 int lk, int d, int dtype, void* stream) {
  if (bad_shape(bh, lq, lk)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, nullptr, bh, lq, lk, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && d == 64) return (int)launch_dq<float, DqTiles64>(a);
  if (dtype == 0 && d == 512) return (int)launch_dq<float, DqTiles512>(a);
  if (dtype == 1 && d == 64) return (int)launch_dq<__nv_bfloat16, DqTiles64>(a);
  if (dtype == 1 && d == 512) return (int)launch_dq<__nv_bfloat16, DqTiles512>(a);
  return (int)cudaErrorInvalidValue;
}

// Same inputs; dk, dv: [bh, lk, d] in the inputs' type.
extern "C" int flash_attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   int bh, int lq, int lk, int d, int dtype, void* stream) {
  if (bad_shape(bh, lq, lk)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
               nullptr, dk, dv, bh, lq, lk, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && d == 64) return (int)launch_dkdv<float, DkvTiles64>(a);
  if (dtype == 0 && d == 512) return (int)launch_dkdv<float, DkvTiles512>(a);
  if (dtype == 1 && d == 64) return (int)launch_dkdv<__nv_bfloat16, DkvTiles64>(a);
  if (dtype == 1 && d == 512) return (int)launch_dkdv<__nv_bfloat16, DkvTiles512>(a);
  return (int)cudaErrorInvalidValue;
}
