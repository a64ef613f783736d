// Flash-attention forward for Hopper (sm_90a): non-causal softmax(Q K^T / sqrt(D)) V.
//
// Replaces the Pallas kernels `_flash_kernel` and `_flash_kernel_stats` of
// triplaneturbo_tpu/ops/attention_pallas.py (called through
// `_fused_attention_fwd_impl` / `fused_attention`). Same function: scale
// 1/sqrt(D), keys at or past Lk score -1e30, running max and normalizer in
// f32, output = acc / max(l, 1e-30) cast to the input type. The stats form
// (entry point `flash_attn_fwd_stats`) also writes the per-row logsumexp
// lse = m + log(max(l, 1e-30)) in f32, which the backward kernels of
// flash_attn_bwd.cu read; the plain form passes no lse pointer and writes none.
//
// What bounds it on an H100: at the joint self-attention shapes (L = 6144,
// D = 64) the work is ~4 L^2 D FLOPs against ~4 L D bytes of operands, far
// above the card's ridge point, so it is bound by arithmetic; the cross
// attention (Lk = 77) is bound by the bytes of Q and O.
//
// What this design does about it: the score matrix never leaves the SM. One
// CTA owns a tile of BQ query rows of one (batch, head) and loops over K/V
// tiles of BK keys staged in shared memory -- the loop takes the place of the
// TPU's sequential grid axis. Q K^T and P V are register-tiled FMA products
// from shared memory in f32 (each thread owns an SR x SC tile of S and an
// OR x OC tile of O), which keeps the f32 accumulation of the TPU kernel for
// both bf16 and f32 inputs. Tensor cores (mma / wgmma) are left to a later
// change: they are where the remaining arithmetic rate is.
//
// D = 64 uses 64 x 64 tiles (~69 KB of shared memory, 3 CTAs per SM); D = 512
// (the VAE mid-block attention) uses 32 x 32 tiles (~203 KB, dynamic shared
// memory raised with cudaFuncSetAttribute), since the TPU's 256 x 1024 blocks
// do not fit the 227 KB a Hopper CTA may use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
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

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
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
  const T* qb = q + bh * (size_t)lq * D;
  const T* kb = k + bh * (size_t)lk * D;
  const T* vb = v + bh * (size_t)lk * D;
  T* ob = o + bh * (size_t)lq * D;

  // Q tile (rows past lq are zero and never stored) and the running stats
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int qr = q0 + r;
    Qs[r * DP + c] = qr < lq ? to_f32(qb[(size_t)qr * D + c]) : 0.f;
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
      Ks[r * DP + c] = ok ? to_f32(kb[(size_t)kr * D + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f32(vb[(size_t)kr * D + c]) : 0.f;
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
    for (int j = 0; j < C::OC; ++j)
      ob[(size_t)qr * D + ox + j * C::O_COLS] = from_f32<T>(acc[i][j] * inv);
  }
  // the stats form: per-row logsumexp (the loop's last barrier made Ms and Ls final)
  if (lse != nullptr) {
    for (int r = tid; r < BQ; r += kThreads)
      if (q0 + r < lq) lse[bh * (size_t)lq + q0 + r] = Ms[r] + logf(fmaxf(Ls[r], 1e-30f));
  }
}

template <typename T, typename C>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                   int lq, int lk, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + C::BQ - 1) / C::BQ, bh);
  kern<<<grid, kThreads, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, lq, lk, 1.0f / sqrtf((float)C::D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse,
                       int bh, int lq, int lk, int d, cudaStream_t stream) {
  if (d == 64) return launch<T, Tiles64>(q, k, v, o, lse, bh, lq, lk, stream);
  if (d == 512) return launch<T, Tiles512>(q, k, v, o, lse, bh, lq, lk, stream);
  return cudaErrorInvalidValue;
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int lq,
             int lk, int d, int dtype, void* stream) {
  if (bh <= 0 || lq <= 0 || lk <= 0 || bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(q, k, v, o, lse, bh, lq, lk, d, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, lq, lk, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: [bh, lq, d]; k, v: [bh, lk, d], contiguous. dtype 0 = float32,
// 1 = bfloat16. Returns the CUDA error code of the launch (0 on success).
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
