// Fused SDF + deformation on the dense marching-cubes grid, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of triplaneturbo_tpu/ops/field_grid_pallas.py
// (called through `_pallas_forward` / `fused_field_grid`). For every grid point
// (x, y, z):
//   h1 = relu(a_xy[x, y] + a_xz[x, z] + a_zy[y, z])       (H = 128: the first
//        layers of the bias-free SDF and deformation MLPs, folded into the planes)
//   h2 = relu(h1 . W2blk)                                  (block-diagonal 128 x 128)
//   sdf[x, y, z]       = h2 . w3t[0] + |world(x, y, z)| - bias_r
//   deform[c, x, y, z] = h2 . w3t[1 + c]
// The sphere bias is computed here from linspace(-radius, radius, R); the TPU
// kernel streamed a precomputed grid only because Mosaic cannot lower a
// leading-dimension iota.
//
// What bounds it on an H100: W2blk is block-diagonal (the SDF and deformation
// nets are separate), so a grid point needs two 64 x 64 products (16384 FLOP),
// the plane sum and the four heads: ~70 GFLOP at R = 160 against ~105 MB of
// inputs and outputs, so it is bound by arithmetic. In f32 on the CUDA cores
// (67 TFLOP/s) that is ~1.05 ms; the tensor cores take TF32 at 495 TFLOP/s.
//
// What this design does about it:
//  * Both products run on the tensor cores as `wgmma.mma_async ... m64n64k8
//    .f32.tf32.tf32`, with f32 accuracy from three TF32 products: every
//    operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi) (round
//    to nearest, as `cvt.rna.tf32.f32`), and h1 W2 is taken as
//    h1_lo W2_hi + h1_hi W2_lo + h1_hi W2_hi in f32 accumulators. The plane
//    sum, the relus, the heads and the sphere bias stay f32 on the CUDA cores.
//    The zero blocks of W2blk are never multiplied: one warpgroup computes the
//    SDF net's 64 columns of a tile of 64 points, a second one the deformation
//    net's.
//  * A (h1) is formed in registers and never leaves them. Each thread sums its
//    own A-fragment values from the staged plane rows and splits them. The
//    reduction index is permuted (`slot_col`) so that a thread's 16 values of
//    a row are four 16-byte chunks; W2 is staged with the same permutation,
//    transposed to [n][k] (the tf32 `wgmma` takes K-major operands only), as
//    hi and lo tiles of 128-byte rows in the 128-byte swizzle, resident for
//    the CTA's life (64 KB).
//  * A tile is 8 x-values by 8 z-values at one y. A CTA (the two warpgroups
//    of one tile) walks y with the tile's 64 rows of a_xz staged once in
//    shared memory, so each y-step reads only 8 rows of a_xy and 8 of a_zy
//    (8 KB, by 16-byte `cp.async`, issued under the previous step's products):
//    ~0.5 GB of L2 traffic at R = 160, where a tile of 64 points along one
//    line of the grid re-reads a 32 KB a_zy slice every time (2.1 GB). Points
//    past R in x or z are zero-filled and never written.
//  * CTAs are persistent, two an SM, each taking a contiguous run of (tile, y)
//    steps, so that one CTA's products run under the other's sums, heads and
//    stores, and no wave is left ragged.
//  * One thread writes each output; no atomics, so reruns are bit-equal.

#include <initializer_list>

#include "hopper_mma.cuh"

namespace {

constexpr int kH = 128;            // hidden width: 64 (sdf net) + 64 (deformation net)
constexpr int kHB = 64;            // one net's width: one diagonal block of W2blk
constexpr int kB = 8;              // a tile is kB x-values by kB z-values at one y
constexpr int kThreads = 256;      // two warpgroups: the sdf net's, the deformation net's
constexpr int kCtasPerSm = 2;
constexpr uint32_t kRowBytes = kH * 4;                 // one point's row of a plane
constexpr uint32_t kAtomBytes = kHB * 128;             // [64 n][32 k] tf32, one swizzle atom wide
constexpr uint32_t kW2Bytes = 2 * 2 * 2 * kAtomBytes;  // [net][hi, lo][two atoms of 32 k]
constexpr uint32_t kW3Bytes = 4 * kH * 4;              // rows 0..3 of w3t
constexpr uint32_t kXZBytes = kB * kB * kRowBytes;     // the tile's a_xz rows
constexpr uint32_t kStageBytes = 2 * kB * kRowBytes;   // the a_xy and a_zy rows of one y
constexpr size_t kSmem = 1024 + kW2Bytes + kW3Bytes + kXZBytes + kStageBytes;
constexpr uint64_t kAtomStep = kAtomBytes >> 4;        // descriptor step from one atom to the next

// The reduction index of a net's 64 columns is permuted so that the thread with
// lane % 4 = t holds, in slots t and t + 4 of every k-step, the columns
// 16 i + 4 t .. 16 i + 4 t + 3 (i = 0..3) of its rows: slot j of k-step s is
// column 16 (s / 2) + 4 (j % 4) + 2 (s % 2) + j / 4.
__host__ __device__ constexpr int slot_col(int s, int j) {
  return 16 * (s >> 1) + 4 * (j & 3) + 2 * (s & 1) + (j >> 2);
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero: half a TF32
// step added to the magnitude bits, the 13 dropped bits cleared. The bits of
// `cvt.rna.tf32.f32` for every input but a NaN whose payload lies only in the dropped
// bits, in two integer instructions where the PTX conversion takes four (it tests for
// inf and NaN first); and the compiler cannot fold x - hi to zero through it.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d (64 x 64, f32) (+)= A (64 x 8 tf32, in registers) x B (8 x 64, K-major in shared memory).
// A register fragment of warp w: a[0] row 16 w + lane / 4, column lane % 4; a[1] eight
// rows below; a[2], a[3] the same rows at column lane % 4 + 4.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS_32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC_32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Byte offset of the 16-byte chunk c of row r of a staged plane tile: chunk c ^ 4 (r % 2),
// so that the two rows a quarter-warp reads fall in different banks.
__device__ __forceinline__ uint32_t row_chunk(int r, int c) {
  return (uint32_t)r * kRowBytes + ((uint32_t)(c ^ ((r & 1) << 2)) << 4);
}

// Byte offset of W2's atom for (net, hi = 0 / lo = 1, k slots [32 a, 32 a + 32)).
__device__ __forceinline__ uint32_t w2_atom(int net, int part, int atom) {
  return (uint32_t)((net * 2 + part) * 2 + atom) * kAtomBytes;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
field_grid_kernel(const float* __restrict__ a_xy, const float* __restrict__ a_xz,
                  const float* __restrict__ a_zy, const float* __restrict__ w2,
                  const float* __restrict__ w3t, float* __restrict__ sdf,
                  float* __restrict__ deform, int R, float radius, float bias_r) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (s_base - smem_u32(smem_raw));
  constexpr uint32_t kOffW3 = kW2Bytes;
  constexpr uint32_t xz_off = kOffW3 + kW3Bytes;
  constexpr uint32_t st_off = xz_off + kXZBytes;

  const int tid = threadIdx.x;
  const int net = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // this CTA's run of steps u = tile * R + y (tiles of 8 x 8 (x, z), row-major)
  const int nb = (R + kB - 1) / kB;
  const long long n_steps = (long long)nb * nb * R;
  const int u_begin = (int)(n_steps * blockIdx.x / gridDim.x);
  const int u_end = (int)(n_steps * (blockIdx.x + 1) / gridDim.x);

  // The 256 threads copy the rows of step (tile (fx0, fz0), fy): a_xy[fx0 + i, fy] and
  // a_zy[fy, fz0 + i] (stage rows i and 8 + i) and, `with_xz`, the tile's rows
  // a_xz[fx0 + k, fz0 + i] (row 8 k + i of the a_xz buffer); thread tid copies the
  // 16-byte chunk tid % 32 of rows with i = tid / 32. Rows past R are zero-filled.
  // Offsets are 32-bit: the host takes R with R * R * 128 < 2^31.
  const int fc = tid & 31, fi = tid >> 5;
  const uint32_t fill_dst = s_base + row_chunk(fi, fc);  // rows fi, 8 + fi, 8 k + fi: same swizzle
  auto fill = [&](int fx0, int fz0, int fy, bool with_xz) {
    const bool x_ok = fx0 + fi < R, z_ok = fz0 + fi < R;
    cp_async16(fill_dst + st_off, a_xy + (x_ok ? ((fx0 + fi) * R + fy) * kH + 4 * fc : 0),
               x_ok ? 16 : 0);
    cp_async16(fill_dst + st_off + kB * kRowBytes,
               a_zy + (z_ok ? (fy * R + fz0 + fi) * kH + 4 * fc : 0), z_ok ? 16 : 0);
    if (with_xz) {
      const int src = (fx0 * R + fz0 + fi) * kH + 4 * fc;
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const bool ok = z_ok && fx0 + k < R;
        cp_async16(fill_dst + xz_off + k * kB * kRowBytes, a_xz + (ok ? src + k * R * kH : 0),
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // the run's first step; tile (x0 / 8, z0 / 8)
  int y = u_begin % R, tile = u_begin / R;
  int x0 = (tile / nb) * kB, z0 = (tile % nb) * kB;
  if (u_begin < u_end) fill(x0, z0, y, true);

  // W2's two diagonal blocks, transposed to [n][k slot] and split into TF32 hi and lo
  for (int idx = tid; idx < 2 * kHB * kHB; idx += kThreads) {
    const int n = idx & 63, slot = (idx >> 6) & 63, b = idx >> 12;
    const int k = slot_col(slot >> 3, slot & 7);
    const float v = w2[(size_t)(b * kHB + k) * kH + b * kHB + n];
    const uint32_t hi = tf32_rna(v);
    const uint32_t lo = tf32_rna(v - __uint_as_float(hi));
    const int kk = slot & 31;
    const uint32_t off = n * 128 + ((uint32_t)((kk >> 2) ^ (n & 7)) << 4) + (kk & 3) * 4;
    *reinterpret_cast<uint32_t*>(sm + w2_atom(b, 0, slot >> 5) + off) = hi;
    *reinterpret_cast<uint32_t*>(sm + w2_atom(b, 1, slot >> 5) + off) = lo;
  }
  for (int i = tid; i < 4 * kH; i += kThreads)
    reinterpret_cast<float*>(sm + kOffW3)[i] = w3t[i];
  fence_async_proxy();  // the wgmma reads W2 through the async proxy
  __syncthreads();

  const uint64_t d_hi = tile_desc(s_base + w2_atom(net, 0, 0));
  const uint64_t d_lo = tile_desc(s_base + w2_atom(net, 1, 0));
  const float* const w3s = reinterpret_cast<const float*>(sm + kOffW3);
  const float step = R > 1 ? 2.f * radius / (float)(R - 1) : 0.f;
  const size_t R2 = (size_t)R * R, R3 = R2 * R;
  // This thread's rows are points (x0 + 2 warp + h, y, z0 + g), h = 0, 1, and it reads
  // the 16-byte chunks 16 net + t + 4 i (i = 0..3) of their planes' rows. In a row of
  // parity p (row_chunk) chunk i lies at byte 16 (16 net + t) + 64 (i ^ p), which is
  // 64 i + 64 p for even i and 64 i - 64 p for odd i: the a_xy rows 2 warp + h have
  // parity h, the a_zy row 8 + g and the a_xz rows 8 (2 warp + h) + g that of g.
  const int lane_col = 16 * (16 * net + t), flip = 64 * (g & 1);
  const uint8_t* const xy_row = sm + st_off + 2 * warp * kRowBytes + lane_col;
  const uint8_t* const zy_even = sm + st_off + (kB + g) * kRowBytes + lane_col + flip;
  const uint8_t* const zy_odd = zy_even - 2 * flip;
  const uint8_t* const xz_even = sm + xz_off + (2 * warp * kB + g) * kRowBytes + lane_col + flip;
  const uint8_t* const xz_odd = xz_even - 2 * flip;

  for (int u = u_begin; u < u_end; ++u) {
    cp_async_wait<0>();
    __syncthreads();  // step u's rows (and the tile's a_xz rows) have landed

    // A is built for one W2 atom (32 slots, k-steps 4 half .. 4 half + 3, row chunks
    // i = 2 half, 2 half + 1) at a time and multiplied before the next: 32 A registers
    // live, not 64
    float acc[32];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 2 * half; i < 2 * half + 2; ++i) {
          const float4 xy = *reinterpret_cast<const float4*>(xy_row + h * kRowBytes + 64 * (i ^ h));
          const float4 zy = *reinterpret_cast<const float4*>((i & 1 ? zy_odd : zy_even) + 64 * i);
          const float4 xz = *reinterpret_cast<const float4*>((i & 1 ? xz_odd : xz_even) +
                                                             h * kB * kRowBytes + 64 * i);
          const float v[4] = {fmaxf(xy.x + xz.x + zy.x, 0.f), fmaxf(xy.y + xz.y + zy.y, 0.f),
                              fmaxf(xy.z + xz.z + zy.z, 0.f), fmaxf(xy.w + xz.w + zy.w, 0.f)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // column 16 i + 4 t + e is slot t + 4 (e % 2) of k-step 2 i + e / 2
            const uint32_t hi = tf32_rna(v[e]);
            ahi[2 * (i & 1) + (e >> 1)][2 * (e & 1) + h] = hi;
            alo[2 * (i & 1) + (e >> 1)][2 * (e & 1) + h] = tf32_rna(v[e] - __uint_as_float(hi));
          }
        }
      }
      if (half == 1) {
        __syncthreads();  // every thread is done with the stage and the a_xz rows
        if (u + 1 < u_end) {
          if (y + 1 < R) fill(x0, z0, y + 1, false);
          else fill(((tile + 1) / nb) * kB, ((tile + 1) % nb) * kB, 0, true);  // the next tile
        }
      }
      // h2 += h1_lo W2_hi + h1_hi W2_lo + h1_hi W2_hi over the atom, the small terms first
      uint64_t hi_atom = d_hi + half * kAtomStep, lo_atom = d_lo + half * kAtomStep;
      // opaque to the compiler, so that it forms each k-step's descriptor where it is used
      // and does not keep all sixteen in registers across the loop
      asm volatile("" : "+l"(hi_atom), "+l"(lo_atom));
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_tf32(acc, alo[s], hi_atom + s * kStepKMajor, half + s > 0);
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_tf32(acc, ahi[s], lo_atom + s * kStepKMajor, 1);
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_tf32(acc, ahi[s], hi_atom + s * kStepKMajor, 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
    }

    // heads: register i of acc is row 16 warp + g + 8 ((i / 2) % 2), column
    // 8 (i / 4) + 2 t + i % 2 of the net; the four lanes of a row sum their parts
    float p[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    if (net == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        p[0][(i >> 1) & 1] = fmaf(fmaxf(acc[i], 0.f), w3s[8 * (i >> 2) + 2 * t + (i & 1)],
                                  p[0][(i >> 1) & 1]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float h2 = fmaxf(acc[i], 0.f);
        const int n = kHB + 8 * (i >> 2) + 2 * t + (i & 1);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          p[c][(i >> 1) & 1] = fmaf(h2, w3s[(1 + c) * kH + n], p[c][(i >> 1) & 1]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (c > 0 && net == 0) continue;
        p[c][h] += __shfl_xor_sync(0xffffffffu, p[c][h], 1);
        p[c][h] += __shfl_xor_sync(0xffffffffu, p[c][h], 2);
      }
    const int z = z0 + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + 2 * warp + h;
      if (x >= R || z >= R) continue;
      const size_t o = (size_t)x * R2 + (size_t)y * R + z;
      if (net == 0) {
        if (t == h) {
          const float wx = -radius + x * step, wy = -radius + y * step, wz = -radius + z * step;
          sdf[o] = p[0][h] + sqrtf(wx * wx + wy * wy + wz * wz) - bias_r;
        }
      } else if (t < 3) {
        deform[t * R3 + o] = t == 0 ? p[0][h] : (t == 1 ? p[1][h] : p[2][h]);
      }
    }
    if (++y == R) {
      y = 0;
      ++tile;
      x0 = (tile / nb) * kB;
      z0 = (tile % nb) * kB;
    }
  }
}

}  // namespace

// a_xy [R, R, 128] (x, y), a_xz [R, R, 128] (x, z), a_zy [R, R, 128] (y, z),
// w2 [128, 128] block-diagonal (only its two 64 x 64 diagonal blocks are read),
// w3t [>= 4, 128] (rows = output channels; row 0 is read in columns 0..63, rows
// 1..3 in columns 64..127), all float32 and contiguous, the planes 16-byte aligned.
// Writes sdf [R, R, R] and deform [3, R, R, R]. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int field_grid_fwd(const void* a_xy, const void* a_xz, const void* a_zy,
                              const void* w2, const void* w3t, void* sdf, void* deform,
                              int R, float radius, float bias_r, void* stream) {
  if (R <= 0 || (long long)R * R * kH > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  for (const void* p : {a_xy, a_xz, a_zy})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const long long nb = (R + kB - 1) / kB;
  if (nb * nb * R > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(field_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  // two persistent CTAs an SM, fewer where there are fewer steps
  const long long steps = nb * nb * R;
  const int grid = (int)(steps < (long long)n_sm * kCtasPerSm ? steps : n_sm * kCtasPerSm);
  field_grid_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_xy), static_cast<const float*>(a_xz),
      static_cast<const float*>(a_zy), static_cast<const float*>(w2),
      static_cast<const float*>(w3t), static_cast<float*>(sdf),
      static_cast<float*>(deform), R, radius, bias_r);
  return (int)cudaGetLastError();
}
