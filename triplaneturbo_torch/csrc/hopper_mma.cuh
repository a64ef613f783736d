// Device helpers shared by the tensor-core kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu, field_grid.cu) for Hopper (sm_90a): 16-byte
// `cp.async` fills of 128-byte-swizzled bf16 tiles, `wgmma` shared-memory
// descriptors, the `wgmma.mma_async` forms the kernels use, and the
// accumulator-fragment helpers.
//
// Where a thread's accumulator registers sit in the 64-row tile of its
// warpgroup: register i of a 64 x N accumulator is row
// 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
// So a thread holds two rows ("halves" h = 0, 1), each shared by four lanes,
// and N / 4 columns, in pairs. Packed in neighbouring pairs to bf16, the
// registers of columns [16 kc, 16 kc + 16) are the register A fragment of a
// product whose reduction runs over those columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// The same for one 4-byte word.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's landed copies visible to wgmma, which reads shared
// memory through the async proxy.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage rows [row0, row0 + ROWS) x columns [col0, col0 + 64) of a row-major
// bf16 matrix [nrows, ld] as a tile of 128-byte rows in the 128-byte swizzle:
// the 16-byte chunk c of row r lands at chunk c ^ (r % 8). `dst` is 1024-byte
// aligned. Rows at or past nrows are zero-filled.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* __restrict__ src, int ld,
                                          int row0, int nrows, int col0, int tid) {
  static_assert((ROWS * 8) % THREADS == 0, "tile rows must divide over the threads");
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx >> 3, c = idx & 7;
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    const bf16* p = src + (size_t)(ok ? gr : 0) * ld + col0 + c * 8;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), p, ok ? 16 : 0);
  }
}

// wgmma shared-memory descriptor of such a tile: start address, 8-row groups
// 1024 bytes apart (stride byte offset), 128-byte swizzle. The leading byte
// offset is not used by a tile one swizzle atom (64 bf16) wide. It serves the
// K-major operands (rows are the M/N index, the 128-byte row holds the
// reduction index) and the MN-major ones (rows are the reduction index).
__device__ __forceinline__ uint64_t tile_desc(uint32_t smem_addr) {
  uint64_t d = (uint64_t)((smem_addr & 0x3FFFFu) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}
// Descriptor steps: 16 reduction elements along a K-major row are 32 bytes;
// 16 reduction rows of an MN-major tile are 2048 bytes (both in 16-byte units).
constexpr uint64_t kStepKMajor = 32 >> 4;
constexpr uint64_t kStepMNMajor = 2048 >> 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed product groups are in flight.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving uses of accumulator registers across the
// point where the asynchronous products have been waited for.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define REGS_16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "         \
  " %8, %9, %10, %11, %12, %13, %14, %15} "
#define REGS_32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "         \
  " %8, %9, %10, %11, %12, %13, %14, %15, "   \
  " %16, %17, %18, %19, %20, %21, %22, %23, " \
  " %24, %25, %26, %27, %28, %29, %30, %31} "
#define REGS_64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "         \
  " %8, %9, %10, %11, %12, %13, %14, %15, "   \
  " %16, %17, %18, %19, %20, %21, %22, %23, " \
  " %24, %25, %26, %27, %28, %29, %30, %31, " \
  " %32, %33, %34, %35, %36, %37, %38, %39, " \
  " %40, %41, %42, %43, %44, %45, %46, %47, " \
  " %48, %49, %50, %51, %52, %53, %54, %55, " \
  " %56, %57, %58, %59, %60, %61, %62, %63} "
#define ACC_8(d, o)                                                                 \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define ACC_16(d, o) ACC_8(d, o), ACC_8(d, o + 8)
#define ACC_32(d, o) ACC_16(d, o), ACC_16(d, o + 16)

// d (64 x 32, f32) = or += A (64 x 16, K-major in shared memory) x B^T (32 x 16, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS_16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC_16(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}
// The same with a 64-wide B: d is 64 x 64.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS_32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC_32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}
// The same with a 128-wide B: d is 64 x 128.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS_64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC_32(d, 0), ACC_32(d, 32)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (64 x 64, f32) += A (64 x 16 bf16, in registers) x B (16 x 64, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS_32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC_32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 2^x in one instruction (exp2f adds a range fix-up around it; a result below
// the normal range may flush to zero here, which the softmax does not mind).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Store one 64-wide block of a thread's accumulator fragment as bf16, row h
// multiplied by mul[h]; rows at or past nrows are not written.
__device__ __forceinline__ void store_acc_block(bf16* __restrict__ ob, int ld,
                                                const float (&acc)[32], const int (&row)[2],
                                                const float (&mul)[2], int nrows, int col0,
                                                int lane4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= nrows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul[h], acc[4 * j + 2 * h + 1] * mul[h]);
      *reinterpret_cast<__nv_bfloat162*>(&ob[(size_t)row[h] * ld + col0 + 8 * j + 2 * lane4]) = v;
    }
  }
}

}  // namespace
