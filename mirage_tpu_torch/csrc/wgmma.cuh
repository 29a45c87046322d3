// Hopper building blocks shared by the wgmma GEMM kernels (the bf16 and
// int8 products of csrc/gemm_pingpong.cuh, csrc/gemm_stash.cu,
// csrc/gemm_lnfold.cu, csrc/mlp_chunked.cu, csrc/fused_block.cu,
// csrc/mlp_bwd.cu, csrc/wgrad.cu, and the attention forward of
// csrc/attention_fwd.cuh): warpgroup MMA (bf16, and s8·s8 -> s32) on 128-,
// 64- or 32-byte-swizzled K-major or MN-major (transposed) tiles, with A from
// shared memory or registers, mbarriers (arrived at from another CTA of the
// cluster too), 2-D and 3-D TMA loads (multicast to several CTAs of a
// cluster too; 3-D maps over a task stack), the cluster's shared-memory
// addresses and barriers, and the tensor-map encoder fetched from the
// driver at run time (so the libraries need no link against libcuda).
#pragma once

#include <cuda.h>  // CUtensorMap

#include <mutex>

#include "common.cuh"

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile whose
// 8-row groups lie 1024 bytes apart (the tile base is 1024-byte aligned).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// wgmma shared-memory descriptor of an MN-major (transposed), 128-byte-
// swizzled operand: rows of 64 MN-contiguous elements (one 128-byte
// swizzle row) for consecutive k, as a TMA box of 64 × 64 lands them; its
// 8-row k groups lie 1024 bytes apart (the stride dimension) and its
// 64-wide MN blocks `mn_stride` bytes apart (the leading dimension: the
// next box). One k16 step is 16 rows: + 2048 bytes (+128 in the
// descriptor's units). The operand is read with the instruction's
// transpose bit set.
__device__ __forceinline__ uint64_t wgmma_desc_mn(uint32_t saddr, uint32_t mn_stride) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((mn_stride >> 4) & 0x3FFF) << 16) | (64ull << 32) | (1ull << 62);
}

// The same two descriptors for a tile swizzled over `row_bytes` (128, 64 or
// 32: one TMA box row of 64, 32 or 16 bf16): K-major, the 8-row groups
// `8 · row_bytes` apart (a k16 step + 32 bytes while it stays inside a
// row); MN-major, the k groups `8 · row_bytes` apart, the MN blocks of one
// row's width `mn_stride` apart, a k16 step + 16 · row_bytes.
__device__ __forceinline__ uint64_t wgmma_desc_sw(uint32_t saddr, int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * row_bytes >> 4) << 32) | (layout << 62);
}
__device__ __forceinline__ uint64_t wgmma_desc_mn_sw(uint32_t saddr, uint32_t mn_stride,
                                                     int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((mn_stride >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(8 * row_bytes >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a wgmma
// wait or fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps register-A fragments in their registers up to this point: a wgmma
// reads them asynchronously after its issue, until the wait.
template <int K>
__device__ __forceinline__ void keep_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    asm volatile("" : "+r"(a[k][0]), "+r"(a[k][1]), "+r"(a[k][2]), "+r"(a[k][3])::"memory");
}

#define MTT_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 × 256, this thread's 128 floats) += A (64 × 16) · B (256 × 16)ᵀ;
// TA / TB = 1: A / B is MN-major (wgmma_desc_mn)
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : MTT_F8(0), MTT_F8(8), MTT_F8(16), MTT_F8(24), MTT_F8(32), MTT_F8(40), MTT_F8(48),
        MTT_F8(56), MTT_F8(64), MTT_F8(72), MTT_F8(80), MTT_F8(88), MTT_F8(96), MTT_F8(104),
        MTT_F8(112), MTT_F8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
// d (64 × 128: this thread's first 64 floats of d) += A (64 × 16) · B (128 × 16)ᵀ;
// TA / TB as wgmma_n256's
template <int TA = 0, int TB = 0, int N>
__device__ __forceinline__ void wgmma_n128(float (&d)[N], uint64_t da, uint64_t db) {
  static_assert(N >= 64, "wgmma_n128 writes 64 accumulators a thread");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : MTT_F8(0), MTT_F8(8), MTT_F8(16), MTT_F8(24), MTT_F8(32), MTT_F8(40), MTT_F8(48),
        MTT_F8(56)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
// d[OFF .. OFF + 63] (64 × 128 of a thread's 128 floats: row block OFF/64 of
// a 128 × 128 tile) += A (64 × 16) · B (128 × 16)ᵀ; TB as wgmma_n256's
template <int OFF, int TB = 0>
__device__ __forceinline__ void wgmma_n128_at(float (&d)[128], uint64_t da, uint64_t db) {
  static_assert(OFF == 0 || OFF == 64, "wgmma_n128_at: OFF 0 or 64");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : MTT_F8(OFF + 0), MTT_F8(OFF + 8), MTT_F8(OFF + 16), MTT_F8(OFF + 24), MTT_F8(OFF + 32),
        MTT_F8(OFF + 40), MTT_F8(OFF + 48), MTT_F8(OFF + 56)
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}
#undef MTT_F8

#define MTT_R8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
    "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[OFF .. OFF + 63] (64 × 128 s32 of a thread's 128: row block OFF/64 of a
// 128 × 128 tile) += A (64 × 32 s8) · B (128 × 32 s8)ᵀ, both K-major (wgmma
// has no transpose for 8-bit types), exact
template <int OFF>
__device__ __forceinline__ void wgmma_s8_n128_at(int (&d)[128], uint64_t da, uint64_t db) {
  static_assert(OFF == 0 || OFF == 64, "wgmma_s8_n128_at: OFF 0 or 64");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : MTT_R8(OFF + 0), MTT_R8(OFF + 8), MTT_R8(OFF + 16), MTT_R8(OFF + 24), MTT_R8(OFF + 32),
        MTT_R8(OFF + 40), MTT_R8(OFF + 48), MTT_R8(OFF + 56)
      : "l"(da), "l"(db), "r"(1));
}
#undef MTT_R8

// d (64 × N: this thread's first N/2 floats of d) = (scale_d ? d : 0) +
// A (64 × 16) · B (N × 16)ᵀ, both in shared memory, K-major or (TA / TB = 1)
// MN-major; N a multiple of 8 up to 64 (the attention forward's score tile
// and its narrower key tail, the attention backward's products)
template <int N, int TA = 0, int TB = 0, int M>
__device__ __forceinline__ void wgmma_ss(float (&d)[M], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N % 8 == 0 && N >= 8 && N <= 64 && M >= N / 2, "wgmma_ss: N in 8..64");
  if constexpr (N == 8)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  else if constexpr (N == 16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  else if constexpr (N == 24)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, %15, %16;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  else if constexpr (N == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  else if constexpr (N == 40)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, %20, %21, p, 1, 1, %23, %24;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  else if constexpr (N == 48)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, %27, %28;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  else if constexpr (N == 56)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, %28, %29, p, 1, 1, %31, %32;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  else if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 × N: this thread's first N/2 floats of d) += A (64 × 16, from
// registers: this warp's 16 rows as mma.sync m16n8k16 A fragments, which is
// also the layout of an m64nNk16 accumulator's two 8-column blocks rounded
// to bf16 pairs) · B (N × 16)ᵀ from shared memory; TB = 1: B is MN-major
// (wgmma_desc_mn), read with the transpose bit. N in 16, 32, 64, 128.
template <int N, int TB, int M>
__device__ __forceinline__ void wgmma_rs(float (&d)[M], const uint32_t (&a)[4], uint64_t db) {
  static_assert((N == 16 || N == 32 || N == 64 || N == 128) && M >= N / 2, "wgmma_rs: N");
  if constexpr (N == 16)
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, %13;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB));
  else if constexpr (N == 32)
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, 1, 1, 1, %21;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB));
  else if constexpr (N == 64)
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, %37;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB));
  else if constexpr (N == 128)
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, 1, 1, 1, %69;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Waits until the barrier's phase of this parity has completed. A phase
// that never completes (a lost arrival) traps after ~10 s instead of
// hanging the card, so the launch fails and the caller raises.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}
// Box (c0 = column, c1 = row) of a 2-D tensor map into shared memory; the
// bytes land on mbarrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Box (c0 = column, c1 = row, c2 = the outer index, e.g. the batch) of a
// 3-D tensor map into shared memory; the bytes land on mbarrier `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same box into the same shared-memory offset of every CTA of the
// cluster whose bit is set in `mask` (bit i: %cluster_ctarank i); the bytes
// land on the mbarrier at offset `bar` of each of those CTAs.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

// tma_load_2d_multicast for a box (c0, c1, c2) of a 3-D tensor map (the
// task-strided kernels: c2 is the task).
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Address of the shared-memory word at local address `local` in the CTA of
// cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
// One arrival on the mbarrier at local offset `bar` of the CTA of cluster
// rank `rank` (this CTA's own too): this warp is done with the stage it
// guards there. Default semantics (.release at CTA scope), as the TMA
// write that follows needs: .release.cluster made S6a markedly slower.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, int rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(cluster_addr(bar, rank))
               : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no link against libcuda.
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a row-major (rows, cols) bf16 matrix read in boxes of
// box_rows × box_cols (box_cols · 2 = 128 bytes, one swizzle row),
// 128-byte swizzled; out-of-range elements read as zero.
static bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                     int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_stride[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, pitch, box,
            elem_stride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map of a bf16 (batch, rows, cols) view with unit column stride and
// row and batch strides `rs` and `bs` (elements, multiples of 8), read in
// boxes of 1 × box_rows × box_cols, swizzled over the box's row (box_cols ·
// 2 = 128, 64 or 32 bytes); out-of-range elements read as zero.
static bool make_map_3d(CUtensorMap* map, const void* ptr, long long cols, long long rows,
                        long long batch, long long rs, long long bs, int box_rows,
                        int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t pitch[2] = {(cuuint64_t)rs * sizeof(bf16), (cuuint64_t)bs * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_stride[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, pitch, box,
            elem_stride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map of a contiguous bf16 (tasks, rows, cols) stack, read in boxes
// of 1 × box_rows × box_cols (the task-strided kernels: a box never crosses
// into the next task's rows; rows past `rows` read as zero).
static bool make_task_map(CUtensorMap* map, const void* ptr, int tasks, int rows, int cols,
                          int box_rows, int box_cols) {
  return make_map_3d(map, ptr, cols, rows, tasks, cols, (long long)rows * cols, box_rows,
                     box_cols);
}

// Tensor maps are encoded once per distinct (pointer, shape, strides, box)
// and kept: a seg step launches the attention kernels 24 times among 1,840
// launches, and serving reuses its buffers, so most launches find their maps
// here.
struct MapKey {
  const void* ptr;
  long long cols, rows, batch, rs, bs;
  int box_rows, box_cols;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && cols == o.cols && rows == o.rows && batch == o.batch && rs == o.rs &&
           bs == o.bs && box_rows == o.box_rows && box_cols == o.box_cols;
  }
};

// make_map_3d through the cache above.
static bool cached_map_3d(CUtensorMap* out, const MapKey& key) {
  constexpr int N = 64;
  static MapKey keys[N];
  static CUtensorMap maps[N];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *out = maps[i];
      return true;
    }
  if (!make_map_3d(out, key.ptr, key.cols, key.rows, key.batch, key.rs, key.bs, key.box_rows,
                   key.box_cols))
    return false;
  keys[next] = key;
  maps[next] = *out;
  next = (next + 1) % N;
  used = used < N ? used + 1 : N;
  return true;
}

