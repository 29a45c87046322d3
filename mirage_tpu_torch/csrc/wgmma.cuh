// Hopper building blocks shared by the wgmma GEMM kernels (csrc/gemm.cu,
// csrc/gemm_stash.cu, csrc/gemm_lnfold.cu, csrc/mlp_chunked.cu,
// csrc/fused_block.cu, csrc/mlp_bwd.cu, csrc/wgrad.cu): warpgroup MMA on
// 128-byte-swizzled K-major or MN-major (transposed) tiles,
// mbarriers (arrived at from another CTA of the cluster too), 2-D TMA loads
// (multicast to several CTAs of a cluster too), the cluster's shared-memory
// addresses and barriers, and the tensor-map encoder fetched from the
// driver at run time (so the libraries need no link against libcuda).
#pragma once

#include <cuda.h>  // CUtensorMap

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
#undef MTT_F8

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

static int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}
