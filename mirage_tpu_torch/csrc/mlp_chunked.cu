// out = T(x + T(fc2(GELU(fc1(y) + b1)) + b2)) with the (M, 4D) hidden kept on
// chip: the MLP half after its LayerNorm in one launch. Replaces
// scripts/bench_overlap.py:_mlp_kernel_chunked (S6), which splits the hidden
// into 2, 4 or 8 chunks and runs fc1 → GELU → fc2 per chunk, summing the
// float partials, so the TPU can overlap one chunk's GELU with the next
// one's products. The GELU is erff, B2's epilogue (csrc/gemm.cu): the
// script's A&S polynomial is a TPU workaround (mirage_tpu/ops/fused_mlp.py
// :43-47), and the A/B against B2 varies only the fusion.
//
// A 128 × D float accumulator does not fit one CTA at D = 1024, so the D =
// 256·C output columns of a 128-row tile are one thread-block cluster of C
// CTAs (C ≤ 4), as csrc/gemm_lnfold.cu splits them: CTA r owns columns
// [256·r, 256·(r+1)) and a 64 × 256 float accumulator per consumer
// warpgroup in registers. The hidden is walked in sub-chunks of 64·C
// columns (256 at D = 1024; the script's chunks of 512-2048 columns are
// walked in these, fc2 accumulating over them in order, so the function is
// the script's at any chunk count). Per sub-chunk:
// - fc1: CTA r computes its 64 hidden columns for the 128 rows, y·W1ᵀ over
//   D, with TMA loads into a four-stage ring of 128-byte-swizzled tiles and
//   wgmma m64n64k16, as gemm.cu's main loop;
// - GELU(acc + b1) is rounded to bf16 and stored into the hidden rows of
//   every CTA of the cluster (st.shared::cluster at mapa addresses), so each
//   CTA holds the whole 128 × 64·C sub-chunk;
// - fc2: each CTA multiplies the sub-chunk (A from registers, loaded with
//   ldmatrix) by its 256 rows of W2 (TMA slices) into its accumulator,
//   wgmma m64n256k16.
// Two cluster barriers a sub-chunk, split into arrive and wait: B1 after
// the hidden stores (before any CTA reads its sub-chunk), B2 after each
// CTA's fc2 reads (before the next sub-chunk overwrites them); a CTA
// arrives at B2 and waits on it only after its next fc1, so the barrier
// overlaps the products. A CTA is two warpgroups and no loader warpgroup:
// 256 threads leave 255 registers a thread, room for the 64 × 256 fc2
// accumulator and the 64 × 64 fc1 accumulator at once (with gemm.cu's
// separate loader warpgroup the cap is 168 and the pair spills). Thread 0
// keeps the ring STAGES − 1 slices ahead of the products, in the one order
// both consume them (per sub-chunk: D/64 fc1 slices of y and W1, then C
// slices of W2), issuing each load as soon as the slot it reuses is free,
// so W2's slices and the next fc1's are in flight across the barriers.
//
// Bound: operations (2·M·D·4D·2 FLOPs against x, the weights and out once).
// What this first version pays: every row tile rereads W1 and W2 from L2
// (16 MB at D = 1024) and each CTA rereads its y tile for every sub-chunk;
// fc1 runs at n = 64; fc2 waits for each slice's products before loading
// the next A fragments; one tile per cluster, not persistent.
#include "common.cuh"
#include "wgmma.cuh"

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4, HC = 64, MAX_CLUSTER = 4;
constexpr int Y_BYTES = BM * BK * 2, W1_BYTES = HC * BK * 2;
constexpr int STAGE_BYTES = BN * BK * 2;  // the largest slice: 256 rows of W2
constexpr int HIDDEN_BYTES = BM * (HC * MAX_CLUSTER + 8) * 2;

__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

#define MTT_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 × 64, this thread's 32 floats) += A (64 × 16) · B (64 × 16)ᵀ, both
// from shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MTT_F8(0), MTT_F8(8), MTT_F8(16), MTT_F8(24)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 × 256, this thread's 128 floats) += A (64 × 16, from registers: this
// warp's 16 rows as mma.sync m16n8k16 A fragments) · B (256 × 16)ᵀ
__device__ __forceinline__ void wgmma_n256_ra(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : MTT_F8(0), MTT_F8(8), MTT_F8(16), MTT_F8(24), MTT_F8(32), MTT_F8(40), MTT_F8(48),
        MTT_F8(56), MTT_F8(64), MTT_F8(72), MTT_F8(80), MTT_F8(88), MTT_F8(96), MTT_F8(104),
        MTT_F8(112), MTT_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef MTT_F8

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// Grid (C, ceil(M / BM)), cluster (C, 1, 1): blockIdx.x is the CTA's rank in
// the cluster and its 256-column tile of out, blockIdx.y the row tile.
// Warpgroups 0 and 1 compute rows 0-63 and 64-127; thread 0 also loads.
constexpr int MC_THREADS = 256;
__global__ void __launch_bounds__(MC_THREADS, 1)
    mlp_chunked_kernel(const __grid_constant__ CUtensorMap map_y,
                       const __grid_constant__ CUtensorMap map_w1,
                       const __grid_constant__ CUtensorMap map_w2, const void* __restrict__ b1,
                       const void* __restrict__ b2, int bias_dtype, const bf16* __restrict__ res,
                       bf16* __restrict__ out, int M, int D, int H) {
  extern __shared__ unsigned char mc_smem_raw[];
  const uint32_t raw = smem_u32(mc_smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  // the ring, the barriers, then the hidden sub-chunk (BM × (64·C + 8) bf16)
  const uint32_t full = sbase + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  const uint32_t hid = empty + 8 * STAGES;
  const bf16* hid_p = reinterpret_cast<const bf16*>(mc_smem_raw + (hid - raw));
  const int tid = threadIdx.x, cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int C = gridDim.x, rank = blockIdx.x;
  const int m0 = blockIdx.y * BM, n0 = rank * BN;
  const int HS = HC * C + 8;  // hidden row stride (elements): ldmatrix rows on distinct banks
  const int chunks = H / (HC * C), ktiles = D / BK, per = ktiles + C, total = chunks * per;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // every CTA of the cluster runs before any remote store
  cluster_wait();

  // thread 0: the load of slice idx (sub-chunk idx / per: D/64 fc1 slices,
  // then C fc2 slices) into stage idx % STAGES, once that stage is free
  auto issue = [&](int idx) {
    const int s = idx % STAGES, j = idx / per, r = idx - j * per, hc0 = j * HC * C;
    mbar_wait(empty + 8 * s, ((idx / STAGES) & 1) ^ 1);  // first round: free
    const uint32_t st = sbase + s * STAGE_BYTES;
    if (r < ktiles) {
      mbar_expect_tx(full + 8 * s, Y_BYTES + W1_BYTES);
      tma_load_2d(st, &map_y, full + 8 * s, r * BK, m0);
      tma_load_2d(st + Y_BYTES, &map_w1, full + 8 * s, r * BK, hc0 + HC * rank);
    } else {
      mbar_expect_tx(full + 8 * s, STAGE_BYTES);
      tma_load_2d(st, &map_w2, full + 8 * s, hc0 + (r - ktiles) * BK, n0);
    }
  };
  int next = 0;  // the next slice to load (thread 0's count)
  if (tid == 0)
    for (; next < STAGES - 1 && next < total; ++next) issue(next);
  // once the products on a slice are handed back: the load STAGES − 1 ahead
  auto refill = [&]() {
    if (tid == 0 && next < total) issue(next++);
  };

  const int hrow = cw * 64 + warp * 16;  // the warp's first row of the tile
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  fence_regs(acc);
  int i = 0;
  for (int j = 0; j < chunks; ++j) {
    const int hc0 = j * HC * C;
    // fc1: this CTA's 64 hidden columns of the sub-chunk for the warpgroup's 64 rows
    float acc1[HC / 2];
#pragma unroll
    for (int e = 0; e < HC / 2; ++e) acc1[e] = 0.f;
    fence_regs(acc1);
    for (int kt = 0; kt < ktiles; ++kt, ++i) {
      const int s = i % STAGES;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      const uint32_t st = sbase + s * STAGE_BYTES;
      const uint64_t da = wgmma_desc(st + cw * 64 * 128), db = wgmma_desc(st + Y_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) wgmma_n64(acc1, da + 2 * k, db + 2 * k);  // +32 B
      wgmma_commit();
      wgmma_wait<1>();  // the products on slice i-1 are done: hand its stage back
      if (kt > 0) {
        if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
        refill();
      }
    }
    wgmma_wait<0>();
    fence_regs(acc1);
    if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
    refill();

    // GELU(acc1 + b1) in bf16 into the sub-chunk's rows of every CTA
    if (j > 0) cluster_wait();  // B2: every CTA is done reading the last sub-chunk
#pragma unroll
    for (int jj = 0; jj < HC / 8; ++jj) {
      const int col = HC * rank + 8 * jj + 2 * tig;  // column within the sub-chunk
      const float bb0 = load_param(b1, hc0 + col, bias_dtype);
      const float bb1 = load_param(b1, hc0 + col + 1, bias_dtype);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t v = pack_bf16(gelu_erf(acc1[4 * jj + 2 * half] + bb0),
                                     gelu_erf(acc1[4 * jj + 2 * half + 1] + bb1));
        const uint32_t local = hid + 2 * ((hrow + gid + 8 * half) * HS + col);
        for (int c = 0; c < C; ++c) st_cluster_u32(cluster_addr(local, c), v);
      }
    }
    cluster_arrive();  // B1: the sub-chunk is whole in every CTA
    cluster_wait();

    // fc2: acc += hidden (the warpgroup's 64 rows × 64·C) · W2ᵀ slices
    for (int kk = 0; kk < C; ++kk, ++i) {
      const int s = i % STAGES;
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        ldmatrix_x4(a[k], smem_u32(hid_p + (hrow + (lane & 15)) * HS + kk * BK + k * 16 +
                                   (lane >> 4) * 8));
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      const uint64_t db = wgmma_desc(sbase + s * STAGE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) wgmma_n256_ra(acc, a[k], db + 2 * k);
      wgmma_commit();
      wgmma_wait<0>();
      // the A registers stay live until the products that read them are done
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        asm volatile("" : "+r"(a[k][0]), "+r"(a[k][1]), "+r"(a[k][2]), "+r"(a[k][3])::"memory");
      if (lane == 0) mbar_arrive(empty + 8 * s);
      refill();
    }
    cluster_arrive();  // B2
  }
  cluster_wait();  // the last B2: no CTA exits while another may still store into it
  fence_regs(acc);

  // out = T(x + T(acc + b2)): rows hrow + gid (+ 8), columns n0 + 8j + 2·tig (+ 1)
#pragma unroll  // fully: acc must stay in registers (constant indices)
  for (int j = 0; j < BN / 8; ++j) {
    const long col = n0 + 8 * j + 2 * tig;
    const float bb0 = load_param(b2, col, bias_dtype), bb1 = load_param(b2, col + 1, bias_dtype);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long row = m0 + hrow + gid + 8 * half;
      if (row >= M) continue;
      const float2 br = __bfloat1622float2(
          __floats2bfloat162_rn(acc[4 * j + 2 * half] + bb0, acc[4 * j + 2 * half + 1] + bb1));
      const float2 xr =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + row * D + col));
      *reinterpret_cast<__nv_bfloat162*>(out + row * D + col) =
          __floats2bfloat162_rn(xr.x + br.x, xr.y + br.y);
    }
  }
}

// y (M, D) = LN(x), x and out (M, D), w1 (H, D), w2 (D, H), all bf16; b1 (H,)
// and b2 (D,) float or bf16 (bias_dtype). D = 256·C with C ≤ 4, H a
// multiple of 64·C.
extern "C" int mtt_mlp_chunked(const void* y, const void* w1, const void* b1, const void* w2,
                               const void* b2, int bias_dtype, const void* x, void* out, int M,
                               int D, int H, void* stream) {
  if (M <= 0 || D <= 0 || D % BN || D / BN > MAX_CLUSTER || H <= 0 || H % (HC * (D / BN)) ||
      b1 == nullptr || b2 == nullptr || x == nullptr)
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = 1024 + STAGES * STAGE_BYTES + 16 * STAGES + HIDDEN_BYTES;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap map_y, map_w1, map_w2;
  if (!make_map(&map_y, y, M, D, BM, BK) || !make_map(&map_w1, w1, H, D, HC, BK) ||
      !make_map(&map_w2, w2, D, H, BN, BK))
    return (int)cudaErrorInvalidValue;
  const int C = D / BN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (M + BM - 1) / BM, 1);
  cfg.blockDim = dim3(MC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, mlp_chunked_kernel, map_y, map_w1, map_w2, b1, b2, bias_dtype,
      static_cast<const bf16*>(x), static_cast<bf16*>(out), M, D, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
