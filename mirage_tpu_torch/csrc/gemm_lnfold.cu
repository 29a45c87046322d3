// out = T(x + T(a·Wᵀ + b)) and y = T(LN(out)·γ + β) in one pass: fc2 of the
// MLP half with its bias and residual, and the NEXT block's LayerNorm folded
// into the epilogue. Replaces the tail of scripts/bench_lnfold.py:
// _mlp_lnfold_kernel, which computes LN_next(out) while out is still in VMEM
// and writes it as a second output, so the attention half that follows
// starts at its qkv product (ops/block_attention.py:
// attn_half_block_prenormed). The LayerNorm takes out after its rounding to
// bf16, in float, with two passes (the mean, then the mean of squared
// deviations), as csrc/layernorm.cu does.
//
// The LayerNorm needs whole rows, and one CTA's wgmma tile is 128 × 256. So
// the N = C·256 columns of a 128-row tile are one thread-block cluster of C
// CTAs (C ≤ 8): CTA r computes columns [256·r, 256·(r+1)) with gemm.cu's
// main loop (one TMA thread filling a four-stage ring of 64-wide K-slices,
// two warpgroups on wgmma m64n256k16), then its epilogue writes out
// (staged through shared memory so the residual, out and y move in 16-byte
// rows, as gemm.cu's) and keeps out's float value in the accumulators. Each
// row's partial sum over the CTA's 256 columns is pushed into every CTA of
// the cluster through distributed shared memory (st.shared::cluster at mapa
// addresses), the cluster meets at barrier.cluster, and each CTA sums the C
// partials in rank order (so every CTA gets the same mean); the squared
// deviations go the same way; then each CTA normalises its columns into y
// (staged like out). Three
// cluster barriers: one at the start (every CTA of the cluster is running
// before any remote store) and one after each pass; after the last one a
// CTA reads only its own shared memory, so it may exit.
//
// Bound: operations (2·M·N·K), the LN adding one read of the residual and
// one write of y. One tile per CTA, not persistent: the epilogue does not
// overlap the next tile's loads (a later PR's work, with gemm.cu's).
#include "common.cuh"
#include "wgmma.cuh"

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4, MAX_CLUSTER = 8;
constexpr int RING_BYTES = STAGES * (BM + BN) * BK * 2;
// each computing warp's staging tile: 16 rows × 64 bf16, rows padded so the
// fragment writes fall on distinct banks and stay 16-byte aligned
constexpr int EPI_COLS = 64, EPI_STRIDE = EPI_COLS + 8, EPI_WARP_BYTES = 16 * EPI_STRIDE * 2;

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// Sums a per-row value over the 4 lanes of a quad (the 8 columns of each
// 8-wide fragment group are spread over them) and pushes the sum of row
// `row` (local to the tile) into slot [rank][row] of `part` in every CTA.
__device__ __forceinline__ void push_row_sums(float (&s)[2], uint32_t part, int rank, int C,
                                              int row) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
    s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
  }
  if (tig != 0) return;
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      st_cluster(cluster_addr(part + 4 * (rank * BM + row + 8 * half), c), s[half]);
}

// The sum over the cluster's C partials of local row `row`, in rank order.
__device__ __forceinline__ float cluster_row_sum(const float* part, int C, int row) {
  float s = 0.f;
  for (int c = 0; c < C; ++c) s += part[c * BM + row];
  return s;
}

// Grid (C, ceil(M / BM)), cluster (C, 1, 1): blockIdx.x is the CTA's rank
// in the cluster and its 256-column tile, blockIdx.y the row tile.
// Warpgroup 0 loads (one thread), 1 and 2 compute rows 0-63 and 64-127.
__global__ void __launch_bounds__(384, 1)
    gemm_lnfold_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w, const void* __restrict__ bias,
                       int bias_dtype, const bf16* __restrict__ res, const void* __restrict__ ln_w,
                       const void* __restrict__ ln_b, int ln_dtype, bf16* __restrict__ out,
                       bf16* __restrict__ y, int M, int N, int K, float eps) {
  constexpr int A_BYTES = BM * BK * 2, STAGE_BYTES = (BM + BN) * BK * 2;
  extern __shared__ unsigned char lnfold_smem_raw[];
  const uint32_t raw = smem_u32(lnfold_smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  // the ring, the barriers, the row partials of the two passes, then the
  // computing warps' staging tiles
  const uint32_t full = sbase + RING_BYTES, empty = full + 8 * STAGES;
  const uint32_t part0 = empty + 8 * STAGES, part1 = part0 + 4 * MAX_CLUSTER * BM;
  const uint32_t stage = part1 + 4 * MAX_CLUSTER * BM;
  const float* part0_f = reinterpret_cast<const float*>(lnfold_smem_raw + (part0 - raw));
  const float* part1_f = reinterpret_cast<const float*>(lnfold_smem_raw + (part1 - raw));
  const int tid = threadIdx.x, wg = tid >> 7;
  const int C = gridDim.x, rank = blockIdx.x;
  const int m0 = blockIdx.y * BM, n0 = rank * BN;
  const int ktiles = (K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_barrier();  // every CTA of the cluster runs before any remote store

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);  // first round: free
        const uint32_t st = sbase + s * STAGE_BYTES;
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load_2d(st, &map_a, full + 8 * s, kt * BK, m0);
        tma_load_2d(st + A_BYTES, &map_w, full + 8 * s, kt * BK, n0);
      }
    }
    __syncwarp();
    cluster_barrier();  // the two passes of the consumers
    cluster_barrier();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  fence_regs(acc);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t st = sbase + s * STAGE_BYTES;
    const uint64_t da = wgmma_desc(st + cw * 64 * 128), db = wgmma_desc(st + A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) wgmma_n256(acc, da + 2 * k, db + 2 * k);  // +32 B
    wgmma_commit();
    wgmma_wait<1>();  // the products on slice kt-1 are done: hand its stage back
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // this thread's rows: r and r + 8 of the tile; columns n0 + 8j + 2·tig, +1.
  // The warp's 16 rows move through its staging tile 64 columns at a time,
  // so the residual, out and y cross device memory in 16-byte rows.
  const int r = cw * 64 + warp * 16 + gid;
  const long wrow = m0 + cw * 64 + warp * 16;  // the warp's first row
  bf16* st = reinterpret_cast<bf16*>(lnfold_smem_raw + (stage - raw)) +
             (cw * 4 + warp) * 16 * EPI_STRIDE;
  // pass 1: out = T(x + T(acc + b)), stored; acc <- float(out); row sums
  float s[2] = {0.f, 0.f};
#pragma unroll  // fully: acc must stay in registers (constant indices)
  for (int cc = 0; cc < BN / EPI_COLS; ++cc) {
    const long c0 = n0 + cc * EPI_COLS;
#pragma unroll
    for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
      const int j = cc * (EPI_COLS / 8) + jj, c = jj * 8 + 2 * tig;
      const float b0 = load_param(bias, c0 + c, bias_dtype);
      const float b1 = load_param(bias, c0 + c + 1, bias_dtype);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<__nv_bfloat162*>(st + (gid + 8 * half) * EPI_STRIDE + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half] + b0, acc[4 * j + 2 * half + 1] + b1);
    }
    __syncwarp();
    // 16 rows × 8 chunks of 16 bytes: four per lane
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = lane + 32 * i, rr = e >> 3, c = (e & 7) * 8;
      if (wrow + rr >= M) continue;
      const long g = (wrow + rr) * N + c0 + c;
      uint4 v = *reinterpret_cast<const uint4*>(st + rr * EPI_STRIDE + c);
      const uint4 xv = *reinterpret_cast<const uint4*>(res + g);
      __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(&v);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 a = __bfloat1622float2(x2[k]), b = __bfloat1622float2(v2[k]);
        v2[k] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
      }
      *reinterpret_cast<uint4*>(out + g) = v;
      *reinterpret_cast<uint4*>(st + rr * EPI_STRIDE + c) = v;
    }
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
      const int j = cc * (EPI_COLS / 8) + jj, c = jj * 8 + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 o = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(st + (gid + 8 * half) * EPI_STRIDE + c));
        acc[4 * j + 2 * half] = o.x;
        acc[4 * j + 2 * half + 1] = o.y;
        s[half] += o.x + o.y;
      }
    }
    __syncwarp();  // the lanes have read the staging tile before it is refilled
  }
  push_row_sums(s, part0, rank, C, r);
  cluster_barrier();
  // pass 2: the mean, then the squared deviations
  float mean[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mean[half] = cluster_row_sum(part0_f, C, r + 8 * half) / N;
    s[half] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dv = acc[4 * j + 2 * half + e] - mean[half];
        s[half] += dv * dv;
      }
  push_row_sums(s, part1, rank, C, r);
  cluster_barrier();
  // y = (out − mean)·rstd·γ + β, this CTA's columns, staged as out was
  float rstd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    rstd[half] = rsqrtf(cluster_row_sum(part1_f, C, r + 8 * half) / N + eps);
#pragma unroll
  for (int cc = 0; cc < BN / EPI_COLS; ++cc) {
    const long c0 = n0 + cc * EPI_COLS;
#pragma unroll
    for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
      const int j = cc * (EPI_COLS / 8) + jj, c = jj * 8 + 2 * tig;
      const float g0 = load_param(ln_w, c0 + c, ln_dtype);
      const float g1 = load_param(ln_w, c0 + c + 1, ln_dtype);
      const float be0 = load_param(ln_b, c0 + c, ln_dtype);
      const float be1 = load_param(ln_b, c0 + c + 1, ln_dtype);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<__nv_bfloat162*>(st + (gid + 8 * half) * EPI_STRIDE + c) =
            __floats2bfloat162_rn(
                (acc[4 * j + 2 * half] - mean[half]) * rstd[half] * g0 + be0,
                (acc[4 * j + 2 * half + 1] - mean[half]) * rstd[half] * g1 + be1);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = lane + 32 * i, rr = e >> 3, c = (e & 7) * 8;
      if (wrow + rr < M)
        *reinterpret_cast<uint4*>(y + (wrow + rr) * N + c0 + c) =
            *reinterpret_cast<const uint4*>(st + rr * EPI_STRIDE + c);
    }
    __syncwarp();
  }
}

// a (M, K), w (N, K), residual, out and y (M, N) bf16; bias, ln_w and ln_b
// (N,) float or bf16 (bias_dtype, ln_dtype). N = C·256 with C ≤ 8, K a
// multiple of 8.
extern "C" int mtt_gemm_lnfold(const void* a, const void* w, const void* bias, int bias_dtype,
                               const void* residual, const void* ln_w, const void* ln_b,
                               int ln_dtype, void* out, void* y, int M, int N, int K, float eps,
                               void* stream) {
  if (M <= 0 || K <= 0 || K % 8 || N <= 0 || N % BN || N / BN > MAX_CLUSTER || bias == nullptr ||
      residual == nullptr || ln_w == nullptr || ln_b == nullptr)
    return (int)cudaErrorInvalidValue;
  constexpr int bytes =
      1024 + RING_BYTES + 16 * STAGES + 2 * 4 * MAX_CLUSTER * BM + 8 * EPI_WARP_BYTES;
  static SmemLimit limit;
  if (int err = set_smem(gemm_lnfold_kernel, bytes, limit)) return err;
  CUtensorMap map_a, map_w;
  if (!make_map(&map_a, a, M, K, BM, BK) || !make_map(&map_w, w, N, K, BN, BK))
    return (int)cudaErrorInvalidValue;
  const int C = N / BN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (M + BM - 1) / BM, 1);
  cfg.blockDim = dim3(384, 1, 1);
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
      &cfg, gemm_lnfold_kernel, map_a, map_w, bias, bias_dtype,
      static_cast<const bf16*>(residual), ln_w, ln_b, ln_dtype, static_cast<bf16*>(out),
      static_cast<bf16*>(y), M, N, K, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
