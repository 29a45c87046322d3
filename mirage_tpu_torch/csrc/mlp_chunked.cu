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
// 256·C output columns of a 128-row tile are C CTAs (C ≤ 4): CTA column c
// owns columns [256·c, 256·(c+1)) and a 64 × 256 float accumulator per
// consumer warpgroup in registers. A thread-block cluster is R × C CTAs
// (R = 1 or 2 row tiles, at most 8 CTAs; ops/fused_mlp.py:mlp_chunked_plan
// picks R). The hidden is walked in sub-chunks of 64·C columns (256 at D =
// 1024; the script's chunks of 512-2048 columns are walked in these, fc2
// accumulating over them in order, so the function is the script's at any
// chunk count). Per sub-chunk:
// - fc1: CTA c computes its 64 hidden columns for its 128 rows, y·W1ᵀ over
//   D, wgmma m64n64k16 on K-slices of 64;
// - GELU(acc + b1) is rounded to bf16 and stored into the hidden rows of
//   the C CTAs of its row tile (st.shared::cluster at mapa addresses), so
//   each CTA holds the whole 128 × 64·C sub-chunk;
// - fc2: each CTA multiplies the sub-chunk (A from registers, loaded with
//   ldmatrix) by its 256 rows of W2, wgmma m64n256k16 over C slices of 64;
//   slice kk + 1's fragments are loaded while slice kk's products run.
//
// The first version read ≈ 4.2 GB from L2 a call at the bench's (16448,
// 1024, 4096): every CTA read its whole y tile, its W1 slice and its W2
// slice for every sub-chunk. Here each operand slice is read from L2 once
// per cluster and multicast (TMA .multicast::cluster) to the CTAs that
// share it: y's slice to the C CTAs of a row tile (each loading 128/C of
// its rows; two CTAs of 64 at C = 3), W1's and W2's slices to the R CTAs
// of a column (each loading 1/R of the rows): ≈ 2.7 GB at R = 1, ≈ 1.6 GB
// at R = 2 (mlp_chunked_plan's l2_bytes). The ring of four 32 KB stages is
// filled in one order on every CTA (per sub-chunk: D/64 fc1 slices of y and
// W1, then C slices of W2); a stage is refilled only when it is free in
// every CTA of the cluster, so each consumer warp releases a stage with one
// arrival on the `empty` barrier of every CTA (8·R·C arrivals a phase), and
// each CTA's `full` barrier expects every byte that reaches it, from
// whichever CTA issued it. Thread 0 issues its CTA's share of a slice when
// its warp hands a stage back, STAGES − 1 slices ahead, waiting until that
// stage is free everywhere. With R = 2 and an odd number of row tiles the
// last cluster's second tile lies past M: its y reads as zero (the TMA unit
// fills it) and its stores are masked, but its CTAs load and meet every
// barrier like the others. Two cluster barriers a sub-chunk, split into
// arrive and wait: B1 after the hidden stores (before any CTA reads its
// sub-chunk), B2 after each CTA's fc2 reads (before the next sub-chunk
// overwrites them); a CTA waits on B2 only after its next fc1, so the
// barrier overlaps the products. A CTA is two warpgroups and no loader
// warpgroup: 256 threads leave 255 registers a thread for the 64 × 256 fc2
// accumulator, the 64 × 64 fc1 accumulator and two slices of A fragments
// (with a third warpgroup, or a ninth warp, ptxas caps them at 168 and
// spills, setmaxnreg or not).
//
// Bound: operations (2·M·D·4D·2 FLOPs against x, the weights and out once).
// On the H100 at the bench's shape the op (with its LN) takes 1.29-1.33 ms
// a call against the first version's 1.49-1.52 (chip_smoke.py phase 9):
// the gain is fc2's double-buffered fragments, not the multicast (the same
// kernel without it was a few percent faster), so L2 was not the bound.
// The release is mbarrier.arrive at its default (.release.cta) semantics:
// at .release.cluster the kernel was slower than the first version, and so
// was a loader that polled the barriers instead of waiting. Clock stamps
// of a CTA put most of a sub-chunk in fc1 (n = 64), then the GELU and its
// cluster stores, then fc2, near the tensor cores' rate; five stages
// changed nothing. What a later PR changes next: fc1 at n = 128 (a 128 ×
// 512 hidden in three stages: faster, but it spilled) and the GELU under
// the next sub-chunk's products.
#include "common.cuh"
#include "wgmma.cuh"

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4, HC = 64, MAX_C = 4, MAX_R = 2;
constexpr int Y_BYTES = BM * BK * 2, W1_BYTES = HC * BK * 2;
constexpr int STAGE_BYTES = BN * BK * 2;  // the largest slice: 256 rows of W2
constexpr int HIDDEN_BYTES = BM * (HC * MAX_C + 8) * 2;

__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
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

// Grid (C, R·ceil(ceil(M / BM) / R)), cluster (C, R, 1): blockIdx.x is the
// CTA's column c (its 256-column tile of out), blockIdx.y the row tile, and
// the CTA's rank in the cluster c + C·r, r = blockIdx.y % R. Warpgroups 0
// and 1 compute rows 0-63 and 64-127; thread 0 also loads. y_rows: the y
// rows each of the first BM / y_rows columns loads and multicasts.
constexpr int MC_THREADS = 256;
template <int C>
__global__ void __launch_bounds__(MC_THREADS, 1)
    mlp_chunked_kernel(const __grid_constant__ CUtensorMap map_y,
                       const __grid_constant__ CUtensorMap map_w1,
                       const __grid_constant__ CUtensorMap map_w2, const void* __restrict__ b1,
                       const void* __restrict__ b2, int bias_dtype, const bf16* __restrict__ res,
                       bf16* __restrict__ out, int M, int H, int R, int y_rows) {
  constexpr int D = BN * C, HS = HC * C + 8;  // hidden row stride: ldmatrix rows on distinct banks
  extern __shared__ unsigned char mc_smem_raw[];
  const uint32_t raw = smem_u32(mc_smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  // the ring, the barriers, then the hidden sub-chunk (BM × HS bf16)
  const uint32_t full = sbase + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  const uint32_t hid = empty + 8 * STAGES;
  const bf16* hid_p = reinterpret_cast<const bf16*>(mc_smem_raw + (hid - raw));
  const int tid = threadIdx.x, cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int c = blockIdx.x, r = blockIdx.y % R, ctas = C * R;
  const int row_rank0 = C * r;  // cluster rank of column 0 of this row tile
  const int m0 = blockIdx.y * BM, n0 = c * BN;
  const int chunks = H / (HC * C), ktiles = D / BK, per = ktiles + C, total = chunks * per;
  // multicast masks: the C CTAs of this row tile; the R CTAs of this column
  const uint16_t row_mask = static_cast<uint16_t>(((1u << C) - 1) << row_rank0);
  uint16_t col_mask = 0;
  for (int rr = 0; rr < R; ++rr) col_mask |= static_cast<uint16_t>(1u << (c + C * rr));
  const int w1_rows = HC / R, w2_rows = BN / R;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8 * ctas);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();  // every CTA's barriers exist before any load or remote store
  cluster_wait();

  // a box into `dst` of this CTA, or of every CTA in `mask` when it holds
  // more than this one
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                  uint16_t mask, int peers) {
    if (peers > 1)
      tma_load_2d_multicast(dst, map, bar, c0, c1, mask);
    else
      tma_load_2d(dst, map, bar, c0, c1);
  };
  // thread 0: this CTA's share of slice idx (sub-chunk idx / per: D/64 fc1
  // slices, then C fc2 slices) into stage idx % STAGES of the CTAs that
  // share it; the stage is free in every CTA of the cluster
  auto issue = [&](int idx) {
    const int s = idx % STAGES, j = idx / per, p = idx - j * per, hc0 = j * HC * C;
    mbar_wait(empty + 8 * s, ((idx / STAGES) & 1) ^ 1);  // first round: free
    const uint32_t st = sbase + s * STAGE_BYTES, bar = full + 8 * s;
    if (p < ktiles) {
      mbar_expect_tx(bar, Y_BYTES + W1_BYTES);
      if (c * y_rows < BM)
        load(st + c * y_rows * 128, &map_y, bar, p * BK, m0 + c * y_rows, row_mask, C);
      load(st + Y_BYTES + r * w1_rows * 128, &map_w1, bar, p * BK, hc0 + HC * c + r * w1_rows,
           col_mask, R);
    } else {
      mbar_expect_tx(bar, STAGE_BYTES);
      load(st + r * w2_rows * 128, &map_w2, bar, hc0 + (p - ktiles) * BK, n0 + r * w2_rows,
           col_mask, R);
    }
  };
  int next = 0;  // the next slice to load (thread 0's count)
  if (tid == 0)
    for (; next < STAGES - 1 && next < total; ++next) issue(next);
  // this warp is done reading stage s: one arrival on it in every CTA; then
  // thread 0 loads the slice STAGES − 1 ahead, once its stage is free
  auto release = [&](int s) {
    if (lane < ctas) mbar_arrive_cluster(empty + 8 * s, lane);
    if (tid == 0 && next < total) issue(next++);
    __syncwarp();
  };

  const int hrow = cw * 64 + warp * 16;  // the warp's first row of the tile
  auto load_frags = [&](uint32_t (&a)[BK / 16][4], int kk) {
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      ldmatrix_x4(a[k], smem_u32(hid_p + (hrow + (lane & 15)) * HS + kk * BK + k * 16 +
                                 (lane >> 4) * 8));
  };
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
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
      if (kt > 0) release((i - 1) % STAGES);
    }
    wgmma_wait<0>();
    fence_regs(acc1);
    release((i - 1) % STAGES);

    // GELU(acc1 + b1) in bf16 into the sub-chunk's rows of the row tile's CTAs
    if (j > 0) cluster_wait();  // B2: every CTA is done reading the last sub-chunk
#pragma unroll
    for (int jj = 0; jj < HC / 8; ++jj) {
      const int col = HC * c + 8 * jj + 2 * tig;  // column within the sub-chunk
      const float bb0 = load_param(b1, hc0 + col, bias_dtype);
      const float bb1 = load_param(b1, hc0 + col + 1, bias_dtype);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t v = pack_bf16(gelu_erf(acc1[4 * jj + 2 * half] + bb0),
                                     gelu_erf(acc1[4 * jj + 2 * half + 1] + bb1));
        const uint32_t local = hid + 2 * ((hrow + gid + 8 * half) * HS + col);
#pragma unroll
        for (int cc = 0; cc < C; ++cc) st_cluster_u32(cluster_addr(local, row_rank0 + cc), v);
      }
    }
    cluster_arrive();  // B1: the sub-chunk is whole in every CTA
    cluster_wait();

    // fc2: acc += hidden (the warpgroup's 64 rows × 64·C) · W2ᵀ slices; the
    // next slice's A fragments load while this slice's products run
    uint32_t a[2][BK / 16][4];
    load_frags(a[0], 0);
#pragma unroll
    for (int kk = 0; kk < C; ++kk, ++i) {
      const int s = i % STAGES;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      const uint64_t db = wgmma_desc(sbase + s * STAGE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) wgmma_n256_ra(acc, a[kk & 1][k], db + 2 * k);
      wgmma_commit();
      if (kk > 0) {
        wgmma_wait<1>();  // slice kk-1's products are done with their stage and fragments
        keep_frags(a[(kk + 1) & 1]);
        release((i - 1) % STAGES);
      }
      if (kk + 1 < C) load_frags(a[(kk + 1) & 1], kk + 1);
    }
    wgmma_wait<0>();
    keep_frags(a[(C - 1) & 1]);
    release((i - 1) % STAGES);
    cluster_arrive();  // B2
  }
  cluster_wait();  // the last B2: no CTA exits while another may still store into it
  fence_regs(acc);

  // out = T(x + T(acc + b2)): rows hrow + gid (+ 8), columns n0 + 8j + 2·tig (+ 1)
#pragma unroll  // fully: acc must stay in registers (constant indices)
  for (int jn = 0; jn < BN / 8; ++jn) {
    const long col = n0 + 8 * jn + 2 * tig;
    const float bb0 = load_param(b2, col, bias_dtype), bb1 = load_param(b2, col + 1, bias_dtype);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long row = m0 + hrow + gid + 8 * half;
      if (row >= M) continue;
      const float2 br = __bfloat1622float2(
          __floats2bfloat162_rn(acc[4 * jn + 2 * half] + bb0, acc[4 * jn + 2 * half + 1] + bb1));
      const float2 xr =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + row * D + col));
      *reinterpret_cast<__nv_bfloat162*>(out + row * D + col) =
          __floats2bfloat162_rn(xr.x + br.x, xr.y + br.y);
    }
  }
}

constexpr int MC_SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES + HIDDEN_BYTES;

template <int C>
static int launch(const void* y, const void* w1, const void* b1, const void* w2, const void* b2,
                  int bias_dtype, const void* x, void* out, int M, int H, int R,
                  cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_chunked_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, MC_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  constexpr int D = BN * C;
  // each of the first BM / y_rows columns multicasts y_rows rows of y
  const int y_rows = BM % C == 0 ? BM / C : BM / 2;
  CUtensorMap map_y, map_w1, map_w2;
  if (!make_map(&map_y, y, M, D, y_rows, BK) || !make_map(&map_w1, w1, H, D, HC / R, BK) ||
      !make_map(&map_w2, w2, D, H, BN / R, BK))
    return (int)cudaErrorInvalidValue;
  const int tiles = (M + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, R * ((tiles + R - 1) / R), 1);
  cfg.blockDim = dim3(MC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = MC_SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = R;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be co-resident is refused here, not run otherwise
  static int clusters[MAX_R + 1] = {};
  if (clusters[R] == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters[R], mlp_chunked_kernel<C>, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters[R] == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, mlp_chunked_kernel<C>, map_y, map_w1, map_w2, b1, b2,
                           bias_dtype, static_cast<const bf16*>(x), static_cast<bf16*>(out), M,
                           H, R, y_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// y (M, D) = LN(x), x and out (M, D), w1 (H, D), w2 (D, H), all bf16; b1 (H,)
// and b2 (D,) float or bf16 (bias_dtype). D = 256·C with C ≤ 4, H a
// multiple of 64·C; R = 1 or 2 row tiles a cluster, R·C ≤ 8.
extern "C" int mtt_mlp_chunked(const void* y, const void* w1, const void* b1, const void* w2,
                               const void* b2, int bias_dtype, const void* x, void* out, int M,
                               int D, int H, int R, void* stream) {
  const int C = D / BN;
  if (M <= 0 || D <= 0 || D % BN || C > MAX_C || R < 1 || R > MAX_R || C * R > 8 || H <= 0 ||
      H % (HC * C) || b1 == nullptr || b2 == nullptr || x == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(y, w1, b1, w2, b2, bias_dtype, x, out, M, H, R, s);
    case 2: return launch<2>(y, w1, b1, w2, b2, bias_dtype, x, out, M, H, R, s);
    case 3: return launch<3>(y, w1, b1, w2, b2, bias_dtype, x, out, M, H, R, s);
    default: return launch<4>(y, w1, b1, w2, b2, bias_dtype, x, out, M, H, R, s);
  }
}
