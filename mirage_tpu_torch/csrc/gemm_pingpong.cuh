// The one ping-pong GEMM of the port's linear layers: C = A · Wᵀ with a
// fused epilogue, A (M, K) and W (N, K) row-major (K-major both), or W
// (K, N) read as it lies (MN-major, bf16 only). Two instantiations: the
// bf16 product (float accumulation) of csrc/gemm.cu, which replaces the
// matrix products inside mirage_tpu/ops/block_attention.py:
// _attn_half_kernel / _xattn_half_kernel and fused_mlp.py:_mlp_kernel, and
// the s8·s8 -> s32 product of csrc/quant.cu (mirage_tpu/ops/quant.py:
// _mlp_q_kernel, scripts/bench_int8.py:probe_pallas_int8).
//
// Bound: operations at the path's shapes (K ≥ 256). The design keeps the
// tensor cores busy through the epilogue:
// - persistent grid, one CTA of three warpgroups per SM in clusters of
//   CLUSTER along M; cluster c takes cluster tiles c, c + clusters, ... in a
//   grouped raster (eight tile rows at a time, column by column inside a
//   group, so concurrent tiles share A's rows and W's in L2), and each
//   CTA's g-th tile goes to consumer warpgroup g % 2;
// - one thread of warpgroup 0 keeps a ring of five K-slices full by TMA
//   (one 128-byte swizzle row per matrix row: 64 bf16 or 128 int8), in tile
//   order across both consumers (setmaxnreg 40 / 232);
// - each consumer owns its whole 128 × 128 tile (two m64n128 wgmma a
//   k-step; 64 × 256 tiles, one m64n256, were no faster on the H100), and
//   an ordered pair of named barriers (1 and 2) hands the tensor cores to
//   one consumer's main loop at a time, so the other's epilogue (bias,
//   GELU, the residual, the s8 dequantisation, the staging into 16-byte
//   rows) runs under its products. The turn also orders the consumers'
//   waits on the ring: a consumer waits for its tile's slices only after
//   the other has waited for all of its previous tile's, so a stage's
//   parity never names an older phase (csrc/gemm_stash.cu's scheme).
// - The main loop is bound by the slices' trip from L2 into shared memory
//   (a 128 × 128 tile takes 256 rows a slice where the old 128 × 256 tile
//   of two warpgroups took 384: at K = 3072-4096 its products alone are
//   slower than the old kernel's), so CLUSTER CTAs along M run their tiles
//   in lockstep and share W's slices: each loads 1/CLUSTER of them and
//   multicasts it to all (mlp_bwd.cu's scheme: a stage is free once every
//   consumer warp of the cluster has arrived on it, so `empty` counts
//   4 · CLUSTER). Without the cluster the epilogue's stores are no longer
//   hidden; a sixth stage gained nothing (both measured on the H100).
// - The epilogue is a compile-time kind of the instantiation: runtime
//   branches between epilogues inside the unrolled store made every kind
//   slower than its own code (measured on the H100).
// - The tensor maps are encoded once per (pointer, shape, box) and kept.
//
// The products of one output element run over the K-slices in order from a
// zero accumulator, as csrc/gemm_stash.cu's, csrc/gemm_lnfold.cu's and
// csrc/mlp_bwd.cu's do, so their outputs stay bit-equal to this kernel's.
// Ragged M, N and K are zero-filled by TMA and masked at the store; rows of
// A and W must be 16-byte multiples.
//
// ``--gemm-split`` (chip_smoke.py) builds this header four ways besides
// the default: MTT_GEMM_SPLIT_NO_EPI (each epilogue's math left out: the
// bias or scales applied and stored), MTT_GEMM_SPLIT_NO_STORE (loads and
// products), MTT_GEMM_SPLIT_LOADS (the loads alone) and
// MTT_GEMM_CLUSTER=1 (no multicast).
#pragma once

#include <mutex>

#include "common.cuh"
#include "wgmma.cuh"

#ifdef MTT_GEMM_SPLIT_LOADS  // the loads alone: no products, no store
#define MTT_GEMM_SPLIT_NO_STORE
#endif

#ifndef MTT_GEMM_CLUSTER
#define MTT_GEMM_CLUSTER 2
#endif

namespace gpp {

// a consumer's tile BM × BN, MH row blocks of 64; one K-slice of 128 bytes
// a row: A's BM rows, then W's BN rows (K-major), or W as BN/64 boxes of
// 64 k × 64 n (MN-major), each 8 KB; CLUSTER CTAs along M share W's rows,
// each loading W_ROWS of them (K-major) or W_BOXES boxes (MN-major)
constexpr int BM = 128, BN = 128, MH = BM / 64, STAGES = 5, CLUSTER = MTT_GEMM_CLUSTER;
constexpr int A_BYTES = BM * 128, STAGE_BYTES = (BM + BN) * 128, MN_BOX = 64 * 128;
constexpr int W_ROWS = BN / CLUSTER, W_BOXES = BN / 64 / CLUSTER;
static_assert(CLUSTER == 1 || CLUSTER == 2, "MTT_GEMM_CLUSTER: 1 or 2");
// per-warp epilogue scratch: VECS column vectors of BN floats (bias; the s8
// weight scales and bias), then a staging tile of 16 rows × EPI_COLS 4-byte
// elements, rows EPI_STRIDE elements apart (conflict-free fragment writes,
// 16-byte aligned rows)
constexpr int EPI_COLS = 64, EPI_STRIDE = 72, STAGE_TILE_BYTES = 16 * EPI_STRIDE * 4;
template <int VECS>
__host__ __device__ constexpr int epi_warp_bytes() { return VECS * BN * 4 + STAGE_TILE_BYTES; }
template <int VECS>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + STAGES * STAGE_BYTES + 16 * STAGES + 8 * epi_warp_bytes<VECS>();
}
constexpr int ORDER_BAR = 1;  // named barriers 1 and 2: consumer 0's and 1's turn

// Operand types: a wgmma k-step reads 32 bytes of a row (16 bf16, 32 int8),
// four steps a K-slice.
struct Bf16 {
  using Acc = float;
  static constexpr int BK = 64;
  template <int TB>
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t da, uint64_t db) {
    wgmma_n128_at<0, TB>(d, da, db);
    wgmma_n128_at<64, TB>(d, da + (64 * 128 >> 4), db);  // A's rows 64-127
  }
};
struct S8 {
  using Acc = int;
  static constexpr int BK = 128;
  template <int TB>
  __device__ __forceinline__ static void mma(int (&d)[128], uint64_t da, uint64_t db) {
    static_assert(TB == 0, "wgmma has no transpose for 8-bit operands");
    wgmma_s8_n128_at<0>(d, da, db);
    wgmma_s8_n128_at<64>(d, da + (64 * 128 >> 4), db);
  }
};

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) { fence_regs(d); }
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void bar_sync_256(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive_256(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Tile t of the grouped raster (of cluster tiles): ``group`` rows at a
// time, down the rows of the group column by column (ops/fused_mlp.py:
// tile_order mirrors it)
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n, int group, int& tm,
                                            int& tn) {
  const int per_group = group * tiles_n, first = t / per_group * group;
  const int rows = min(tiles_m - first, group), r = t % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

// ------------------------------------------------------------ epilogue aids

// A fragment element of a consumer's tile: row block h (of MH), column
// block j (of BN/8), row gid + 8·r8 of the warp's 16, column 2·tig + e.
__device__ __forceinline__ constexpr int frag(int h, int j, int r8, int e) {
  return h * (BN / 2) + 4 * j + 2 * r8 + e;
}

// A column pair (c, c + 1) of staging row r, rounded to / kept as OutT.
__device__ __forceinline__ void stage_pair(bf16* s, int r, int c, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(s + r * EPI_STRIDE + c) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void stage_pair(float* s, int r, int c, float v0, float v1) {
  *reinterpret_cast<float2*>(s + r * EPI_STRIDE + c) = make_float2(v0, v1);
}
__device__ __forceinline__ void stage_pair(int* s, int r, int c, int v0, int v1) {
  *reinterpret_cast<int2*>(s + r * EPI_STRIDE + c) = make_int2(v0, v1);
}

// out = T(res + out) over a 16-byte chunk of bf16 or float (the residual
// added in float to the rounded branch); int has none.
__device__ __forceinline__ void add_residual(uint4& o, const uint4& r, const bf16*) {
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
  const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 x = __bfloat1622float2(r2[k]), y = __bfloat1622float2(o2[k]);
    o2[k] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
  }
}
__device__ __forceinline__ void add_residual(uint4& o, const uint4& r, const float*) {
  float* of = reinterpret_cast<float*>(&o);
  const float* rf = reinterpret_cast<const float*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) of[k] = rf[k] + of[k];
}
__device__ __forceinline__ void add_residual(uint4&, const uint4&, const int*) {}

// The staging tile (16 rows × 64 columns of OutT) to C at (row0, c0) as
// 16-byte rows (coalesced: a row's 128 or 256 bytes from consecutive
// lanes), rows < M and columns < N (N % 8 == 0: a chunk is wholly in or
// out), each chunk first added to the residual's (when res is not null).
template <class T>
struct ident {
  using type = T;
};
template <typename OutT>
__device__ __forceinline__ void store_staged(const OutT* stage, OutT* __restrict__ C,
                                             const typename ident<OutT>::type* __restrict__ res,
                                             int M, int N, long row0, long c0) {
  constexpr int PER_ROW = EPI_COLS * (int)sizeof(OutT) / 16, ELEMS = 16 / (int)sizeof(OutT);
  constexpr int PASSES = 16 * PER_ROW / 32 / 4;  // four chunks a lane a pass
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    uint4 out[4], rv[4];
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = lane + 32 * (4 * p + i), r = e / PER_ROW, c = e % PER_ROW * ELEMS;
      ok[i] = row0 + r < M && c0 + c < N;
      out[i] = *reinterpret_cast<const uint4*>(stage + r * EPI_STRIDE + c);
      if (res != nullptr && ok[i])
        rv[i] = *reinterpret_cast<const uint4*>(res + (row0 + r) * N + c0 + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!ok[i]) continue;
      const int e = lane + 32 * (4 * p + i), r = e / PER_ROW, c = e % PER_ROW * ELEMS;
      if (res != nullptr) add_residual(out[i], rv[i], res);
      *reinterpret_cast<uint4*>(C + (row0 + r) * N + c0 + c) = out[i];
    }
  }
}

// The warp's scratch: VECS column vectors of the tile (BN floats each),
// then the staging tile.
struct Scratch {
  float* vec;
  unsigned char* stage;
};

// ------------------------------------------------------------ tensor maps

// Tensor map of a row-major (rows, cols) matrix of `type` read in boxes of
// box_rows × box_cols (box_cols elements = 128 bytes, one swizzle row),
// 128-byte swizzled, zero past the edges; encoded once per (pointer, shape,
// box, type) and kept (serving and training reuse their buffers and
// weights, so most launches find their maps here).
struct MapKey2d {
  const void* ptr;
  long long rows, cols;
  int box_rows, box_cols, type;
  bool operator==(const MapKey2d& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && box_rows == o.box_rows &&
           box_cols == o.box_cols && type == o.type;
  }
};

static bool cached_map_2d(CUtensorMap* out, const MapKey2d& key) {
  constexpr int N = 128;
  static MapKey2d keys[N];
  static CUtensorMap maps[N];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *out = maps[i];
      return true;
    }
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const CUtensorMapDataType type = static_cast<CUtensorMapDataType>(key.type);
  const int elem = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)key.cols, (cuuint64_t)key.rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)key.cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)key.box_cols, (cuuint32_t)key.box_rows};
  const cuuint32_t elem_stride[2] = {1, 1};
  if (fn(out, type, 2, const_cast<void*>(key.ptr), dims, pitch, box, elem_stride,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[next] = key;
  maps[next] = *out;
  next = (next + 1) % N;
  used = used < N ? used + 1 : N;
  return true;
}

// ------------------------------------------------------------ the kernel body

// W's share of this CTA into the stage of every CTA of the cluster.
__device__ __forceinline__ void load_w(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  if constexpr (CLUSTER > 1)
    tma_load_2d_multicast(dst, map, bar, c0, c1, (1 << CLUSTER) - 1);
  else
    tma_load_2d(dst, map, bar, c0, c1);
}

// This warp is done with the stage behind `bar`: one arrival on it in every
// CTA of the cluster (lane r arrives in CTA r).
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  if constexpr (CLUSTER > 1) {
    if (lane < CLUSTER) mbar_arrive_cluster(bar, lane);
  } else if (lane == 0) {
    mbar_arrive(bar);
  }
}

// The body of a kernel of 384 threads (__launch_bounds__(384, 1)) with
// smem_bytes<Epi::VECS>() of dynamic shared memory. Epi provides VECS,
// vec(p, v, col) (column vector v at col; 0 past N) and store(p, acc,
// scratch, M, N, row0, n0) (one warp's 16 rows of each row block, row0 its
// first in block 0). W_MN: W is (K, N), read MN-major.
template <class Op, bool W_MN, class Epi>
__device__ __forceinline__ void gemm_pingpong(const CUtensorMap* map_a, const CUtensorMap* map_w,
                                              const typename Epi::Params& p, int M, int N, int K,
                                              int group) {
  using Acc = typename Op::Acc;
  constexpr int VECS = Epi::VECS;
  extern __shared__ unsigned char gpp_smem_raw[];
  const uint32_t sbase = (smem_u32(gpp_smem_raw) + 1023) & ~1023u;  // the swizzle's period
  // the ring, the barriers, then each consumer warp's epilogue scratch
  const uint32_t full = sbase + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  // cluster c (CLUSTER consecutive CTAs) takes cluster tiles c, c + clusters,
  // ...: CLUSTER tiles down M, CTA `rank` the rank-th (past M for the last
  // rank of an odd tail: zero-filled, nothing stored)
  const int rank = blockIdx.x % CLUSTER, cluster = blockIdx.x / CLUSTER;
  const int clusters = gridDim.x / CLUSTER;
  const int tiles_mc = ((M + BM - 1) / BM + CLUSTER - 1) / CLUSTER, tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_mc * tiles_n, ktiles = (K + Op::BK - 1) / Op::BK;
  const int mine = tiles > cluster ? (tiles - cluster + clusters - 1) / clusters : 0;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CLUSTER > 1) {
    cluster_arrive();  // every CTA's barriers exist before any multicast or remote arrival
    cluster_wait();
  } else {
    __syncthreads();
  }

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int i = 0;
      for (int g = 0; g < mine; ++g) {
        int tm, tn;
        tile_coords(cluster + g * clusters, tiles_mc, tiles_n, group, tm, tn);
        tm = tm * CLUSTER + rank;
        for (int kt = 0; kt < ktiles; ++kt, ++i) {
          const int s = i % STAGES;
          mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);  // free in every CTA; first round
          const uint32_t st = sbase + s * STAGE_BYTES, bar = full + 8 * s;
          mbar_expect_tx(bar, STAGE_BYTES);  // A's rows and all of W's, this CTA's share or not
          tma_load_2d(st, map_a, bar, kt * Op::BK, tm * BM);
          if constexpr (W_MN) {
#pragma unroll
            for (int b = rank * W_BOXES; b < (rank + 1) * W_BOXES; ++b)
              load_w(st + A_BYTES + b * MN_BOX, map_w, bar, tn * BN + 64 * b, kt * 64);
          } else {
            load_w(st + A_BYTES + rank * W_ROWS * 128, map_w, bar, kt * Op::BK,
                   tn * BN + rank * W_ROWS);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // the warpgroup index as a warp-uniform value, so no wgmma sits under a
    // branch the compiler cannot prove uniform
    const int cw = __shfl_sync(0xffffffffu, wg - 1, 0), warp = (tid >> 5) & 3, lane = tid & 31;
    constexpr int WARP_BYTES = epi_warp_bytes<VECS>();
    unsigned char* raw = gpp_smem_raw + (empty + 8 * STAGES - smem_u32(gpp_smem_raw)) +
                         (cw * 4 + warp) * WARP_BYTES;  // 16-byte aligned
    const Scratch scratch{reinterpret_cast<float*>(raw), raw + VECS * BN * 4};
    for (int g = cw; g < mine; g += 2) {
      int tm, tn;
      tile_coords(cluster + g * clusters, tiles_mc, tiles_n, group, tm, tn);
      const long n0 = (long)tn * BN, row0 = (long)(tm * CLUSTER + rank) * BM + warp * 16;
      // lane l's share of the tile's column vectors, loaded before the main
      // loop so its products hide the loads
      float vecs[VECS > 0 ? VECS : 1][BN / 32];
#pragma unroll
      for (int v = 0; v < VECS; ++v)
#pragma unroll
        for (int e = 0; e < BN / 32; ++e)
          vecs[v][e] = Epi::vec(p, v, n0 + lane * (BN / 32) + e, N);
      Acc acc[128];
#pragma unroll
      for (int j = 0; j < 128; ++j) acc[j] = 0;
      fence_acc(acc);
      if (g > 0) bar_sync_256(ORDER_BAR + cw);  // this consumer's turn on the tensor cores
      int i = g * ktiles;
      for (int kt = 0; kt < ktiles; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(full + 8 * s, (i / STAGES) & 1);
        const uint32_t st = sbase + s * STAGE_BYTES;
        const uint64_t da = wgmma_desc(st);
        const uint64_t db = W_MN ? wgmma_desc_mn(st + A_BYTES, MN_BOX) : wgmma_desc(st + A_BYTES);
        wgmma_fence();
#ifndef MTT_GEMM_SPLIT_LOADS
#pragma unroll
        for (int k = 0; k < 4; ++k)  // K-major: + 32 B; MN-major: + 16 rows (2048 B)
          Op::template mma<W_MN ? 1 : 0>(acc, da + 2 * k, db + (W_MN ? 128 : 2) * k);
#endif
        wgmma_commit();
        wgmma_wait<1>();  // the products on slice i-1 are done: hand its stage back
        if (kt > 0) release(empty + 8 * ((i - 1) % STAGES), lane);
      }
      if (g + 1 < mine) bar_arrive_256(ORDER_BAR + 1 - cw);  // the other's turn
      wgmma_wait<0>();
      fence_acc(acc);
      release(empty + 8 * ((i - 1) % STAGES), lane);
#ifndef MTT_GEMM_SPLIT_NO_STORE
#pragma unroll
      for (int v = 0; v < VECS; ++v)
#pragma unroll
        for (int e = 0; e < BN / 32; ++e) scratch.vec[v * BN + lane * (BN / 32) + e] = vecs[v][e];
      __syncwarp();
      Epi::store(p, acc, scratch, M, N, row0, n0);
      __syncwarp();  // the lanes are done with the scratch before the next tile's vectors
#endif
    }
  }
  if constexpr (CLUSTER > 1) {
    cluster_arrive();  // no CTA exits while another may still write to it or arrive on it
    cluster_wait();
  }
}

// The launch of an (M, N) product on `sms` SMs: one cluster per CLUSTER
// SMs (or per cluster tile, if fewer), cluster tile rows grouped so that a
// group spans eight tile rows (ops/fused_mlp.py:gemm_plan).
struct Plan {
  int grid, group;
};
static Plan plan(int M, int N, int sms) {
  constexpr int GROUP = 8 / CLUSTER;
  const int tiles_mc = ((M + BM - 1) / BM + CLUSTER - 1) / CLUSTER;
  const int tiles = tiles_mc * ((N + BN - 1) / BN), clusters = sms / CLUSTER;
  return {CLUSTER * (tiles < clusters ? tiles : clusters), tiles_mc < GROUP ? tiles_mc : GROUP};
}

// Launches `kernel` on the plan's grid of 384-thread CTAs in clusters of
// CLUSTER along x.
template <class Kernel, class... Args>
static int launch(Kernel kernel, const Plan& pl, int smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.grid, 1, 1);
  cfg.blockDim = dim3(384, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}


}  // namespace gpp
