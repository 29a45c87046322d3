// fc1 of the stash MLP forward: h = A · Wᵀ + bias in float, act = T(GELU(h))
// and dg = T(GELU′(h)), the product inside mirage_tpu/ops/fused_mlp.py:
// _mlp_fwd_stash_kernel (B9, reached through _mlp_block_fwd_stash and, as
// B9′, _mlp_block_fwd_stash3d), which writes both for the stash backward.
// A is (M, K) row-major, W (N, K) row-major (a torch Linear weight), act and
// dg (M, N).
//
// Bound: bytes at the MLP's shapes (K = 384, 768: two bf16 outputs of
// M × 4K against 2·M·K·4K FLOPs), with the erff and expf of every output
// element close behind. The first version ran this as an epilogue of
// csrc/gemm.cu's 128 × 256 tiles: both computing warpgroups stopped the
// tensor cores while they stored, in two passes over the accumulator (erff
// twice, two bias copies and two staging rounds), and at K = 384 a tile has
// only 6 K-slices of products to hide it behind. Here:
// - one epilogue pass computes both outputs from the same float h:
//   e = erff(h/√2), act = 0.5·h·(1 + e), dg = 0.5·(1 + e) + h·φ(h), each
//   rounded to bf16 into its own per-warp staging tile and stored as
//   16-byte rows;
// - two consumer warpgroups in ping-pong, each owning its own 64 × 256 tile
//   (wgmma m64n256k16, 128 float accumulators a thread): an ordered pair of
//   named barriers gives the tensor cores to one warpgroup's main loop at a
//   time, so the other's GELU, GELU′ and stores run under it. A CTA's tiles
//   alternate between the two; one thread of a third warpgroup keeps a ring
//   of four 40 KB stages (A's 64 rows and W's 256 rows of a 64-wide
//   K-slice, 128-byte swizzled) filled in tile order across both, and the
//   grid is persistent (one CTA per SM, ops/fused_mlp.py:gemm_stash_plan).
//   The turn also orders the consumers' waits on the ring: a warpgroup
//   waits for its tile's slices only after the other has waited for all of
//   its previous tile's, so a stage's parity never names an older phase.
// act is bit-equal to csrc/gemm.cu's EPI_GELU output (B2's fc1): the same
// m64n256k16 products over the K-slices in order from a zero accumulator,
// the bias added in float, the same erff GELU, one rounding. float32 runs a
// 64 × 64 FMA tile (gemm.cu's float path, with this epilogue) for the
// float32 golden.
//
// What bounds it now is the epilogue's arithmetic, not memory: on the
// H100 at B9's shape (chip_smoke.py's stash split) it takes 0.355-0.375
// ms, B2's kernel writing act alone 0.293-0.304 and with no epilogue
// 0.196-0.204. W's 256 rows are read from L2 once per 64 rows of A, twice
// what a 128-row tile reads; multicasting them over a cluster of two CTAs
// along M gained nothing, so it is not done. What a later PR changes next:
// fewer instructions per element (erff is kept for act's bits), and fc2
// after it, which pads N = 384 to 512 on 256-wide tiles (csrc/gemm.cu).
#include "common.cuh"
#include "wgmma.cuh"

// ---------------------------------------------------------------- bf16 path

// a consumer's tile BM × BN; BK bf16 = one 128-byte swizzle row
constexpr int BM = 64, BN = 256, BK = 64, STAGES = 4;
constexpr int A_BYTES = BM * BK * 2, STAGE_BYTES = (BM + BN) * BK * 2;
// per-warp epilogue scratch: the tile's bias as float, then staging tiles of
// 16 rows × EPI_COLS for act and for dg, padded so the fragment writes fall
// on distinct banks and rows stay 16-byte aligned
constexpr int EPI_COLS = 64, EPI_STRIDE = EPI_COLS + 8;
constexpr int EPI_TILE_BYTES = 16 * EPI_STRIDE * 2, EPI_WARP_BYTES = BN * 4 + 2 * EPI_TILE_BYTES;
constexpr int STASH_SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES + 8 * EPI_WARP_BYTES;
constexpr int ORDER_BAR = 1;  // named barriers 1 and 2: consumer 0's and 1's turn

__device__ __forceinline__ void bar_sync_256(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive_256(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// h = v, e = erf(h/√2): act = 0.5·h·(1 + e) (csrc/gemm.cu's gelu_f, the same
// operations in the same order) and dg = Φ(h) + h·φ(h). FAST takes φ's
// exponential from __expf (relative error ≈ 1e-6, far below bf16's step,
// and faster at B9's shape); the float path keeps expf.
template <bool FAST>
__device__ __forceinline__ void gelu_pair(float v, float& act, float& dg) {
  const float e = erff(v * 0.7071067811865476f);
  act = 0.5f * v * (1.f + e);
  dg = 0.5f * (1.f + e) +
       v * 0.3989422804014327f * (FAST ? __expf(-0.5f * v * v) : expf(-0.5f * v * v));
}

// Stores one warp's 16 × BN slice of the tile (its accumulator fragments:
// rows l/4 and l/4 + 8, columns 8j + 2(l%4) and +1) at (row0, n0), 64
// columns at a time: h = acc + bias, act and dg rounded to bf16 into the
// staging tiles, then 16-byte coalesced rows of both out of them.
__device__ __forceinline__ void store_stash(const float (&acc)[BN / 2],
                                            const float (&bias)[BN / 32],
                                            float* __restrict__ sbias, bf16* __restrict__ sact,
                                            bf16* __restrict__ sdg, bf16* __restrict__ act,
                                            bf16* __restrict__ dg, int M, int N, long row0,
                                            long n0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int e = 0; e < BN / 32; ++e) sbias[lane * (BN / 32) + e] = bias[e];
  __syncwarp();
#pragma unroll
  for (int cc = 0; cc < BN / EPI_COLS; ++cc) {
    const long c0 = n0 + cc * EPI_COLS;
    if (c0 >= N) break;
#pragma unroll
    for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
      const int j = cc * (EPI_COLS / 8) + jj, c = jj * 8 + 2 * tig;
      const float2 bv = *reinterpret_cast<const float2*>(sbias + cc * EPI_COLS + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float a0, a1, g0, g1;
        gelu_pair<true>(acc[4 * j + 2 * half] + bv.x, a0, g0);
        gelu_pair<true>(acc[4 * j + 2 * half + 1] + bv.y, a1, g1);
        const int at = (gid + 8 * half) * EPI_STRIDE + c;
        *reinterpret_cast<__nv_bfloat162*>(sact + at) = __floats2bfloat162_rn(a0, a1);
        *reinterpret_cast<__nv_bfloat162*>(sdg + at) = __floats2bfloat162_rn(g0, g1);
      }
    }
    __syncwarp();
    // 16 rows × 8 chunks of 16 bytes of each output: four per lane
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = lane + 32 * i, r = e >> 3, c = (e & 7) * 8;
      if (row0 + r >= M || c0 + c >= N) continue;
      const long at = (row0 + r) * N + c0 + c;
      *reinterpret_cast<uint4*>(act + at) =
          *reinterpret_cast<const uint4*>(sact + r * EPI_STRIDE + c);
      *reinterpret_cast<uint4*>(dg + at) =
          *reinterpret_cast<const uint4*>(sdg + r * EPI_STRIDE + c);
    }
    __syncwarp();  // the lanes have read the staging tiles before they are refilled
  }
}

// Persistent: block b computes tiles b, b + gridDim.x, ... of the 64 × BN
// tiling of the outputs (row-major tile order); its g-th tile goes to
// consumer g % 2. Warpgroup 0 loads (one thread), 1 and 2 are the
// consumers. K-slices are numbered across the block's tiles; slice i sits
// in stage i % STAGES (A rows, then W rows), full[s] counts its bytes in and
// empty[s] the four warps of the consumer done with it.
__global__ void __launch_bounds__(384, 1)
    gemm_stash_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_w, bf16* __restrict__ act,
                      bf16* __restrict__ dg, const void* __restrict__ bias, int bias_dtype, int M,
                      int N, int K) {
  extern __shared__ unsigned char stash_smem_raw[];
  const uint32_t sbase = (smem_u32(stash_smem_raw) + 1023) & ~1023u;  // the swizzle's period
  // the ring, the barriers, then each computing warp's epilogue scratch
  const uint32_t full = sbase + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles_n = (N + BN - 1) / BN, tiles = tiles_n * ((M + BM - 1) / BM);
  const int ktiles = (K + BK - 1) / BK;
  const int mine = tiles > (int)blockIdx.x ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int i = 0;
      for (int g = 0; g < mine; ++g) {
        const int t = blockIdx.x + g * gridDim.x;
        const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++i) {
          const int s = i % STAGES;
          mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);  // first round: free
          const uint32_t st = sbase + s * STAGE_BYTES;
          mbar_expect_tx(full + 8 * s, STAGE_BYTES);
          tma_load_2d(st, &map_a, full + 8 * s, kt * BK, m0);
          tma_load_2d(st + A_BYTES, &map_w, full + 8 * s, kt * BK, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    unsigned char* scratch = stash_smem_raw + (empty + 8 * STAGES - smem_u32(stash_smem_raw)) +
                             (cw * 4 + warp) * EPI_WARP_BYTES;  // 16-byte aligned
    float* sbias = reinterpret_cast<float*>(scratch);
    bf16* sact = reinterpret_cast<bf16*>(scratch + BN * 4);
    bf16* sdg = reinterpret_cast<bf16*>(scratch + BN * 4 + EPI_TILE_BYTES);
    for (int g = cw; g < mine; g += 2) {
      const int t = blockIdx.x + g * gridDim.x;
      const long n0 = t % tiles_n * BN, row0 = t / tiles_n * BM + warp * 16;
      float tile_bias[BN / 32];
      const long bc0 = n0 + lane * (BN / 32);
#pragma unroll
      for (int e = 0; e < BN / 32; ++e)
        tile_bias[e] = bias != nullptr && bc0 + e < N ? load_param(bias, bc0 + e, bias_dtype) : 0.f;
      float acc[BN / 2];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
      fence_regs(acc);
      if (g > 0) bar_sync_256(ORDER_BAR + cw);  // this consumer's turn on the tensor cores
      int i = g * ktiles;
      for (int kt = 0; kt < ktiles; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(full + 8 * s, (i / STAGES) & 1);
        const uint32_t st = sbase + s * STAGE_BYTES;
        const uint64_t da = wgmma_desc(st), db = wgmma_desc(st + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) wgmma_n256(acc, da + 2 * k, db + 2 * k);  // +32 B
        wgmma_commit();
        wgmma_wait<1>();  // the products on slice i-1 are done: hand its stage back
        if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
      }
      if (g + 1 < mine) bar_arrive_256(ORDER_BAR + 1 - cw);  // the other's turn
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
      store_stash(acc, tile_bias, sbias, sact, sdg, act, dg, M, N, row0, n0);
    }
  }
}

// --------------------------------------------------------------- float path

constexpr int FT = 64, FK = 16;

__global__ void __launch_bounds__(256)
    gemm_stash_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                          float* __restrict__ act, float* __restrict__ dg,
                          const void* __restrict__ bias, int bias_dtype, int M, int N, int K) {
  __shared__ float as[FK][FT + 4];  // as[k][m]
  __shared__ float bs[FK][FT + 4];  // bs[k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long m0 = (long)blockIdx.y * FT, n0 = (long)blockIdx.x * FT;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256, r = e / FK, kk = e % FK;
      const long gk = k0 + kk, gr = m0 + r, gn = n0 + r;
      as[kk][r] = (gr < M && gk < K) ? A[gr * K + gk] : 0.f;
      bs[kk][r] = (gn < N && gk < K) ? W[gn * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long r = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (r >= M || col >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += load_param(bias, col, bias_dtype);
      gelu_pair<false>(v, act[r * N + col], dg[r * N + col]);
    }
}

// act = T(GELU(a · wᵀ + bias)), dg = T(GELU′(·)), all (M, N) in the working
// type (dtype: MTT_F32 or MTT_BF16; bf16 needs K and N multiples of 8);
// `grid` CTAs of the bf16 kernel (gemm_stash_plan: one per SM, or per tile).
extern "C" int mtt_gemm_stash(const void* a, const void* w, void* act, void* dg,
                              const void* bias, int bias_dtype, int M, int N, int K, int dtype,
                              int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act == nullptr || dg == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MTT_BF16) {
    if (K % 8 != 0 || N % 8 != 0 || grid <= 0) return (int)cudaErrorInvalidValue;
    static SmemLimit limit;
    if (int err = set_smem(gemm_stash_kernel, STASH_SMEM_BYTES, limit)) return err;
    CUtensorMap map_a, map_w;
    if (!make_map(&map_a, a, M, K, BM, BK) || !make_map(&map_w, w, N, K, BN, BK))
      return (int)cudaErrorInvalidValue;
    gemm_stash_kernel<<<grid, 384, STASH_SMEM_BYTES, s>>>(
        map_a, map_w, static_cast<bf16*>(act), static_cast<bf16*>(dg), bias, bias_dtype, M, N,
        K);
    return (int)cudaGetLastError();
  }
  const dim3 blocks((N + FT - 1) / FT, (M + FT - 1) / FT);
  gemm_stash_f32_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<float*>(act),
      static_cast<float*>(dg), bias, bias_dtype, M, N, K);
  return (int)cudaGetLastError();
}
