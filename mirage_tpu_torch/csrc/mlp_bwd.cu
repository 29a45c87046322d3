// The MLP backward's two products over the hidden (M, H = 4D), for the
// chain that B5 and B7 share: mirage_tpu/ops/fused_mlp.py:_mlp_bwd_rows
// (inside _mlp_bwd_dx_kernel, B5, and _mlp_bwd_kernel, B7) recomputes
// h = y·W1ᵀ + b1 in float, takes dact = dy·W2 in float, and then
// dyln = T(dh)·W1 in float for the LN backward.
//
// mtt_mlp_bwd_hidden: one launch computes both products of a tile of the
// hidden, acc_h = y·W1ᵀ and acc_d = dy·W2ᵀ (torch layouts: y, dy (M, D),
// W1 (H, D), W2 (D, H)), and its epilogue writes, from h = acc_h + b1 and
// e = erff(h/√2):
//   act = T(0.5·h·(1 + e)), dh = T(acc_d·(0.5·(1 + e) + h·φ(h))),
// and the float column sums of the unrounded dh over each 16-row group
// (db1's partials). The float h never reaches device memory.
// mtt_mlp_bwd_dyln: dyln = dh (M, H) · W1 (H, D), float out, or rounded
// to bf16 (B4's dattn = T(dy·Wproj), the same form with H = D).
//
// Bound: operations (2·M·D·H FLOPs a product, three here at K = D and
// K = H). The first version wrote h in float (M × 4D × 4 bytes: 311 MB at
// the pretraining encoder's 25344 rows) and read it back in the dact
// product's epilogue, and both products stopped the tensor cores for an
// epilogue of 8-byte stores straight from the fragments. Here:
// - a persistent grid (ops/fused_mlp.py:mlp_bwd_plan: one CTA per SM, or
//   per tile) of three warpgroups: one thread of the first keeps a ring of
//   128-byte-swizzled K-slices filled by TMA, the other two are consumers
//   in ping-pong, each owning its own 64-row tile, the g-th tile of a CTA
//   going to consumer g % 2. Named barriers 1 and 2 hand the tensor cores
//   to one consumer's main loop while the other runs its epilogue, and
//   also order the consumers' ring waits (a stage's parity never names an
//   older phase), as csrc/gemm_stash.cu does;
// - the hidden stage's tile is 64 × 128 with two accumulators (128 floats
//   a thread): each K-slice stage holds y's and dy's 64 rows, W1's 128 rows
//   (K-major) and W2's 64 × 128 block (MN-major: W2 is read as it lies,
//   with wgmma's transpose bit, so no transposed copy of it is made); four
//   48 KB stages. At 2.1 MFLOP a slice the loads, not the products, set
//   its pace (in variants on the H100, leaving W2's loads out made it about
//   a fifth faster, and leaving out the dact product or the ring's fourth
//   stage changed nothing), so two CTAs along M form a cluster: each loads
//   its own y and dy rows and half of W1's and W2's slices, multicast to
//   both, and every consumer warp releases a stage in both CTAs (about a
//   fifth faster at the encoder's shapes than one CTA alone, the same bits);
// - the epilogue stages act and dh through per-warp shared memory and
//   stores them as 16-byte rows; the column partials are shuffle sums over
//   the warp's 16 rows, in a fixed order (no atomics: reruns are
//   bit-identical);
// - dyln's tile is 64 × 256, W1 read MN-major (no transposed copy), its
//   float output staged through shared memory into 16-byte rows.
// act is bit-equal to csrc/gemm.cu's GELU output (B2's fc1): the same
// products over the K-slices in order from a zero accumulator, the bias in
// float, the same erff, one rounding. float32 runs plain 64 × 64 FMA tiles
// of the same functions, for the float32 checks.
//
// What a later PR changes first: the hidden stage's epilogue (erff, the
// exponential, the 16-row sums and the stores), which at the decoder's
// K = 256 (4 slices a tile) outlasts the other consumer's main loop (a
// variant with a trivial epilogue ran markedly faster there, and no faster
// at K = 768); and the LN backward folded into dyln's epilogue.
#include "common.cuh"
#include "wgmma.cuh"

constexpr int BK = 64;  // a K-slice: one 128-byte swizzle row of bf16
constexpr int BOX = BK * BK * 2;  // one 64 × 64 bf16 TMA box
constexpr int ORDER_BAR = 1;  // named barriers 1 and 2: consumer 0's and 1's turn

__device__ __forceinline__ void bar_sync_256(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive_256(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// ------------------------------------------------------- the hidden stage

constexpr int HM = 64, HN = 128, H_STAGES = 4;
// a stage: y's 64 rows, dy's 64 rows, W1's 128 rows (each a K-slice of 64),
// then W2's rows k0..k0+63 in two boxes of 64 hidden columns
constexpr int H_Y = 0, H_DY = HM * BK * 2, H_W1 = 2 * HM * BK * 2, H_W2 = H_W1 + HN * BK * 2;
constexpr int H_STAGE_BYTES = H_W2 + 2 * BOX;
// per-warp epilogue scratch: the tile's bias as float, then act's and dh's
// staging tiles of 16 rows × H_EPI_COLS, padded so the fragment writes fall
// on distinct banks and rows stay 16-byte aligned
constexpr int H_EPI_COLS = 32, H_EPI_STRIDE = H_EPI_COLS + 8;
constexpr int H_EPI_TILE = 16 * H_EPI_STRIDE * 2, H_EPI_WARP = HN * 4 + 2 * H_EPI_TILE;
constexpr int H_SMEM = 1024 + H_STAGES * H_STAGE_BYTES + 16 * H_STAGES + 8 * H_EPI_WARP;

// e = erf(h/√2): act = 0.5·h·(1 + e) (csrc/gemm.cu's gelu_f, the same
// operations in the same order) and GELU′(h) = 0.5·(1 + e) + h·φ(h). FAST
// takes φ's exponential from __expf (relative error ≈ 1e-6, far below
// bf16's step); the float path keeps expf.
template <bool FAST>
__device__ __forceinline__ void gelu_and_grad(float h, float& act, float& grad) {
  const float e = erff(h * 0.7071067811865476f);
  act = 0.5f * h * (1.f + e);
  grad = 0.5f * (1.f + e) +
         h * 0.3989422804014327f * (FAST ? __expf(-0.5f * h * h) : expf(-0.5f * h * h));
}

// One warp's 16 × HN slice of the tile (its accumulator fragments: rows
// l/4 and l/4 + 8, columns 8j + 2(l%4) and +1) at (row0, n0), H_EPI_COLS
// columns at a time: act and dh rounded to bf16 into the staging tiles,
// the 16-row column sums of the float dh into row row0/16 of `part`, then
// 16-byte rows of act and dh out of the staging tiles.
__device__ __forceinline__ void store_hidden(const float (&acc_h)[HN / 2],
                                             const float (&acc_d)[HN / 2],
                                             const float (&bias)[HN / 32],
                                             float* __restrict__ sbias, bf16* __restrict__ sact,
                                             bf16* __restrict__ sdh, bf16* __restrict__ act,
                                             bf16* __restrict__ dh, float* __restrict__ part,
                                             int M, int N, long row0, long n0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int e = 0; e < HN / 32; ++e) sbias[lane * (HN / 32) + e] = bias[e];
  __syncwarp();
#pragma unroll  // fully: the accumulators must stay in registers
  for (int cc = 0; cc < HN / H_EPI_COLS; ++cc) {
    const long c0 = n0 + cc * H_EPI_COLS;
    if (c0 >= N) break;
#pragma unroll
    for (int jj = 0; jj < H_EPI_COLS / 8; ++jj) {
      const int j = cc * (H_EPI_COLS / 8) + jj, c = jj * 8 + 2 * tig;
      const float2 bv = *reinterpret_cast<const float2*>(sbias + cc * H_EPI_COLS + c);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float a0, a1, g0, g1;
        gelu_and_grad<true>(acc_h[4 * j + 2 * half] + bv.x, a0, g0);
        gelu_and_grad<true>(acc_h[4 * j + 2 * half + 1] + bv.y, a1, g1);
        // rows past M read zeros (TMA's fill): acc_d = 0 there, so dh = 0
        const float d0 = acc_d[4 * j + 2 * half] * g0, d1 = acc_d[4 * j + 2 * half + 1] * g1;
        s0 += d0;
        s1 += d1;
        const int at = (gid + 8 * half) * H_EPI_STRIDE + c;
        *reinterpret_cast<__nv_bfloat162*>(sact + at) = __floats2bfloat162_rn(a0, a1);
        *reinterpret_cast<__nv_bfloat162*>(sdh + at) = __floats2bfloat162_rn(d0, d1);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (gid == 0 && row0 < M && c0 + c < N)
        *reinterpret_cast<float2*>(part + (row0 / 16) * N + c0 + c) = make_float2(s0, s1);
    }
    __syncwarp();
    // 16 rows × H_EPI_COLS/8 chunks of 16 bytes of each output: two per lane
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = lane + 32 * i, r = e / (H_EPI_COLS / 8), c = (e % (H_EPI_COLS / 8)) * 8;
      if (row0 + r >= M || c0 + c >= N) continue;
      const long at = (row0 + r) * N + c0 + c;
      *reinterpret_cast<uint4*>(act + at) =
          *reinterpret_cast<const uint4*>(sact + r * H_EPI_STRIDE + c);
      *reinterpret_cast<uint4*>(dh + at) =
          *reinterpret_cast<const uint4*>(sdh + r * H_EPI_STRIDE + c);
    }
    __syncwarp();  // the lanes have read the staging tiles before they are refilled
  }
}

// Persistent, in clusters of two CTAs along M: cluster c takes tiles c,
// c + clusters, ... of the 128 × HN tiling of the hidden (row-major tile
// order), rank r of the cluster its rows 64r..64r+63, and each CTA gives
// its g-th tile to consumer g % 2. K-slices are numbered across the
// tiles; slice i sits in stage i % H_STAGES of both CTAs: each CTA's loader
// brings its own y and dy rows and multicasts its half of W1's and W2's
// slices (rows / columns 64r..64r+63 of the tile) to both, so each weight
// byte is read from L2 once per cluster. full[s] counts a stage's bytes in;
// empty[s] the eight warps (four in each CTA) done with it, each warp
// arriving in both CTAs, since the partner's loader writes this stage too.
__global__ void __launch_bounds__(384, 1)
    mlp_bwd_hidden_kernel(const __grid_constant__ CUtensorMap map_y,
                          const __grid_constant__ CUtensorMap map_dy,
                          const __grid_constant__ CUtensorMap map_w1,
                          const __grid_constant__ CUtensorMap map_w2, const void* __restrict__ b1,
                          int b1_dtype, bf16* __restrict__ dh, bf16* __restrict__ act,
                          float* __restrict__ part, int M, int D, int H) {
  extern __shared__ unsigned char hid_smem_raw[];
  const uint32_t sbase = (smem_u32(hid_smem_raw) + 1023) & ~1023u;  // the swizzle's period
  const uint32_t full = sbase + H_STAGES * H_STAGE_BYTES, empty = full + 8 * H_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int rank = blockIdx.x & 1, cluster = blockIdx.x >> 1, clusters = gridDim.x >> 1;
  const int tiles_n = (H + HN - 1) / HN, tiles = tiles_n * ((M + 2 * HM - 1) / (2 * HM));
  const int ktiles = (D + BK - 1) / BK;
  const int mine = tiles > cluster ? (tiles - cluster + clusters - 1) / clusters : 0;
  if (tid == 0) {
    for (int s = 0; s < H_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive();  // both CTAs' barriers exist before any multicast or remote arrival
  cluster_wait();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int i = 0;
      for (int g = 0; g < mine; ++g) {
        const int t = cluster + g * clusters;
        const int m0 = t / tiles_n * 2 * HM + rank * HM, n0 = t % tiles_n * HN;
        for (int kt = 0; kt < ktiles; ++kt, ++i) {
          const int s = i % H_STAGES;
          mbar_wait(empty + 8 * s, ((i / H_STAGES) & 1) ^ 1);  // free in both CTAs
          const uint32_t st = sbase + s * H_STAGE_BYTES, bar = full + 8 * s;
          mbar_expect_tx(bar, H_STAGE_BYTES);
          tma_load_2d(st + H_Y, &map_y, bar, kt * BK, m0);
          tma_load_2d(st + H_DY, &map_dy, bar, kt * BK, m0);
          tma_load_2d_multicast(st + H_W1 + rank * BOX, &map_w1, bar, kt * BK, n0 + rank * BK, 3);
          tma_load_2d_multicast(st + H_W2 + rank * BOX, &map_w2, bar, n0 + rank * BK, kt * BK, 3);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    unsigned char* scratch = hid_smem_raw + (empty + 8 * H_STAGES - smem_u32(hid_smem_raw)) +
                             (cw * 4 + warp) * H_EPI_WARP;  // 16-byte aligned
    float* sbias = reinterpret_cast<float*>(scratch);
    bf16* sact = reinterpret_cast<bf16*>(scratch + HN * 4);
    bf16* sdh = reinterpret_cast<bf16*>(scratch + HN * 4 + H_EPI_TILE);
    // this warp is done with stage s: one arrival on it in each CTA
    auto release = [&](int s) {
      if (lane < 2) mbar_arrive_cluster(empty + 8 * s, lane);
    };
    for (int g = cw; g < mine; g += 2) {
      const int t = cluster + g * clusters;
      const long n0 = t % tiles_n * HN, row0 = t / tiles_n * 2 * HM + rank * HM + warp * 16;
      float tile_bias[HN / 32];
      const long bc0 = n0 + lane * (HN / 32);
#pragma unroll
      for (int e = 0; e < HN / 32; ++e)
        tile_bias[e] = bc0 + e < H ? load_param(b1, bc0 + e, b1_dtype) : 0.f;
      float acc_h[HN / 2], acc_d[HN / 2];
#pragma unroll
      for (int j = 0; j < HN / 2; ++j) acc_h[j] = acc_d[j] = 0.f;
      fence_regs(acc_h);
      fence_regs(acc_d);
      if (g > 0) bar_sync_256(ORDER_BAR + cw);  // this consumer's turn on the tensor cores
      int i = g * ktiles;
      for (int kt = 0; kt < ktiles; ++kt, ++i) {
        const int s = i % H_STAGES;
        mbar_wait(full + 8 * s, (i / H_STAGES) & 1);
        const uint32_t st = sbase + s * H_STAGE_BYTES;
        const uint64_t desc_y = wgmma_desc(st + H_Y), desc_dy = wgmma_desc(st + H_DY);
        const uint64_t desc_w1 = wgmma_desc(st + H_W1);
        const uint64_t desc_w2 = wgmma_desc_mn(st + H_W2, BOX);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {
          wgmma_n128(acc_h, desc_y + 2 * k, desc_w1 + 2 * k);           // K-major: +32 B a k16
          wgmma_n128<0, 1>(acc_d, desc_dy + 2 * k, desc_w2 + 128 * k);  // MN-major: +2048 B
        }
        wgmma_commit();
        wgmma_wait<1>();  // the products on slice i-1 are done: hand its stage back
        if (kt > 0) release((i - 1) % H_STAGES);
      }
      if (g + 1 < mine) bar_arrive_256(ORDER_BAR + 1 - cw);  // the other's turn
      wgmma_wait<0>();
      fence_regs(acc_h);
      fence_regs(acc_d);
      release((i - 1) % H_STAGES);
      store_hidden(acc_h, acc_d, tile_bias, sbias, sact, sdh, act, dh, part, M, H, row0, n0);
    }
  }
  cluster_arrive();  // no CTA exits while its partner may still arrive on its barriers
  cluster_wait();
}

// ------------------------------------------------------------------- dyln

constexpr int DM = 64, DN = 256, D_STAGES = 4;
// a stage: dh's 64 rows of a K-slice, then W1's rows k0..k0+63 in four
// boxes of 64 output columns
constexpr int D_W1 = DM * BK * 2, D_STAGE_BYTES = D_W1 + (DN / BK) * BOX;
// per-warp epilogue scratch: a staging tile of 16 rows × D_EPI_COLS float,
// padded so the fragments' 8-byte writes fall on distinct banks
constexpr int D_EPI_COLS = 32, D_EPI_STRIDE = D_EPI_COLS + 8;
constexpr int D_EPI_WARP = 16 * D_EPI_STRIDE * 4;
constexpr int D_SMEM = 1024 + D_STAGES * D_STAGE_BYTES + 16 * D_STAGES + 8 * D_EPI_WARP;

// One warp's 16 × DN slice of the float output at (row0, n0), D_EPI_COLS
// columns at a time through the staging tile, as 16-byte rows (8-byte rows
// of bf16, rounded once, with OUT = bf16).
template <typename OUT>
__device__ __forceinline__ void store_dyln(const float (&acc)[DN / 2], float* __restrict__ stage,
                                           OUT* __restrict__ C, int M, int N, long row0,
                                           long n0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int cc = 0; cc < DN / D_EPI_COLS; ++cc) {
    const long c0 = n0 + cc * D_EPI_COLS;
    if (c0 >= N) break;
#pragma unroll
    for (int jj = 0; jj < D_EPI_COLS / 8; ++jj) {
      const int j = cc * (D_EPI_COLS / 8) + jj, c = jj * 8 + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(stage + (gid + 8 * half) * D_EPI_STRIDE + c) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
    __syncwarp();
    // 16 rows × D_EPI_COLS/4 chunks of 16 bytes: four per lane
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = lane + 32 * i, r = e / (D_EPI_COLS / 4), c = (e % (D_EPI_COLS / 4)) * 4;
      if (row0 + r >= M || c0 + c >= N) continue;
      const float4 v = *reinterpret_cast<const float4*>(stage + r * D_EPI_STRIDE + c);
      if constexpr (sizeof(OUT) == 4) {
        *reinterpret_cast<float4*>(C + (row0 + r) * N + c0 + c) = v;
      } else {
        const uint2 w = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
        *reinterpret_cast<uint2*>(C + (row0 + r) * N + c0 + c) = w;
      }
    }
    __syncwarp();
  }
}

// Persistent as mlp_bwd_hidden_kernel, over the 64 × DN tiling of dyln
// (M, D), K = H; OUT float or bf16.
template <typename OUT>
__global__ void __launch_bounds__(384, 1)
    mlp_bwd_dyln_kernel(const __grid_constant__ CUtensorMap map_dh,
                        const __grid_constant__ CUtensorMap map_w1, OUT* __restrict__ dyln, int M,
                        int D, int H) {
  extern __shared__ unsigned char dyln_smem_raw[];
  const uint32_t sbase = (smem_u32(dyln_smem_raw) + 1023) & ~1023u;
  const uint32_t full = sbase + D_STAGES * D_STAGE_BYTES, empty = full + 8 * D_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles_n = (D + DN - 1) / DN, tiles = tiles_n * ((M + DM - 1) / DM);
  const int ktiles = (H + BK - 1) / BK;
  const int mine = tiles > (int)blockIdx.x ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (tid == 0) {
    for (int s = 0; s < D_STAGES; ++s) {
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
        const int m0 = t / tiles_n * DM, n0 = t % tiles_n * DN;
        for (int kt = 0; kt < ktiles; ++kt, ++i) {
          const int s = i % D_STAGES;
          mbar_wait(empty + 8 * s, ((i / D_STAGES) & 1) ^ 1);
          const uint32_t st = sbase + s * D_STAGE_BYTES, bar = full + 8 * s;
          mbar_expect_tx(bar, D_STAGE_BYTES);
          tma_load_2d(st, &map_dh, bar, kt * BK, m0);
#pragma unroll
          for (int b = 0; b < DN / BK; ++b)
            tma_load_2d(st + D_W1 + b * BOX, &map_w1, bar, n0 + b * BK, kt * BK);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    float* stage = reinterpret_cast<float*>(
        dyln_smem_raw + (empty + 8 * D_STAGES - smem_u32(dyln_smem_raw)) +
        (cw * 4 + warp) * D_EPI_WARP);
    for (int g = cw; g < mine; g += 2) {
      const int t = blockIdx.x + g * gridDim.x;
      const long n0 = t % tiles_n * DN, row0 = t / tiles_n * DM + warp * 16;
      float acc[DN / 2];
#pragma unroll
      for (int j = 0; j < DN / 2; ++j) acc[j] = 0.f;
      fence_regs(acc);
      if (g > 0) bar_sync_256(ORDER_BAR + cw);
      int i = g * ktiles;
      for (int kt = 0; kt < ktiles; ++kt, ++i) {
        const int s = i % D_STAGES;
        mbar_wait(full + 8 * s, (i / D_STAGES) & 1);
        const uint32_t st = sbase + s * D_STAGE_BYTES;
        const uint64_t da = wgmma_desc(st), db = wgmma_desc_mn(st + D_W1, BOX);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) wgmma_n256<0, 1>(acc, da + 2 * k, db + 128 * k);
        wgmma_commit();
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % D_STAGES));
      }
      if (g + 1 < mine) bar_arrive_256(ORDER_BAR + 1 - cw);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % D_STAGES));
      store_dyln(acc, stage, dyln, M, D, row0, n0);
    }
  }
}

// ------------------------------------------------------------- float path

constexpr int FT = 64, FK = 16;

// The hidden stage on a 64 × 64 tile of FMA: acc_h = y·W1ᵀ and acc_d =
// dy·W2ᵀ, then the same epilogue, the 16-row sums row by row in order.
__global__ void __launch_bounds__(256)
    mlp_bwd_hidden_f32_kernel(const float* __restrict__ Y, const float* __restrict__ DY,
                              const float* __restrict__ W1, const float* __restrict__ W2,
                              const void* __restrict__ b1, int b1_dtype, float* __restrict__ dh,
                              float* __restrict__ act, float* __restrict__ part, int M, int D,
                              int H) {
  __shared__ float ys[FK][FT + 4], dys[FK][FT + 4];  // [k][row]
  __shared__ float w1s[FK][FT + 4], w2s[FK][FT + 4];  // [k][hidden column]
  __shared__ float red[4][16][FT];                    // dh by row, for the sums
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long m0 = (long)blockIdx.y * FT, n0 = (long)blockIdx.x * FT;
  float acc_h[4][4] = {}, acc_d[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256, r = e / FK, kk = e % FK;
      const long gk = k0 + kk, gr = m0 + r, gn = n0 + r;
      ys[kk][r] = (gr < M && gk < D) ? Y[gr * D + gk] : 0.f;
      dys[kk][r] = (gr < M && gk < D) ? DY[gr * D + gk] : 0.f;
      w1s[kk][r] = (gn < H && gk < D) ? W1[gn * D + gk] : 0.f;
      // W2 (D, H) row k: hidden columns contiguous
      const int kr = e / FT, c = e % FT;
      w2s[kr][c] = (k0 + kr < D && n0 + c < H) ? W2[(k0 + kr) * (long)H + n0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], da[4], b[4], db[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ys[kk][ty + 16 * i];
        da[i] = dys[kk][ty + 16 * i];
        b[i] = w1s[kk][tx + 16 * i];
        db[i] = w2s[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_h[i][j] = fmaf(a[i], b[j], acc_h[i][j]);
          acc_d[i][j] = fmaf(da[i], db[j], acc_d[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long r = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      float d = 0.f;
      if (r < M && col < H) {
        float a, g;
        gelu_and_grad<false>(acc_h[i][j] + load_param(b1, col, b1_dtype), a, g);
        d = acc_d[i][j] * g;
        act[r * H + col] = a;
        dh[r * H + col] = d;
      }
      red[i][ty][tx + 16 * j] = d;
    }
  __syncthreads();
  const int i = tid >> 6, c = tid & (FT - 1);
  const long grp = m0 / 16 + i, col = n0 + c;
  if (grp * 16 < M && col < H) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s += red[i][t][c];
    part[grp * H + col] = s;
  }
}

// dyln = dh · W1 on a 64 × 64 tile of FMA (W1 (H, D) read as it lies)
__global__ void __launch_bounds__(256)
    mlp_bwd_dyln_f32_kernel(const float* __restrict__ DH, const float* __restrict__ W1,
                            float* __restrict__ dyln, int M, int D, int H) {
  __shared__ float as[FK][FT + 4];  // [k][row]
  __shared__ float bs[FK][FT + 4];  // [k][column]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long m0 = (long)blockIdx.y * FT, n0 = (long)blockIdx.x * FT;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < H; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256, r = e / FK, kk = e % FK;
      as[kk][r] = (m0 + r < M && k0 + kk < H) ? DH[(m0 + r) * H + k0 + kk] : 0.f;
      const int kr = e / FT, c = e % FT;
      bs[kr][c] = (k0 + kr < H && n0 + c < D) ? W1[(k0 + kr) * (long)D + n0 + c] : 0.f;
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
      if (r < M && col < D) dyln[r * D + col] = acc[i][j];
    }
}

// ----------------------------------------------------------------- entries

// y, dy (M, D), w1 (H, D), w2 (D, H), b1 (H) of type b1_dtype -> dh, act
// (M, H) in the working type (dtype) and part (ceil(M/16), H) float, the
// 16-row column sums of the float dh; `grid` CTAs of the bf16 kernel, in
// clusters of two (mlp_bwd_plan). bf16 needs D and H multiples of 8.
extern "C" int mtt_mlp_bwd_hidden(const void* y, const void* dy, const void* w1, const void* b1,
                                  int b1_dtype, const void* w2, void* dh, void* act, void* part,
                                  int M, int D, int H, int dtype, int grid, void* stream) {
  if (M <= 0 || D <= 0 || H <= 0 || b1 == nullptr || dh == nullptr || act == nullptr ||
      part == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MTT_BF16) {
    if (D % 8 != 0 || H % 8 != 0 || grid <= 0 || grid % 2) return (int)cudaErrorInvalidValue;
    static SmemLimit limit;
    if (int err = set_smem(mlp_bwd_hidden_kernel, H_SMEM, limit)) return err;
    CUtensorMap map_y, map_dy, map_w1, map_w2;
    if (!make_map(&map_y, y, M, D, HM, BK) || !make_map(&map_dy, dy, M, D, HM, BK) ||
        !make_map(&map_w1, w1, H, D, BK, BK) || !make_map(&map_w2, w2, D, H, BK, BK))
      return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid, 1, 1);
    cfg.blockDim = dim3(384, 1, 1);
    cfg.dynamicSmemBytes = H_SMEM;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, mlp_bwd_hidden_kernel, map_y, map_dy, map_w1, map_w2, b1, b1_dtype,
        static_cast<bf16*>(dh), static_cast<bf16*>(act), static_cast<float*>(part), M, D, H);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const dim3 blocks((H + FT - 1) / FT, (M + FT - 1) / FT);
  mlp_bwd_hidden_f32_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(y), static_cast<const float*>(dy), static_cast<const float*>(w1),
      static_cast<const float*>(w2), b1, b1_dtype, static_cast<float*>(dh),
      static_cast<float*>(act), static_cast<float*>(part), M, D, H);
  return (int)cudaGetLastError();
}

// dh (M, H) in the working type, w1 (H, D) -> dyln (M, D) = dh · w1, in
// float or (out_dtype bf16, a bf16 dh only) rounded to bf16; `grid` CTAs of
// the bf16 kernel (mlp_bwd_plan).
extern "C" int mtt_mlp_bwd_dyln(const void* dh, const void* w1, void* dyln, int M, int D, int H,
                                int dtype, int out_dtype, int grid, void* stream) {
  if (M <= 0 || D <= 0 || H <= 0 || dyln == nullptr || (out_dtype == MTT_BF16 && dtype != MTT_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MTT_BF16) {
    if (D % 8 != 0 || H % 8 != 0 || grid <= 0) return (int)cudaErrorInvalidValue;
    static SmemLimit limit_f32, limit_bf16;
    if (int err = out_dtype == MTT_BF16
                      ? set_smem(mlp_bwd_dyln_kernel<bf16>, D_SMEM, limit_bf16)
                      : set_smem(mlp_bwd_dyln_kernel<float>, D_SMEM, limit_f32))
      return err;
    CUtensorMap map_dh, map_w1;
    if (!make_map(&map_dh, dh, M, H, DM, BK) || !make_map(&map_w1, w1, H, D, BK, BK))
      return (int)cudaErrorInvalidValue;
    if (out_dtype == MTT_BF16)
      mlp_bwd_dyln_kernel<<<grid, 384, D_SMEM, s>>>(map_dh, map_w1, static_cast<bf16*>(dyln), M,
                                                    D, H);
    else
      mlp_bwd_dyln_kernel<<<grid, 384, D_SMEM, s>>>(map_dh, map_w1, static_cast<float*>(dyln), M,
                                                    D, H);
    return (int)cudaGetLastError();
  }
  const dim3 blocks((D + FT - 1) / FT, (M + FT - 1) / FT);
  mlp_bwd_dyln_f32_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(dh),
                                                 static_cast<const float*>(w1),
                                                 static_cast<float*>(dyln), M, D, H);
  return (int)cudaGetLastError();
}
