// C = A · Wᵀ (+ bias) [GELU_erf] (+ residual), the matrix products inside
// three TPU kernels: the qkv and output projections of mirage_tpu/ops/
// block_attention.py:_attn_half_kernel and :_xattn_half_kernel, and fc1/fc2
// of mirage_tpu/ops/fused_mlp.py:_mlp_kernel. The attention backward
// (block_attention.py:_attn_half_bwd_rows) adds a float32 output (its
// dyln). The stash backward of fused_mlp.py (_mlp_bwd_stash_kernel) adds
// the dgelu-multiply epilogue of the dact product: dh = T(acc·dg) with dg
// read in the working type at the tile's coordinates, and the float 16-row
// column sums of the unrounded dh (the stash forward's fc1, which writes act
// and dg, is csrc/gemm_stash.cu). The products with a non-transposed weight
// (dy·W) take W transposed by the caller. The MLP backward's recompute,
// GELU backward and dyln products are csrc/mlp_bwd.cu.
//
// A is (M, K) row-major, W is (N, K) row-major (a torch Linear weight), C and
// the optional residual are (M, N). The epilogue follows the TPU kernels'
// rounding: acc + bias in float, GELU in float, one rounding to T; with a
// residual, out = T(residual + T(branch)).
//
// Bound: operations at the encoder shapes (K = 1024/4096, M = B·257), bytes
// for the small decoder GEMMs. bf16 runs on Hopper's warpgroup MMA (wgmma,
// float accumulation) in a persistent, warp-specialised block of three
// warpgroups, one block per SM walking 128 × 256 tiles of C: one thread of
// the first issues TMA loads of K-slices (BK = 64, one 128-byte swizzled row
// per matrix row, the layout wgmma reads) into a ring of four shared-memory
// stages, and the other two each multiply 64 rows of the tile, handing a
// stage back through an mbarrier as soon as its products are done. A and W
// are both K-major, so neither is transposed. The epilogue stages each
// warp's rows through shared memory so C (and the residual) move in 16-byte
// coalesced rows; the loader meanwhile fills the ring for the next tile.
// Ragged M, N and K are zero-filled by the TMA unit and masked at the store;
// K and N must be multiples of 8 (16-byte rows). float runs a plain 64×64
// FMA tile for the float32 golden. What a later PR changes first: fusing
// the LayerNorm in front and the attention behind, so the LN output, the
// qkv and the (M, 4D) MLP hidden stop going through device memory, and
// overlapping the epilogue's bias/GELU/residual math with the next tile's
// products (two computing warpgroups taking turns on the tensor cores, as
// csrc/gemm_stash.cu and csrc/mlp_bwd.cu do); the float output's 8-byte
// stores from the fragments (the attention backward's dyln and the stash
// backward's dgelu multiply) staged into 16-byte rows.
//
// The bf16 GELU epilogue takes its formula as a template parameter, for the
// bench's S5 ablation (scripts/bench_vpu.py:_mlp_kernel_v's ``act``): erff
// (GELU_ERF, the main path's and the only one mtt_gemm instantiates), the
// Abramowitz & Stegun 7.1.26 polynomial the TPU kernels use for erf (in float,
// or with every operation rounded to bf16) and A&S 7.1.28 (no exp). Only
// mtt_gemm_gelu_mode instantiates the others.
#include "common.cuh"
#include "wgmma.cuh"

// ---------------------------------------------------------------- bf16 path

// C tile BM × BN; BK bf16 = one 128-byte swizzle row; STAGES K-slices in flight
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_DGELU_MUL = 2 };

__device__ __forceinline__ float gelu_f(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}
enum { GELU_ERF = 0, GELU_AS26 = 1, GELU_AS26_BF16 = 2, GELU_HASTINGS = 3 };

// mirage_tpu/ops/fused_mlp.py:_erf (A&S 7.1.26), op for op, as csrc/quant.cu
__device__ __forceinline__ float erf_as26(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f, a4 = -1.453152027f,
              a5 = 1.061405429f, p = 0.3275911f;
  const float s = (x > 0.f) ? 1.f : ((x < 0.f) ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(p, ax)));
  float poly = __fadd_rn(a4, __fmul_rn(t, a5));
  poly = __fadd_rn(a3, __fmul_rn(t, poly));
  poly = __fadd_rn(a2, __fmul_rn(t, poly));
  poly = __fadd_rn(a1, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  const float e = exp2f(__fmul_rn(-__fmul_rn(ax, ax), 1.4426950408889634f));
  return __fmul_rn(s, __fsub_rn(1.f, __fmul_rn(poly, e)));
}

// The same polynomial with every operation in bf16 (the constants rounded
// to bf16 first), as jnp evaluates it on a bf16 array (bench_vpu.py:250-251)
__device__ __forceinline__ float gelu_as26_bf16(float v) {
  const bf16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);
  const bf16 hb = __float2bfloat16(v);
  const bf16 x = __hdiv(hb, __float2bfloat16(1.4142135623730951f));
  const bf16 s = __hgt(x, zero) ? one : (__hlt(x, zero) ? __hneg(one) : zero);
  const bf16 ax = __habs(x);
  const bf16 t = __hdiv(one, __hadd(one, __hmul(__float2bfloat16(0.3275911f), ax)));
  bf16 poly = __hadd(__float2bfloat16(-1.453152027f), __hmul(t, __float2bfloat16(1.061405429f)));
  poly = __hadd(__float2bfloat16(1.421413741f), __hmul(t, poly));
  poly = __hadd(__float2bfloat16(-0.284496736f), __hmul(t, poly));
  poly = __hadd(__float2bfloat16(0.254829592f), __hmul(t, poly));
  poly = __hmul(t, poly);
  const bf16 e = hexp2(__hmul(__hneg(__hmul(ax, ax)), __float2bfloat16(1.4426950408889634f)));
  const bf16 erf = __hmul(s, __hsub(one, __hmul(poly, e)));
  return __bfloat162float(__hmul(__hmul(__float2bfloat16(0.5f), hb), __hadd(one, erf)));
}

// A&S 7.1.28: erf(z) = 1 − 1/(1 + a1·z + ... + a6·z⁶)¹⁶, a division and no exp
__device__ __forceinline__ float gelu_hastings(float v) {
  const float z = v * 0.7071067811865476f, az = fabsf(z);
  const float q = 1.f + az * (0.0705230784f + az * (0.0422820123f + az * (0.0092705272f +
                  az * (0.0001520143f + az * (0.0002765672f + az * 0.0000430638f)))));
  const float q2 = q * q, q4 = q2 * q2, q8 = q4 * q4;
  const float e = 1.f - 1.f / (q8 * q8);
  const float sg = (z > 0.f) ? 1.f : ((z < 0.f) ? -1.f : 0.f);
  return 0.5f * v * (1.f + sg * e);
}

template <int GM>
__device__ __forceinline__ float gelu_mode(float v) {
  if constexpr (GM == GELU_AS26) return 0.5f * v * (1.f + erf_as26(v / 1.4142135623730951f));
  else if constexpr (GM == GELU_AS26_BF16) return gelu_as26_bf16(v);
  else if constexpr (GM == GELU_HASTINGS) return gelu_hastings(v);
  else return gelu_f(v);
}


// Per-warp epilogue scratch: the tile's BN bias values as float, then a
// staging tile of 16 rows × EPI_COLS bf16, padded so the fragment writes
// fall on distinct banks and rows stay 16-byte aligned.
constexpr int EPI_COLS = 64, EPI_STRIDE = EPI_COLS + 8;
constexpr int EPI_WARP_BYTES = BN * 4 + 16 * EPI_STRIDE * 2;

// Lane l's share of the tile's bias, columns n0 + l·BN/32 ... (zero past N
// or without a bias), loaded when the tile starts so the mainloop hides the
// load; the epilogue puts it in the warp's scratch.
__device__ __forceinline__ void load_tile_bias(float (&b)[BN / 32], const void* __restrict__ bias,
                                               int bias_dtype, int N, long n0) {
  const long c0 = n0 + (threadIdx.x & 31) * (BN / 32);
#pragma unroll
  for (int e = 0; e < BN / 32; ++e)
    b[e] = bias != nullptr && c0 + e < N ? load_param(bias, c0 + e, bias_dtype) : 0.f;
}

// Stores one warp's 16 × BN slice of the tile (its accumulator fragments:
// rows l/4 and l/4 + 8, columns 8j + 2(l%4) and +1) to C at (row0, n0), 64
// columns at a time: bias and the activation (none or GELU) on the
// fragments, rounded to bf16 into the staging tile, then 16-byte coalesced
// rows out of it, adding the residual in float.
enum { ACT_NONE = 0, ACT_GELU = 1 };
template <int GM>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           const float (&bias)[BN / 32], float* __restrict__ sbias,
                                           bf16* __restrict__ stage, bf16* __restrict__ C,
                                           const bf16* __restrict__ res, int act, int M, int N,
                                           long row0, long n0) {
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
        float v0 = acc[4 * j + 2 * half] + bv.x, v1 = acc[4 * j + 2 * half + 1] + bv.y;
        if (act == ACT_GELU) {
          v0 = gelu_mode<GM>(v0);
          v1 = gelu_mode<GM>(v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(stage + (gid + 8 * half) * EPI_STRIDE + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncwarp();
    // 16 rows × 8 chunks of 16 bytes: four per lane, loads issued first
    uint4 out[4], rv[4];
    bool ok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = lane + 32 * i, r = e >> 3, c = (e & 7) * 8;
      ok[i] = row0 + r < M && c0 + c < N;
      out[i] = *reinterpret_cast<const uint4*>(stage + r * EPI_STRIDE + c);
      if (res != nullptr && ok[i])
        rv[i] = *reinterpret_cast<const uint4*>(res + (row0 + r) * N + c0 + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!ok[i]) continue;
      const int e = lane + 32 * i, r = e >> 3, c = (e & 7) * 8;
      if (res != nullptr) {
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out[i]);
        const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv[i]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 x = __bfloat1622float2(r2[k]), y = __bfloat1622float2(o2[k]);
          o2[k] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
        }
      }
      *reinterpret_cast<uint4*>(C + (row0 + r) * N + c0 + c) = out[i];
    }
    __syncwarp();  // the lanes have read the staging tile before it is refilled
  }
}

// Writes one warp's 16 × BN accumulator straight from its fragments (a
// column pair per lane, whole 32-byte row segments per lane quad): the float
// output (+ bias, GELU); or the dgelu multiply, dh = acc·dg with dg read in
// bf16 from aux_in, and the float column sums of dh over the warp's 16 rows
// into row row0/16 of colsum.
__device__ __forceinline__ void store_tile_direct(const float (&acc)[BN / 2],
                                                  const void* __restrict__ bias, int bias_dtype,
                                                  int epi, int out_f32, void* __restrict__ C,
                                                  const void* __restrict__ aux_in,
                                                  float* __restrict__ colsum, int M, int N,
                                                  long row0, long n0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll  // fully: acc must stay in registers (constant indices)
  for (int j = 0; j < BN / 8; ++j) {
    if (n0 + 8 * j >= N) break;  // N % 8 == 0: a column pair is wholly in or out
    const long col = n0 + 8 * j + 2 * tig;
    const float b0 = bias != nullptr ? load_param(bias, col, bias_dtype) : 0.f;
    const float b1 = bias != nullptr ? load_param(bias, col + 1, bias_dtype) : 0.f;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long row = row0 + gid + 8 * half;
      if (row >= M) continue;
      const long i = row * N + col;
      float v0 = acc[4 * j + 2 * half] + b0, v1 = acc[4 * j + 2 * half + 1] + b1;
      if (epi == EPI_DGELU_MUL) {
        const float2 g = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(aux_in) + i));
        v0 *= g.x;
        v1 *= g.y;
        s0 += v0;
        s1 += v1;
      } else if (epi == EPI_GELU) {
        v0 = gelu_f(v0);
        v1 = gelu_f(v1);
      }
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(C) + i) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(C) + i) =
            __floats2bfloat162_rn(v0, v1);
    }
    if (epi == EPI_DGELU_MUL) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (gid == 0 && row0 < M) {
        colsum[(row0 / 16) * N + col] = s0;
        colsum[(row0 / 16) * N + col + 1] = s1;
      }
    }
  }
}


// Persistent: block b computes tiles b, b + gridDim.x, ... of the 128 × BN
// tiling of C (row-major tile order). Warpgroup 0 loads (one thread), 1 and
// 2 compute rows 0-63 and 64-127 of each tile. K-slices are numbered across
// the block's tiles; slice i sits in stage i % STAGES (A rows, then W rows),
// full[s] counts its bytes in and empty[s] the eight computing warps done
// with it. The loader runs ahead into the next tile while the computing
// warpgroups store the last one. GM: the GELU formula of the bf16 epilogue.
template <int GM>
__global__ void __launch_bounds__(384, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w, void* __restrict__ C,
                     const void* __restrict__ bias, int bias_dtype, int epi,
                     const bf16* __restrict__ res, int M, int N, int K, int out_f32,
                     const void* __restrict__ aux_in, float* __restrict__ colsum) {
  constexpr int A_BYTES = BM * BK * 2, STAGE_BYTES = (BM + BN) * BK * 2;
  extern __shared__ unsigned char gemm_smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  const uint32_t sbase = (smem_u32(gemm_smem_raw) + 1023) & ~1023u;
  // the ring, then the barriers, then each computing warp's epilogue scratch
  const uint32_t full = sbase + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles_n = (N + BN - 1) / BN, tiles = tiles_n * ((M + BM - 1) / BM);
  const int ktiles = (K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int i = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
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
    int i = 0;
    unsigned char* scratch = gemm_smem_raw + (empty + 8 * STAGES - smem_u32(gemm_smem_raw)) +
                             (cw * 4 + warp) * EPI_WARP_BYTES;  // 16-byte aligned
    float* sbias = reinterpret_cast<float*>(scratch);
    bf16* stage = reinterpret_cast<bf16*>(scratch + BN * 4);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      float tile_bias[BN / 32];
      load_tile_bias(tile_bias, bias, bias_dtype, N, t % tiles_n * BN);
      float acc[BN / 2];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
      fence_regs(acc);
      for (int kt = 0; kt < ktiles; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(full + 8 * s, (i / STAGES) & 1);
        const uint32_t st = sbase + s * STAGE_BYTES;
        const uint64_t da = wgmma_desc(st + cw * 64 * 128), db = wgmma_desc(st + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) wgmma_n256(acc, da + 2 * k, db + 2 * k);  // +32 B
        wgmma_commit();
        wgmma_wait<1>();  // the products on slice i-1 are done: hand its stage back
        if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));

      const long row0 = t / tiles_n * BM + cw * 64 + warp * 16, n0 = t % tiles_n * BN;
      if (out_f32 || epi == EPI_DGELU_MUL) {
        store_tile_direct(acc, bias, bias_dtype, epi, out_f32, C, aux_in, colsum, M, N, row0, n0);
      } else {
        store_tile<GM>(acc, tile_bias, sbias, stage, static_cast<bf16*>(C), res,
                       epi == EPI_GELU ? ACT_GELU : ACT_NONE, M, N, row0, n0);
      }
    }
  }
}


template <int GM = GELU_ERF>
static int launch_bf16(const void* a, const void* w, void* c, const void* bias, int bias_dtype,
                       const void* residual, int M, int N, int K, int epi, int out_f32,
                       const void* aux_in, void* colsum, cudaStream_t s) {
  constexpr int bytes = 1024 + STAGES * (BM + BN) * BK * 2 + 16 * STAGES + 8 * EPI_WARP_BYTES;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16_kernel<GM>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap map_a, map_w;
  const int sms = sm_count();
  if (sms == 0 || !make_map(&map_a, a, M, K, BM, BK) || !make_map(&map_w, w, N, K, BN, BK))
    return (int)cudaErrorInvalidValue;
  // one block per SM (or per tile, if fewer), each walking its share of tiles
  const int tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  gemm_bf16_kernel<GM><<<tiles < sms ? tiles : sms, 384, bytes, s>>>(
      map_a, map_w, c, bias, bias_dtype, epi, static_cast<const bf16*>(residual), M, N, K,
      out_f32, aux_in, static_cast<float*>(colsum));
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- float path

constexpr int FT = 64, FK = 16;

__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W, float* __restrict__ C,
                    const void* __restrict__ bias, int bias_dtype, int epi,
                    const float* __restrict__ res, int M, int N, int K,
                    const float* __restrict__ aux_in, float* __restrict__ colsum) {
  __shared__ float as[FK][FT + 4];  // as[k][m]
  __shared__ float bs[FK][FT + 4];  // bs[k][n]
  __shared__ float red[4][16][FT];  // the colsum epilogue's terms, by row
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
  const bool sums = epi == EPI_DGELU_MUL;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long r = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      float v = 0.f;
      if (r < M && col < N) {
        v = acc[i][j];
        if (bias != nullptr) v += load_param(bias, col, bias_dtype);
        if (epi == EPI_GELU) {
          v = gelu_f(v);
        } else if (epi == EPI_DGELU_MUL) {
          v *= aux_in[r * N + col];
        }
        if (res != nullptr) v += res[r * N + col];
        C[r * N + col] = v;
      }
      if (sums) red[i][ty][tx + 16 * j] = v;
    }
  if (!sums) return;
  // the 16-row column sums, row by row in order (no atomics: a rerun gives
  // the same bits): row group m0/16 + i, column n0 + c
  __syncthreads();
  const int i = tid >> 6, c = tid & (FT - 1);
  const long grp = m0 / 16 + i, col = n0 + c;
  if (grp * 16 < M && col < N) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s += red[i][t][c];
    colsum[grp * N + col] = s;
  }
}

// epi: EPI_NONE, EPI_GELU or EPI_DGELU_MUL (aux_in = dg (M, N) in the
// working type, colsum = (ceil(M/16), N) float: the 16-row column sums of
// dh). out_f32 writes C in float from bf16 operands (no residual); a
// float32 product always writes float.
extern "C" int mtt_gemm(const void* a, const void* w, void* c, const void* bias, int bias_dtype,
                        const void* residual, int M, int N, int K, int epi, int dtype,
                        int out_f32, const void* aux_in, void* colsum, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || epi < EPI_NONE || epi > EPI_DGELU_MUL)
    return (int)cudaErrorInvalidValue;
  if (epi == EPI_DGELU_MUL &&
      (aux_in == nullptr || colsum == nullptr || out_f32 || residual != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MTT_BF16) {
    if (K % 8 != 0 || N % 8 != 0 || (out_f32 && residual != nullptr))
      return (int)cudaErrorInvalidValue;
    return launch_bf16(a, w, c, bias, bias_dtype, residual, M, N, K, epi, out_f32, aux_in,
                       colsum, s);
  }
  const dim3 grid((N + FT - 1) / FT, (M + FT - 1) / FT);
  gemm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(a), static_cast<const float*>(w),
                                       static_cast<float*>(c), bias, bias_dtype, epi,
                                       static_cast<const float*>(residual), M, N, K,
                                       static_cast<const float*>(aux_in),
                                       static_cast<float*>(colsum));
  return (int)cudaGetLastError();
}

// The bf16 product with bias, GELU of formula `mode` (GELU_AS26,
// GELU_AS26_BF16 or GELU_HASTINGS; GELU_ERF is mtt_gemm's EPI_GELU) and an
// optional residual, for the bench's S5 ablation.
extern "C" int mtt_gemm_gelu_mode(const void* a, const void* w, void* c, const void* bias,
                                  int bias_dtype, const void* residual, int M, int N, int K,
                                  int mode, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case GELU_AS26:
      return launch_bf16<GELU_AS26>(a, w, c, bias, bias_dtype, residual, M, N, K, EPI_GELU, 0,
                                    nullptr, nullptr, s);
    case GELU_AS26_BF16:
      return launch_bf16<GELU_AS26_BF16>(a, w, c, bias, bias_dtype, residual, M, N, K, EPI_GELU,
                                         0, nullptr, nullptr, s);
    case GELU_HASTINGS:
      return launch_bf16<GELU_HASTINGS>(a, w, c, bias, bias_dtype, residual, M, N, K, EPI_GELU, 0,
                                        nullptr, nullptr, s);
  }
  return (int)cudaErrorInvalidValue;
}
