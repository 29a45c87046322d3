// C = A · Wᵀ (+ bias) [GELU_erf] (+ residual), the matrix products inside
// three TPU kernels: the qkv and output projections of mirage_tpu/ops/
// block_attention.py:_attn_half_kernel and :_xattn_half_kernel, and fc1/fc2
// of mirage_tpu/ops/fused_mlp.py:_mlp_kernel. The backward kernels
// (block_attention.py:_attn_half_bwd_rows, fused_mlp.py:_mlp_bwd_rows) add
// two epilogues: a float32 output (their dyln and fc1 recompute h are float)
// and the GELU backward, which reads h (float) at the tile's coordinates and
// writes dh = T(acc·GELU′(h)), act = T(GELU(h)) and float column sums of the
// unrounded dh over each 16-row group (for db1). The stash pair of
// fused_mlp.py (_mlp_fwd_stash_kernel, _mlp_bwd_stash_kernel) adds two
// more: the stash epilogue of fc1 writes act = T(GELU(h)) and dg =
// T(GELU′(h)) from the float h = acc + b1, and the dgelu-multiply epilogue of
// the dact product writes dh = T(acc·dg) with dg read in the working type at
// the tile's coordinates, and the float 16-row column sums of the unrounded
// dh. The products with a non-transposed weight (dy·W) take W transposed by
// the caller.
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
// products (two computing warpgroups taking turns on the tensor cores).
#include <cuda.h>  // CUtensorMap; the encoder itself is fetched at run time

#include "common.cuh"

// ---------------------------------------------------------------- bf16 path

// C tile BM × BN; BK bf16 = one 128-byte swizzle row; STAGES K-slices in flight
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_GELU_BWD = 2, EPI_GELU_STASH = 3, EPI_DGELU_MUL = 4 };

__device__ __forceinline__ float gelu_f(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}
// d/dh GELU(h) = Φ(h) + h·φ(h)
__device__ __forceinline__ float gelu_grad(float h) {
  return 0.5f * (1.f + erff(h * 0.7071067811865476f)) +
         h * 0.3989422804014327f * expf(-0.5f * h * h);
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile whose
// 8-row groups lie 1024 bytes apart (the tile base is 1024-byte aligned).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
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

// d (64 × 256, this thread's 128 floats) += A (64 × 16) · B (256 × 16)ᵀ
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
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : MTT_F8(0), MTT_F8(8), MTT_F8(16), MTT_F8(24), MTT_F8(32), MTT_F8(40), MTT_F8(48),
        MTT_F8(56), MTT_F8(64), MTT_F8(72), MTT_F8(80), MTT_F8(88), MTT_F8(96), MTT_F8(104),
        MTT_F8(112), MTT_F8(120)
      : "l"(da), "l"(db), "r"(1));
}
#undef MTT_F8

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
// columns at a time: bias and the activation (none, GELU, or GELU′ for the
// stash) on the fragments, rounded to bf16 into the staging tile, then
// 16-byte coalesced rows out of it, adding the residual in float.
enum { ACT_NONE = 0, ACT_GELU = 1, ACT_GELU_GRAD = 2 };
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
          v0 = gelu_f(v0);
          v1 = gelu_f(v1);
        } else if (act == ACT_GELU_GRAD) {
          v0 = gelu_grad(v0);
          v1 = gelu_grad(v1);
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
// output (+ bias, GELU); the GELU backward, dh = acc·GELU′(h) with h read in
// float at the same coordinates, act = GELU(h) into aux_out, and the float
// column sums of dh over the warp's 16 rows into row row0/16 of colsum; or
// the dgelu multiply, dh = acc·dg with dg read in bf16 from aux_in, and the
// column sums of dh.
__device__ __forceinline__ void store_tile_direct(const float (&acc)[BN / 2],
                                                  const void* __restrict__ bias, int bias_dtype,
                                                  int epi, int out_f32, void* __restrict__ C,
                                                  const void* __restrict__ aux_in,
                                                  bf16* __restrict__ aux_out,
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
      if (epi == EPI_GELU_BWD) {
        const float2 h = *reinterpret_cast<const float2*>(static_cast<const float*>(aux_in) + i);
        v0 *= gelu_grad(h.x);
        v1 *= gelu_grad(h.y);
        s0 += v0;
        s1 += v1;
        *reinterpret_cast<__nv_bfloat162*>(aux_out + i) =
            __floats2bfloat162_rn(gelu_f(h.x), gelu_f(h.y));
      } else if (epi == EPI_DGELU_MUL) {
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
    if (epi == EPI_GELU_BWD || epi == EPI_DGELU_MUL) {
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

// Persistent: block b computes tiles b, b + gridDim.x, ... of the 128 × BN
// tiling of C (row-major tile order). Warpgroup 0 loads (one thread), 1 and
// 2 compute rows 0-63 and 64-127 of each tile. K-slices are numbered across
// the block's tiles; slice i sits in stage i % STAGES (A rows, then W rows),
// full[s] counts its bytes in and empty[s] the eight computing warps done
// with it. The loader runs ahead into the next tile while the computing
// warpgroups store the last one.
__global__ void __launch_bounds__(384, 1)
    gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w, void* __restrict__ C,
                     const void* __restrict__ bias, int bias_dtype, int epi,
                     const bf16* __restrict__ res, int M, int N, int K, int out_f32,
                     const void* __restrict__ aux_in, bf16* __restrict__ aux_out,
                     float* __restrict__ colsum) {
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
      if (out_f32 || epi == EPI_GELU_BWD || epi == EPI_DGELU_MUL) {
        store_tile_direct(acc, bias, bias_dtype, epi, out_f32, C, aux_in, aux_out, colsum, M, N,
                          row0, n0);
      } else if (epi == EPI_GELU_STASH) {  // act, then GELU′ from the same fragments
        store_tile(acc, tile_bias, sbias, stage, static_cast<bf16*>(C), nullptr, ACT_GELU, M, N,
                   row0, n0);
        store_tile(acc, tile_bias, sbias, stage, aux_out, nullptr, ACT_GELU_GRAD, M, N, row0,
                   n0);
      } else {
        store_tile(acc, tile_bias, sbias, stage, static_cast<bf16*>(C), res,
                   epi == EPI_GELU ? ACT_GELU : ACT_NONE, M, N, row0, n0);
      }
    }
  }
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
// box_rows × BK, 128-byte swizzled; out-of-range elements read as zero.
static bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
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

static int launch_bf16(const void* a, const void* w, void* c, const void* bias, int bias_dtype,
                       const void* residual, int M, int N, int K, int epi, int out_f32,
                       const void* aux_in, void* aux_out, void* colsum, cudaStream_t s) {
  constexpr int bytes = 1024 + STAGES * (BM + BN) * BK * 2 + 16 * STAGES + 8 * EPI_WARP_BYTES;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap map_a, map_w;
  const int sms = sm_count();
  if (sms == 0 || !make_map(&map_a, a, M, K, BM) || !make_map(&map_w, w, N, K, BN))
    return (int)cudaErrorInvalidValue;
  // one block per SM (or per tile, if fewer), each walking its share of tiles
  const int tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  gemm_bf16_kernel<<<tiles < sms ? tiles : sms, 384, bytes, s>>>(
      map_a, map_w, c, bias, bias_dtype, epi, static_cast<const bf16*>(residual), M, N, K,
      out_f32, aux_in, static_cast<bf16*>(aux_out), static_cast<float*>(colsum));
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- float path

constexpr int FT = 64, FK = 16;

__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W, float* __restrict__ C,
                    const void* __restrict__ bias, int bias_dtype, int epi,
                    const float* __restrict__ res, int M, int N, int K,
                    const float* __restrict__ aux_in, float* __restrict__ aux_out,
                    float* __restrict__ colsum) {
  __shared__ float as[FK][FT + 4];  // as[k][m]
  __shared__ float bs[FK][FT + 4];  // bs[k][n]
  __shared__ float red[4][16][FT];  // the colsum epilogues' terms, by row
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
  const bool sums = epi == EPI_GELU_BWD || epi == EPI_DGELU_MUL;
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
        } else if (epi == EPI_GELU_BWD) {
          const float h = aux_in[r * N + col];
          v *= gelu_grad(h);
          aux_out[r * N + col] = gelu_f(h);
        } else if (epi == EPI_GELU_STASH) {
          aux_out[r * N + col] = gelu_grad(v);
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

// epi: EPI_NONE, EPI_GELU, EPI_GELU_BWD (aux_in = h (M, N) float, aux_out
// = act (M, N) in the working type, colsum = (ceil(M/16), N) float, zeroed),
// EPI_GELU_STASH (C = act, aux_out = dg (M, N) in the working type) or
// EPI_DGELU_MUL (aux_in = dg (M, N) in the working type, colsum as above).
// out_f32 writes C in float from bf16 operands (no residual); a float32
// product always writes float.
extern "C" int mtt_gemm(const void* a, const void* w, void* c, const void* bias, int bias_dtype,
                        const void* residual, int M, int N, int K, int epi, int dtype,
                        int out_f32, const void* aux_in, void* aux_out, void* colsum,
                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || epi < EPI_NONE || epi > EPI_DGELU_MUL)
    return (int)cudaErrorInvalidValue;
  if (epi == EPI_GELU_BWD && (aux_in == nullptr || aux_out == nullptr || colsum == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((epi == EPI_GELU_STASH && aux_out == nullptr) ||
      (epi == EPI_DGELU_MUL && (aux_in == nullptr || colsum == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (epi >= EPI_GELU_STASH && (out_f32 || residual != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MTT_BF16) {
    if (K % 8 != 0 || N % 8 != 0 || (out_f32 && residual != nullptr))
      return (int)cudaErrorInvalidValue;
    return launch_bf16(a, w, c, bias, bias_dtype, residual, M, N, K, epi, out_f32, aux_in,
                       aux_out, colsum, s);
  }
  const dim3 grid((N + FT - 1) / FT, (M + FT - 1) / FT);
  gemm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(a), static_cast<const float*>(w),
                                       static_cast<float*>(c), bias, bias_dtype, epi,
                                       static_cast<const float*>(residual), M, N, K,
                                       static_cast<const float*>(aux_in),
                                       static_cast<float*>(aux_out), static_cast<float*>(colsum));
  return (int)cudaGetLastError();
}
