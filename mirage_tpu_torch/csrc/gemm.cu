// C = A · Wᵀ (+ bias) [GELU] (+ residual), the matrix products inside
// three TPU kernels: the qkv and output projections of mirage_tpu/ops/
// block_attention.py:_attn_half_kernel and :_xattn_half_kernel, and fc1/fc2
// of mirage_tpu/ops/fused_mlp.py:_mlp_kernel. A float32 output serves the
// stash backward's dyln (fused_mlp.py:_mlp_bwd_stash_kernel), which also
// adds the dgelu-multiply epilogue of the dact product: dh = T(acc·dg) with
// dg read in the working type at the tile's coordinates, and the float
// 16-row column sums of the unrounded dh (the stash forward's fc1, which
// writes act and dg, is csrc/gemm_stash.cu). Those two products take W as
// it lies, (K, N) (mtt_gemm_kn: dh = dy·W2 and dyln = dh·W1, MN-major
// wgmma operands), so no weight is copied. The MLP backward's recompute,
// GELU backward and dyln products are csrc/mlp_bwd.cu.
//
// A is (M, K) row-major, W is (N, K) row-major (a torch Linear weight), C and
// the optional residual are (M, N). The epilogue follows the TPU kernels'
// rounding: acc + bias in float, GELU in float, one rounding to T; with a
// residual, out = T(residual + T(branch)).
//
// bf16 runs csrc/gemm_pingpong.cuh (bound: operations at the encoder
// shapes, bytes for the small decoder products): a persistent grid of one
// CTA per SM, a TMA loader thread and two consumer warpgroups that each own
// a 128 × 128 tile and take the tensor cores in turn, so one's epilogue
// (bias, GELU, the staging into 16-byte rows, the residual) runs under the
// other's products. K and N must be multiples of 8 (16-byte rows). float
// runs a plain 64×64 FMA tile for the float32 golden.
//
// mtt_gemm_tasks runs T products of one shape in one launch (the
// task-batched decoder tails): A (T, M, K), W (T, N, K), bias (T, N), C and
// the residual (T, M, N), every epilogue of mtt_gemm's but the (K, N)
// weight, bit-equal to T launches of mtt_gemm (csrc/gemm_pingpong.cuh's
// TASKS; a float product runs the FMA tile on a grid with the task in z).
//
// The bf16 GELU epilogue takes its formula as a template parameter, for the
// bench's S5 ablation (scripts/bench_vpu.py:_mlp_kernel_v's ``act``): erff
// (GELU_ERF, the main path's), the Abramowitz & Stegun 7.1.26 polynomial the
// TPU kernels use for erf (in float, or with every operation rounded to
// bf16) and A&S 7.1.28 (no exp). Only mtt_gemm_gelu_mode instantiates the
// others.
#include <type_traits>

#include "gemm_pingpong.cuh"

// ---------------------------------------------------------------- bf16 path

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

// The bf16 epilogues of csrc/gemm_pingpong.cuh, one kind an instantiation:
// PLAIN (+ bias, rounded to bf16), GELU (+ bias, GELU of formula GM, one
// rounding), both then + residual in float when one is given; F32 (+ bias,
// kept in float); DGELU (the dgelu multiply dh = T((acc + bias)·dg) and the
// float 16-row column sums of the unrounded dh). Each value goes through the
// warp's staging tile into 16-byte rows of C.
enum { EK_PLAIN = 0, EK_GELU = 1, EK_DGELU = 2, EK_F32 = 3 };

template <int KIND, int GM = GELU_ERF>
struct EpiBf16 {
  struct Params {
    void* C;
    const void* bias;
    int bias_dtype;
    const bf16* res;
    const bf16* dg;  // DGELU: GELU′ (M, N); colsum (ceil(M/16), N)
    float* colsum;
  };
  static constexpr int VECS = 1;
  __device__ __forceinline__ static float vec(const Params& p, int, long col, int N) {
    return p.bias != nullptr && col < N ? load_param(p.bias, col, p.bias_dtype) : 0.f;
  }
  // task `task` of a task-strided launch: its rows of C, the residual and
  // dg, its bias row and its row groups of the column sums
  __device__ __forceinline__ static Params at_task(const Params& p, int task, int M, int N) {
    using OutT = typename std::conditional<KIND == EK_F32, float, bf16>::type;
    const long rows = (long)task * M * N;
    Params q = p;
    q.C = static_cast<OutT*>(p.C) + rows;
    if (p.bias != nullptr)
      q.bias = static_cast<const char*>(p.bias) +
               (long)task * N * (p.bias_dtype == MTT_BF16 ? 2 : 4);
    if (p.res != nullptr) q.res = p.res + rows;
    if (p.dg != nullptr) q.dg = p.dg + rows;
    if (p.colsum != nullptr) q.colsum = p.colsum + (long)task * ((M + 15) / 16) * N;
    return q;
  }
  __device__ __forceinline__ static void store(const Params& p, const float (&acc)[128],
                                               const gpp::Scratch& s, int M, int N, long row0,
                                               long n0) {
    using namespace gpp;
    using OutT = typename std::conditional<KIND == EK_F32, float, bf16>::type;
    OutT* stage = reinterpret_cast<OutT*>(s.stage);
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int h = 0; h < MH; ++h) {
      const long r0 = row0 + h * 64;
#pragma unroll
      for (int cc = 0; cc < BN / EPI_COLS; ++cc) {
        const long c0 = n0 + cc * EPI_COLS;
        if (c0 >= N) break;
#pragma unroll  // fully: acc must stay in registers (constant indices)
        for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
          const int j = cc * (EPI_COLS / 8) + jj, c = jj * 8 + 2 * tig;
          const float2 bv = *reinterpret_cast<const float2*>(s.vec + cc * EPI_COLS + c);
          float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
          for (int r8 = 0; r8 < 2; ++r8) {
            float v0 = acc[frag(h, j, r8, 0)] + bv.x, v1 = acc[frag(h, j, r8, 1)] + bv.y;
#ifndef MTT_GEMM_SPLIT_NO_EPI
            if constexpr (KIND == EK_GELU) {
              v0 = gelu_mode<GM>(v0);
              v1 = gelu_mode<GM>(v1);
            } else if constexpr (KIND == EK_DGELU) {
              // N % 8 == 0: a column pair is wholly in or out
              const long row = r0 + gid + 8 * r8;
              float2 g = make_float2(0.f, 0.f);
              if (row < M && c0 + 8 * jj < N)
                g = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(p.dg + row * N + c0 + c));
              v0 *= g.x;
              v1 *= g.y;
              cs0 += v0;
              cs1 += v1;
            }
#endif
            stage_pair(stage, gid + 8 * r8, c, v0, v1);
          }
#ifndef MTT_GEMM_SPLIT_NO_EPI
          if constexpr (KIND == EK_DGELU) {  // the warp's 16 rows in a fixed order
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
              cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
            }
            if (gid == 0 && r0 < M && c0 + 8 * jj < N) {
              p.colsum[(r0 / 16) * N + c0 + c] = cs0;
              p.colsum[(r0 / 16) * N + c0 + c + 1] = cs1;
            }
          }
#endif
        }
        __syncwarp();
#ifdef MTT_GEMM_SPLIT_NO_EPI
        const OutT* res = nullptr;
#else
        const OutT* res = nullptr;
        if constexpr (KIND == EK_PLAIN || KIND == EK_GELU) res = p.res;
#endif
        store_staged(stage, static_cast<OutT*>(p.C), res, M, N, r0, c0);
        __syncwarp();  // the lanes have read the staging tile before it is refilled
      }
    }
  }
};

// KIND, GM: the epilogue; W_MN: W is (K, N), read as it lies.
template <int KIND, int GM, bool W_MN>
__global__ void __launch_bounds__(384, 1)
    gemm_bf16_pingpong(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w,
                       const typename EpiBf16<KIND, GM>::Params p, int M, int N, int K,
                       int group) {
  gpp::gemm_pingpong<gpp::Bf16, W_MN, EpiBf16<KIND, GM>>(&map_a, &map_w, p, M, N, K, group);
}

// The task-strided kernel: `tasks` products over 3-D maps of A and W.
template <int KIND>
__global__ void __launch_bounds__(384, 1)
    gemm_bf16_pingpong_tasks(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_w,
                             const typename EpiBf16<KIND>::Params p, int M, int N, int K,
                             int group, int tasks) {
  gpp::gemm_pingpong<gpp::Bf16, false, EpiBf16<KIND>, true>(&map_a, &map_w, p, M, N, K, group,
                                                              tasks);
}

template <int KIND, int GM = GELU_ERF, bool W_MN = false>
static int launch_kind(const void* a, const void* w, void* c, const void* bias, int bias_dtype,
                       const void* residual, int M, int N, int K, const void* aux_in,
                       void* colsum, cudaStream_t s) {
  constexpr int bytes = gpp::smem_bytes<1>();
  static SmemLimit limit;
  const int err = set_smem(gemm_bf16_pingpong<KIND, GM, W_MN>, bytes, limit);
  if (err != 0) return err;
  const int sms = sm_count();
  CUtensorMap map_a, map_w;
  const int bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // W (N, K): this CTA's W_ROWS rows of one K-slice; (K, N): 64 × 64 boxes
  const gpp::MapKey2d kw = W_MN ? gpp::MapKey2d{w, K, N, 64, 64, bf}
                                : gpp::MapKey2d{w, N, K, gpp::W_ROWS, 64, bf};
  if (sms == 0 || !gpp::cached_map_2d(&map_a, {a, M, K, gpp::BM, 64, bf}) ||
      !gpp::cached_map_2d(&map_w, kw))
    return (int)cudaErrorInvalidValue;
  const gpp::Plan pl = gpp::plan(M, N, sms);
  const typename EpiBf16<KIND, GM>::Params p{c, bias, bias_dtype,
                                             static_cast<const bf16*>(residual),
                                             static_cast<const bf16*>(aux_in),
                                             static_cast<float*>(colsum)};
  return gpp::launch(gemm_bf16_pingpong<KIND, GM, W_MN>, pl, bytes, s, map_a, map_w, p, M, N, K,
                     pl.group);
}

// The epilogue kind of mtt_gemm's (epi, out_f32); a float output takes no
// GELU.
template <int GM = GELU_ERF>
static int launch_bf16(const void* a, const void* w, void* c, const void* bias, int bias_dtype,
                       const void* residual, int M, int N, int K, int epi, int out_f32,
                       const void* aux_in, void* colsum, cudaStream_t s) {
  if (out_f32)
    return epi == EPI_NONE ? launch_kind<EK_F32>(a, w, c, bias, bias_dtype, nullptr, M, N, K,
                                                 nullptr, nullptr, s)
                           : (int)cudaErrorInvalidValue;
  if (epi == EPI_GELU)
    return launch_kind<EK_GELU, GM>(a, w, c, bias, bias_dtype, residual, M, N, K, nullptr,
                                    nullptr, s);
  if (epi == EPI_DGELU_MUL)
    return launch_kind<EK_DGELU>(a, w, c, bias, bias_dtype, nullptr, M, N, K, aux_in, colsum, s);
  return launch_kind<EK_PLAIN>(a, w, c, bias, bias_dtype, residual, M, N, K, nullptr, nullptr, s);
}

// `tasks` products of M rows a task (gpp::plan over the tasks' tiles).
template <int KIND>
static int launch_kind_tasks(const void* a, const void* w, void* c, const void* bias,
                             int bias_dtype, const void* residual, int M, int N, int K, int tasks,
                             cudaStream_t s) {
  constexpr int bytes = gpp::smem_bytes<1>();
  static SmemLimit limit;
  const int err = set_smem(gemm_bf16_pingpong_tasks<KIND>, bytes, limit);
  if (err != 0) return err;
  const int sms = sm_count();
  CUtensorMap map_a, map_w;
  // A (T, M, K) in boxes of BM rows; W (T, N, K), this CTA's W_ROWS rows
  const MapKey ka{a, K, M, tasks, K, (long long)M * K, gpp::BM, 64};
  const MapKey kw{w, K, N, tasks, K, (long long)N * K, gpp::W_ROWS, 64};
  if (sms == 0 || !cached_map_3d(&map_a, ka) || !cached_map_3d(&map_w, kw))
    return (int)cudaErrorInvalidValue;
  const gpp::Plan pl = gpp::plan(M, N, sms, tasks);
  const typename EpiBf16<KIND>::Params p{c, bias, bias_dtype,
                                         static_cast<const bf16*>(residual), nullptr, nullptr};
  return gpp::launch(gemm_bf16_pingpong_tasks<KIND>, pl, bytes, s, map_a, map_w, p, M, N, K,
                     pl.group, tasks);
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
  if (blockIdx.z > 0) {  // task blockIdx.z of a task-strided launch (no colsum epilogue)
    const long task = blockIdx.z;
    A += task * M * K;
    W += task * N * K;
    C += task * M * N;
    if (res != nullptr) res += task * M * N;
    if (bias != nullptr)
      bias = static_cast<const char*>(bias) + task * N * (bias_dtype == MTT_BF16 ? 2 : 4);
  }
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
// dh). out_f32 writes C in float from bf16 operands (no residual, no GELU); a
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
      return launch_kind<EK_GELU, GELU_AS26>(a, w, c, bias, bias_dtype, residual, M, N, K,
                                             nullptr, nullptr, s);
    case GELU_AS26_BF16:
      return launch_kind<EK_GELU, GELU_AS26_BF16>(a, w, c, bias, bias_dtype, residual, M, N, K,
                                                  nullptr, nullptr, s);
    case GELU_HASTINGS:
      return launch_kind<EK_GELU, GELU_HASTINGS>(a, w, c, bias, bias_dtype, residual, M, N, K,
                                                 nullptr, nullptr, s);
  }
  return (int)cudaErrorInvalidValue;
}

// mtt_gemm over `tasks` products of one shape: a (tasks, M, K), w (tasks,
// N, K), bias (tasks, N) or null, residual and c (tasks, M, N); epi
// EPI_NONE or EPI_GELU (out_f32 with EPI_NONE), as mtt_gemm.
extern "C" int mtt_gemm_tasks(const void* a, const void* w, void* c, const void* bias,
                              int bias_dtype, const void* residual, int M, int N, int K,
                              int tasks, int epi, int dtype, int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || tasks <= 0 || tasks > 65535 ||
      (epi != EPI_NONE && epi != EPI_GELU) || (out_f32 && (epi != EPI_NONE || residual != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MTT_BF16) {
    if (K % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
    if (out_f32)
      return launch_kind_tasks<EK_F32>(a, w, c, bias, bias_dtype, nullptr, M, N, K, tasks, s);
    if (epi == EPI_GELU)
      return launch_kind_tasks<EK_GELU>(a, w, c, bias, bias_dtype, residual, M, N, K, tasks, s);
    return launch_kind_tasks<EK_PLAIN>(a, w, c, bias, bias_dtype, residual, M, N, K, tasks, s);
  }
  const dim3 grid((N + FT - 1) / FT, (M + FT - 1) / FT, tasks);
  gemm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(a), static_cast<const float*>(w),
                                       static_cast<float*>(c), bias, bias_dtype, epi,
                                       static_cast<const float*>(residual), M, N, K, nullptr,
                                       nullptr);
  return (int)cudaGetLastError();
}

// mtt_gemm with W as (K, N) row-major, read as it lies (bf16 only): the
// stash backward's dh = dy·W2 (EPI_DGELU_MUL) and dyln = dh·W1 (EPI_NONE
// with out_f32), the two epilogues it takes.
extern "C" int mtt_gemm_kn(const void* a, const void* w, void* c, const void* bias,
                           int bias_dtype, const void* residual, int M, int N, int K, int epi,
                           int dtype, int out_f32, const void* aux_in, void* colsum,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || dtype != MTT_BF16 || K % 8 != 0 || N % 8 != 0 ||
      residual != nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi == EPI_NONE && out_f32)
    return launch_kind<EK_F32, GELU_ERF, true>(a, w, c, bias, bias_dtype, nullptr, M, N, K,
                                               nullptr, nullptr, s);
  if (epi == EPI_DGELU_MUL && !out_f32 && aux_in != nullptr && colsum != nullptr)
    return launch_kind<EK_DGELU, GELU_ERF, true>(a, w, c, bias, bias_dtype, nullptr, M, N, K,
                                                 aux_in, colsum, s);
  return (int)cudaErrorInvalidValue;
}
