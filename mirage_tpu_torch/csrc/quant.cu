// The int8 MLP half, out = x + MLP_int8(LN(x)), as a chain of four kernels.
// Replaces mirage_tpu/ops/quant.py:_mlp_block_q_fwd / _mlp_q_kernel, which
// runs _mlp_q_math (:72-92) on a row block: LN with the one-pass variance
// clamped at 0, per-row dynamic int8 activations (scale = abs-max / 127,
// zero -> 1, round half to even, clip to ±127), s8·s8 -> s32 products with
// per-output-channel weight scales, dequantised as acc·rs·s + b, the
// Abramowitz-Stegun erf in the GELU, and the same quantisation of the
// hidden before fc2.
//
//   1. ln_quant: LN -> the row's abs-max -> yq (int8) and rs (one row per warp)
//   2. gemm_s8 (fc1): h = GELU(acc·rs·s1 + b1) in float, and each row's
//      abs-max of h by atomicMax on the float's bits (order-independent:
//      a rerun gives the same bits)
//   3. quant_rows: aq = q(h / rs2), rs2 = abs-max / 127
//   4. gemm_s8 (fc2): out = T(x + T(acc·rs2·s2 + b2))
//
// gemm_s8 has a third epilogue for the port's bench (scripts/bench_int8.py:
// probe_pallas_int8, an s8·s8 -> s32 dot): the raw s32 accumulator stored
// as it is, exact. Bound: bytes at the bench's shapes (an (M, N) int32
// output against 2·M·N·K int8 operations).
//
// A rounding difference moves a code by a whole int8 step, so the float
// arithmetic is the TPU kernel's op for op, with explicitly rounded
// intrinsics (no FMA contraction), true division by every scale, a
// correctly rounded reciprocal square root (__frsqrt_rn) and rintf (round
// half to even). Two things may still flip a code against the plain
// version: the LN sums are taken in another order, and exp2f in the erf
// (like torch's exp and XLA's) is within 2 ulp, not correctly rounded.
//
// Bound: operations at the encoder shape (2·M·D·4D·2 int8 operations against
// x, out and the int8 weights read once). The products run on
// csrc/gemm_pingpong.cuh's s8 instantiation: wgmma m64nNk32 s8·s8 -> s32
// on 128-byte (128-element) K-slices fed by TMA, a persistent grid whose two
// consumer warpgroups each own a tile and take the tensor cores in turn,
// so one's dequantisation, GELU and staged 16-byte stores run under the
// other's products. The float hidden (M × 4D) goes through device memory
// between steps 2 and 3: what a later PR removes first (a CTA that owns
// whole rows of the hidden, or an fp8 hidden).
#include <type_traits>

#include "gemm_pingpong.cuh"

constexpr float SQRT2 = 1.4142135623730951f, LOG2E = 1.4426950408889634f;
constexpr float LN_EPS = 1e-6f;

// mirage_tpu/ops/fused_mlp.py:_erf, op for op
__device__ __forceinline__ float erf_as(float x) {
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
  const float e = exp2f(__fmul_rn(-__fmul_rn(ax, ax), LOG2E));
  return __fmul_rn(s, __fsub_rn(1.f, __fmul_rn(poly, e)));
}

// 0.5·h·(1 + erf(h / √2))
__device__ __forceinline__ float gelu_as(float h) {
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, erf_as(__fdiv_rn(h, SQRT2))));
}

__device__ __forceinline__ float row_scale(float amax) {
  const float s = __fdiv_rn(amax, 127.f);
  return s == 0.f ? 1.f : s;
}

__device__ __forceinline__ signed char quant(float v, float scale) {
  return (signed char)fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
}

// ------------------------------------------------- 1. LN + row quantisation

template <typename T>
__device__ __forceinline__ float ln_value(const T* xr, int i, float mean, float rstd,
                                          const void* gamma, const void* beta, int pdtype) {
  const float y = __fmul_rn(__fsub_rn(to_f(xr[i]), mean), rstd);
  return __fadd_rn(__fmul_rn(y, load_param(gamma, i, pdtype)), load_param(beta, i, pdtype));
}

template <typename T>
__global__ void __launch_bounds__(256)
    ln_quant_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                    const void* __restrict__ beta, int pdtype, signed char* __restrict__ yq,
                    float* __restrict__ rs, int rows, int d) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  float s = 0.f, s2 = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f(xr[i]);
    s = __fadd_rn(s, v);
    s2 = __fadd_rn(s2, __fmul_rn(v, v));
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = __fdiv_rn(s, (float)d);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, (float)d), __fmul_rn(mean, mean)), 0.f);
  const float rstd = __frsqrt_rn(__fadd_rn(var, LN_EPS));
  float amax = 0.f;
  for (int i = lane; i < d; i += 32)
    amax = fmaxf(amax, fabsf(ln_value(xr, i, mean, rstd, gamma, beta, pdtype)));
  const float scale = row_scale(warp_max(amax));
  for (int i = lane; i < d; i += 32)
    yq[row * d + i] = quant(ln_value(xr, i, mean, rstd, gamma, beta, pdtype), scale);
  if (lane == 0) rs[row] = scale;
}

// ------------------------------------------------------- 3. quantise h

__global__ void __launch_bounds__(256)
    quant_rows_kernel(const float* __restrict__ h, const float* __restrict__ amax,
                      signed char* __restrict__ aq, float* __restrict__ rs, int rows, int cols) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float scale = row_scale(amax[row]);
  const float4* hr = reinterpret_cast<const float4*>(h + row * cols);
  char4* qr = reinterpret_cast<char4*>(aq + row * cols);
  for (int i = lane; i < cols / 4; i += 32) {
    const float4 v = hr[i];
    qr[i] = make_char4(quant(v.x, scale), quant(v.y, scale), quant(v.z, scale),
                       quant(v.w, scale));
  }
  if (lane == 0) rs[row] = scale;
}

// ------------------------------------------------------ 2., 4. int8 GEMM

enum { QEPI_FC1 = 0, QEPI_FC2 = 1, QEPI_S32 = 2 };

// The int8 epilogues of csrc/gemm_pingpong.cuh, one kind (QEPI) an
// instantiation. acc = A (M, K) int8 · W (N, K) int8ᵀ in s32; v =
// acc·rs[row]·s[col] + b[col] in float. FC1: h = GELU(v) as float into hout,
// and atomicMax of |h| per row into amax (float bits, zeroed by the caller;
// order-independent). FC2: out = T(x + T(v)). S32: acc itself into out,
// read as int32 (M, N); rs, s and b are not read. Every value goes through
// the warp's staging tile into 16-byte rows.
template <int KIND, typename T = float>
struct EpiS8 {
  struct Params {
    const float* rs;
    const float* s;
    const float* b;
    float* hout;
    float* amax;
    const T* x;
    void* out;
  };
  static constexpr int VECS = KIND == QEPI_S32 ? 0 : 2;  // the weight scales, then the bias
  __device__ __forceinline__ static float vec(const Params& p, int v, long col, int N) {
    return col >= N ? 0.f : v == 0 ? p.s[col] : p.b[col];
  }
  __device__ __forceinline__ static void store(const Params& p, const int (&acc)[128],
                                               const gpp::Scratch& sc, int M, int N, long row0,
                                               long n0) {
    using namespace gpp;
    using OutT = typename std::conditional<KIND == QEPI_S32, int,
                 typename std::conditional<KIND == QEPI_FC1, float, T>::type>::type;
    OutT* stage = reinterpret_cast<OutT*>(sc.stage);
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int h = 0; h < MH; ++h) {
      const long r0 = row0 + h * 64;
      float rsv[2], mx[2] = {0.f, 0.f};
      if constexpr (KIND != QEPI_S32) {
#pragma unroll
        for (int r8 = 0; r8 < 2; ++r8) {
          const long row = r0 + gid + 8 * r8;
          rsv[r8] = row < M ? p.rs[row] : 0.f;
        }
      }
#pragma unroll
      for (int cc = 0; cc < BN / EPI_COLS; ++cc) {
        const long c0 = n0 + cc * EPI_COLS;
        if (c0 >= N) break;
#pragma unroll  // fully: acc must stay in registers (constant indices)
        for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
          const int j = cc * (EPI_COLS / 8) + jj, c = jj * 8 + 2 * tig;
#pragma unroll
          for (int r8 = 0; r8 < 2; ++r8) {
            const int a0 = acc[frag(h, j, r8, 0)], a1 = acc[frag(h, j, r8, 1)];
            if constexpr (KIND == QEPI_S32) {
              stage_pair(stage, gid + 8 * r8, c, a0, a1);
            } else {
              const float2 sv = *reinterpret_cast<const float2*>(sc.vec + cc * EPI_COLS + c);
              const float2 bv =
                  *reinterpret_cast<const float2*>(sc.vec + BN + cc * EPI_COLS + c);
              float v0 = __fadd_rn(__fmul_rn(__fmul_rn((float)a0, rsv[r8]), sv.x), bv.x);
              float v1 = __fadd_rn(__fmul_rn(__fmul_rn((float)a1, rsv[r8]), sv.y), bv.y);
#ifndef MTT_GEMM_SPLIT_NO_EPI
              if constexpr (KIND == QEPI_FC1) {
                v0 = gelu_as(v0);
                v1 = gelu_as(v1);
                mx[r8] = fmaxf(mx[r8], fmaxf(fabsf(v0), fabsf(v1)));
              }
#endif
              stage_pair(stage, gid + 8 * r8, c, v0, v1);
            }
          }
        }
        __syncwarp();
        if constexpr (KIND == QEPI_FC1) {
          store_staged(stage, p.hout, nullptr, M, N, r0, c0);
        } else {
#ifdef MTT_GEMM_SPLIT_NO_EPI
          const OutT* x = nullptr;
#else
          const OutT* x = nullptr;
          if constexpr (KIND == QEPI_FC2) x = p.x;
#endif
          store_staged(stage, static_cast<OutT*>(p.out), x, M, N, r0, c0);
        }
        __syncwarp();
      }
#ifndef MTT_GEMM_SPLIT_NO_EPI
      if constexpr (KIND == QEPI_FC1) {
#pragma unroll
        for (int r8 = 0; r8 < 2; ++r8) {
          float m = fmaxf(mx[r8], __shfl_xor_sync(0xffffffffu, mx[r8], 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          const long row = r0 + gid + 8 * r8;
          if (tig == 0 && row < M) atomicMax(reinterpret_cast<int*>(p.amax + row), __float_as_int(m));
        }
      }
#endif
    }
  }
};

template <int KIND, typename T>
__global__ void __launch_bounds__(384, 1)
    gemm_s8_pingpong(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w,
                     const typename EpiS8<KIND, T>::Params p, int M, int N, int K, int group) {
  gpp::gemm_pingpong<gpp::S8, false, EpiS8<KIND, T>>(&map_a, &map_w, p, M, N, K, group);
}

// ----------------------------------------------------------------- launch

extern "C" int mtt_ln_quant(const void* x, const void* gamma, const void* beta, int pdtype,
                            void* yq, void* rs, int rows, int d, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + 7) / 8);
  if (dtype == MTT_BF16)
    ln_quant_kernel<bf16><<<grid, 256, 0, s>>>(static_cast<const bf16*>(x), gamma, beta, pdtype,
                                               static_cast<signed char*>(yq),
                                               static_cast<float*>(rs), rows, d);
  else
    ln_quant_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), gamma, beta, pdtype,
                                                static_cast<signed char*>(yq),
                                                static_cast<float*>(rs), rows, d);
  return (int)cudaGetLastError();
}

extern "C" int mtt_quant_rows(const void* h, const void* amax, void* aq, void* rs, int rows,
                              int cols, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 4) return (int)cudaErrorInvalidValue;
  quant_rows_kernel<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(amax),
      static_cast<signed char*>(aq), static_cast<float*>(rs), rows, cols);
  return (int)cudaGetLastError();
}

template <int KIND, typename T = float>
static int launch_gemm(const void* a, const void* w, const void* rs, const void* s, const void* b,
                       void* hout, void* amax, const void* x, void* out, int M, int N, int K,
                       cudaStream_t st) {
  constexpr int bytes = gpp::smem_bytes<EpiS8<KIND, T>::VECS>();
  static bool configured = false;
  const int err = gpp::configure_once(gemm_s8_pingpong<KIND, T>, bytes, configured);
  if (err != 0) return err;
  const int sms = sm_count();
  CUtensorMap map_a, map_w;
  const int u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (sms == 0 || !gpp::cached_map_2d(&map_a, {a, M, K, gpp::BM, 128, u8}) ||
      !gpp::cached_map_2d(&map_w, {w, N, K, gpp::W_ROWS, 128, u8}))
    return (int)cudaErrorInvalidValue;
  const gpp::Plan pl = gpp::plan(M, N, sms);
  const typename EpiS8<KIND, T>::Params p{
      static_cast<const float*>(rs), static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<float*>(hout),     static_cast<float*>(amax),    static_cast<const T*>(x),
      out};
  return gpp::launch(gemm_s8_pingpong<KIND, T>, pl, bytes, st, map_a, map_w, p, M, N, K,
                     pl.group);
}

// epi QEPI_FC1: hout (M, N) float, amax (M) float zeroed; QEPI_FC2: x, out
// (M, N) in the working type dtype; QEPI_S32: out (M, N) int32 (rs, s, b,
// x may be null). K a multiple of 16, N of 8.
extern "C" int mtt_gemm_s8(const void* a, const void* w, const void* rs, const void* s,
                           const void* b, int epi, void* hout, void* amax, const void* x,
                           void* out, int M, int N, int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 8 || epi < QEPI_FC1 || epi > QEPI_S32)
    return (int)cudaErrorInvalidValue;
  if (epi == QEPI_FC1 ? (hout == nullptr || amax == nullptr)
                      : (out == nullptr || (epi == QEPI_FC2 && x == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epi == QEPI_S32) return launch_gemm<QEPI_S32>(a, w, rs, s, b, hout, amax, x, out, M, N, K, st);
  if (epi == QEPI_FC1) return launch_gemm<QEPI_FC1>(a, w, rs, s, b, hout, amax, x, out, M, N, K, st);
  if (dtype == MTT_BF16)
    return launch_gemm<QEPI_FC2, bf16>(a, w, rs, s, b, hout, amax, x, out, M, N, K, st);
  return launch_gemm<QEPI_FC2, float>(a, w, rs, s, b, hout, amax, x, out, M, N, K, st);
}
