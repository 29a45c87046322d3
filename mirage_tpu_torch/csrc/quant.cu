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
// x, out and the int8 weights read once). The products run on mma.sync
// m16n8k32 s8·s8 -> s32 tensor-core MMAs: 128 × 128 tiles of 8 warps (32 ×
// 64 each), K-slices of 64 bytes in a three-stage cp.async ring. The float
// hidden (M × 4D) goes through device memory between steps 2 and 3: what a
// later PR removes first (a CTA that owns whole rows of the hidden, or an
// fp8 hidden), then wgmma.
#include "common.cuh"

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

constexpr int QBM = 128, QBN = 128, QBK = 64, QSTAGES = 3;  // QBK in bytes
constexpr int QDS = QBK + 16;  // padded row stride: ldmatrix rows on distinct banks

// d += a (16×32, row) · b (32×8, col), s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

enum { QEPI_FC1 = 0, QEPI_FC2 = 1, QEPI_S32 = 2 };

// acc = A (M, K) int8 · W (N, K) int8ᵀ in s32; v = acc·rs[row]·s[col] +
// b[col] in float. FC1: h = GELU(v) as float into hout, and atomicMax of
// |h| per row into amax (float bits, zeroed by the caller). FC2: out =
// T(x + T(v)). S32: acc itself into out, read as int32 (M, N); rs, s and b
// are not read.
template <typename T>
__global__ void __launch_bounds__(256)
    gemm_s8_kernel(const signed char* __restrict__ A, const signed char* __restrict__ W,
                   const float* __restrict__ rs, const float* __restrict__ s,
                   const float* __restrict__ b, int epi, float* __restrict__ hout,
                   float* __restrict__ amax, const T* __restrict__ x, T* __restrict__ out, int M,
                   int N, int K) {
  extern __shared__ __align__(16) unsigned char q_smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;  // 32-row group, 64-column half
  const long m0 = (long)blockIdx.y * QBM, n0 = (long)blockIdx.x * QBN;
  const int ktiles = (K + QBK - 1) / QBK;
  auto stage = [&](int st, int kt) {
    unsigned char* as = q_smem + st * (QBM + QBN) * QDS;
    unsigned char* ws = as + QBM * QDS;
    const int k0 = kt * QBK;
    for (int e = tid; e < (QBM + QBN) * (QBK / 16); e += 256) {
      const int r = e / (QBK / 16), c = (e % (QBK / 16)) * 16;
      if (r < QBM) {
        const long g = m0 + r;
        const bool ok = g < M && k0 + c < K;
        cp_async16(smem_u32(as + r * QDS + c), ok ? A + g * K + k0 + c : A, ok ? 16 : 0);
      } else {
        const long g = n0 + r - QBM;
        const bool ok = g < N && k0 + c < K;
        cp_async16(smem_u32(ws + (r - QBM) * QDS + c), ok ? W + g * K + k0 + c : W, ok ? 16 : 0);
      }
    }
  };
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll
  for (int st = 0; st < QSTAGES - 1; ++st) {
    if (st < ktiles) stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<QSTAGES - 2>();  // slice kt has landed
    __syncthreads();               // and every warp is done with slice kt - 1's stage
    if (kt + QSTAGES - 1 < ktiles) stage((kt + QSTAGES - 1) % QSTAGES, kt + QSTAGES - 1);
    cp_async_commit();
    const unsigned char* as = q_smem + (kt % QSTAGES) * (QBM + QBN) * QDS;
    const unsigned char* ws = as + QBM * QDS;
#pragma unroll
    for (int kk = 0; kk < QBK / 32; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], smem_u32(as + (wr * 32 + i * 16 + (lane & 15)) * QDS + kk * 32 +
                                    (lane >> 4) * 16));
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(ws + (wc * 64 + j * 8 + (lane & 7) + ((lane >> 4) << 3)) * QDS +
                                kk * 32 + ((lane >> 3) & 1) * 16));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8_16832(acc[i][j], af[i], r[0], r[1]);
          mma_s8_16832(acc[i][j + 1], af[i], r[2], r[3]);
        }
      }
    }
  }
  // epilogue from the fragments: rows gid, gid + 8 of each 16-row group,
  // columns 8j + 2·tig and + 1 (N is a multiple of 8)
  if (epi == QEPI_S32) {
    int* o = reinterpret_cast<int*>(out);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long row = m0 + wr * 32 + i * 16 + gid + 8 * half;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const long col = n0 + wc * 64 + 8 * j + 2 * tig;
          if (row < M && col < N)
            *reinterpret_cast<int2*>(o + row * N + col) =
                make_int2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
        }
      }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long row = m0 + wr * 32 + i * 16 + gid + 8 * half;
      const bool row_ok = row < M;
      const float r_s = row_ok ? rs[row] : 0.f;
      float mx = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long col = n0 + wc * 64 + 8 * j + 2 * tig;
        if (!row_ok || col >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = __fadd_rn(
              __fmul_rn(__fmul_rn((float)acc[i][j][2 * half + e], r_s), s[col + e]), b[col + e]);
        const long off = row * N + col;
        if (epi == QEPI_FC1) {
          v[0] = gelu_as(v[0]);
          v[1] = gelu_as(v[1]);
          mx = fmaxf(mx, fmaxf(fabsf(v[0]), fabsf(v[1])));
          *reinterpret_cast<float2*>(hout + off) = make_float2(v[0], v[1]);
        } else {
          const float x0 = to_f(x[off]), x1 = to_f(x[off + 1]);
          out[off] = from_f<T>(x0 + to_f(from_f<T>(v[0])));
          out[off + 1] = from_f<T>(x1 + to_f(from_f<T>(v[1])));
        }
      }
      if (epi == QEPI_FC1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (tig == 0 && row_ok) atomicMax(reinterpret_cast<int*>(amax + row), __float_as_int(mx));
      }
    }
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

template <typename T>
static int launch_gemm(const void* a, const void* w, const void* rs, const void* s, const void* b,
                       int epi, void* hout, void* amax, const void* x, void* out, int M, int N,
                       int K, cudaStream_t st) {
  static bool configured = false;
  constexpr int bytes = QSTAGES * (QBM + QBN) * QDS;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_s8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((N + QBN - 1) / QBN, (M + QBM - 1) / QBM);
  gemm_s8_kernel<T><<<grid, 256, bytes, st>>>(
      static_cast<const signed char*>(a), static_cast<const signed char*>(w),
      static_cast<const float*>(rs), static_cast<const float*>(s), static_cast<const float*>(b),
      epi, static_cast<float*>(hout), static_cast<float*>(amax), static_cast<const T*>(x),
      static_cast<T*>(out), M, N, K);
  return (int)cudaGetLastError();
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
  if (dtype == MTT_BF16)
    return launch_gemm<bf16>(a, w, rs, s, b, epi, hout, amax, x, out, M, N, K, st);
  return launch_gemm<float>(a, w, rs, s, b, epi, hout, amax, x, out, M, N, K, st);
}
