// Row LayerNorm, y = (x - mean) * rsqrt(var + eps) * gamma + beta.
//
// Replaces the LN prologue of three TPU kernels: mirage_tpu/ops/
// block_attention.py:_attn_half_kernel and :_xattn_half_kernel, and
// mirage_tpu/ops/fused_mlp.py:_mlp_kernel. Those compute the variance in
// one pass as E[x^2] - mean^2; this kernel takes two passes (mean, then the
// mean of squared deviations), which stays exact when |mean| >> std.
//
// Bound: bytes. One warp owns one row and reads it in 16-byte vectors when
// the width allows (8 bf16 or 4 floats per lane and load): once for the
// mean, again (from L1) for the variance and the output, which it writes
// once; statistics are float. First thing a later PR removes: the
// normalised rows are written to device memory and read back by the GEMM
// that follows; fusing LN into that GEMM's A-tile load takes them out.
//
// ONEPASS (the bench's S5 ablation, scripts/bench_vpu.py:_ln "onepass"):
// the mean and E[x^2] from one read of the row, the variance E[x^2] −
// mean² clamped at 0; the main path instantiates the two-pass form only.
#include "common.cuh"

// VEC consecutive elements of T at p (16-byte aligned when VEC > 1), as floats
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f(p[0]);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

template <typename T, int VEC, bool ONEPASS = false>
__global__ void __launch_bounds__(256)
    layernorm_kernel(const T* __restrict__ x, const void* __restrict__ gamma,
                     const void* __restrict__ beta, int wdtype, T* __restrict__ y,
                     int rows, int dim, float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * dim;
  float v[VEC];
  float s = 0.f, s2 = 0.f;
  for (int i = lane * VEC; i < dim; i += 32 * VEC) {
    load_vec<T, VEC>(xr + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s += v[e];
      if constexpr (ONEPASS) s2 += v[e] * v[e];
    }
  }
  const float mean = warp_sum(s) / dim;
  float rstd;
  if constexpr (ONEPASS) {
    rstd = rsqrtf(fmaxf(warp_sum(s2) / dim - mean * mean, 0.f) + eps);
  } else {
    float var = 0.f;
    for (int i = lane * VEC; i < dim; i += 32 * VEC) {
      load_vec<T, VEC>(xr + i, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) var += (v[e] - mean) * (v[e] - mean);
    }
    rstd = rsqrtf(warp_sum(var) / dim + eps);
  }
  T* yr = y + row * dim;
  for (int i = lane * VEC; i < dim; i += 32 * VEC) {
    load_vec<T, VEC>(xr + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      v[e] = (v[e] - mean) * rstd * load_param(gamma, i + e, wdtype) +
             load_param(beta, i + e, wdtype);
    store_vec<T, VEC>(yr + i, v);
  }
}

template <typename T, bool ONEPASS = false>
static void launch(const void* x, const void* gamma, const void* beta, void* y, int rows, int dim,
                   int wdtype, float eps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const dim3 grid((rows + 7) / 8);
  // rows start 16-byte aligned (x and y are) when dim is a multiple of VEC
  if (dim % VEC == 0)
    layernorm_kernel<T, VEC, ONEPASS><<<grid, 256, 0, s>>>(
        static_cast<const T*>(x), gamma, beta, wdtype, static_cast<T*>(y), rows, dim, eps);
  else
    layernorm_kernel<T, 1, ONEPASS><<<grid, 256, 0, s>>>(
        static_cast<const T*>(x), gamma, beta, wdtype, static_cast<T*>(y), rows, dim, eps);
}

extern "C" int mtt_layernorm(const void* x, const void* gamma, const void* beta, void* y,
                             int rows, int dim, int dtype, int wdtype, float eps,
                             void* stream) {
  if (rows <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MTT_BF16)
    launch<bf16>(x, gamma, beta, y, rows, dim, wdtype, eps, s);
  else
    launch<float>(x, gamma, beta, y, rows, dim, wdtype, eps, s);
  return (int)cudaGetLastError();
}

// The one-pass form (S5's ln=onepass), same arguments.
extern "C" int mtt_layernorm_onepass(const void* x, const void* gamma, const void* beta, void* y,
                                     int rows, int dim, int dtype, int wdtype, float eps,
                                     void* stream) {
  if (rows <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MTT_BF16)
    launch<bf16, true>(x, gamma, beta, y, rows, dim, wdtype, eps, s);
  else
    launch<float, true>(x, gamma, beta, y, rows, dim, wdtype, eps, s);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// The LayerNorm tail of two TPU backward kernels, mirage_tpu/ops/
// block_attention.py:_attn_half_bwd_rows (B4) and mirage_tpu/ops/
// fused_mlp.py:_mlp_bwd_rows (B5): from x, gamma and the float cotangent
// dyln of the LN output,
//   dx = dy + inv·(dyhat − mean(dyhat) − yhat·mean(dyhat·yhat)), dyhat = dyln·gamma,
// and float partials of dgamma = Σ dyln·yhat and dbeta = Σ dyln over each
// block's LNB_ROWS rows (the caller sums them). dy (the residual cotangent)
// may be absent; sub_dy gives the no-residual form T(T(dy + ·) − dy) of
// fused_mlp.py:_mlp_block_nores_bwd_vjp. Statistics are recomputed from x in
// two passes, as the forward takes them.
//
// Bound: bytes. Each block first takes its rows' statistics (one warp per
// row), then walks the columns, one thread per column, so the partials of
// dgamma and dbeta stay in registers and every load is coalesced across the
// threads of a row. What a later PR changes first: fusing this into the
// epilogue of the dyln GEMM, so the float dyln stops going through device
// memory.

constexpr int LNB_ROWS = 32;

template <typename T>
__global__ void __launch_bounds__(256)
    layernorm_bwd_kernel(const T* __restrict__ x, const void* __restrict__ gamma, int wdtype,
                         const float* __restrict__ dyln, const T* __restrict__ dy, int sub_dy,
                         T* __restrict__ dx, float* __restrict__ dgp, float* __restrict__ dbp,
                         int rows, int dim, float eps) {
  __shared__ float stats[LNB_ROWS][4];  // mean, inv, mean(dyhat), mean(dyhat·yhat)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long r0 = (long)blockIdx.x * LNB_ROWS;
  for (int rr = warp; rr < LNB_ROWS; rr += 8) {
    const long row = r0 + rr;
    if (row >= rows) break;
    const T* xr = x + row * dim;
    const float* gr = dyln + row * dim;
    float s = 0.f;
    for (int i = lane; i < dim; i += 32) s += to_f(xr[i]);
    const float mean = warp_sum(s) / dim;
    float var = 0.f;
    for (int i = lane; i < dim; i += 32) {
      const float c = to_f(xr[i]) - mean;
      var += c * c;
    }
    const float inv = rsqrtf(warp_sum(var) / dim + eps);
    float a = 0.f, c2 = 0.f;
    for (int i = lane; i < dim; i += 32) {
      const float dyhat = gr[i] * load_param(gamma, i, wdtype);
      a += dyhat;
      c2 += dyhat * (to_f(xr[i]) - mean) * inv;
    }
    a = warp_sum(a);
    c2 = warp_sum(c2);
    if (lane == 0) {
      stats[rr][0] = mean;
      stats[rr][1] = inv;
      stats[rr][2] = a / dim;
      stats[rr][3] = c2 / dim;
    }
  }
  __syncthreads();
  const int nr = rows - r0 < LNB_ROWS ? (int)(rows - r0) : LNB_ROWS;
  for (int c = tid; c < dim; c += 256) {
    const float g = load_param(gamma, c, wdtype);
    float dg = 0.f, db = 0.f;
    for (int rr = 0; rr < nr; ++rr) {
      const long i = (r0 + rr) * dim + c;
      const float yhat = (to_f(x[i]) - stats[rr][0]) * stats[rr][1];
      const float dl = dyln[i];
      dg += dl * yhat;
      db += dl;
      float v = stats[rr][1] * (dl * g - stats[rr][2] - yhat * stats[rr][3]);
      if (dy != nullptr) {
        const float d = to_f(dy[i]);
        v = sub_dy ? round_to<T>(d + v) - d : d + v;
      }
      dx[i] = from_f<T>(v);
    }
    dgp[(long)blockIdx.x * dim + c] = dg;
    dbp[(long)blockIdx.x * dim + c] = db;
  }
}

// dgp and dbp are (ceil(rows / 32), dim) float.
extern "C" int mtt_layernorm_bwd(const void* x, const void* gamma, const void* dyln,
                                 const void* dy, void* dx, void* dgp, void* dbp, int rows,
                                 int dim, int dtype, int wdtype, int sub_dy, float eps,
                                 void* stream) {
  if (rows <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + LNB_ROWS - 1) / LNB_ROWS);
  const float* g = static_cast<const float*>(dyln);
  float* pg = static_cast<float*>(dgp);
  float* pb = static_cast<float*>(dbp);
  if (dtype == MTT_BF16)
    layernorm_bwd_kernel<bf16><<<grid, 256, 0, s>>>(
        static_cast<const bf16*>(x), gamma, wdtype, g, static_cast<const bf16*>(dy), sub_dy,
        static_cast<bf16*>(dx), pg, pb, rows, dim, eps);
  else
    layernorm_bwd_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), gamma, wdtype, g, static_cast<const float*>(dy), sub_dy,
        static_cast<float*>(dx), pg, pb, rows, dim, eps);
  return (int)cudaGetLastError();
}
