// Row LayerNorm for Hopper, forward and backward.
//
// The forward replaces the LN prologue of three TPU kernels: mirage_tpu/ops/
// block_attention.py:_attn_half_kernel :251 and :_xattn_half_kernel :745,
// and mirage_tpu/ops/fused_mlp.py:_mlp_kernel :58. The backward replaces the
// LN tail of two: block_attention.py:_attn_half_bwd_dx_kernel :549 (B4) and
// fused_mlp.py:_mlp_bwd_dx_kernel :453 (B5). Statistics are float and taken
// in two passes (the mean, then the mean of squared deviations), which stays
// exact when |mean| >> std; the TPU kernels take E[x^2] - mean^2 in one.
// ONEPASS (the bench's S5 ablation, scripts/bench_vpu.py:_ln "onepass") is a
// run-time flag of the same kernels: the mean and E[x^2] from one sweep, the
// variance clamped at 0.
//
// Bound: bytes (the forward moves x and y, the backward x, the float dyln,
// dy and dx). What the design does about it:
// - A row lives in registers. A group of TPR lanes (a half-warp at widths up
//   to 256, a warp up to 1024) holds NV 16-byte vectors a lane, all issued
//   before any arithmetic, so a row is read once from device memory; the
//   statistics and the output come from the registers.
// - The widths the paths use (256, 768, 1024) are compile-time classes; a
//   narrower width of the class (a multiple of the vector) is masked at run
//   time. gamma's and beta's type is a template parameter.
// - Each lane group walks rows g, g + G, g + 2G, ... (G: the groups of the
//   grid, a few CTAs an SM). The forward loads gamma and beta once a lane as
//   vectors and keeps them over its rows, and loads the group's next row
//   before it works on this one. The backward keeps its lanes' columns'
//   dgamma and dbeta sums in registers over its rows.
// - dgamma and dbeta are finished on the card (ln_finish): the CTA adds its
//   groups' sums in group order into one partial row, and the partial rows
//   are summed in a fixed tree. No float atomics: a rerun is bit-identical.
// Widths that are not a multiple of the vector (rows not 16-byte aligned) or
// wider than 1024 take the generic kernels: a warp a row, element by element.
//
// Task-strided launches (mtt_layernorm_tasks, mtt_layernorm_bwd_tasks: the
// task-batched decoder tails, each task its own gamma and beta, and its own
// dgamma and dbeta) run the same kernels on a grid (G, T): blockIdx.y is the
// task, whose rows are contiguous, so no CTA's rows straddle two tasks and
// the forward still keeps one gamma/beta over a lane group's rows. The
// backward's partial rows, finish groups and counters are per task; each
// task's dgamma and dbeta are summed in the fixed order of a one-task launch
// of G CTAs. A one-task launch is the grid (G, 1).
//
// ops/runtime.py:layernorm_plan mirrors every launch; tests/
// test_torch_layernorm.py reads the constants below from this file. What a
// later PR fuses first: the normalised rows into the A-tile load of the GEMM
// that follows, and the backward into the epilogue of the dyln product.
#include "common.cuh"

constexpr int LN_THREADS = 256;      // threads a CTA
constexpr int LN_BWD_CTAS = 1;       // backward CTAs an SM
constexpr int LN_FINISH_CTAS = 12;   // CTAs whose partial rows one finisher sums
constexpr int LN_GENERIC_ROWS = 32;  // rows a block of the generic backward
// forward CTAs an SM: bf16 2, float 1 (its rows take twice the registers)
template <typename T>
constexpr int LN_FWD_CTAS = sizeof(T) == 2 ? 2 : 1;

// lanes a row at width class W
__host__ __device__ constexpr int ln_tpr(int w) { return w == 256 ? 16 : 32; }

// 16 bytes of T as floats, and back
template <typename T>
struct Vec16;
template <>
struct Vec16<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void get(const uint4& u, float (&v)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 put(const float (&v)[8]) {
    return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                      pack_bf16(v[6], v[7]));
  }
};
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void get(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 put(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

// N consecutive elements of P at p as floats: 16-byte loads (8-byte for four
// bf16) through the read-only path
template <typename P, int N>
__device__ __forceinline__ void load_vec(const P* __restrict__ p, float (&v)[N]) {
  if constexpr (sizeof(P) == 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else if constexpr (N == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      float w[8];
      Vec16<bf16>::get(__ldg(reinterpret_cast<const uint4*>(p + i)), w);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i + e] = w[e];
    }
  }
}

template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row `row` of an (rows, dim) array of T: this lane's vectors j·TPR + lane,
// zeros past the width (own[j] false) or past the last row.
template <typename T, int NV, int TPR>
__device__ __forceinline__ void load_row(const T* __restrict__ a, long row, int rows, int dim,
                                         int lane, const bool (&own)[NV], uint4 (&u)[NV]) {
  const uint4* p = reinterpret_cast<const uint4*>(a + row * dim) + lane;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    u[j] = row < rows && own[j] ? __ldg(p + j * TPR) : make_uint4(0u, 0u, 0u, 0u);
}

// ------------------------------------------------------------------ forward

template <typename T, typename P, int W>
__global__ void __launch_bounds__(LN_THREADS, LN_FWD_CTAS<T>)
    layernorm_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                     const P* __restrict__ beta, T* __restrict__ y, int rows, int dim, int onepass,
                     float eps) {
  using V = Vec16<T>;
  constexpr int VEC = V::N, TPR = ln_tpr(W), NV = W / (VEC * TPR), GROUPS = LN_THREADS / TPR;
  const int lane = threadIdx.x % TPR, nvec = dim / VEC;
  // task blockIdx.y: its `rows` rows and its gamma and beta
  x += (long)blockIdx.y * rows * dim;
  y += (long)blockIdx.y * rows * dim;
  gamma += (long)blockIdx.y * dim;
  beta += (long)blockIdx.y * dim;
  const long stride = (long)gridDim.x * GROUPS;
  long row = (long)blockIdx.x * GROUPS + threadIdx.x / TPR;
  // the warp's lane groups move together, so each shuffle sees the whole warp
  const long first = row - (threadIdx.x % 32) / TPR;
  bool own[NV];
  float g[NV][VEC], b[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = j * TPR + lane;
    own[j] = v < nvec;
    if (own[j]) {
      load_vec<P, VEC>(gamma + v * VEC, g[j]);
      load_vec<P, VEC>(beta + v * VEC, b[j]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) g[j][e] = b[j][e] = 0.f;
    }
  }
  uint4 cur[NV], nxt[NV];
  load_row<T, NV, TPR>(x, row, rows, dim, lane, own, cur);
  for (long r = first; r < rows; r += stride, row += stride) {
    load_row<T, NV, TPR>(x, row + stride, rows, dim, lane, own, nxt);
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float v[VEC];
      V::get(cur[j], v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s += v[e];
        s2 += v[e] * v[e];
      }
    }
    const float mean = group_sum<TPR>(s) / dim;
    float var;
    if (onepass) {
      var = fmaxf(group_sum<TPR>(s2) / dim - mean * mean, 0.f);
    } else {
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!own[j]) continue;
        float v[VEC];
        V::get(cur[j], v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) q += (v[e] - mean) * (v[e] - mean);
      }
      var = group_sum<TPR>(q) / dim;
    }
    const float rstd = rsqrtf(var + eps);
    if (row < rows) {
      uint4* out = reinterpret_cast<uint4*>(y + row * dim) + lane;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!own[j]) continue;
        float v[VEC];
        V::get(cur[j], v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = (v[e] - mean) * rstd * g[j][e] + b[j][e];
        out[j * TPR] = V::put(v);
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
  }
}

// Any width: a warp a row, element by element (the row read from L1 again
// for the variance and the output).
template <typename T, typename P>
__global__ void __launch_bounds__(LN_THREADS)
    layernorm_generic_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                             const P* __restrict__ beta, T* __restrict__ y, int rows, int dim,
                             int onepass, float eps) {
  constexpr int WARPS = LN_THREADS / 32;
  const int lane = threadIdx.x & 31;
  x += (long)blockIdx.y * rows * dim;
  y += (long)blockIdx.y * rows * dim;
  gamma += (long)blockIdx.y * dim;
  beta += (long)blockIdx.y * dim;
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * WARPS) {
    const T* xr = x + (long)row * dim;
    float s = 0.f, s2 = 0.f;
    for (int i = lane; i < dim; i += 32) {
      const float v = to_f(xr[i]);
      s += v;
      s2 += v * v;
    }
    const float mean = warp_sum(s) / dim;
    float var;
    if (onepass) {
      var = fmaxf(warp_sum(s2) / dim - mean * mean, 0.f);
    } else {
      float q = 0.f;
      for (int i = lane; i < dim; i += 32) q += (to_f(xr[i]) - mean) * (to_f(xr[i]) - mean);
      var = warp_sum(q) / dim;
    }
    const float rstd = rsqrtf(var + eps);
    T* yr = y + (long)row * dim;
    for (int i = lane; i < dim; i += 32)
      yr[i] = from_f<T>((to_f(xr[i]) - mean) * rstd * to_f(gamma[i]) + to_f(beta[i]));
  }
}

template <typename T, typename P>
static int launch_fwd(const void* x, const void* gamma, const void* beta, void* y, int rows,
                      int tasks, int dim, int width, int grid, int onepass, float eps,
                      cudaStream_t s) {
  const dim3 blocks(grid, tasks);
  const T* xt = static_cast<const T*>(x);
  const P* gt = static_cast<const P*>(gamma);
  const P* bt = static_cast<const P*>(beta);
  T* yt = static_cast<T*>(y);
  switch (width) {
    case 256:
      layernorm_kernel<T, P, 256><<<blocks, LN_THREADS, 0, s>>>(xt, gt, bt, yt, rows, dim,
                                                              onepass, eps);
      break;
    case 768:
      layernorm_kernel<T, P, 768><<<blocks, LN_THREADS, 0, s>>>(xt, gt, bt, yt, rows, dim,
                                                              onepass, eps);
      break;
    case 1024:
      layernorm_kernel<T, P, 1024><<<blocks, LN_THREADS, 0, s>>>(xt, gt, bt, yt, rows, dim,
                                                               onepass, eps);
      break;
    default:
      layernorm_generic_kernel<T, P><<<blocks, LN_THREADS, 0, s>>>(xt, gt, bt, yt, rows, dim,
                                                                 onepass, eps);
  }
  return (int)cudaGetLastError();
}

// The width class (256, 768 or 1024; 0: the generic kernel) and the grid
// are layernorm_plan's; anything else is refused before a launch.
static bool plan_ok(int rows, int tasks, int dim, int dtype, int width, int grid) {
  const int vec = dtype == MTT_BF16 ? 8 : 4;
  if (rows <= 0 || tasks <= 0 || tasks > 65535 || dim <= 0 || grid <= 0) return false;
  if (width == 0) return true;
  return (width == 256 || width == 768 || width == 1024) && dim % vec == 0 && dim <= width;
}

static int ln_forward(const void* x, const void* gamma, const void* beta, void* y, int rows,
                      int tasks, int dim, int dtype, int wdtype, int width, int grid,
                      int onepass, float eps, void* stream) {
  if (!plan_ok(rows, tasks, dim, dtype, width, grid)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MTT_BF16)
    return wdtype == MTT_BF16 ? launch_fwd<bf16, bf16>(x, gamma, beta, y, rows, tasks, dim,
                                                       width, grid, onepass, eps, s)
                              : launch_fwd<bf16, float>(x, gamma, beta, y, rows, tasks, dim,
                                                        width, grid, onepass, eps, s);
  return wdtype == MTT_BF16 ? launch_fwd<float, bf16>(x, gamma, beta, y, rows, tasks, dim, width,
                                                      grid, onepass, eps, s)
                            : launch_fwd<float, float>(x, gamma, beta, y, rows, tasks, dim,
                                                       width, grid, onepass, eps, s);
}

extern "C" int mtt_layernorm(const void* x, const void* gamma, const void* beta, void* y,
                             int rows, int dim, int dtype, int wdtype, int width, int grid,
                             float eps, void* stream) {
  return ln_forward(x, gamma, beta, y, rows, 1, dim, dtype, wdtype, width, grid, 0, eps, stream);
}

// The one-pass form (S5's ln=onepass), same arguments.
extern "C" int mtt_layernorm_onepass(const void* x, const void* gamma, const void* beta, void* y,
                                     int rows, int dim, int dtype, int wdtype, int width,
                                     int grid, float eps, void* stream) {
  return ln_forward(x, gamma, beta, y, rows, 1, dim, dtype, wdtype, width, grid, 1, eps, stream);
}

// The task-strided form: x and y (tasks, rows, dim), gamma and beta (tasks,
// dim); `grid` CTAs a task.
extern "C" int mtt_layernorm_tasks(const void* x, const void* gamma, const void* beta, void* y,
                                   int rows, int tasks, int dim, int dtype, int wdtype, int width,
                                   int grid, float eps, void* stream) {
  return ln_forward(x, gamma, beta, y, rows, tasks, dim, dtype, wdtype, width, grid, 0, eps,
                    stream);
}

// ---------------------------------------------------------------- backward
//
// From x, gamma and the float cotangent dyln of the LN output:
//   dx = dy + inv·(dyhat − mean(dyhat) − yhat·mean(dyhat·yhat)), dyhat = dyln·gamma,
// in x's type; dy (the residual cotangent) may be absent, and sub_dy gives
// the no-residual form T(T(dy + ·) − dy) of fused_mlp.py:
// _mlp_block_nores_bwd_vjp. dgamma = Σ dyln·yhat and dbeta = Σ dyln in
// float. The statistics are recomputed from x in two passes, as the forward
// takes them.

// Finishes dgamma and dbeta from the CTAs' partial rows (part: the grid's
// rows of 2·dim floats, dgamma's then dbeta's, then one row a finish group).
// The CTAs are taken in finish groups of LN_FINISH_CTAS; the last CTA of a
// group to arrive (counters[1 + group]) sums its group's rows in CTA order
// into the group's row, and the last group to finish (counters[0]) sums the
// group rows in order into dgamma and dbeta. Each finisher sets its counter
// back to 0, so the counters (zeroed once by the launcher) are 0 between
// launches; a refused launch never moves them.
__device__ __forceinline__ void ln_finish(float* __restrict__ part, float* __restrict__ dgamma,
                                          float* __restrict__ dbeta, int* __restrict__ counters,
                                          int dim) {
  __shared__ int ticket;
  const int grid = gridDim.x, width = 2 * dim;
  const int fg = blockIdx.x / LN_FINISH_CTAS;
  const int groups = (grid + LN_FINISH_CTAS - 1) / LN_FINISH_CTAS;
  const int first = fg * LN_FINISH_CTAS, n = min(grid - first, LN_FINISH_CTAS);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counters + 1 + fg, 1);
  __syncthreads();
  if (ticket != n - 1) return;
  __threadfence();
  float* grow = part + (long)(grid + fg) * width;
  for (int i = threadIdx.x; i < width; i += LN_THREADS) {
    float s = 0.f;
    for (int c = 0; c < n; ++c) s += __ldcg(part + (long)(first + c) * width + i);
    grow[i] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    counters[1 + fg] = 0;
    ticket = atomicAdd(counters, 1);
  }
  __syncthreads();
  if (ticket != groups - 1) return;
  __threadfence();
  for (int i = threadIdx.x; i < width; i += LN_THREADS) {
    float s = 0.f;
    for (int k = 0; k < groups; ++k) s += __ldcg(part + (long)(grid + k) * width + i);
    if (i < dim)
      dgamma[i] = s;
    else
      dbeta[i - dim] = s;
  }
  if (threadIdx.x == 0) counters[0] = 0;
}

// Task blockIdx.y of a backward launch: its rows of x, dyln, dy and dx, its
// gamma, its partial and finish-group rows (gridDim.x + groups rows of
// 2·dim), its dgamma and dbeta (`dim` apart) and its 1 + groups counters.
#define LN_BWD_TASK_OFFSETS()                                               \
  do {                                                                      \
    const long task_ = blockIdx.y, rows_off_ = task_ * rows * dim;          \
    const int groups_ = (gridDim.x + LN_FINISH_CTAS - 1) / LN_FINISH_CTAS;  \
    x += rows_off_;                                                         \
    dyln += rows_off_;                                                      \
    dx += rows_off_;                                                        \
    if (dy != nullptr) dy += rows_off_;                                     \
    gamma += task_ * dim;                                                   \
    part += task_ * (gridDim.x + groups_) * 2 * dim;                        \
    dgamma += task_ * dim;                                                  \
    dbeta += task_ * dim;                                                   \
    counters += task_ * (1 + groups_);                                      \
  } while (0)

template <typename T, typename P, int W>
__global__ void __launch_bounds__(LN_THREADS, LN_BWD_CTAS)
    layernorm_bwd_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                         const float* __restrict__ dyln, const T* __restrict__ dy, int sub_dy,
                         T* __restrict__ dx, float* __restrict__ part, float* __restrict__ dgamma,
                         float* __restrict__ dbeta, int* __restrict__ counters, int rows, int dim,
                         float eps) {
  using V = Vec16<T>;
  constexpr int VEC = V::N, TPR = ln_tpr(W), NV = W / (VEC * TPR), GROUPS = LN_THREADS / TPR;
  __shared__ float red[2][W];  // the CTA's dgamma and dbeta sums
  const int lane = threadIdx.x % TPR, group = threadIdx.x / TPR, nvec = dim / VEC;
  LN_BWD_TASK_OFFSETS();
  const long stride = (long)gridDim.x * GROUPS;
  long row = (long)blockIdx.x * GROUPS + group;
  const long first = row - (threadIdx.x % 32) / TPR;
  bool own[NV];
  float pg[NV][VEC], pb[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    own[j] = j * TPR + lane < nvec;
#pragma unroll
    for (int e = 0; e < VEC; ++e) pg[j][e] = pb[j][e] = 0.f;
  }
  for (long r = first; r < rows; r += stride, row += stride) {
    const bool live = row < rows;
    const long base = row * dim + (long)lane * VEC;
    uint4 xu[NV], du[NV];
    float gl[NV][VEC];
    load_row<T, NV, TPR>(x, row, rows, dim, lane, own, xu);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (live && own[j]) {
        load_vec<float, VEC>(dyln + base + j * TPR * VEC, gl[j]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) gl[j][e] = 0.f;
      }
    }
    if (dy != nullptr) load_row<T, NV, TPR>(dy, row, rows, dim, lane, own, du);
    float xv[NV][VEC];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      V::get(xu[j], xv[j]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += xv[j][e];
    }
    const float mean = group_sum<TPR>(s) / dim;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!own[j]) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) q += (xv[j][e] - mean) * (xv[j][e] - mean);
    }
    const float inv = rsqrtf(group_sum<TPR>(q) / dim + eps);
    // dyhat = dyln·gamma, with gamma from L1 (gl becomes dyhat; dyln is
    // added to the partial sums first)
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float g[VEC];
      if (own[j]) {
        load_vec<P, VEC>(gamma + (j * TPR + lane) * VEC, g);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) g[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float yhat = (xv[j][e] - mean) * inv;
        pg[j][e] += gl[j][e] * yhat;
        pb[j][e] += gl[j][e];
        gl[j][e] *= g[e];
        a += gl[j][e];
        c += gl[j][e] * yhat;
      }
    }
    a = group_sum<TPR>(a) / dim;
    c = group_sum<TPR>(c) / dim;
    if (live) {
      uint4* out = reinterpret_cast<uint4*>(dx + row * dim) + lane;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!own[j]) continue;
        float v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          v[e] = inv * (gl[j][e] - a - (xv[j][e] - mean) * inv * c);
        if (dy != nullptr) {
          float d[VEC];
          V::get(du[j], d);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            v[e] = sub_dy ? round_to<T>(d[e] + v[e]) - d[e] : d[e] + v[e];
        }
        out[j * TPR] = V::put(v);
      }
    }
  }
  // the CTA's lane groups in order, one partial row
  for (int k = 0; k < GROUPS; ++k) {
    if (group == k) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!own[j]) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int col = (j * TPR + lane) * VEC + e;
          red[0][col] = k ? red[0][col] + pg[j][e] : pg[j][e];
          red[1][col] = k ? red[1][col] + pb[j][e] : pb[j][e];
        }
      }
    }
    __syncthreads();
  }
  float* mine = part + (long)blockIdx.x * 2 * dim;
  for (int i = threadIdx.x; i < dim; i += LN_THREADS) {
    mine[i] = red[0][i];
    mine[dim + i] = red[1][i];
  }
  ln_finish(part, dgamma, dbeta, counters, dim);
}

// Any width: a CTA walks blocks of LN_GENERIC_ROWS rows (blockIdx.x, + grid,
// ...): a warp a row takes its statistics, then a thread a column adds the
// block's rows into the CTA's sums in shared memory.
template <typename T, typename P>
__global__ void __launch_bounds__(LN_THREADS, LN_BWD_CTAS)
    layernorm_bwd_generic_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                                 const float* __restrict__ dyln, const T* __restrict__ dy,
                                 int sub_dy, T* __restrict__ dx, float* __restrict__ part,
                                 float* __restrict__ dgamma, float* __restrict__ dbeta,
                                 int* __restrict__ counters, int rows, int dim, float eps) {
  extern __shared__ float red[];  // dgamma's and dbeta's sums (2·dim), then stats
  float(*stats)[4] = reinterpret_cast<float(*)[4]>(red + 2 * dim);  // mean, inv, means
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  LN_BWD_TASK_OFFSETS();
  for (int i = tid; i < 2 * dim; i += LN_THREADS) red[i] = 0.f;
  for (long blk = blockIdx.x; blk * LN_GENERIC_ROWS < rows; blk += gridDim.x) {
    const long r0 = blk * LN_GENERIC_ROWS;
    const int nr = rows - r0 < LN_GENERIC_ROWS ? (int)(rows - r0) : LN_GENERIC_ROWS;
    __syncthreads();  // the previous block's statistics are read
    for (int rr = warp; rr < nr; rr += LN_THREADS / 32) {
      const T* xr = x + (r0 + rr) * dim;
      const float* gr = dyln + (r0 + rr) * dim;
      float s = 0.f;
      for (int i = lane; i < dim; i += 32) s += to_f(xr[i]);
      const float mean = warp_sum(s) / dim;
      float var = 0.f;
      for (int i = lane; i < dim; i += 32) var += (to_f(xr[i]) - mean) * (to_f(xr[i]) - mean);
      const float inv = rsqrtf(warp_sum(var) / dim + eps);
      float a = 0.f, c = 0.f;
      for (int i = lane; i < dim; i += 32) {
        const float dyhat = gr[i] * to_f(gamma[i]);
        a += dyhat;
        c += dyhat * (to_f(xr[i]) - mean) * inv;
      }
      a = warp_sum(a);
      c = warp_sum(c);
      if (lane == 0) {
        stats[rr][0] = mean;
        stats[rr][1] = inv;
        stats[rr][2] = a / dim;
        stats[rr][3] = c / dim;
      }
    }
    __syncthreads();
    for (int col = tid; col < dim; col += LN_THREADS) {
      const float g = to_f(gamma[col]);
      float dg = 0.f, db = 0.f;
      for (int rr = 0; rr < nr; ++rr) {
        const long i = (r0 + rr) * dim + col;
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
      red[col] += dg;
      red[dim + col] += db;
    }
  }
  __syncthreads();
  float* mine = part + (long)blockIdx.x * 2 * dim;
  for (int i = tid; i < 2 * dim; i += LN_THREADS) mine[i] = red[i];
  ln_finish(part, dgamma, dbeta, counters, dim);
}

template <typename T, typename P>
static int launch_bwd(const void* x, const void* gamma, const void* dyln, const void* dy,
                      int sub_dy, void* dx, void* part, void* dgamma, void* dbeta,
                      void* counters, int rows, int tasks, int dim, int width, int grid,
                      float eps, cudaStream_t s) {
  const dim3 blocks(grid, tasks);
  const T* xt = static_cast<const T*>(x);
  const P* gt = static_cast<const P*>(gamma);
  const float* gl = static_cast<const float*>(dyln);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  float* pt = static_cast<float*>(part);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  int* cnt = static_cast<int*>(counters);
  switch (width) {
    case 256:
      layernorm_bwd_kernel<T, P, 256><<<blocks, LN_THREADS, 0, s>>>(
          xt, gt, gl, dyt, sub_dy, dxt, pt, dg, db, cnt, rows, dim, eps);
      break;
    case 768:
      layernorm_bwd_kernel<T, P, 768><<<blocks, LN_THREADS, 0, s>>>(
          xt, gt, gl, dyt, sub_dy, dxt, pt, dg, db, cnt, rows, dim, eps);
      break;
    case 1024:
      layernorm_bwd_kernel<T, P, 1024><<<blocks, LN_THREADS, 0, s>>>(
          xt, gt, gl, dyt, sub_dy, dxt, pt, dg, db, cnt, rows, dim, eps);
      break;
    default: {
      static SmemLimit limit(48 * 1024);
      const size_t smem = (2 * (size_t)dim + 4 * LN_GENERIC_ROWS) * sizeof(float);
      const int err = set_smem(layernorm_bwd_generic_kernel<T, P>, smem, limit);
      if (err) return err;
      layernorm_bwd_generic_kernel<T, P><<<blocks, LN_THREADS, smem, s>>>(
          xt, gt, gl, dyt, sub_dy, dxt, pt, dg, db, cnt, rows, dim, eps);
    }
  }
  return (int)cudaGetLastError();
}

// part: (grid + ceil(grid / LN_FINISH_CTAS), 2, dim) float scratch;
// dgamma, dbeta: (dim,) float; counters: 1 + ceil(grid / LN_FINISH_CTAS)
// ints, zero.
static int ln_backward(const void* x, const void* gamma, const void* dyln, const void* dy,
                       void* dx, void* part, void* dgamma, void* dbeta, void* counters, int rows,
                       int tasks, int dim, int dtype, int wdtype, int sub_dy, int width, int grid,
                       float eps, void* stream) {
  if (!plan_ok(rows, tasks, dim, dtype, width, grid) || (sub_dy && dy == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == MTT_BF16)
    return wdtype == MTT_BF16
               ? launch_bwd<bf16, bf16>(x, gamma, dyln, dy, sub_dy, dx, part, dgamma, dbeta,
                                        counters, rows, tasks, dim, width, grid, eps, s)
               : launch_bwd<bf16, float>(x, gamma, dyln, dy, sub_dy, dx, part, dgamma, dbeta,
                                         counters, rows, tasks, dim, width, grid, eps, s);
  return wdtype == MTT_BF16
             ? launch_bwd<float, bf16>(x, gamma, dyln, dy, sub_dy, dx, part, dgamma, dbeta,
                                       counters, rows, tasks, dim, width, grid, eps, s)
             : launch_bwd<float, float>(x, gamma, dyln, dy, sub_dy, dx, part, dgamma, dbeta,
                                        counters, rows, tasks, dim, width, grid, eps, s);
}

extern "C" int mtt_layernorm_bwd(const void* x, const void* gamma, const void* dyln,
                                 const void* dy, void* dx, void* part, void* dgamma, void* dbeta,
                                 void* counters, int rows, int dim, int dtype, int wdtype,
                                 int sub_dy, int width, int grid, float eps, void* stream) {
  return ln_backward(x, gamma, dyln, dy, dx, part, dgamma, dbeta, counters, rows, 1, dim, dtype,
                     wdtype, sub_dy, width, grid, eps, stream);
}

// The task-strided form: x, dyln, dy and dx (tasks, rows, dim), gamma
// (tasks, dim); part (tasks, grid + ceil(grid / LN_FINISH_CTAS), 2, dim)
// float scratch; dgamma and dbeta (tasks, dim) float; counters tasks · (1 +
// ceil(grid / LN_FINISH_CTAS)) ints, zero; `grid` CTAs a task.
extern "C" int mtt_layernorm_bwd_tasks(const void* x, const void* gamma, const void* dyln,
                                       const void* dy, void* dx, void* part, void* dgamma,
                                       void* dbeta, void* counters, int rows, int tasks, int dim,
                                       int dtype, int wdtype, int sub_dy, int width, int grid,
                                       float eps, void* stream) {
  return ln_backward(x, gamma, dyln, dy, dx, part, dgamma, dbeta, counters, rows, tasks, dim,
                     dtype, wdtype, sub_dy, width, grid, eps, stream);
}
