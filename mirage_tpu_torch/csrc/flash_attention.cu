// Flash attention for any number of queries and keys: softmax(q·kᵀ·scale)·v
// for every (batch, head), its per-row log-sum-exp, and its backward.
//
// Replaces mirage_tpu/ops/flash_attention.py:_flash_fwd / _attn_kernel and
// _flash_bwd / _attn_bwd_kernel (B8, the attention core the JAX package runs
// at 512 keys or more: the encoder at 1025 tokens in segmentation tuning, the
// decoders' cross-attention over 769 context tokens). The TPU kernels keep a
// query block's scores against ALL keys of one (batch, head) in VMEM (keys
// padded to 128 and masked); an SM's shared memory cannot hold that, so the
// keys stream through shared memory in chunks (FlashAttention-2):
//
// - the bf16 forward: csrc/attention_fwd.cuh (TMA, wgmma, two consumer
//   warpgroups in ping-pong), shared with csrc/attention.cu; the running max
//   and sum in float, keys at or past nk masked to -inf, queries past nq not
//   written, the output divided by the float row sum at the end, and lse =
//   m + log2(l) (log2 units) written for the backward.
// - the bf16 backward: csrc/attention_bwd.cuh (TMA, wgmma), shared with
//   csrc/attention_bwd.cu: a dQ kernel that reads the forward's lse and takes
//   delta = rowsum(P∘dP) from the float P and dP (the TPU's delta, not
//   rowsum(dO∘O) from the rounded output), then a dK/dV kernel that sums dK
//   and dV in float over every query and rounds each once (the TPU sums dk
//   and dv in float across its sequential query grid and casts once,
//   _flash_bwd :196-217). No atomics: every sum in a fixed order.
//
// Q, K, V, O, dO, dQ, dK and dV are (B, rows, ·) views addressed through
// batch and row strides and a per-head column offset, so a packed qkv (or a
// packed kv) is read and its gradient written in place, never transposed.
//
// Numerics against the TPU kernel: it rounds the unnormalised exp(s − m)
// with m the row max over ALL keys; online rescaling rounds exp(s − m_run)
// against the running max of the chunks so far and rescales the float
// accumulator when the max grows. The rounded values differ in their last
// bf16 bit where the max changes; the float32 path has no rounding and
// matches to float precision.
//
// Bound: operations at B8's lengths (4·nq·nk·dh FLOPs a head forward, 10
// backward, against reading q, k, v (and dO) once). The float path runs one
// warp per query (or key) row on plain FMAs, for the float32 checks.
#include <math.h>

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"

constexpr int MAX_DH = 128;
constexpr float LOG2E = 1.4426950408889634f;

// Batch and row strides (elements) of q, k, v, dout (or o), dq, dk, dv, in
// that order; a kernel parameter passed by value.
struct Strides {
  long long s[14];
};

// --------------------------------------------------------------- float path
//
// One warp per query row (forward, dq) or key row (dk/dv); the lanes take
// 32 keys (queries) at a time, each one dot product, and each lane owns the
// output columns lane, lane + 32, ... of the row. Any nq, nk; dh ≤ 128.

constexpr int FW = 8;  // warps (rows) per block

__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int nq, int nk, int heads, int dh,
                         const Strides st, float scale_log2) {
  __shared__ float qrow[FW][MAX_DH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, r = blockIdx.x * FW + warp;
  if (r >= nq) return;
  const float* qr = q + b * st.s[0] + (long long)r * st.s[1] + (long long)h * dh;
  const float* kb = k + b * st.s[2] + (long long)h * dh;
  const float* vb = v + b * st.s[4] + (long long)h * dh;
  for (int d = lane; d < dh; d += 32) qrow[warp][d] = qr[d];
  __syncwarp();
  float m = -INFINITY, l = 0.f, acc[MAX_DH / 32] = {};
  for (int j0 = 0; j0 < nk; j0 += 32) {
    const int j = j0 + lane;
    float s = -INFINITY;
    if (j < nk) {
      const float* kj = kb + (long long)j * st.s[3];
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qrow[warp][d], kj[d], dot);
      s = dot * scale_log2;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float corr = exp2f(m - m_new);
    m = m_new;
    const float p = j < nk ? exp2f(s - m) : 0.f;
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int c = 0; c < MAX_DH / 32; ++c) acc[c] *= corr;
    const int jn = min(32, nk - j0);
    for (int t = 0; t < jn; ++t) {
      const float pt = __shfl_sync(0xffffffffu, p, t);
      const float* vt = vb + (long long)(j0 + t) * st.s[5];
#pragma unroll
      for (int c = 0; c < MAX_DH / 32; ++c)
        if (lane + 32 * c < dh) acc[c] = fmaf(pt, vt[lane + 32 * c], acc[c]);
    }
  }
  float* orow = o + b * st.s[6] + (long long)r * st.s[7] + (long long)h * dh;
#pragma unroll
  for (int c = 0; c < MAX_DH / 32; ++c)
    if (lane + 32 * c < dh) orow[lane + 32 * c] = acc[c] / l;
  if (lane == 0) lse[((long long)b * heads + h) * nq + r] = m + log2f(l);
}

__global__ void __launch_bounds__(256)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            float* __restrict__ dq, const float* __restrict__ lse,
                            float* __restrict__ delta, int nq, int nk, int heads, int dh,
                            const Strides st, float scale) {
  __shared__ float qrow[FW][MAX_DH], drow[FW][MAX_DH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, r = blockIdx.x * FW + warp;
  if (r >= nq) return;
  const float* kb = k + b * st.s[2] + (long long)h * dh;
  const float* vb = v + b * st.s[4] + (long long)h * dh;
  const float* qr = q + b * st.s[0] + (long long)r * st.s[1] + (long long)h * dh;
  const float* dr = dout + b * st.s[6] + (long long)r * st.s[7] + (long long)h * dh;
  for (int d = lane; d < dh; d += 32) {
    qrow[warp][d] = qr[d];
    drow[warp][d] = dr[d];
  }
  __syncwarp();
  const long long srow = ((long long)b * heads + h) * nq + r;
  const float sl2 = scale * LOG2E, ls = lse[srow];
  // lane j's key: P (float) and dP of this row
  auto p_dp = [&](int j, float* p, float* dp) {
    const float* kj = kb + (long long)j * st.s[3];
    const float* vj = vb + (long long)j * st.s[5];
    float s = 0.f, t = 0.f;
    for (int d = 0; d < dh; ++d) {
      s = fmaf(qrow[warp][d], kj[d], s);
      t = fmaf(drow[warp][d], vj[d], t);
    }
    *p = exp2f(s * sl2 - ls);
    *dp = t;
  };
  float u = 0.f;
  for (int j = lane; j < nk; j += 32) {
    float p, dp;
    p_dp(j, &p, &dp);
    u += p * dp;
  }
  const float dl = warp_sum(u);
  float acc[MAX_DH / 32] = {};
  for (int j0 = 0; j0 < nk; j0 += 32) {
    const int j = j0 + lane;
    float ds = 0.f;
    if (j < nk) {
      float p, dp;
      p_dp(j, &p, &dp);
      ds = p * (dp - dl) * scale;
    }
    const int jn = min(32, nk - j0);
    for (int t = 0; t < jn; ++t) {
      const float dst = __shfl_sync(0xffffffffu, ds, t);
      const float* kt = kb + (long long)(j0 + t) * st.s[3];
#pragma unroll
      for (int c = 0; c < MAX_DH / 32; ++c)
        if (lane + 32 * c < dh) acc[c] = fmaf(dst, kt[lane + 32 * c], acc[c]);
    }
  }
  float* out = dq + b * st.s[8] + (long long)r * st.s[9] + (long long)h * dh;
#pragma unroll
  for (int c = 0; c < MAX_DH / 32; ++c)
    if (lane + 32 * c < dh) out[lane + 32 * c] = acc[c];
  if (lane == 0) delta[srow] = dl;
}

__global__ void __launch_bounds__(256)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             float* __restrict__ dk, float* __restrict__ dv,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             int nq, int nk, int heads, int dh, const Strides st,
                             float scale) {
  __shared__ float krow[FW][MAX_DH], vrow[FW][MAX_DH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, r = blockIdx.x * FW + warp;
  if (r >= nk) return;
  const float* qb = q + b * st.s[0] + (long long)h * dh;
  const float* db = dout + b * st.s[6] + (long long)h * dh;
  const float* kr = k + b * st.s[2] + (long long)r * st.s[3] + (long long)h * dh;
  const float* vr = v + b * st.s[4] + (long long)r * st.s[5] + (long long)h * dh;
  for (int d = lane; d < dh; d += 32) {
    krow[warp][d] = kr[d];
    vrow[warp][d] = vr[d];
  }
  __syncwarp();
  const float* lb = lse + ((long long)b * heads + h) * nq;
  const float* dlb = delta + ((long long)b * heads + h) * nq;
  const float sl2 = scale * LOG2E;
  float gk[MAX_DH / 32] = {}, gv[MAX_DH / 32] = {};
  for (int i0 = 0; i0 < nq; i0 += 32) {
    const int i = i0 + lane;
    float p = 0.f, ds = 0.f;
    if (i < nq) {
      const float* qi = qb + (long long)i * st.s[1];
      const float* di = db + (long long)i * st.s[7];
      float s = 0.f, t = 0.f;
      for (int d = 0; d < dh; ++d) {
        s = fmaf(krow[warp][d], qi[d], s);
        t = fmaf(vrow[warp][d], di[d], t);
      }
      p = exp2f(s * sl2 - lb[i]);
      ds = p * (t - dlb[i]) * scale;
    }
    const int in = min(32, nq - i0);
    for (int t = 0; t < in; ++t) {
      const float pt = __shfl_sync(0xffffffffu, p, t);
      const float dst = __shfl_sync(0xffffffffu, ds, t);
      const float* qt = qb + (long long)(i0 + t) * st.s[1];
      const float* dt = db + (long long)(i0 + t) * st.s[7];
#pragma unroll
      for (int c = 0; c < MAX_DH / 32; ++c)
        if (lane + 32 * c < dh) {
          gv[c] = fmaf(pt, dt[lane + 32 * c], gv[c]);
          gk[c] = fmaf(dst, qt[lane + 32 * c], gk[c]);
        }
    }
  }
  float* ok = dk + b * st.s[10] + (long long)r * st.s[11] + (long long)h * dh;
  float* ov = dv + b * st.s[12] + (long long)r * st.s[13] + (long long)h * dh;
#pragma unroll
  for (int c = 0; c < MAX_DH / 32; ++c)
    if (lane + 32 * c < dh) {
      ok[lane + 32 * c] = gk[c];
      ov[lane + 32 * c] = gv[c];
    }
}

// ----------------------------------------------------------------- launch

static bool bad_args(int batch, int nq, int nk, int heads, int dh) {
  return batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 || dh < 16 || dh > MAX_DH || dh % 16;
}

static Strides copy_strides(const long long* strides, int n) {
  Strides st = {};
  for (int i = 0; i < n; ++i) st.s[i] = strides[i];
  return st;
}

// q (B, nq, ·), k and v (B, nk, ·), o (B, nq, ·): head h reads and writes
// columns [h·dh, (h+1)·dh) of its rows. strides: q, k, v, o batch and row
// strides in elements (host memory). lse: (B, heads, nq) float, log2 units.
extern "C" int mtt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const long long* strides, int batch, int nq, int nk, int heads,
                             int dh, float scale, int dtype, void* stream) {
  if (bad_args(batch, nq, nk, heads, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const Strides st = copy_strides(strides, 8);
  if (dtype == MTT_BF16)
    return attn_fwd::run(q, k, v, o, l, batch, nq, nk, heads, dh, st.s, scale, s);
  flash_fwd_f32_kernel<<<dim3((nq + FW - 1) / FW, heads, batch), 32 * FW, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), l, nq, nk, heads, dh, st, scale * LOG2E);
  return (int)cudaGetLastError();
}

// strides: q, k, v, dout, dq, dk, dv batch and row strides (host memory);
// lse (B, heads, nq) from the forward, delta (B, heads, nq) float scratch.
extern "C" int mtt_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, const void* lse, void* delta,
                             const long long* strides, int batch, int nq, int nk, int heads,
                             int dh, float scale, int dtype, void* stream) {
  if (bad_args(batch, nq, nk, heads, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const Strides st = copy_strides(strides, 14);
  if (dtype == MTT_BF16)
    return attn_bwd::run(q, k, v, dout, dq, dk, dv, const_cast<float*>(l), dl, nullptr, batch, nq,
                         nk, heads, dh, st.s, scale, false, s);
  const float *q_ = static_cast<const float*>(q), *k_ = static_cast<const float*>(k),
              *v_ = static_cast<const float*>(v), *d_ = static_cast<const float*>(dout);
  flash_bwd_dq_f32_kernel<<<dim3((nq + FW - 1) / FW, heads, batch), 32 * FW, 0, s>>>(
      q_, k_, v_, d_, static_cast<float*>(dq), l, dl, nq, nk, heads, dh, st, scale);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  flash_bwd_dkv_f32_kernel<<<dim3((nk + FW - 1) / FW, heads, batch), 32 * FW, 0, s>>>(
      q_, k_, v_, d_, static_cast<float*>(dk), static_cast<float*>(dv), l, dl, nq, nk, heads,
      dh, st, scale);
  return (int)cudaGetLastError();
}
