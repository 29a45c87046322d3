// Multi-head softmax(q·kᵀ·scale)·v for up to 512 keys: the attention core of
// mirage_tpu/ops/block_attention.py:_attn_half_kernel (self-attention on
// the packed (B, N, 3D) qkv, column order q|k|v × heads × dh) and
// :_xattn_half_kernel (q from (B, Nq, D), k|v from the packed (B, Nc, 2D)).
// Q, K, V and O are addressed in place through batch and row strides and a
// per-head column offset, so nothing is transposed in device memory.
//
// bf16 is the Hopper forward of csrc/attention_fwd.cuh (TMA, wgmma, two
// consumer warpgroups in ping-pong), shared with csrc/flash_attention.cu.
// float keeps a 64-row tile's scores for all keys in shared memory (≤ 128
// KB) and runs register-tiled FMAs, for the float32 goldens. What a later PR
// changes first: fusing the attention between the qkv and output GEMMs so
// the packed qkv stops going through device memory.
#include <math.h>

#include "attention_fwd.cuh"

constexpr int QT = 64;  // queries per block
constexpr int MAX_KEYS = 512;
constexpr int MAX_DH = 128;

// ------------------------------------------------------------- float path

__global__ void __launch_bounds__(256)
    attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int nq, int nk,
                         int dh, long long q_bs, int q_rs, long long k_bs, int k_rs,
                         long long v_bs, int v_rs, long long o_bs, int o_rs, float scale) {
  extern __shared__ float sm[];
  const int nk_pad = (nk + QT - 1) / QT * QT;
  const int ds = dh + 1;       // padded row stride of the q and k/v tiles
  const int ss = nk_pad + 1;   // padded row stride of the scores
  float* qs = sm;              // QT × ds
  float* kvs = qs + QT * ds;   // QT × ds
  float* s = kvs + QT * ds;    // QT × ss
  float* lsum = s + QT * ss;   // QT

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const float* qb = q + b * q_bs + (long long)h * dh;
  const float* kb = k + b * k_bs + (long long)h * dh;
  const float* vb = v + b * v_bs + (long long)h * dh;

  for (int e = tid; e < QT * dh; e += 256) {
    const int r = e / dh, d = e - r * dh, gq = q0 + r;
    qs[r * ds + d] = gq < nq ? qb[(long long)gq * q_rs + d] : 0.f;
  }

  // scores: s = scale · q kᵀ, 64 keys at a time
  for (int j0 = 0; j0 < nk_pad; j0 += QT) {
    __syncthreads();
    for (int e = tid; e < QT * dh; e += 256) {
      const int r = e / dh, d = e - r * dh, gj = j0 + r;
      kvs[r * ds + d] = gj < nk ? kb[(long long)gj * k_rs + d] : 0.f;
    }
    __syncthreads();
    float acc[4][4] = {};
    for (int d = 0; d < dh; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ds + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kvs[(tx + 16 * j) * ds + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[(ty * 4 + i) * ss + j0 + tx + 16 * j] = acc[i][j] * scale;
  }
  __syncthreads();

  // softmax numerators and row sums: each warp owns 8 rows
  for (int rr = 0; rr < QT / 8; ++rr) {
    const int r = warp * (QT / 8) + rr;
    float* row = s + r * ss;
    float m = -INFINITY;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nk_pad; j += 32) {
      const float e = j < nk ? expf(row[j] - m) : 0.f;
      l += e;
      row[j] = e;
    }
    l = warp_sum(l);
    if (lane == 0) lsum[r] = l;
  }

  // out = p · v, rows ty*4+i, columns tx + 16*c
  const int nc = dh / 16;
  float acc[4][MAX_DH / 16] = {};
  for (int j0 = 0; j0 < nk_pad; j0 += QT) {
    __syncthreads();
    for (int e = tid; e < QT * dh; e += 256) {
      const int r = e / dh, d = e - r * dh, gj = j0 + r;
      kvs[r * ds + d] = gj < nk ? vb[(long long)gj * v_rs + d] : 0.f;
    }
    __syncthreads();
    const int jn = min(QT, nk - j0);
    for (int j = 0; j < jn; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s[(ty * 4 + i) * ss + j0 + j];
#pragma unroll
      for (int c = 0; c < MAX_DH / 16; ++c) {
        if (c < nc) {
          const float vv = kvs[j * ds + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }
  float* ob = o + b * o_bs + (long long)h * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, gq = q0 + r;
    if (gq >= nq) continue;
    const float inv = 1.f / lsum[r];
#pragma unroll
    for (int c = 0; c < MAX_DH / 16; ++c)
      if (c < nc) ob[(long long)gq * o_rs + tx + 16 * c] = acc[i][c] * inv;
  }
}

// ----------------------------------------------------------------- launch

static size_t f32_smem_bytes(int nk, int dh) {
  const int nk_pad = (nk + QT - 1) / QT * QT;
  return sizeof(float) * ((size_t)2 * QT * (dh + 1) + (size_t)QT * (nk_pad + 1) + QT);
}

extern "C" int mtt_attention(const void* q, const void* k, const void* v, void* o, int batch,
                             int nq, int nk, int heads, int dh, long long q_bs, int q_rs,
                             long long k_bs, int k_rs, long long v_bs, int v_rs, long long o_bs,
                             int o_rs, float scale, int dtype, void* stream) {
  if (batch <= 0 || nq <= 0 || nk <= 0 || nk > MAX_KEYS || dh <= 0 || dh > MAX_DH || dh % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + QT - 1) / QT, heads, batch);
  if (dtype == MTT_BF16) {
    const long long st[8] = {q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs};
    return attn_fwd::run(q, k, v, o, nullptr, batch, nq, nk, heads, dh, st, scale, s);
  }
  static SmemLimit limit;
  const size_t bytes = f32_smem_bytes(nk, dh);
  if (int err = set_smem(attention_f32_kernel, bytes, limit)) return err;
  attention_f32_kernel<<<grid, 256, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), nq, nk, dh, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale);
  return (int)cudaGetLastError();
}
