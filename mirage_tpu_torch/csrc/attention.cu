// Multi-head softmax(q·kᵀ·scale)·v for up to 512 keys: the attention core of
// mirage_tpu/ops/block_attention.py:_attn_half_kernel (self-attention on
// the packed (B, N, 3D) qkv, column order q|k|v × heads × dh) and
// :_xattn_half_kernel (q from (B, Nq, D), k|v from the packed (B, Nc, 2D)).
// Q, K, V and O are addressed in place through batch and row strides and a
// per-head column offset, so nothing is transposed in device memory.
//
// One block per (batch, head, 64-query tile). The TPU kernel holds a
// per-head (N, N) score tile in VMEM; an SM's shared memory cannot hold that
// for all heads, so the bf16 kernel keeps each warp's 16 query rows of
// scores in registers and streams the keys through shared memory in chunks
// of 64, carrying the softmax max and sum from chunk to chunk. The
// probabilities are rounded to the working type before P·V and the output
// divided by the float row sum after it, as the TPU kernel does.
//
// Bound: operations at the main-path shapes (4·N²·D FLOPs per batch element
// against reading q, k, v once). bf16 runs both products on the tensor cores
// (mma.sync m16n8k16, float accumulation). float keeps a 64-row tile's
// scores for all keys in shared memory (≤ 128 KB) and runs register-tiled
// FMAs, for the float32 golden. What a later PR changes first: wgmma for
// the two products, and fusing the attention between the qkv and output
// GEMMs so the packed qkv stops going through device memory.
#include <math.h>

#include <initializer_list>

#include "common.cuh"

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

// -------------------------------------------------------------- bf16 path

constexpr int KC = 64;  // keys per staged chunk

// Four warps, each 16 query rows of the block's 64; the keys stream through
// shared memory in chunks of 64 (K and V double-buffered by cp.async). A
// warp keeps its scores, probabilities and output in registers: S = Q Kᵀ and
// O += P V are mma.sync m16n8k16 (the S accumulator is repacked as the A
// operand of P V), with the softmax max and sum carried across chunks. The
// probabilities are rounded to bf16 before P V and the output divided by the
// float row sum after it, as the TPU kernel does.
template <int DH>
__global__ void __launch_bounds__(128)
    attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o, int nq, int nk,
                          long long q_bs, int q_rs, long long k_bs, int k_rs, long long v_bs,
                          int v_rs, long long o_bs, int o_rs, float scale_log2) {
  constexpr int DS = DH + 8;   // padded row stride: ldmatrix rows on distinct banks
  constexpr int CPR = DH / 8;  // 16-byte chunks per row
  constexpr int KT = DH / 16, NT = DH / 8;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  bf16* qs = reinterpret_cast<bf16*>(attn_smem);  // QT × DS
  bf16* ks = qs + QT * DS;                        // 2 × KC × DS
  bf16* vs = ks + 2 * KC * DS;                    // 2 × KC × DS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const bf16* qb = q + b * q_bs + (long long)h * DH;
  const bf16* kb = k + b * k_bs + (long long)h * DH;
  const bf16* vb = v + b * v_bs + (long long)h * DH;

  // rows [row0, row0 + 64) of src into a 64 × DS tile, rows >= n zero-filled
  auto stage = [&](bf16* dst, const bf16* src, int row0, int n, int rs) {
    for (int e = tid; e < 64 * CPR; e += 128) {
      const int r = e / CPR, c = (e - r * CPR) * 8, g = row0 + r;
      const bool ok = g < n;
      cp_async16(smem_u32(dst + r * DS + c), ok ? src + (long long)g * rs + c : src, ok ? 16 : 0);
    }
  };
  stage(qs, qb, q0, nq, q_rs);
  stage(ks, kb, 0, nk, k_rs);
  stage(vs, vb, 0, nk, v_rs);
  cp_async_commit();

  const bool active = q0 + warp * 16 < nq;  // a warp past the last query only helps load
  uint32_t qf[KT][4];
  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows gid, gid + 8

  const int nchunks = (nk + KC - 1) / KC;
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      const int nb = (c + 1) & 1;
      stage(ks + nb * KC * DS, kb, (c + 1) * KC, nk, k_rs);
      stage(vs + nb * KC * DS, vb, (c + 1) * KC, nk, v_rs);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk c (and Q) have landed
    __syncthreads();
    if (active) {
      if (c == 0) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          ldmatrix_x4(qf[kt], smem_u32(qs + (warp * 16 + (lane & 15)) * DS + kt * 16 +
                                       (lane >> 4) * 8));
      }
      const bf16* kc = ks + (c & 1) * KC * DS;
      const bf16* vc = vs + (c & 1) * KC * DS;

      // S (16 × 64) = Q Kᵀ; K rows are the n index, read as the col-major B
      float s[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int j = 0; j < KC / 8; j += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, smem_u32(kc + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * DS +
                                  kt * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16_16816(s[j], qf[kt], r[0], r[1]);
          mma_bf16_16816(s[j + 1], qf[kt], r[2], r[3]);
        }

      // scale (in log2 units), mask keys past nk, running max and rescale
      const int key0 = c * KC;
      float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + j * 8 + 2 * tig + (e & 1);
          s[j][e] = key < nk ? s[j][e] * scale_log2 : -INFINITY;
          cmax[e >> 1] = fmaxf(cmax[e >> 1], s[j][e]);
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        cmax[hf] = fmaxf(cmax[hf], __shfl_xor_sync(0xffffffffu, cmax[hf], 1));
        cmax[hf] = fmaxf(cmax[hf], __shfl_xor_sync(0xffffffffu, cmax[hf], 2));
        const float m_new = fmaxf(m_run[hf], cmax[hf]);  // finite: a chunk has a key
        const float corr = exp2f(m_run[hf] - m_new);
        m_run[hf] = m_new;
        l_run[hf] *= corr;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          oacc[n][2 * hf] *= corr;
          oacc[n][2 * hf + 1] *= corr;
        }
      }

      // P = exp2(s - m): float row sums, bf16 A fragments of P V
      uint32_t pf[KC / 16][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        const float p0 = exp2f(s[j][0] - m_run[0]), p1 = exp2f(s[j][1] - m_run[0]);
        const float p2 = exp2f(s[j][2] - m_run[1]), p3 = exp2f(s[j][3] - m_run[1]);
        l_run[0] += p0 + p1;
        l_run[1] += p2 + p3;
        pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }

      // O (16 × DH) += P V; V rows are the k index, read transposed
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, smem_u32(vc + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DS +
                                        n * 8 + (lane >> 4) * 8));
          mma_bf16_16816(oacc[n], pf[kk], r[0], r[1]);
          mma_bf16_16816(oacc[n + 1], pf[kk], r[2], r[3]);
        }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  if (!active) return;

  bf16* ob = o + b * o_bs + (long long)h * DH;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int gq = q0 + warp * 16 + gid + 8 * hf;
    if (gq >= nq) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)gq * o_rs + n * 8 + 2 * tig) =
          __floats2bfloat162_rn(oacc[n][2 * hf] * inv, oacc[n][2 * hf + 1] * inv);
  }
}

// ----------------------------------------------------------------- launch

static size_t f32_smem_bytes(int nk, int dh) {
  const int nk_pad = (nk + QT - 1) / QT * QT;
  return sizeof(float) * ((size_t)2 * QT * (dh + 1) + (size_t)QT * (nk_pad + 1) + QT);
}

template <typename Kernel>
static int set_smem(Kernel kernel, size_t bytes, size_t* configured) {
  if (bytes <= *configured) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  *configured = bytes;
  return 0;
}

template <int DH>
static int launch_bf16(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v,
                       void* o, int nq, int nk, long long q_bs, int q_rs, long long k_bs, int k_rs,
                       long long v_bs, int v_rs, long long o_bs, int o_rs, float scale) {
  static size_t configured = 0;
  const size_t bytes = sizeof(bf16) * (QT + 4 * KC) * (DH + 8);
  if (int err = set_smem(attention_bf16_kernel<DH>, bytes, &configured)) return err;
  attention_bf16_kernel<DH><<<grid, 128, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), nq, nk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
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
    // 16-byte loads of q, k, v rows and 4-byte stores of o pairs
    const long long strides[] = {q_bs, q_rs, k_bs, k_rs, v_bs, v_rs};
    for (long long st : strides)
      if (st % 8) return (int)cudaErrorInvalidValue;
    for (const void* ptr : {q, k, v})
      if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
    if (o_bs % 2 || o_rs % 2 || reinterpret_cast<uintptr_t>(o) % 4)
      return (int)cudaErrorInvalidValue;
#define MTT_ATTN(D)                                                                          \
  case D:                                                                                    \
    return launch_bf16<D>(grid, s, q, k, v, o, nq, nk, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, \
                          o_bs, o_rs, scale);
    switch (dh) {
      MTT_ATTN(16)
      MTT_ATTN(32)
      MTT_ATTN(48)
      MTT_ATTN(64)
      MTT_ATTN(80)
      MTT_ATTN(96)
      MTT_ATTN(112)
      MTT_ATTN(128)
    }
#undef MTT_ATTN
    return (int)cudaErrorInvalidValue;
  }
  static size_t configured = 0;
  const size_t bytes = f32_smem_bytes(nk, dh);
  if (int err = set_smem(attention_f32_kernel, bytes, &configured)) return err;
  attention_f32_kernel<<<grid, 256, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), nq, nk, dh, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale);
  return (int)cudaGetLastError();
}
