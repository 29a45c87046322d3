// Multi-head softmax(q·kᵀ·scale)·v in three phases over a group of heads:
// every head's scores first, then one softmax pass, then every P·V. Replaces
// the attention core of three TPU prototypes of the bench: scripts/
// bench_attn_half.py:_v2_kernel (S2: all heads' (N, N) float scores in one
// scratch, one max-subtracted exp softmax over all of them, then every P·V),
// scripts/bench_vpu.py:_attn_kernel_v (S5: the same with the softmax varied:
// exp, exp2 with log2 e folded into the scale, no max, or skipped — the raw
// scores as P, wrong math kept for timing) and scripts/bench_overlap.py:
// _attn_half_grouped (S6: three phases per group of 2, 4 or 8 heads).
//
// One block per (batch, group of G heads, tile of 8 queries). The TPU kernel
// holds (H, N, N) float scores in VMEM; a block holds its 8 query rows of
// them for its G heads, every key (padded to 16), in shared memory: 16 heads
// × 8 × 276 × 4 B = 141 KB at 257 keys, so all 16 heads of MIRAGE-Large fit
// one block beside one head's K or V and the group's queries (≈ 197 KB).
// Eight queries are the n side of mma.sync m16n8k16, so the scores are
// computed as K·Qᵀ (16 keys × 8 queries a product) and P·V as Vᵀ·Pᵀ:
// - phase 1: per head, K is staged (cp.async), each warp takes 16-key tiles
//   and writes scale·(K·Qᵀ) into the float score rows;
// - phase 2: one warp per (head, query) row: the max (exp, exp2), the
//   exponentials and their float sum; the row is rewritten in place as bf16
//   P (keys past N are zero);
// - phase 3: per head, V is staged, each warp takes 16 of its head-dim
//   columns, O = P·V summed over all keys in float, divided by the float sum
//   (unless `divide` is 0: the bench checks S5's "skip" before the
//   division) and rounded to bf16 into the query tile's staging rows, which
//   go out in 16-byte rows at the end.
// P is rounded to bf16 before P·V and the output divided after it, as the
// TPU kernels do. q, k and v are read in place from the packed (B, N, 3D)
// qkv through batch and row strides and a per-head column offset, as
// csrc/attention.cu does.
//
// Bound: operations at the bench's shape (4·N²·D FLOPs per batch element
// against q, k, v read once). This first version stages each head's K and V
// once per 8-query block (every block rereads them from L2: 33 blocks per
// batch element at 257 tokens) and runs phase by phase with no overlap
// between the staging and the products; bf16 only, head dims 16..128 in
// steps of 16, at most 512 keys, and the group's shared memory within a
// block's 227 KB.
#include <math.h>

#include <initializer_list>

#include "common.cuh"

constexpr int PQ = 8;  // queries per block: the n side of m16n8k16
constexpr int MAX_KEYS = 512;
constexpr int MAX_DH = 128;
constexpr int PH_THREADS = 128;

enum { SMAX_EXP = 0, SMAX_EXP2 = 1, SMAX_NOMAX = 2, SMAX_SKIP = 3 };

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// Shared memory of one block: the float score rows (G·PQ × (nkp + 4)), their
// sums (G·PQ), the queries / output staging (PQ × (G·dh + 8) bf16) and one
// head's K or V (nkp × (dh + 8) bf16); nkp = nk rounded up to 16.
static size_t phased_smem_bytes(int nk, int dh, int group) {
  const size_t nkp = (nk + 15) / 16 * 16, ss = nkp + 4;
  return 4 * ((size_t)group * PQ * ss + group * PQ) + 2 * (size_t)PQ * (group * dh + 8) +
         2 * nkp * (dh + 8);
}

template <int DH, int SMAX>
__global__ void __launch_bounds__(PH_THREADS)
    attention_phased_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o, int nq, int nk,
                            int group, long long q_bs, int q_rs, long long k_bs, int k_rs,
                            long long v_bs, int v_rs, long long o_bs, int o_rs, float scale,
                            int divide) {
  constexpr int DS = DH + 8, CPR = DH / 8, KT = DH / 16;
  constexpr int WARPS = PH_THREADS / 32;
  extern __shared__ __align__(16) unsigned char ph_smem[];
  const int G = group, nkp = (nk + 15) & ~15, ss = nkp + 4, qstride = G * DH + 8;
  float* sc = reinterpret_cast<float*>(ph_smem);  // row (head, query): ss floats
  float* lsum = sc + (size_t)G * PQ * ss;
  bf16* qo = reinterpret_cast<bf16*>(lsum + G * PQ);
  bf16* kv = qo + PQ * qstride;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h0 = blockIdx.y * G, q0 = blockIdx.x * PQ;
  const int qchunks = G * CPR;  // 16-byte chunks of a query row of the group

  {  // the group's queries
    const bf16* qb = q + b * q_bs + (long long)h0 * DH;
    for (int e = tid; e < PQ * qchunks; e += PH_THREADS) {
      const int r = e / qchunks, c = (e - r * qchunks) * 8, g = q0 + r;
      const bool ok = g < nq;
      cp_async16(smem_u32(qo + r * qstride + c), ok ? qb + (long long)g * q_rs + c : qb,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  }
  // rows [0, nkp) of one head's K or V (rows past nk zero-filled)
  auto stage = [&](const bf16* src, int rs) {
    for (int e = tid; e < nkp * CPR; e += PH_THREADS) {
      const int r = e / CPR, c = (e - r * CPR) * 8;
      const bool ok = r < nk;
      cp_async16(smem_u32(kv + r * DS + c), ok ? src + (long long)r * rs + c : src, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };
  const float sl = SMAX == SMAX_EXP2 ? scale * 1.4426950408889634f : scale;

  // phase 1: scores of every head of the group, (key, query) tiles of K·Qᵀ
  for (int hh = 0; hh < G; ++hh) {
    stage(k + b * k_bs + (long long)(h0 + hh) * DH, k_rs);
    uint32_t qf[KT][2];  // Qᵀ as the col-major B operand: query rows of qo
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      ldmatrix_x2(qf[kt], smem_u32(qo + (lane & 7) * qstride + hh * DH + kt * 16 +
                                   ((lane >> 3) & 1) * 8));
    float* rows = sc + (size_t)(hh * PQ + 2 * tig) * ss;  // queries 2·tig and 2·tig + 1
    for (int t = warp; t < nkp / 16; t += WARPS) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(kv + (t * 16 + (lane & 15)) * DS + kt * 16 + (lane >> 4) * 8));
        mma_bf16_16816(c, a, qf[kt][0], qf[kt][1]);
      }
      const int key = t * 16 + gid;
      rows[key] = c[0] * sl;
      rows[ss + key] = c[1] * sl;
      rows[key + 8] = c[2] * sl;
      rows[ss + key + 8] = c[3] * sl;
    }
    __syncthreads();  // every warp is done with K before the next head's
  }

  // phase 2: one softmax pass over every (head, query) row; P in place as bf16
  for (int r = warp; r < G * PQ; r += WARPS) {
    float* row = sc + (size_t)r * ss;
    float vals[MAX_KEYS / 32];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < MAX_KEYS / 32; ++i) {
      const int j = lane + 32 * i;
      vals[i] = j < nk ? row[j] : 0.f;
      if (SMAX == SMAX_EXP || SMAX == SMAX_EXP2)
        if (j < nk) m = fmaxf(m, vals[i]);
    }
    if (SMAX == SMAX_EXP || SMAX == SMAX_EXP2) m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_KEYS / 32; ++i) {
      const int j = lane + 32 * i;
      float e = 0.f;
      if (j < nk) {
        if constexpr (SMAX == SMAX_EXP) e = expf(vals[i] - m);
        else if constexpr (SMAX == SMAX_EXP2) e = exp2f(vals[i] - m);
        else if constexpr (SMAX == SMAX_NOMAX) e = expf(vals[i]);
        else e = vals[i];  // skip: the raw scores and their sum
      }
      vals[i] = e;
      l += e;
    }
    l = warp_sum(l);
    __syncwarp();  // every lane has read the float row before it is overwritten
    bf16* prow = reinterpret_cast<bf16*>(row);
#pragma unroll
    for (int i = 0; i < MAX_KEYS / 32; ++i) {
      const int j = lane + 32 * i;
      if (j < nkp) prow[j] = __float2bfloat16(vals[i]);
    }
    if (lane == 0) lsum[r] = l;
  }
  __syncthreads();

  // phase 3: Oᵀ (dh × 8) = Vᵀ·Pᵀ per head, 16 head-dim rows a warp
  for (int hh = 0; hh < G; ++hh) {
    stage(v + b * v_bs + (long long)(h0 + hh) * DH, v_rs);
    const bf16* prow = reinterpret_cast<const bf16*>(sc + (size_t)(hh * PQ + (lane & 7)) * ss);
    for (int mt = warp; mt < KT; mt += WARPS) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < nkp / 16; ++kk) {
        uint32_t a[4], bq[2];
        ldmatrix_x4_trans(a, smem_u32(kv + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * DS +
                                      mt * 16 + ((lane >> 3) & 1) * 8));
        ldmatrix_x2(bq, smem_u32(prow + kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16_16816(c, a, bq[0], bq[1]);
      }
      // rows: head-dim columns mt·16 + gid (+ 8); columns: queries 2·tig, 2·tig + 1
      const float l0 = divide ? lsum[hh * PQ + 2 * tig] : 1.f;
      const float l1 = divide ? lsum[hh * PQ + 2 * tig + 1] : 1.f;
      bf16* o0 = qo + (2 * tig) * qstride + hh * DH + mt * 16 + gid;
      bf16* o1 = o0 + qstride;
      o0[0] = __float2bfloat16(c[0] / l0);
      o1[0] = __float2bfloat16(c[1] / l1);
      o0[8] = __float2bfloat16(c[2] / l0);
      o1[8] = __float2bfloat16(c[3] / l1);
    }
    __syncthreads();  // every warp is done with V before the next head's
  }

  // the tile's output rows, 16 bytes at a time
  bf16* ob = o + b * o_bs + (long long)h0 * DH;
  for (int e = tid; e < PQ * qchunks; e += PH_THREADS) {
    const int r = e / qchunks, c = (e - r * qchunks) * 8, g = q0 + r;
    if (g < nq)
      *reinterpret_cast<uint4*>(ob + (long long)g * o_rs + c) =
          *reinterpret_cast<const uint4*>(qo + r * qstride + c);
  }
}

template <int DH, int SMAX>
static int launch(dim3 grid, size_t bytes, cudaStream_t s, const void* q, const void* k,
                  const void* v, void* o, int nq, int nk, int group, long long q_bs, int q_rs,
                  long long k_bs, int k_rs, long long v_bs, int v_rs, long long o_bs, int o_rs,
                  float scale, int divide) {
  static size_t configured = 0;
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_phased_kernel<DH, SMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = bytes;
  }
  attention_phased_kernel<DH, SMAX><<<grid, PH_THREADS, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), nq, nk, group, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs,
      scale, divide);
  return (int)cudaGetLastError();
}

template <int DH>
static int launch_smax(int smax, dim3 grid, size_t bytes, cudaStream_t s, const void* q,
                       const void* k, const void* v, void* o, int nq, int nk, int group,
                       long long q_bs, int q_rs, long long k_bs, int k_rs, long long v_bs,
                       int v_rs, long long o_bs, int o_rs, float scale, int divide) {
#define MTT_PH(M)                                                                              \
  case M:                                                                                      \
    return launch<DH, M>(grid, bytes, s, q, k, v, o, nq, nk, group, q_bs, q_rs, k_bs, k_rs,    \
                         v_bs, v_rs, o_bs, o_rs, scale, divide);
  switch (smax) {
    MTT_PH(SMAX_EXP)
    MTT_PH(SMAX_EXP2)
    MTT_PH(SMAX_NOMAX)
    MTT_PH(SMAX_SKIP)
  }
#undef MTT_PH
  return (int)cudaErrorInvalidValue;
}

// bf16 q (B, nq, heads·dh), k and v (B, nk, heads·dh) views with unit
// column stride (strides in elements), o likewise; `group` heads per block
// (dividing heads); smax: SMAX_EXP, SMAX_EXP2, SMAX_NOMAX or SMAX_SKIP;
// divide = 0 leaves the output unnormalised.
extern "C" int mtt_attention_phased(const void* q, const void* k, const void* v, void* o,
                                    int batch, int nq, int nk, int heads, int dh, int group,
                                    long long q_bs, int q_rs, long long k_bs, int k_rs,
                                    long long v_bs, int v_rs, long long o_bs, int o_rs,
                                    float scale, int smax, int divide, void* stream) {
  if (batch <= 0 || nq <= 0 || nk <= 0 || nk > MAX_KEYS || dh <= 0 || dh > MAX_DH || dh % 16 ||
      group <= 0 || heads % group)
    return (int)cudaErrorInvalidValue;
  const long long strides[] = {q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs};
  for (long long st : strides)
    if (st % 8) return (int)cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
  const size_t bytes = phased_smem_bytes(nk, dh, group);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + PQ - 1) / PQ, heads / group, batch);
#define MTT_PHD(D)                                                                           \
  case D:                                                                                    \
    return launch_smax<D>(smax, grid, bytes, s, q, k, v, o, nq, nk, group, q_bs, q_rs, k_bs, \
                          k_rs, v_bs, v_rs, o_bs, o_rs, scale, divide);
  switch (dh) {
    MTT_PHD(16)
    MTT_PHD(32)
    MTT_PHD(48)
    MTT_PHD(64)
    MTT_PHD(80)
    MTT_PHD(96)
    MTT_PHD(112)
    MTT_PHD(128)
  }
#undef MTT_PHD
  return (int)cudaErrorInvalidValue;
}
