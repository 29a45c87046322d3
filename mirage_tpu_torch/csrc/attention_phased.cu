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
// The resident branch (the bench's shapes). The G heads of a group are split
// over a thread-block cluster of G / hpc CTAs (at most 8); each CTA keeps
// its hpc heads' K and V resident in shared memory (hpc = 2 at dh 64 and 257
// keys: 2 × 2 × 272 × 72 × 2 B = 157 KB) and walks the query tiles of its
// batch element (16 queries a tile where the scores fit, else 8). Per tile:
// - phase 1: scale·(K·Qᵀ) of the CTA's heads into float score rows (16 keys
//   × 8 queries an mma.sync m16n8k16 product, the queries as its n side);
// - cluster barrier: every head of the group has its scores;
// - phase 2: one warp per (head, query) row: the max (exp, exp2), the
//   exponentials and their float sum, P written as bf16 into rows of its own
//   (keys past N are zero);
// - cluster barrier: every row of the group is P;
// - phase 3: Oᵀ (dh × 8) = Vᵀ·Pᵀ per head, summed over all keys in float,
//   divided by the float sum (unless `divide` is 0: the bench checks S5's
//   "skip" before the division), rounded to bf16 into the tile's query
//   buffer, which goes out in 16-byte rows.
// The barriers keep the scripts' order (every score of the group, then one
// softmax pass, then every P·V), so G stays the A/B knob of S6. K, Q of the
// first tile and V arrive by cp.async as three groups: phase 1 waits for K
// and Q only, V lands during phases 1-2; the next tile's Q is prefetched
// into the other half of a double buffer while the current tile computes.
// Where the CTAs of a batch element's heads would not fill the card, the
// query tiles are split over two clusters (K and V then read twice).
//
// The staging branch (one head's K and V do not fit: dh 128 above 384
// keys, or a group would need more than 8 CTAs): one block per (8 queries,
// group, batch element) holds the group's scores and P and stages each
// head's K, then V, through shared memory, as the first version of this
// kernel did.
// ops/block_attention.py:phased_plan chooses the branch, the heads per CTA,
// the query tile and the split; this file checks what it is given.
//
// P is rounded to bf16 before P·V and the output divided after it, as the
// TPU kernels do. q, k and v are read in place from the packed (B, N, 3D)
// qkv through batch and row strides and a per-head column offset, as
// csrc/attention.cu does.
//
// Bound: bytes at the bench's shape (64, 257, 1024, 16): q, k, v read and o
// written once, 135 MB (0.040 ms at 3.35 TB/s), against 17.3 GFLOP (0.018
// ms). The resident branch reads each (batch, head)'s K and V from L2 once
// per cluster: 67 MB of K and V at the bench's shape, where the staging
// branch (the first version's only design) rereads them for every 8 queries,
// ≈ 2.2 GB. A CTA is 16 warps: each phase is a few hundred instructions a
// warp, so the tile's time is latency (each phase's longest warp, and the
// barriers that wait for it), not bandwidth or tensor-core rate. What it
// pays now: the phases do not overlap one another (the barriers separate
// them), and a CTA holds one 16-query tile's scores (219 KB at the bench's
// shape), so one CTA runs per SM and nothing hides a phase's tail.
#include <math.h>

#include <initializer_list>

#include "common.cuh"

constexpr int PQ = 8;  // staging branch: queries per block, the n side of m16n8k16
constexpr int MAX_KEYS = 512;
constexpr int MAX_DH = 128;
constexpr int MAX_CLUSTER = 8;
constexpr int PH_THREADS = 128;   // staging branch
constexpr int RES_THREADS = 512;  // resident branch: 16 warps hide the phases' latency
constexpr size_t SMEM_LIMIT = 232448;

enum { SMAX_EXP = 0, SMAX_EXP2 = 1, SMAX_NOMAX = 2, SMAX_SKIP = 3 };

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Shared memory of one staging block: the float score rows (G·PQ × (nkp +
// 4)), their sums (G·PQ), the bf16 P rows (G·PQ × (nkp + 8)), the queries
// / output staging (PQ × (G·dh + 8) bf16) and one head's K or V (nkp × (dh
// + 8) bf16); nkp = nk rounded up to 16.
static size_t staged_smem_bytes(int nk, int dh, int group) {
  const size_t nkp = (nk + 15) / 16 * 16, ss = nkp + 4, ps = nkp + 8;
  return 4 * ((size_t)group * PQ * ss + group * PQ) + 2 * (size_t)group * PQ * ps +
         2 * (size_t)PQ * (group * dh + 8) + 2 * nkp * (dh + 8);
}

// Shared memory of one resident CTA: K and V of its hpc heads (2·hpc × nkp
// × (dh + 8) bf16), the float score rows (hpc·qt × (nkp + 4)) and their
// sums, the bf16 P rows (hpc·qt × (nkp + 8)) and the double-buffered query
// / output tile (2 × qt × (hpc·dh + 8) bf16).
static size_t resident_smem_bytes(int nk, int dh, int hpc, int qt) {
  const size_t nkp = (nk + 15) / 16 * 16, ss = nkp + 4, ps = nkp + 8;
  return 2 * (2 * (size_t)hpc * nkp * (dh + 8)) + 4 * ((size_t)hpc * qt * ss + hpc * qt) +
         2 * ((size_t)hpc * qt * ps) + 2 * (2 * (size_t)qt * (hpc * dh + 8));
}

// Phase 2 on one (head, query) row of nk float scores: two passes over the
// row in shared memory, the max (exp, exp2) and then the exponentials (the
// raw scores for SMAX_SKIP), each lane summing its keys in order; P goes
// as bf16 into the row's own prow (zero from nk to nkp). Returns the float
// sum.
template <int SMAX>
__device__ __forceinline__ float softmax_row(const float* row, bf16* prow, int nk, int nkp) {
  const int lane = threadIdx.x & 31;
  float m = 0.f;
  if (SMAX == SMAX_EXP || SMAX == SMAX_EXP2) {
    m = -INFINITY;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
  }
  float l = 0.f;
#pragma unroll 4
  for (int j = lane; j < nkp; j += 32) {
    float e = 0.f;
    if (j < nk) {
      const float v = row[j];
      if constexpr (SMAX == SMAX_EXP) e = expf(v - m);
      else if constexpr (SMAX == SMAX_EXP2) e = exp2f(v - m);
      else if constexpr (SMAX == SMAX_NOMAX) e = expf(v);
      else e = v;  // skip: the raw scores and their sum
    }
    l += e;
    prow[j] = __float2bfloat16(e);
  }
  return warp_sum(l);
}

// Phase 2 over rows r0, r0 + step, ... < rows of the score block (stride
// ss) into the P rows of pbuf (stride ps); the mode is a run-time switch
// outside the row loop, each branch its own code.
__device__ __forceinline__ void softmax_rows(int smax, const float* sc, float* lsum, bf16* pbuf,
                                             int rows, int ss, int ps, int nk, int nkp, int r0,
                                             int step) {
  const int lane = threadIdx.x & 31;
#define MTT_SMAX_ROWS(M)                                                                   \
  for (int r = r0; r < rows; r += step) {                                                  \
    const float l = softmax_row<M>(sc + (size_t)r * ss, pbuf + (size_t)r * ps, nk, nkp); \
    if (lane == 0) lsum[r] = l;                                                            \
  }
  switch (smax) {
    case SMAX_EXP: MTT_SMAX_ROWS(SMAX_EXP) break;
    case SMAX_EXP2: MTT_SMAX_ROWS(SMAX_EXP2) break;
    case SMAX_NOMAX: MTT_SMAX_ROWS(SMAX_NOMAX) break;
    default: MTT_SMAX_ROWS(SMAX_SKIP) break;
  }
#undef MTT_SMAX_ROWS
}

// ------------------------------------------------------------ resident branch

// Grid (cluster · heads / group, qsplit, batch), cluster (G / hpc, 1, 1):
// CTA rank c of group g owns heads g·G + c·hpc ...; split s walks query
// tiles s, s + qsplit, ...
template <int DH>
__global__ void __launch_bounds__(RES_THREADS, 1)
    attention_phased_resident(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ o, int nq, int nk,
                              int group, int hpc, int qt, int qsplit, long long q_bs, int q_rs,
                              long long k_bs, int k_rs, long long v_bs, int v_rs, long long o_bs,
                              int o_rs, float scale, int smax, int divide) {
  constexpr int DS = DH + 8, CPR = DH / 8, KT = DH / 16;
  constexpr int WARPS = RES_THREADS / 32;
  extern __shared__ __align__(16) unsigned char ph_smem[];
  const int nkp = (nk + 15) & ~15, ss = nkp + 4, ps = nkp + 8, ntk = nkp / 16, qo_n = qt / 8;
  const int qstride = hpc * DH + 8, qchunks = hpc * CPR;
  bf16* kv = reinterpret_cast<bf16*>(ph_smem);  // K of each head, then V of each head
  float* sc = reinterpret_cast<float*>(kv + (size_t)2 * hpc * nkp * DS);
  float* lsum = sc + (size_t)hpc * qt * ss;
  bf16* pbuf = reinterpret_cast<bf16*>(lsum + hpc * qt);  // hpc·qt × ps
  bf16* qbuf = pbuf + (size_t)hpc * qt * ps;               // 2 × qt × qstride

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int cl = group / hpc, rank = blockIdx.x % cl;
  const int h0 = (blockIdx.x / cl) * group + rank * hpc;
  const int split = blockIdx.y, b = blockIdx.z;
  const int ntiles = (nq + qt - 1) / qt;
  const int count = split < ntiles ? (ntiles - split + qsplit - 1) / qsplit : 0;
  if (count == 0) return;  // the cluster's CTAs share the split: none meets a barrier
  const bf16* qb = q + b * q_bs + (long long)h0 * DH;

  auto load_q = [&](bf16* dst, int q0) {
    for (int e = tid; e < qt * qchunks; e += RES_THREADS) {
      const int r = e / qchunks, c = (e - r * qchunks) * 8, g = q0 + r;
      const bool ok = g < nq;
      cp_async16(smem_u32(dst + r * qstride + c), ok ? qb + (long long)g * q_rs + c : qb,
                 ok ? 16 : 0);
    }
  };
  // rows [0, nkp) of the CTA's heads' K or V (rows past nk zero-filled)
  auto load_kv = [&](bf16* dst, const bf16* src, long long bs, int rs) {
    const bf16* base = src + b * bs + (long long)h0 * DH;
    for (int e = tid; e < hpc * nkp * CPR; e += RES_THREADS) {
      const int hh = e / (nkp * CPR), r0 = e - hh * nkp * CPR;
      const int r = r0 / CPR, c = (r0 - r * CPR) * 8;
      const bool ok = r < nk;
      const bf16* s = base + hh * DH;
      cp_async16(smem_u32(dst + ((size_t)hh * nkp + r) * DS + c),
                 ok ? s + (long long)r * rs + c : s, ok ? 16 : 0);
    }
  };
  load_q(qbuf, split * qt);
  load_kv(kv, k, k_bs, k_rs);
  cp_async_commit();  // group: K and the first tile's Q
  load_kv(kv + (size_t)hpc * nkp * DS, v, v_bs, v_rs);
  cp_async_commit();  // group: V

  const float sl = smax == SMAX_EXP2 ? scale * 1.4426950408889634f : scale;
  for (int it = 0; it < count; ++it) {
    const int q0 = (split + it * qsplit) * qt;
    bf16* qo = qbuf + (it & 1) * qt * qstride;
    if (it == 0) cp_async_wait<1>();  // K and Q (V may still be in flight)
    else cp_async_wait<0>();          // this tile's Q
    __syncthreads();
    // the next tile's Q into the other buffer (written out and synced at the last tile's end)
    if (it + 1 < count) load_q(qbuf + ((it + 1) & 1) * qt * qstride, q0 + qsplit * qt);
    cp_async_commit();

    // phase 1: scores of the CTA's heads: per (head, 16 keys), K·Qᵀ for each
    // query octet of the tile (one K fragment, qt / 8 products)
    {
      uint32_t qf[2][KT][2];  // Qᵀ of the head's octets as col-major B operands
      int held = -1;          // the head whose fragments qf holds
      for (int item = warp; item < hpc * ntk; item += WARPS) {
        const int hh = item / ntk, t = item - hh * ntk;
        if (hh != held) {
#pragma unroll
          for (int qg = 0; qg < 2; ++qg)
            if (qg < qo_n)
#pragma unroll
              for (int kt = 0; kt < KT; ++kt)
                ldmatrix_x2(qf[qg][kt], smem_u32(qo + (qg * 8 + (lane & 7)) * qstride + hh * DH +
                                                 kt * 16 + ((lane >> 3) & 1) * 8));
          held = hh;
        }
        const bf16* kh = kv + (size_t)hh * nkp * DS;
        float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          uint32_t a[4];
          ldmatrix_x4(a, smem_u32(kh + (t * 16 + (lane & 15)) * DS + kt * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int qg = 0; qg < 2; ++qg)
            if (qg < qo_n) mma_bf16_16816(c[qg], a, qf[qg][kt][0], qf[qg][kt][1]);
        }
        // rows: keys t·16 + gid (+ 8); columns: queries qg·8 + 2·tig (+ 1)
        const int key = t * 16 + gid;
#pragma unroll
        for (int qg = 0; qg < 2; ++qg) {
          if (qg >= qo_n) break;
          float* rows = sc + (size_t)(hh * qt + qg * 8 + 2 * tig) * ss;
          rows[key] = c[qg][0] * sl;
          rows[ss + key] = c[qg][1] * sl;
          rows[key + 8] = c[qg][2] * sl;
          rows[ss + key + 8] = c[qg][3] * sl;
        }
      }
    }
    cluster_sync();  // every head of the group has its scores

    // phase 2: one softmax pass over every (head, query) row of the CTA, P
    // into its own rows
    softmax_rows(smax, sc, lsum, pbuf, hpc * qt, ss, ps, nk, nkp, warp, WARPS);
    if (it == 0) cp_async_wait<1>();  // V has landed (the next Q may be in flight)
    cluster_sync();                   // every row of the group is P

    // phase 3: Oᵀ (dh × 8) = Vᵀ·Pᵀ per (head, 16 head-dim rows, query octet)
    for (int item = warp; item < hpc * KT * qo_n; item += WARPS) {
      const int hh = item / (KT * qo_n), r = item - hh * KT * qo_n, mt = r / qo_n,
                qg = r - mt * qo_n;
      const bf16* vh = kv + (size_t)(hpc + hh) * nkp * DS;
      const bf16* prow = pbuf + (size_t)(hh * qt + qg * 8 + (lane & 7)) * ps;
      // two accumulators (even and odd key tiles) halve the chain of dependent MMAs
      float c[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
      auto pv = [&](float(&acc)[4], int kk) {
        uint32_t a[4], bq[2];
        ldmatrix_x4_trans(a, smem_u32(vh + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * DS +
                                      mt * 16 + ((lane >> 3) & 1) * 8));
        ldmatrix_x2(bq, smem_u32(prow + kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16_16816(acc, a, bq[0], bq[1]);
      };
      int kk = 0;
      for (; kk + 1 < ntk; kk += 2) {
        pv(c, kk);
        pv(c2, kk + 1);
      }
      if (kk < ntk) pv(c, kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] += c2[e];
      // rows: head-dim columns mt·16 + gid (+ 8); columns: queries qg·8 + 2·tig (+ 1)
      const int r0 = hh * qt + qg * 8 + 2 * tig;
      const float l0 = divide ? lsum[r0] : 1.f, l1 = divide ? lsum[r0 + 1] : 1.f;
      bf16* o0 = qo + (qg * 8 + 2 * tig) * qstride + hh * DH + mt * 16 + gid;
      bf16* o1 = o0 + qstride;
      o0[0] = __float2bfloat16(c[0] / l0);
      o1[0] = __float2bfloat16(c[1] / l1);
      o0[8] = __float2bfloat16(c[2] / l0);
      o1[8] = __float2bfloat16(c[3] / l1);
    }
    __syncthreads();

    // the tile's output rows, 16 bytes at a time
    bf16* ob = o + b * o_bs + (long long)h0 * DH;
    for (int e = tid; e < qt * qchunks; e += RES_THREADS) {
      const int r = e / qchunks, c = (e - r * qchunks) * 8, g = q0 + r;
      if (g < nq)
        *reinterpret_cast<uint4*>(ob + (long long)g * o_rs + c) =
            *reinterpret_cast<const uint4*>(qo + r * qstride + c);
    }
  }
  cp_async_wait<0>();  // nothing in flight when the CTA exits
}

// ------------------------------------------------------------- staging branch

template <int DH>
__global__ void __launch_bounds__(PH_THREADS)
    attention_phased_staged(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o, int nq, int nk,
                            int group, long long q_bs, int q_rs, long long k_bs, int k_rs,
                            long long v_bs, int v_rs, long long o_bs, int o_rs, float scale,
                            int smax, int divide) {
  constexpr int DS = DH + 8, CPR = DH / 8, KT = DH / 16;
  constexpr int WARPS = PH_THREADS / 32;
  extern __shared__ __align__(16) unsigned char ph_smem[];
  const int G = group, nkp = (nk + 15) & ~15, ss = nkp + 4, ps = nkp + 8, qstride = G * DH + 8;
  float* sc = reinterpret_cast<float*>(ph_smem);  // row (head, query): ss floats
  float* lsum = sc + (size_t)G * PQ * ss;
  bf16* pbuf = reinterpret_cast<bf16*>(lsum + G * PQ);  // row (head, query): ps bf16
  bf16* qo = pbuf + (size_t)G * PQ * ps;
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
  const float sl = smax == SMAX_EXP2 ? scale * 1.4426950408889634f : scale;

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

  // phase 2: one softmax pass over every (head, query) row; P as bf16
  softmax_rows(smax, sc, lsum, pbuf, G * PQ, ss, ps, nk, nkp, warp, WARPS);
  __syncthreads();

  // phase 3: Oᵀ (dh × 8) = Vᵀ·Pᵀ per head, 16 head-dim rows a warp
  for (int hh = 0; hh < G; ++hh) {
    stage(v + b * v_bs + (long long)(h0 + hh) * DH, v_rs);
    const bf16* prow = pbuf + (size_t)(hh * PQ + (lane & 7)) * ps;
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

// ------------------------------------------------------------------ launch

struct PhasedArgs {
  const bf16 *q, *k, *v;
  bf16* o;
  int batch, nq, nk, heads, group, hpc, qt, qsplit;
  long long q_bs;
  int q_rs;
  long long k_bs;
  int k_rs;
  long long v_bs;
  int v_rs;
  long long o_bs;
  int o_rs;
  float scale;
  int smax, divide;
};

template <int DH>
static int launch_resident(const PhasedArgs& a, size_t bytes, cudaStream_t s) {
  static SmemLimit limit;
  if (int err = set_smem(attention_phased_resident<DH>, bytes, limit)) return err;
  const int cl = a.group / a.hpc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * (a.heads / a.group), a.qsplit, a.batch);
  cfg.blockDim = dim3(RES_THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, attention_phased_resident<DH>, a.q, a.k, a.v, a.o, a.nq, a.nk, a.group, a.hpc, a.qt,
      a.qsplit, a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs, a.o_bs, a.o_rs, a.scale, a.smax,
      a.divide);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int DH>
static int launch_staged(const PhasedArgs& a, size_t bytes, cudaStream_t s) {
  static SmemLimit limit;
  if (int err = set_smem(attention_phased_staged<DH>, bytes, limit)) return err;
  const dim3 grid((a.nq + PQ - 1) / PQ, a.heads / a.group, a.batch);
  attention_phased_staged<DH><<<grid, PH_THREADS, bytes, s>>>(
      a.q, a.k, a.v, a.o, a.nq, a.nk, a.group, a.q_bs, a.q_rs, a.k_bs, a.k_rs, a.v_bs, a.v_rs,
      a.o_bs, a.o_rs, a.scale, a.smax, a.divide);
  return (int)cudaGetLastError();
}

template <int DH>
static int launch(int resident, const PhasedArgs& a, size_t bytes, cudaStream_t s) {
  return resident ? launch_resident<DH>(a, bytes, s) : launch_staged<DH>(a, bytes, s);
}

// bf16 q (B, nq, heads·dh), k and v (B, nk, heads·dh) views with unit
// column stride (strides in elements), o likewise; `group` heads per phase
// (dividing heads); smax: SMAX_EXP, SMAX_EXP2, SMAX_NOMAX or SMAX_SKIP;
// divide = 0 leaves the output unnormalised. resident = 1: the resident
// branch with hpc heads per CTA (group / hpc ≤ 8 CTAs a cluster), qt (8 or
// 16) queries a tile, the query tiles split over qsplit clusters; resident =
// 0: the staging branch (hpc, qt and qsplit unused).
extern "C" int mtt_attention_phased(const void* q, const void* k, const void* v, void* o,
                                    int batch, int nq, int nk, int heads, int dh, int group,
                                    int resident, int hpc, int qt, int qsplit, long long q_bs,
                                    int q_rs, long long k_bs, int k_rs, long long v_bs, int v_rs,
                                    long long o_bs, int o_rs, float scale, int smax, int divide,
                                    void* stream) {
  if (batch <= 0 || batch > 65535 || nq <= 0 || nk <= 0 || nk > MAX_KEYS || dh <= 0 ||
      dh > MAX_DH || dh % 16 || group <= 0 || heads % group || smax < SMAX_EXP ||
      smax > SMAX_SKIP)
    return (int)cudaErrorInvalidValue;
  const long long strides[] = {q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs};
  for (long long st : strides)
    if (st % 8) return (int)cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
  size_t bytes;
  if (resident) {
    if (hpc <= 0 || group % hpc || group / hpc > MAX_CLUSTER || (qt != 8 && qt != 16) ||
        qsplit <= 0 || qsplit > 65535)
      return (int)cudaErrorInvalidValue;
    bytes = resident_smem_bytes(nk, dh, hpc, qt);
  } else {
    bytes = staged_smem_bytes(nk, dh, group);
  }
  if (bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const PhasedArgs a = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), static_cast<bf16*>(o), batch, nq, nk, heads,
                        group, hpc, qt, qsplit, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs,
                        scale, smax, divide};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(resident, a, bytes, s);
    case 32: return launch<32>(resident, a, bytes, s);
    case 48: return launch<48>(resident, a, bytes, s);
    case 64: return launch<64>(resident, a, bytes, s);
    case 80: return launch<80>(resident, a, bytes, s);
    case 96: return launch<96>(resident, a, bytes, s);
    case 112: return launch<112>(resident, a, bytes, s);
    case 128: return launch<128>(resident, a, bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}
