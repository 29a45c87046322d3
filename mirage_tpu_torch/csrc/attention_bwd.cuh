// The bf16 attention backward, for every (batch, head), shared by
// csrc/attention_bwd.cu (mtt_attention_bwd: the packed (B, N, 3D) qkv of up
// to 512 tokens, the core of B4/B7's backward and B6's) and
// csrc/flash_attention.cu (mtt_flash_bwd: q and kv in separate tensors, any
// length, B8's, with the forward's log-sum-exp). It replaces the attention
// cores of mirage_tpu/ops/block_attention.py:_block_attn_bwd_kernel and
// :_attn_half_bwd_rows (through _attn_half_bwd_dx_kernel and
// _attn_half_bwd_kernel), and mirage_tpu/ops/flash_attention.py:
// _attn_bwd_kernel.
//
// What it computes, as the TPU kernels do: P = softmax(q·kᵀ·scale) in float
// (exp2 of the scores in log2 units less the row's log-sum-exp), dP = dO·Vᵀ,
// delta = rowsum(P∘dP) from the float P and dP (the TPU's delta, not
// rowsum(dO∘O) from the rounded output), dS = P∘(dP − delta)·scale rounded
// to bf16, dQ = T(dS)·K, dK = T(dS)ᵀ·Q and dV = T(P)ᵀ·dO, each summed in
// float over every key (dQ) or query (dK, dV) and rounded once; the packed
// form also writes the float column sums of the unrounded dqkv over each
// 16-row group, which dbqkv is summed from.
//
// Bound: bytes at B4's and B6's shapes (q, k, v and dO read once, dq, dk, dv
// written once against 10·N²·dh FLOPs a head: 35-80 FLOPs a byte at 99-257
// tokens, under the card's ≈ 295), operations at B8's 1025. The first port
// (mma.sync, cp.async double buffers, four warps a block) spent 9 products
// where 5 suffice and read every operand twice. No kernel here uses atomics,
// so every sum has a fixed order and a rerun is bit for bit the same:
// - head_kernel, the packed form at up to 128 tokens and head dims up to 64
//   (B4's core at 99 tokens): one persistent launch, every product once and
//   every operand read once (see its comment).
// - Otherwise two launches. dq_kernel: a CTA is one warpgroup owning 64
//   query rows of a (batch, head); thread 0 loads its Q and dO once and
//   streams K and V by TMA in 64-key chunks through a ring of full/empty
//   mbarriers. Pass 1 issues S = Q·Kᵀ and dP = dO·Vᵀ (wgmma, both operands
//   K-major in shared memory) and carries the row max, the row sum of exp
//   and the row sum of exp·dP, which give the log-sum-exp (the packed form;
//   the flash form reads the forward's) and delta. Pass 2 issues them again
//   and dQ += T(dS)·K with dS from registers (register-A wgmma) and K read
//   MN-major. Where every chunk fits the ring, pass 2 reads the chunks pass
//   1 left there. It writes dQ, the log-sum-exp and delta.
// - dkv_kernel: a CTA is one warpgroup owning 64 key rows; thread 0 loads
//   its K and V once and streams Q and dO in chunks of 64 queries (32 at
//   head dims above 64, to bound the registers). For each chunk it issues
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, turns them into Pᵀ and dSᵀ with the chunk's
//   log-sum-exp and delta, and issues dV += T(P)ᵀ·dO and dK += T(dS)ᵀ·Q (Pᵀ
//   and dSᵀ from registers, Q and dO read MN-major). So these two issue 7
//   products where 5 suffice (S and dP twice) and read q, k, v and dO
//   twice, once in each kernel.
// One warpgroup a CTA keeps the two kernels' shared memory near 65 KB, so
// two or three CTAs share an SM and one's loads run under another's
// products. Every wgmma is issued in straight-line code of compile-time
// widths (the rounds peeled), as ptxas otherwise serializes them (note
// C7520). Head dims 16 and 32 are loaded as boxes of their own width (32-
// and 64-byte swizzle), the others as 64-column boxes (128-byte swizzle)
// whose k-steps stop at dh; dQ, dK and dV are issued 64 or 128 wide and the
// columns past dh are not stored. Rows past nq or nk read as zeros; keys
// past nk are masked out of P, and queries past nq enter with a log-sum-exp
// of +∞, so P = 0 there.
//
// MTT_ATTN_BWD_SPLIT_NO_DQ, _NO_DKV, _NO_SOFTMAX and _LOADS build variants
// without the dQ products (dq_kernel's second pass), without the dK and dV
// products (dkv_kernel), without the exponentials, or without any product,
// for chip_smoke.py --attn-bwd-split; the library build defines none of
// them.
#pragma once

#include <math.h>

#include <algorithm>
#include <initializer_list>

#include "wgmma.cuh"

#ifdef MTT_ATTN_BWD_SPLIT_NO_SOFTMAX
#define MTT_BWD_EXP2(x) (x)
#else
#define MTT_BWD_EXP2(x) exp2f(x)
#endif

namespace attn_bwd {

constexpr int ROWS = 64;                 // rows of a CTA's warpgroup: queries or keys
constexpr int THREADS = 128;             // one consumer warpgroup, thread 0 the loader
constexpr int KC = 64;                   // keys a dq_kernel ring stage holds
constexpr int SMEM_BUDGET = 72 * 1024;   // three CTAs an SM
constexpr float LOG2E_F = 1.4426950408889634f;

// How a head dim is laid out in shared memory and how many ring stages fit
// the budget (ops/block_attention.py:attention_bwd_plan mirrors it).
template <int DH>
struct Geom {
  static constexpr int BOXC = (DH == 16 || DH == 32) ? DH : 64;  // columns of a TMA box
  static constexpr int NBOX = (DH + BOXC - 1) / BOXC;             // boxes a row
  static constexpr int NPV = NBOX * BOXC;                         // dQ's, dK's and dV's width
  static constexpr int ROWB = BOXC * 2;                           // a box row = the swizzle
  static constexpr int KSTEPS = DH / 16;                          // S's and dP's k16 steps
  static constexpr int TILE = NBOX * ROWS * ROWB;                 // 64 rows × all columns
  static constexpr int QC = NPV <= 64 ? 64 : 32;                  // queries a dkv_kernel stage holds
  static constexpr int QTILE = NBOX * QC * ROWB;
  static constexpr int DQ_FIT = (SMEM_BUDGET - 1024 - 2 * TILE) / (2 * TILE);
  static constexpr int DQ_STAGES = DQ_FIT < 2 ? 2 : DQ_FIT > 8 ? 8 : DQ_FIT;
  static constexpr int KV_FIT = (SMEM_BUDGET - 1024 - 2 * TILE) / (2 * QTILE);
  static constexpr int KV_STAGES = KV_FIT < 2 ? 2 : KV_FIT > 8 ? 8 : KV_FIT;
  // alignment slack, the two resident tiles, the ring, full[S], empty[S], rbar
  static constexpr int DQ_SMEM = 1024 + (2 + 2 * DQ_STAGES) * TILE + 8 * (2 * DQ_STAGES + 1);
  static constexpr int KV_SMEM = 1024 + 2 * TILE + 2 * KV_STAGES * QTILE + 8 * (2 * KV_STAGES + 1);
};

// acc (64 × W) = A (64 rows) · B (W rows)ᵀ over the head's k16 steps, both
// K-major tiles of the head's boxes in shared memory (B's boxes BROWS rows)
template <int DH, int W, int BROWS>
__device__ __forceinline__ void ss_product(float (&acc)[W / 2], uint32_t a, uint32_t b) {
  using G = Geom<DH>;
  constexpr int KPB = G::BOXC / 16;  // k16 steps a box holds
#pragma unroll
  for (int ks = 0; ks < G::KSTEPS; ++ks) {
    const uint32_t col = (ks % KPB) * 32;
    wgmma_ss<W>(acc, wgmma_desc_sw(a + (ks / KPB) * ROWS * G::ROWB + col, G::ROWB),
                wgmma_desc_sw(b + (ks / KPB) * BROWS * G::ROWB + col, G::ROWB), ks > 0);
  }
}

// acc (64 × NPV) += A (64 × 16·KK, register fragments) · B, B a tile of
// 16·KK rows (BROWS a box) read MN-major: its rows are the k index
template <int DH, int KK, int BROWS>
__device__ __forceinline__ void rs_product(float (&acc)[Geom<DH>::NPV / 2],
                                           const uint32_t (&a)[KK][4], uint32_t b) {
  using G = Geom<DH>;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    wgmma_rs<G::NPV, 1>(acc, a[kk], wgmma_desc_mn_sw(b + kk * 16 * G::ROWB, BROWS * G::ROWB, G::ROWB));
}

// S, dP (64 × W) rounded to bf16 A fragments: s_acc's two 8-column blocks
// j, j + 1 are the k16 step j / 2
template <int W>
__device__ __forceinline__ void to_frags(uint32_t (&f)[W / 16][4], const float (&acc)[W / 2]) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    f[j >> 1][(j & 1) * 2] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    f[j >> 1][(j & 1) * 2 + 1] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// A warp's 16 rows of a 64 × NPV float accumulator, rows row0 + gid (+ 8):
// their float sums over the rows below n for each of the DH columns, into
// part[0 .. DH), in a fixed order (the partials dbqkv is summed from).
template <int DH>
__device__ __forceinline__ void col_sums(const float (&acc)[Geom<DH>::NPV / 2], int row0, int n,
                                         float* part) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const bool v0 = row0 + gid < n, v1 = row0 + gid + 8 < n;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    float s0 = (v0 ? acc[4 * j] : 0.f) + (v1 ? acc[4 * j + 2] : 0.f);
    float s1 = (v0 ? acc[4 * j + 1] : 0.f) + (v1 ? acc[4 * j + 3] : 0.f);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (gid == 0) {
      part[j * 8 + 2 * tig] = s0;
      part[j * 8 + 2 * tig + 1] = s1;
    }
  }
}

// The outputs leave through shared memory: a warpgroup's 64-row tile,
// rounded to bf16, is staged as boxes of 64 rows × 128 bytes (STAGE_BOX
// each), the 16-byte chunk c of row r at chunk c ^ (r % 8) (no bank
// conflict either way), then written out as 16-byte rows. 4-byte pair
// stores straight from the fragments, 8 rows an instruction, set the pace
// of the one-launch kernel on the H100 (PERF.md §6).
constexpr int STAGE_BOX = ROWS * 128;

template <int DH>
__device__ __forceinline__ void stage_tile(const float (&acc)[Geom<DH>::NPV / 2], uint32_t stg) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const uint32_t row = ((threadIdx.x >> 5) & 3) * 16 + gid;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stg + (j / 8) * STAGE_BOX +
                                                    (row + 8 * hf) * 128 +
                                                    (((j % 8) ^ gid) << 4) + 4 * tig),
                   "r"(pack_bf16(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]))
                   : "memory");
}

// rows row_base .. row_base + 63 of a staged tile, those below n, to out
// (row stride rs), by the warpgroup's 128 threads
template <int DH>
__device__ __forceinline__ void copy_tile(uint32_t stg, bf16* out, int rs, int row_base, int n) {
  constexpr int CPR = DH / 8;  // 16-byte chunks a row
#pragma unroll
  for (int e = threadIdx.x & 127; e < ROWS * CPR; e += 128) {
    const int r = e / CPR, c = e % CPR;
    if (row_base + r >= n) continue;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(stg + (c / 8) * STAGE_BOX + r * 128 + (((c % 8) ^ (r & 7)) << 4)));
    *reinterpret_cast<uint4*>(out + (long long)(row_base + r) * rs + c * 8) = v;
  }
}

__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ------------------------------------------------------------- dq_kernel

// One round's products as one wgmma group: S = Q·Kᵀ and dP = dO·Vᵀ of a
// chunk (SS), and dQ += T(dS)·K of the chunk before (RS).
template <int DH, bool SS, bool RS>
__device__ __forceinline__ void dq_issue(float (&s)[KC / 2], float (&dp)[KC / 2],
                                         float (&dq)[Geom<DH>::NPV / 2],
                                         const uint32_t (&ds)[KC / 16][4], uint32_t q, uint32_t d,
                                         uint32_t k, uint32_t v, uint32_t k_prev) {
  wgmma_fence();
#ifndef MTT_ATTN_BWD_SPLIT_LOADS
  if constexpr (SS) {
    ss_product<DH, KC, KC>(s, q, k);
    ss_product<DH, KC, KC>(dp, d, v);
  }
  if constexpr (RS) rs_product<DH, KC / 16, KC>(dq, ds, k_prev);
#endif
  wgmma_commit();
}

// STATS: the packed form, which computes the log-sum-exp (written to lse);
// else the flash form, which reads the forward's. Both write delta.
template <int DH, bool STATS>
__global__ void __launch_bounds__(THREADS, 2)
    dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
              bf16* __restrict__ dq, long long dq_bs, int dq_rs, float* __restrict__ lse,
              float* __restrict__ delta, float* __restrict__ part, int part_rs, int groups, int nq,
              int nk, int heads, float scale_log2, float scale) {
  using G = Geom<DH>;
  constexpr int S = G::DQ_STAGES;
  extern __shared__ unsigned char attn_bwd_smem[];
  const uint32_t sq = (smem_u32(attn_bwd_smem) + 1023) & ~1023u;  // the swizzle's period
  const uint32_t sdo = sq + G::TILE, sst = sdo + G::TILE;           // stage s: K, then V
  const uint32_t full = sst + S * 2 * G::TILE, empty = full + 8 * S, rbar = empty + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int nch = (nk + KC - 1) / KC;
  // every chunk fits the ring: pass 2 reads what pass 1 loaded
  const bool resident = nch <= S;
  const int loads = resident ? nch : 2 * nch;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // every warp
    }
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const bool loader = tid == 0;
  auto stage = [&](int t) { return sst + (t % S) * 2 * G::TILE; };
  auto load_chunk = [&](int t) {  // load t holds chunk t % nch
    const uint32_t st = stage(t), bar = full + 8 * (t % S);
    mbar_expect_tx(bar, 2 * G::TILE);
#pragma unroll
    for (int x = 0; x < G::NBOX; ++x) {
      tma_load_3d(st + x * ROWS * G::ROWB, &map_k, bar, h * DH + x * G::BOXC, (t % nch) * KC, b);
      tma_load_3d(st + G::TILE + x * ROWS * G::ROWB, &map_v, bar, h * DH + x * G::BOXC,
                  (t % nch) * KC, b);
    }
  };
  if (loader) {
    mbar_expect_tx(rbar, 2 * G::TILE);
#pragma unroll
    for (int x = 0; x < G::NBOX; ++x) {
      tma_load_3d(sq + x * ROWS * G::ROWB, &map_q, rbar, h * DH + x * G::BOXC, q0, b);
      tma_load_3d(sdo + x * ROWS * G::ROWB, &map_do, rbar, h * DH + x * G::BOXC, q0, b);
    }
    for (int t = 0; t < min(S, loads); ++t) load_chunk(t);
  }
  float s_acc[KC / 2], dp_acc[KC / 2], dq_acc[G::NPV / 2];
  uint32_t ds_frag[KC / 16][4];
#pragma unroll
  for (int i = 0; i < KC / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < G::NPV / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KC / 16; ++i) ds_frag[i][0] = ds_frag[i][1] = ds_frag[i][2] = ds_frag[i][3] = 0u;
  const int row0 = q0 + warp * 16;  // this warp's rows: row0 + gid, row0 + gid + 8
  const long long sbase = ((long long)b * heads + h) * nq;
  float lse_r[2] = {0.f, 0.f}, del_r[2];
  if constexpr (!STATS) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + gid + 8 * hf;
      lse_r[hf] = r < nq ? lse[sbase + r] : 0.f;
    }
  }
  auto wait_chunk = [&](int t) { mbar_wait(full + 8 * (t % S), (t / S) & 1); };
  auto finish = [&]() {
    wgmma_wait<0>();
    fence_regs(s_acc);
    fence_regs(dp_acc);
    fence_regs(dq_acc);
    keep_frags(ds_frag);  // the dQ product read them asynchronously until the wait
  };
  // load t is done with: every warp releases its stage, and the loader
  // refills it once all have
  auto release = [&](int t) {
    if (resident) return;
    if (lane == 0) mbar_arrive(empty + 8 * (t % S));
    if (loader && t + S < loads) {
      mbar_wait(empty + 8 * (t % S), (t / S) & 1);
      load_chunk(t + S);
    }
  };
  // keys past nk at −∞ (only the last chunk has them)
  auto mask = [&](int c) {
    if (c != nch - 1) return;
    const int key0 = c * KC + 2 * tig;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + j * 8 + (e & 1) >= nk) s_acc[4 * j + e] = -INFINITY;
  };
  mbar_wait(rbar, 0);

  // pass 1: the row statistics
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, u_run[2] = {0.f, 0.f};
  for (int c = 0; c < nch; ++c) {
    wait_chunk(c);
    dq_issue<DH, true, false>(s_acc, dp_acc, dq_acc, ds_frag, sq, sdo, stage(c), stage(c) + G::TILE, 0);
    finish();
    release(c);
    mask(c);
    if constexpr (STATS) {
      // the running max in log2 units (the scale is positive: the max of
      // the raw scores times the scale is the max of the scaled ones)
      float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < KC / 2; ++i) cmax[(i >> 1) & 1] = fmaxf(cmax[(i >> 1) & 1], s_acc[i]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        cmax[hf] = fmaxf(cmax[hf], __shfl_xor_sync(0xffffffffu, cmax[hf], 1));
        cmax[hf] = fmaxf(cmax[hf], __shfl_xor_sync(0xffffffffu, cmax[hf], 2));
        const float m_new = fmaxf(m_run[hf], cmax[hf] * scale_log2);  // finite: a chunk has a key
        const float corr = MTT_BWD_EXP2(m_run[hf] - m_new);
        m_run[hf] = m_new;
        l_run[hf] *= corr;
        u_run[hf] *= corr;
      }
#pragma unroll
      for (int i = 0; i < KC / 2; ++i) {
        const float p = MTT_BWD_EXP2(fmaf(s_acc[i], scale_log2, -m_run[(i >> 1) & 1]));
        l_run[(i >> 1) & 1] += p;
        u_run[(i >> 1) & 1] += p * dp_acc[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < KC / 2; ++i)
        u_run[(i >> 1) & 1] +=
            MTT_BWD_EXP2(fmaf(s_acc[i], scale_log2, -lse_r[(i >> 1) & 1])) * dp_acc[i];
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float u = u_run[hf];
    u += __shfl_xor_sync(0xffffffffu, u, 1);
    u += __shfl_xor_sync(0xffffffffu, u, 2);
    if constexpr (STATS) {
      float l = l_run[hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      lse_r[hf] = m_run[hf] + log2f(l);
      del_r[hf] = u / l;
    } else {
      del_r[hf] = u;
    }
  }

#ifndef MTT_ATTN_BWD_SPLIT_NO_DQ
  // pass 2: dS, and dQ += T(dS)·K one round behind
  auto t2 = [&](int c) { return resident ? c : nch + c; };
  auto make_ds = [&](int c) {
    mask(c);
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) {
      const int hf = (i >> 1) & 1;
      const float p = MTT_BWD_EXP2(fmaf(s_acc[i], scale_log2, -lse_r[hf]));
      s_acc[i] = p * (dp_acc[i] - del_r[hf]) * scale;
    }
    to_frags<KC>(ds_frag, s_acc);
  };
  wait_chunk(t2(0));
  dq_issue<DH, true, false>(s_acc, dp_acc, dq_acc, ds_frag, sq, sdo, stage(t2(0)),
                            stage(t2(0)) + G::TILE, 0);
  finish();
  make_ds(0);
  for (int c = 1; c < nch; ++c) {
    wait_chunk(t2(c));
    dq_issue<DH, true, true>(s_acc, dp_acc, dq_acc, ds_frag, sq, sdo, stage(t2(c)),
                             stage(t2(c)) + G::TILE, stage(t2(c - 1)));
    finish();
    release(t2(c - 1));
    make_ds(c);
  }
  dq_issue<DH, false, true>(s_acc, dp_acc, dq_acc, ds_frag, 0, 0, 0, 0, stage(t2(nch - 1)));
  finish();
#endif

  if (tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + gid + 8 * hf;
      if (r >= nq) continue;
      if constexpr (STATS) lse[sbase + r] = lse_r[hf];
      delta[sbase + r] = del_r[hf];
    }
  }
  if (part != nullptr && row0 < nq)
    col_sums<DH>(dq_acc, row0, nq, part + ((long long)b * groups + row0 / 16) * part_rs + h * DH);
  __syncthreads();  // every product is done: the ring stages the output
  stage_tile<DH>(dq_acc, sst);
  __syncthreads();
  copy_tile<DH>(sst, dq + b * dq_bs + (long long)h * DH, dq_rs, q0, nq);
}

// ------------------------------------------------------------ dkv_kernel

// A chunk's products: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (SS), or dV += T(P)ᵀ·dO
// and dK += T(dS)ᵀ·Q (RS), as one wgmma group.
template <int DH, bool SS, bool RS>
__device__ __forceinline__ void dkv_issue(float (&s)[Geom<DH>::QC / 2],
                                          float (&dp)[Geom<DH>::QC / 2],
                                          float (&dv)[Geom<DH>::NPV / 2],
                                          float (&dk)[Geom<DH>::NPV / 2],
                                          const uint32_t (&p)[Geom<DH>::QC / 16][4],
                                          const uint32_t (&ds)[Geom<DH>::QC / 16][4], uint32_t k,
                                          uint32_t v, uint32_t q, uint32_t d, uint32_t q_prev,
                                          uint32_t d_prev) {
  using G = Geom<DH>;
  wgmma_fence();
#ifndef MTT_ATTN_BWD_SPLIT_LOADS
  if constexpr (SS) {
    ss_product<DH, G::QC, G::QC>(s, k, q);
    ss_product<DH, G::QC, G::QC>(dp, v, d);
  }
  if constexpr (RS) {
    rs_product<DH, G::QC / 16, G::QC>(dv, p, d_prev);
    rs_product<DH, G::QC / 16, G::QC>(dk, ds, q_prev);
  }
#endif
  wgmma_commit();
}

template <int DH>
__global__ void __launch_bounds__(THREADS, Geom<DH>::NPV <= 32 ? 3 : 2)
    dkv_kernel(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
               bf16* __restrict__ dk, long long dk_bs, int dk_rs, bf16* __restrict__ dv,
               long long dv_bs, int dv_rs, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ part_k,
               float* __restrict__ part_v, int part_rs, int groups, int nq, int nk, int heads,
               float scale_log2, float scale) {
  using G = Geom<DH>;
  constexpr int S = G::KV_STAGES, QC = G::QC;
  extern __shared__ unsigned char attn_bwd_smem[];
  const uint32_t sk = (smem_u32(attn_bwd_smem) + 1023) & ~1023u;
  const uint32_t sv = sk + G::TILE, sst = sv + G::TILE;  // stage s: Q, then dO
  const uint32_t full = sst + S * 2 * G::QTILE, empty = full + 8 * S, rbar = empty + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int nqc = (nq + QC - 1) / QC;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const bool loader = tid == 0;
  auto stage = [&](int c) { return sst + (c % S) * 2 * G::QTILE; };
  auto load_chunk = [&](int c) {
    const uint32_t st = stage(c), bar = full + 8 * (c % S);
    mbar_expect_tx(bar, 2 * G::QTILE);
#pragma unroll
    for (int x = 0; x < G::NBOX; ++x) {
      tma_load_3d(st + x * QC * G::ROWB, &map_q, bar, h * DH + x * G::BOXC, c * QC, b);
      tma_load_3d(st + G::QTILE + x * QC * G::ROWB, &map_do, bar, h * DH + x * G::BOXC, c * QC, b);
    }
  };
  if (loader) {
    mbar_expect_tx(rbar, 2 * G::TILE);
#pragma unroll
    for (int x = 0; x < G::NBOX; ++x) {
      tma_load_3d(sk + x * ROWS * G::ROWB, &map_k, rbar, h * DH + x * G::BOXC, k0, b);
      tma_load_3d(sv + x * ROWS * G::ROWB, &map_v, rbar, h * DH + x * G::BOXC, k0, b);
    }
    for (int c = 0; c < min(S, nqc); ++c) load_chunk(c);
  }
  float s_acc[QC / 2], dp_acc[QC / 2], dv_acc[G::NPV / 2], dk_acc[G::NPV / 2];
  uint32_t p_frag[QC / 16][4], ds_frag[QC / 16][4];
#pragma unroll
  for (int i = 0; i < QC / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < G::NPV / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < QC / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) p_frag[i][e] = ds_frag[i][e] = 0u;
  const long long sbase = ((long long)b * heads + h) * nq;
  // this thread's query columns of a chunk: 8j + 2·tig (+ 1); past nq, an
  // lse of +∞ gives P = 0 and a delta of 0 keeps dS finite
  float lz[QC / 4], dz[QC / 4];
  auto load_stats = [&](int c) {
#pragma unroll
    for (int j = 0; j < QC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = c * QC + j * 8 + 2 * tig + e;
        lz[2 * j + e] = qi < nq ? lse[sbase + qi] : INFINITY;
        dz[2 * j + e] = qi < nq ? delta[sbase + qi] : 0.f;
      }
  };
  auto finish = [&]() {
    wgmma_wait<0>();
    fence_regs(s_acc);
    fence_regs(dp_acc);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    keep_frags(p_frag);
    keep_frags(ds_frag);
  };
  auto release = [&](int c) {
    if (lane == 0) mbar_arrive(empty + 8 * (c % S));
    if (loader && c + S < nqc) {
      mbar_wait(empty + 8 * (c % S), (c / S) & 1);
      load_chunk(c + S);
    }
  };
  auto make_frags = [&]() {
#pragma unroll
    for (int i = 0; i < QC / 2; ++i) {
      const int col = 2 * (i >> 2) + (i & 1);
      const float p = MTT_BWD_EXP2(fmaf(s_acc[i], scale_log2, -lz[col]));
      s_acc[i] = p;
      dp_acc[i] = p * (dp_acc[i] - dz[col]) * scale;
    }
    to_frags<QC>(p_frag, s_acc);
    to_frags<QC>(ds_frag, dp_acc);
  };
  auto wait_chunk = [&](int c) { mbar_wait(full + 8 * (c % S), (c / S) & 1); };
  mbar_wait(rbar, 0);

  // the chunk's products in two groups: Sᵀ and dPᵀ, then dV and dK from
  // its Pᵀ and dSᵀ (not one round behind, as dq_kernel: the fragments and
  // the next scores are never live together, which lets three CTAs share
  // an SM at head dims up to 32 without a spill)
  for (int c = 0; c < nqc; ++c) {
    load_stats(c);
    wait_chunk(c);
    dkv_issue<DH, true, false>(s_acc, dp_acc, dv_acc, dk_acc, p_frag, ds_frag, sk, sv, stage(c),
                               stage(c) + G::QTILE, 0, 0);
    finish();
    make_frags();
    dkv_issue<DH, false, true>(s_acc, dp_acc, dv_acc, dk_acc, p_frag, ds_frag, 0, 0, 0, 0,
                               stage(c), stage(c) + G::QTILE);
    finish();
    release(c);
  }

  const int row0 = k0 + warp * 16;
  if (part_k != nullptr && row0 < nk) {
    const long long prow = ((long long)b * groups + row0 / 16) * part_rs + h * DH;
    col_sums<DH>(dk_acc, row0, nk, part_k + prow);
    col_sums<DH>(dv_acc, row0, nk, part_v + prow);
  }
  __syncthreads();  // every product is done: the ring stages the outputs
  stage_tile<DH>(dk_acc, sst);
  stage_tile<DH>(dv_acc, sst + G::NBOX * STAGE_BOX);
  __syncthreads();
  copy_tile<DH>(sst, dk + b * dk_bs + (long long)h * DH, dk_rs, k0, nk);
  copy_tile<DH>(sst + G::NBOX * STAGE_BOX, dv + b * dv_bs + (long long)h * DH, dv_rs, k0, nk);
}

// ----------------------------------------------------------- head_kernel

constexpr int HEAD_ROWS = 2 * ROWS;   // tokens a head_kernel CTA holds
constexpr int HEAD_THREADS = 2 * THREADS;
constexpr int PLANE = HEAD_ROWS * 128;  // P or dS of 64 keys × 128 queries, bf16

constexpr int HEAD_BUFS = 3;           // items a head_kernel CTA has loaded or in flight

// head_kernel's shared memory: HEAD_BUFS buffers of a head's Q, dO, K, V (two
// 64-row tiles each), the dS planes, the P planes (in the buffer's K and V
// tiles where they fit: from head dim 48), full[HEAD_BUFS]
template <int DH>
struct HeadGeom {
  static constexpr int INPUT = 8 * Geom<DH>::TILE;
  static constexpr bool P_IN_KV = 4 * Geom<DH>::TILE >= 2 * PLANE;
  static constexpr int SMEM =
      1024 + HEAD_BUFS * INPUT + (P_IN_KV ? 2 : 4) * PLANE + 8 * HEAD_BUFS;
};

// The packed form at up to 128 tokens and head dims up to 64 (B4's core at
// 99 tokens), every product once: a persistent CTA of two warpgroups walks
// the (batch, head) items, thread 0 loading the Q, dO, K and V of the item
// two ahead by TMA into a third buffer while this one's are used. Warpgroup
// w owns
// query rows 64w..64w+63 for S = Q·Kᵀ and dP = dO·Vᵀ over all 128 keys,
// takes the softmax and delta in its registers (all of a row's keys are
// there: no second pass, no log-sum-exp), issues dQ = T(dS)·K from
// registers, and writes T(P) and T(dS) into shared memory in the 128-byte
// swizzle TMA would give them, keys along a row; after a CTA barrier it
// owns keys 64w..64w+63 for dV = T(P)ᵀ·dO and dK = T(dS)ᵀ·Q, both operands
// MN-major in shared memory. T(P) goes where K and V were once dQ has read K
// in both warpgroups (a CTA barrier), so three buffers fit at head dim 64.
template <int DH>
__global__ void __launch_bounds__(HEAD_THREADS, 1)
    head_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                bf16* __restrict__ dqkv, float* __restrict__ part, int n, int heads,
                int batch, float scale_log2, float scale) {
  using G = Geom<DH>;
  static_assert(G::NPV <= 64, "head_kernel takes head dims up to 64");
  constexpr int T = G::TILE;
  extern __shared__ unsigned char attn_bwd_smem[];
  using HG = HeadGeom<DH>;
  const uint32_t base = (smem_u32(attn_bwd_smem) + 1023) & ~1023u;
  const uint32_t sds = base + HEAD_BUFS * HG::INPUT;
  const uint32_t sp_own = sds + 2 * PLANE;  // the P planes where they are not in K, V
  const uint32_t full = sp_own + (HG::P_IN_KV ? 0 : 2 * PLANE);
  const int tid = threadIdx.x, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // uniform in the warp, as wgmma needs
  const int warp = (tid >> 5) & 3;
  const int items = batch * heads, dim = heads * DH, groups = (n + 15) / 16;
  if (tid == 0) {
    for (int i = 0; i < HEAD_BUFS; ++i) mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // buffer: Q tiles at 0, T; dO at 2T, 3T; K at 4T, 5T; V at 6T, 7T
  auto load = [&](int item, int buf) {
    const uint32_t in = base + buf * HG::INPUT, bar = full + 8 * buf;
    const int b = item / heads, col = (item % heads) * DH;
    mbar_expect_tx(bar, HG::INPUT);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int x = 0; x < G::NBOX; ++x) {
        const uint32_t off = t * T + x * ROWS * G::ROWB;
        tma_load_3d(in + off, &map_q, bar, col + x * G::BOXC, t * ROWS, b);
        tma_load_3d(in + 2 * T + off, &map_do, bar, col + x * G::BOXC, t * ROWS, b);
        tma_load_3d(in + 4 * T + off, &map_k, bar, col + x * G::BOXC, t * ROWS, b);
        tma_load_3d(in + 6 * T + off, &map_v, bar, col + x * G::BOXC, t * ROWS, b);
      }
  };
  if (tid == 0)
    for (int i = 0; i < HEAD_BUFS - 1; ++i)
      if ((int)blockIdx.x + i * (int)gridDim.x < items) load(blockIdx.x + i * gridDim.x, i);
  const int row0 = wg * ROWS + warp * 16;  // this warp's rows: queries, then keys
  const uint32_t prow = (row0 + gid) * 128;  // this thread's first row in a plane
  for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
    const int buf = it % HEAD_BUFS;
    // the buffer of item it - 1, free since the barrier that ended it
    const int ahead = item + (HEAD_BUFS - 1) * gridDim.x;
    if (tid == 0 && ahead < items) load(ahead, (it + HEAD_BUFS - 1) % HEAD_BUFS);
    const uint32_t in = base + buf * HG::INPUT;
    const uint32_t sq = in, sdo = in + 2 * T, sk = in + 4 * T, sv = in + 6 * T;
    const uint32_t sp = HG::P_IN_KV ? sk : sp_own;
    const int b = item / heads, h = item % heads;
    mbar_wait(full + 8 * buf, (it / HEAD_BUFS) & 1);

    // S and dP of this warpgroup's 64 queries over the two 64-key tiles
    float s[2][KC / 2], dp[2][KC / 2];
    wgmma_fence();
#ifndef MTT_ATTN_BWD_SPLIT_LOADS
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      ss_product<DH, KC, ROWS>(s[t], sq + wg * T, sk + t * T);
      ss_product<DH, KC, ROWS>(dp[t], sdo + wg * T, sv + t * T);
    }
#endif
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      fence_regs(s[t]);
      fence_regs(dp[t]);
    }
    // keys past n at −∞; the row max (raw scores, the scale positive), P
    // normalised in float, delta = rowsum(P∘dP), dS = P∘(dP − delta)·scale
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < KC / 2; ++i) {
        if (t * KC + (i >> 2) * 8 + 2 * tig + (i & 1) >= n) s[t][i] = -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[t][i]);
      }
    float l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2)) * scale_log2;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < KC / 2; ++i) {
        s[t][i] = MTT_BWD_EXP2(fmaf(s[t][i], scale_log2, -mx[(i >> 1) & 1]));
        l[(i >> 1) & 1] += s[t][i];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
      l[hf] = 1.f / l[hf];
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < KC / 2; ++i) {
        s[t][i] *= l[(i >> 1) & 1];
        u[(i >> 1) & 1] += s[t][i] * dp[t][i];
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      u[hf] += __shfl_xor_sync(0xffffffffu, u[hf], 1);
      u[hf] += __shfl_xor_sync(0xffffffffu, u[hf], 2);
    }
    // T(dS) as dQ's A fragments (keys 0..127: k16 steps 0..7), and T(dS),
    // later T(P), into the planes of their 64-key tiles: row = query, the
    // 16-byte chunk of columns 8j..8j+7 at chunk j ^ (row % 8) (= gid)
    auto plane_at = [&](int t, int j, int hf) {
      return t * PLANE + prow + hf * 8 * 128 + ((j ^ gid) << 4) + 4 * tig;
    };
    uint32_t ds_frag[2 * KC / 16][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * j + 2 * hf;
          const uint32_t dd = pack_bf16(s[t][i] * (dp[t][i] - u[hf]) * scale,
                                        s[t][i + 1] * (dp[t][i + 1] - u[hf]) * scale);
          ds_frag[t * (KC / 16) + (j >> 1)][(j & 1) * 2 + hf] = dd;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sds + plane_at(t, j, hf)), "r"(dd)
                       : "memory");
        }

    // dQ = T(dS)·K, K read MN-major from its two tiles
    float dq[G::NPV / 2];
#pragma unroll
    for (int i = 0; i < G::NPV / 2; ++i) dq[i] = 0.f;
    wgmma_fence();
#if !defined(MTT_ATTN_BWD_SPLIT_LOADS) && !defined(MTT_ATTN_BWD_SPLIT_NO_DQ)
#pragma unroll
    for (int kk = 0; kk < 2 * KC / 16; ++kk)
      wgmma_rs<G::NPV, 1>(dq, ds_frag[kk],
                          wgmma_desc_mn_sw(sk + (kk / 4) * T + (kk % 4) * 16 * G::ROWB,
                                           ROWS * G::ROWB, G::ROWB));
#endif
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    keep_frags(ds_frag);
    if constexpr (HG::P_IN_KV) __syncthreads();  // both warpgroups' dQ have read K
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sp + plane_at(t, j, hf)),
                       "r"(pack_bf16(s[t][4 * j + 2 * hf], s[t][4 * j + 2 * hf + 1]))
                       : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the planes, for wgmma
    __syncthreads();  // every row of both planes is written

    // dV = T(P)ᵀ·dO and dK = T(dS)ᵀ·Q for this warpgroup's 64 keys: A is its
    // plane read MN-major (k = the query rows, 16 a step), B the dO or Q
    // tiles read MN-major
    float dv[G::NPV / 2], dk[G::NPV / 2];
#pragma unroll
    for (int i = 0; i < G::NPV / 2; ++i) dv[i] = dk[i] = 0.f;
    wgmma_fence();
#if !defined(MTT_ATTN_BWD_SPLIT_LOADS) && !defined(MTT_ATTN_BWD_SPLIT_NO_DKV)
#pragma unroll
    for (int kk = 0; kk < 2 * KC / 16; ++kk) {
      const uint32_t b_off = (kk / 4) * T + (kk % 4) * 16 * G::ROWB;
      wgmma_ss<G::NPV, 1, 1>(dv, wgmma_desc_mn_sw(sp + wg * PLANE + kk * 2048, PLANE, 128),
                             wgmma_desc_mn_sw(sdo + b_off, ROWS * G::ROWB, G::ROWB), kk > 0);
      wgmma_ss<G::NPV, 1, 1>(dk, wgmma_desc_mn_sw(sds + wg * PLANE + kk * 2048, PLANE, 128),
                             wgmma_desc_mn_sw(sq + b_off, ROWS * G::ROWB, G::ROWB), kk > 0);
    }
#endif
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (row0 < n) {
      float* pr = part + ((long long)b * groups + row0 / 16) * 3 * dim + h * DH;
      col_sums<DH>(dq, row0, n, pr);
      col_sums<DH>(dk, row0, n, pr + dim);
      col_sums<DH>(dv, row0, n, pr + 2 * dim);
    }
    // dQ, dK and dV through the buffer (or the planes) both warpgroups are
    // done with
    __syncthreads();
    const uint32_t stg = (HG::P_IN_KV ? in : sds) + wg * 3 * STAGE_BOX;
    stage_tile<DH>(dq, stg);
    stage_tile<DH>(dk, stg + STAGE_BOX);
    stage_tile<DH>(dv, stg + 2 * STAGE_BOX);
    wg_sync(1 + wg);
    bf16* out = dqkv + (long long)b * n * 3 * dim + (long long)h * DH;
    copy_tile<DH>(stg, out, 3 * dim, wg * ROWS, n);
    copy_tile<DH>(stg + STAGE_BOX, out + dim, 3 * dim, wg * ROWS, n);
    copy_tile<DH>(stg + 2 * STAGE_BOX, out + 2 * dim, 3 * dim, wg * ROWS, n);
    __syncthreads();  // this buffer and the planes are free for the next items
  }
}

// ------------------------------------------------------------------ host

// st: q, k, v, dout, dq, dk, dv batch and row strides (elements). stats:
// the packed form (lse written; part, the (B·groups, part_rs) float 16-row
// partials, with dq's columns at 0, dk's at dim and dv's at 2·dim); else the
// flash form (lse read; part null).
template <int DH>
static int launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                  void* dk, void* dv, float* lse, float* delta, float* part, int batch, int nq,
                  int nk, int heads, const long long* st, float scale, bool stats,
                  cudaStream_t s) {
  using G = Geom<DH>;
  static size_t conf_stats = 0, conf_flash = 0, conf_kv = 0;
  if (int err = set_smem(dq_kernel<DH, true>, G::DQ_SMEM, &conf_stats)) return err;
  if (int err = set_smem(dq_kernel<DH, false>, G::DQ_SMEM, &conf_flash)) return err;
  if (int err = set_smem(dkv_kernel<DH>, G::KV_SMEM, &conf_kv)) return err;
  const long long cols = (long long)heads * DH;
  CUtensorMap mq, mk, mv, mdo, mqc, mdoc;
  if (!cached_map_3d(&mq, {q, cols, nq, batch, st[1], st[0], ROWS, G::BOXC}) ||
      !cached_map_3d(&mk, {k, cols, nk, batch, st[3], st[2], ROWS, G::BOXC}) ||
      !cached_map_3d(&mv, {v, cols, nk, batch, st[5], st[4], ROWS, G::BOXC}) ||
      !cached_map_3d(&mdo, {dout, cols, nq, batch, st[7], st[6], ROWS, G::BOXC}) ||
      !cached_map_3d(&mqc, {q, cols, nq, batch, st[1], st[0], G::QC, G::BOXC}) ||
      !cached_map_3d(&mdoc, {dout, cols, nq, batch, st[7], st[6], G::QC, G::BOXC}))
    return (int)cudaErrorInvalidValue;
  const int groups = (nq + 15) / 16, part_rs = 3 * (int)cols;
  const float sl2 = scale * LOG2E_F;
  if constexpr (G::NPV <= 64) {
    // the packed form at up to 128 tokens: one persistent launch
    if (stats && nq == nk && nq <= HEAD_ROWS) {
      static size_t conf_head = 0;
      if (int err = set_smem(head_kernel<DH>, HeadGeom<DH>::SMEM, &conf_head)) return err;
      const int grid = std::max(1, std::min(batch * heads, sm_count()));
      head_kernel<DH><<<grid, HEAD_THREADS, HeadGeom<DH>::SMEM, s>>>(
          mq, mk, mv, mdo, static_cast<bf16*>(dq), part, nq, heads, batch, sl2, scale);
      return (int)cudaGetLastError();
    }
  }
  const dim3 grid_q((nq + ROWS - 1) / ROWS, heads, batch);
  if (stats)
    dq_kernel<DH, true><<<grid_q, THREADS, G::DQ_SMEM, s>>>(
        mq, mk, mv, mdo, static_cast<bf16*>(dq), st[8], (int)st[9], lse, delta, part, part_rs,
        groups, nq, nk, heads, sl2, scale);
  else
    dq_kernel<DH, false><<<grid_q, THREADS, G::DQ_SMEM, s>>>(
        mq, mk, mv, mdo, static_cast<bf16*>(dq), st[8], (int)st[9], lse, delta, nullptr, 0, 0,
        nq, nk, heads, sl2, scale);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
#ifndef MTT_ATTN_BWD_SPLIT_NO_DKV
  dkv_kernel<DH><<<dim3((nk + ROWS - 1) / ROWS, heads, batch), THREADS, G::KV_SMEM, s>>>(
      mk, mv, mqc, mdoc, static_cast<bf16*>(dk), st[10], (int)st[11], static_cast<bf16*>(dv),
      st[12], (int)st[13], lse, delta, part == nullptr ? nullptr : part + cols,
      part == nullptr ? nullptr : part + 2 * cols, part_rs, groups, nq, nk, heads, sl2, scale);
#endif
  return (int)cudaGetLastError();
}

// The bf16 backward at any head dim 16..128 in steps of 16: q, k, v, dout
// (TMA) and dq, dk, dv (16-byte row stores) 16-byte aligned with strides of
// 8 elements.
static int run(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
               void* dv, float* lse, float* delta, float* part, int batch, int nq, int nk,
               int heads, int dh, const long long* st, float scale, bool stats, cudaStream_t s) {
  for (int i = 0; i < 14; ++i)
    if (st[i] % 8) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, dout, (const void*)dq, (const void*)dk, (const void*)dv})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
#define MTT_BWD_CASE(D) \
  case D:               \
    return launch<D>(q, k, v, dout, dq, dk, dv, lse, delta, part, batch, nq, nk, heads, st, scale, stats, s);
  switch (dh) {
    MTT_BWD_CASE(16)
    MTT_BWD_CASE(32)
    MTT_BWD_CASE(48)
    MTT_BWD_CASE(64)
    MTT_BWD_CASE(80)
    MTT_BWD_CASE(96)
    MTT_BWD_CASE(112)
    MTT_BWD_CASE(128)
  }
#undef MTT_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn_bwd
