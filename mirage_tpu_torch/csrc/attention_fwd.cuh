// The bf16 attention forward, softmax(q·kᵀ·scale)·v for every (batch,
// head), shared by csrc/attention.cu (mtt_attention: up to 512 keys, the
// core of B1, B3, B4/B7's recompute, B6 and the bench's S1, S4 and S7) and
// csrc/flash_attention.cu (mtt_flash_fwd: any length, B8, which also writes
// the per-row log-sum-exp). It replaces the attention cores of
// mirage_tpu/ops/block_attention.py:_attn_half_kernel, _xattn_half_kernel
// and _block_attn_kernel, and mirage_tpu/ops/flash_attention.py:_attn_kernel.
//
// Bound: bytes at the main-path shapes (q, k, v read once and o written
// once: 4·N·D·2 bytes a batch element against 4·N²·D FLOPs, 64 FLOPs a byte
// at 257 tokens, under the card's ≈ 295), operations only from ≈ 1200
// tokens. The first port (one block per 64 queries, four warps on mma.sync,
// keys staged by cp.async from every thread with two block barriers a
// chunk, products and softmax in series, the last chunk 64 wide) ran at
// 3-8× that bound. Here:
// - a CTA is two warpgroups, each owning 64 query rows of one (batch,
//   head): 128 queries a CTA, two CTAs an SM at a P·V width of 64 or less
//   (128 registers a thread). A warpgroup whose rows all lie past nq exits;
// - thread 0 of the last warpgroup with rows loads both Q tiles once and
//   streams K and V by TMA in chunks of 64 keys into a ring of stages
//   guarded by full/empty mbarriers: five stages at head dims 48 and 64, so
//   every chunk of up to 320 keys is in flight from the start, else four.
//   It refills a stage once both warpgroups have released it. The tensor
//   maps are 3-D (column, row, batch) over the strided views, so the packed
//   qkv is read in place, rows past nq or nk read as zeros, and a head is a
//   column coordinate;
// - S = Q·Kᵀ is a wgmma with both operands K-major in shared memory, issued
//   8·⌈r/8⌉ keys wide on the last chunk (r keys in it). O += P·V is a wgmma
//   with A = P in registers (S's accumulator rounded to bf16 pairs is the A
//   fragment) and B = V read MN-major with the transpose bit, so V is never
//   transposed. Round r issues S of chunk r and P·V of chunk r − 1 together;
// - the two warpgroups alternate on the tensor cores (named barriers 1 and
//   2): one's softmax runs while the other's products run;
// - head dims 16 and 32 are loaded as boxes of their own width (32- and
//   64-byte swizzle); 64 and 128 as one or two 64-column boxes (128-byte
//   swizzle); 48 and 80-112 as 64-column boxes whose k-steps stop at dh
//   (P·V runs 64 or 128 wide and the columns past dh are not stored).
// A persistent grid (two CTAs an SM walking the query tiles, the next
// tile's Q and chunks loaded under the current one's products, K and V kept
// for all of a head's tiles where they fit) measured 1.3-1.5× slower at the
// serving encoder's shape on the H100 than these short CTAs, which the
// hardware overlaps two an SM (PERF.md §6).
// Numerics as the first port's: the scale folded into log2 units (here in
// one FMA with the max's subtraction), keys at or past nk at −∞, the float
// running max with the float accumulator rescaled when it grows, P rounded
// to bf16 before P·V, the float row sum, the output divided by it after
// P·V, lse = m + log2(l). The float32 kernels of the two
// files are separate (FMA tiles, for the float32 goldens).
//
// MTT_ATTN_SPLIT_NO_PV, _NO_SOFTMAX and _LOADS build variants without P·V,
// without the exponentials and the softmax, or without any product, for
// chip_smoke.py --attn-split; the library build defines none of them.
#pragma once

#include <math.h>

#include <initializer_list>

#include "wgmma.cuh"

namespace attn_fwd {

constexpr int QROWS = 64;                     // query rows of a consumer warpgroup
constexpr int KC = 64;                        // keys a ring stage holds
constexpr int CONSUMERS = 2;                  // consumer warpgroups a CTA
constexpr int THREADS = 128 * CONSUMERS;
constexpr int ORDER_BAR = 1;                  // named barriers 1, 2: warpgroup 0's, 1's turn

// How a head dim is laid out in shared memory (ops/block_attention.py:
// attention_plan mirrors it).
template <int DH>
struct Geom {
  static constexpr int BOXC = (DH == 16 || DH == 32) ? DH : 64;  // columns of a TMA box
  static constexpr int NBOX = (DH + BOXC - 1) / BOXC;             // boxes a 64-row tile
  static constexpr int NPV = NBOX * BOXC;                         // P·V's width
  static constexpr int ROWB = BOXC * 2;                           // a box row = the swizzle
  static constexpr int BOX_BYTES = KC * ROWB;
  static constexpr int TILE_BYTES = NBOX * BOX_BYTES;             // 64 rows × all columns
  static constexpr int KSTEPS = DH / 16;                          // S's k16 steps
  // ring stages: 5 (320 keys) for one 64-column box, else 4
  static constexpr int STAGES = BOXC == 64 && NBOX == 1 ? 5 : 4;
  // alignment slack, a Q tile per warpgroup, the ring, full[S], empty[S], qbar
  static constexpr int SMEM = 1024 + (CONSUMERS + 2 * STAGES) * TILE_BYTES + 8 * (2 * STAGES + 1);
  static constexpr int MIN_BLOCKS = NPV <= 64 ? 2 : 1;  // CTAs an SM holds
};

__device__ __forceinline__ void bar_sync_256(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive_256(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// S (64 × SW keys) = Q·K_cᵀ over the head's k16 steps
template <int DH, int SW>
__device__ __forceinline__ void qk(float (&s)[KC / 2], uint32_t q, uint32_t k) {
  using G = Geom<DH>;
#pragma unroll
  for (int ks = 0; ks < G::KSTEPS; ++ks) {
    const uint32_t off = (ks / (G::BOXC / 16)) * G::BOX_BYTES + (ks % (G::BOXC / 16)) * 32;
    wgmma_ss<SW>(s, wgmma_desc_sw(q + off, G::ROWB), wgmma_desc_sw(k + off, G::ROWB), ks > 0);
  }
}

// One round's products as one wgmma group: S of a chunk, SW keys wide (0:
// none), and O += P·V of the chunk before, over PVK k16 steps of its keys
// (0: none). Straight-line code: the widths are compile-time.
template <int DH, int SW, int PVK>
__device__ __forceinline__ void issue(float (&s)[KC / 2], float (&o)[Geom<DH>::NPV / 2],
                                      uint32_t (&p)[KC / 16][4], uint32_t q, uint32_t k,
                                      uint32_t v) {
  using G = Geom<DH>;
  wgmma_fence();
#ifndef MTT_ATTN_SPLIT_LOADS
  if constexpr (SW > 0) qk<DH, SW>(s, q, k);
#ifndef MTT_ATTN_SPLIT_NO_PV
#pragma unroll
  for (int kk = 0; kk < PVK; ++kk)
    wgmma_rs<G::NPV, 1>(o, p[kk], wgmma_desc_mn_sw(v + kk * 16 * G::ROWB, G::BOX_BYTES, G::ROWB));
#endif
#endif
  wgmma_commit();
}

// The last chunk's two rounds, one case for each issued width tw (a
// multiple of 8): S_last with P·V of the chunk before, then P·V_last alone.
#define MTT_TAIL_CASES(F) \
  case 8: F(8) case 16: F(16) case 24: F(24) case 32: F(32) case 40: F(40) case 48: F(48) \
  case 56: F(56) default: F(64)

template <int DH>
__global__ void __launch_bounds__(THREADS, Geom<DH>::MIN_BLOCKS)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                         float* __restrict__ lse, int nq, int nk, int heads, long long o_bs,
                         int o_rs, float scale_log2) {
  using G = Geom<DH>;
  constexpr int S = G::STAGES;
  extern __shared__ unsigned char attn_fwd_smem[];
  const uint32_t sq = (smem_u32(attn_fwd_smem) + 1023) & ~1023u;  // the swizzle's period
  const uint32_t sst = sq + CONSUMERS * G::TILE_BYTES;             // stage s: K, then V
  const uint32_t full = sst + S * 2 * G::TILE_BYTES, empty = full + 8 * S, qbar = empty + 8 * S;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // uniform in the warp, as wgmma needs
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * (CONSUMERS * QROWS);
  const int active = min(CONSUMERS, (nq - q0 + QROWS - 1) / QROWS);  // warpgroups with rows
  const int nch = (nk + KC - 1) / KC;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * active);  // every warp of the active warpgroups
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg >= active) return;  // every row of this warpgroup lies past nq

  // Thread 0 of the last active warpgroup (the later of the two in the
  // ping-pong) loads: the Q tiles and the ring's first chunks now, each
  // later chunk once both warpgroups have released the stage it goes into.
  const bool loader = wg == active - 1 && (tid & 127) == 0;
  auto load_chunk = [&](int c) {
    const uint32_t st = sst + (c % S) * 2 * G::TILE_BYTES, bar = full + 8 * (c % S);
    mbar_expect_tx(bar, 2 * G::TILE_BYTES);
#pragma unroll
    for (int x = 0; x < G::NBOX; ++x) {
      tma_load_3d(st + x * G::BOX_BYTES, &map_k, bar, h * DH + x * G::BOXC, c * KC, b);
      tma_load_3d(st + G::TILE_BYTES + x * G::BOX_BYTES, &map_v, bar, h * DH + x * G::BOXC,
                  c * KC, b);
    }
  };
  if (loader) {
    mbar_expect_tx(qbar, active * G::TILE_BYTES);
    for (int w = 0; w < active; ++w)
#pragma unroll
      for (int x = 0; x < G::NBOX; ++x)
        tma_load_3d(sq + w * G::TILE_BYTES + x * G::BOX_BYTES, &map_q, qbar,
                    h * DH + x * G::BOXC, q0 + w * QROWS, b);
    for (int c = 0; c < min(S, nch); ++c) load_chunk(c);
  }
  const bool pingpong = active == CONSUMERS;
  const int warp = (tid >> 5) & 3, lane = tid & 31, tig = lane & 3;
  const uint32_t my_q = sq + wg * G::TILE_BYTES;
  float o_acc[G::NPV / 2], s_acc[KC / 2];
  uint32_t p_frag[KC / 16][4];
#pragma unroll
  for (int i = 0; i < G::NPV / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KC / 2; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KC / 16; ++i) p_frag[i][0] = p_frag[i][1] = p_frag[i][2] = p_frag[i][3] = 0u;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows l/4, l/4 + 8
  mbar_wait(qbar, 0);
  auto kaddr = [&](int c) { return sst + (c % S) * 2 * G::TILE_BYTES; };
  // Before round r's products: chunk r has landed, and it is this
  // warpgroup's turn on the tensor cores.
  auto begin = [&](int r) {
    if (r < nch) mbar_wait(full + 8 * (r % S), (r / S) & 1);
    if (pingpong && (wg == 1 || r > 0)) bar_sync_256(ORDER_BAR + wg);
  };
  // After them: the other's turn, the products done, chunk r − 1 released
  // (and its stage refilled), then chunk r's softmax.
  auto end = [&](int r) {
    if (pingpong && (wg == 0 || r < nch)) bar_arrive_256(ORDER_BAR + 1 - wg);
    wgmma_wait<0>();
    fence_regs(s_acc);
    fence_regs(o_acc);
    keep_frags(p_frag);  // P·V read them asynchronously until the wait
    if (r > 0) {
      if (lane == 0) mbar_arrive(empty + 8 * ((r - 1) % S));
      if (loader && r - 1 + S < nch) {
        mbar_wait(empty + 8 * ((r - 1) % S), ((r - 1) / S) & 1);  // the other's release too
        load_chunk(r - 1 + S);
      }
    }
    if (r == nch) return;

    // keys past nk at −∞ (only the last chunk has them; the tail's unissued
    // columns too), the running max in log2 units (the scale is positive:
    // the max of the raw scores times the scale is the max of the scaled
    // ones) and the rescale of the float accumulator
    if (r == nch - 1) {
      const int key0 = r * KC + 2 * tig;
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + j * 8 + (e & 1) >= nk) s_acc[4 * j + e] = -INFINITY;
    }
    float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) cmax[(i >> 1) & 1] = fmaxf(cmax[(i >> 1) & 1], s_acc[i]);
#ifndef MTT_ATTN_SPLIT_NO_SOFTMAX
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      cmax[hf] = fmaxf(cmax[hf], __shfl_xor_sync(0xffffffffu, cmax[hf], 1));
      cmax[hf] = fmaxf(cmax[hf], __shfl_xor_sync(0xffffffffu, cmax[hf], 2));
      const float m_new = fmaxf(m_run[hf], cmax[hf] * scale_log2);  // finite: a chunk has a key
      const float corr = exp2f(m_run[hf] - m_new);
      m_run[hf] = m_new;
      l_run[hf] *= corr;
#pragma unroll
      for (int j = 0; j < G::NPV / 8; ++j) {
        o_acc[4 * j + 2 * hf] *= corr;
        o_acc[4 * j + 2 * hf + 1] *= corr;
      }
    }
    // P = exp2(s·scale − m), the scale and the max in one FMA: float row
    // sums, rounded to bf16 as P·V's A fragments
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) {
      s_acc[i] = exp2f(fmaf(s_acc[i], scale_log2, -m_run[(i >> 1) & 1]));
      l_run[(i >> 1) & 1] += s_acc[i];
    }
#else
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) {
      s_acc[i] = fmaxf(s_acc[i], -1.f);  // masked keys: no infinity into P·V
      l_run[(i >> 1) & 1] += s_acc[i];
    }
#endif
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      p_frag[j >> 1][(j & 1) * 2] = pack_bf16(s_acc[4 * j], s_acc[4 * j + 1]);
      p_frag[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s_acc[4 * j + 2], s_acc[4 * j + 3]);
    }
  };
  // rounds 0 .. nch − 2: S of a full chunk (with P·V of the one before)
  if (nch > 1) {
    begin(0);
    issue<DH, KC, 0>(s_acc, o_acc, p_frag, my_q, kaddr(0), 0);
    end(0);
  }
  for (int r = 1; r < nch - 1; ++r) {
    begin(r);
    issue<DH, KC, KC / 16>(s_acc, o_acc, p_frag, my_q, kaddr(r), kaddr(r - 1) + G::TILE_BYTES);
    end(r);
  }
  // the last chunk, tw = 8·⌈r/8⌉ keys wide, in its two rounds
  const int last = nch - 1, tw = ((nk - last * KC) + 7) & ~7;
  const uint32_t v_prev = last > 0 ? kaddr(last - 1) + G::TILE_BYTES : 0;
  const uint32_t v_last = kaddr(last) + G::TILE_BYTES;
#define MTT_TAIL(W)                                                                          \
  begin(last);                                                                               \
  if (last > 0)                                                                              \
    issue<DH, W, KC / 16>(s_acc, o_acc, p_frag, my_q, kaddr(last), v_prev);                   \
  else                                                                                       \
    issue<DH, W, 0>(s_acc, o_acc, p_frag, my_q, kaddr(last), 0);                              \
  end(last);                                                                                 \
  begin(nch);                                                                                \
  issue<DH, 0, (W + 15) / 16>(s_acc, o_acc, p_frag, my_q, 0, v_last);                         \
  end(nch);                                                                                  \
  break;
  switch (tw) { MTT_TAIL_CASES(MTT_TAIL) }
#undef MTT_TAIL

  bf16* ob = o + b * o_bs + (long long)h * DH;
  const int row0 = q0 + wg * QROWS + warp * 16 + (lane >> 2);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int gq = row0 + 8 * hf;
    if (gq >= nq) continue;
    if (lse != nullptr && tig == 0) lse[((long long)b * heads + h) * nq + gq] = m_run[hf] + log2f(l);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)gq * o_rs + j * 8 + 2 * tig) =
          __floats2bfloat162_rn(o_acc[4 * j + 2 * hf] * inv, o_acc[4 * j + 2 * hf + 1] * inv);
  }
}
#undef MTT_TAIL_CASES

// ------------------------------------------------------------------ host

// st: q, k, v, o batch and row strides (elements); lse may be null
template <int DH>
static int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                  int nq, int nk, int heads, const long long* st, float scale, cudaStream_t s) {
  using G = Geom<DH>;
  static SmemLimit limit;
  if (int err = set_smem(attention_fwd_kernel<DH>, G::SMEM, limit)) return err;
  const long long cols = (long long)heads * DH;
  CUtensorMap mq, mk, mv;
  if (!cached_map_3d(&mq, {q, cols, nq, batch, st[1], st[0], KC, G::BOXC}) ||
      !cached_map_3d(&mk, {k, cols, nk, batch, st[3], st[2], KC, G::BOXC}) ||
      !cached_map_3d(&mv, {v, cols, nk, batch, st[5], st[4], KC, G::BOXC}))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + CONSUMERS * QROWS - 1) / (CONSUMERS * QROWS), heads, batch);
  attention_fwd_kernel<DH><<<grid, THREADS, G::SMEM, s>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, nq, nk, heads, st[6], (int)st[7],
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// The bf16 forward at any head dim 16..128 in steps of 16: q, k, v 16-byte
// aligned with strides of 8 elements (TMA), o 4-byte aligned with even
// strides (pair stores).
static int run(const void* q, const void* k, const void* v, void* o, float* lse, int batch, int nq,
               int nk, int heads, int dh, const long long* st, float scale, cudaStream_t s) {
  for (int i = 0; i < 6; ++i)
    if (st[i] % 8) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if (st[6] % 2 || st[7] % 2 || reinterpret_cast<uintptr_t>(o) % 4)
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch<16>(q, k, v, o, lse, batch, nq, nk, heads, st, scale, s);
    case 32: return launch<32>(q, k, v, o, lse, batch, nq, nk, heads, st, scale, s);
    case 48: return launch<48>(q, k, v, o, lse, batch, nq, nk, heads, st, scale, s);
    case 64: return launch<64>(q, k, v, o, lse, batch, nq, nk, heads, st, scale, s);
    case 80: return launch<80>(q, k, v, o, lse, batch, nq, nk, heads, st, scale, s);
    case 96: return launch<96>(q, k, v, o, lse, batch, nq, nk, heads, st, scale, s);
    case 112: return launch<112>(q, k, v, o, lse, batch, nq, nk, heads, st, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, batch, nq, nk, heads, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn_fwd
