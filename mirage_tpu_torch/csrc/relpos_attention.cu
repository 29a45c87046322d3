// Attention with SAM's decomposed relative-position bias (the SAM ViT image
// encoder's attention core, ops/relpos_attention.py): for each window of
// wh × ww positions of the token grid (the whole grid in a global block) and
// each head, softmax((q·dh^-½)·kᵀ + rel_h + rel_w)·v, on the packed bf16 qkv
// of the real tokens (B, H, W, 3D), out (B, H, W, D). The grid is padded at
// the bottom and right to a multiple of the window; a padded position's
// query, key and value are the qkv bias. It replaces no TPU kernel: the JAX
// package has no SAM encoder.
//
// One kernel a call, relpos_attn_kernel<BX, PAD>. The Q, K and V tensor maps
// are 4-D (column, x, y, batch) over the grid, so a window is read where it
// lies and nothing is partitioned or copied; a tile row is BX slots of a
// window row (BX 16 for windows up to 16 × 16, else 64 for rows and columns
// up to 64). A head's 80 columns are two boxes, 64 columns (128-byte
// swizzle) and 16 (32-byte swizzle): S = Q·Kᵀ takes its last k16 step from
// the narrow box, O += P·V runs 64 + 16 wide, and no byte of a neighbouring
// head is read. One producer thread keeps the TMA loads in flight (the tables
// once, each work item's Q with its head's b_k, then K and V through a ring
// of stages); two consumer warpgroups run wgmma on tiles of 64 query
// slots, with the producer's registers (setmaxnreg). Each warpgroup
// computes its queries' bias products itself, on the tensor cores
// with float accumulators, from the Q tile already in shared memory: T =
// Q·[rel_pos_h; rel_pos_w]ᵀ and q·b_k. rel_w[i, kw] = T_w[i, x − kw + ww −
// 1] goes to registers for the item (a thread's slots fall on fixed window
// columns), rel_h[i, kh] = T_h[i, y − kh + wh − 1] to a per-warp float
// scratch in shared memory, read a stage at a time (q unscaled in both).
// Each logits tile takes its bias before the running max: t = s·scale·log2e
// + (rel_h + rel_w)·log2e in one FMA, a slot past the window at −∞. A slot
// past the grid is padding (PAD: the grid is not a multiple of the window):
// the maps read it as zeros, so its score is replaced by q·b_k (in the
// units where some thread of the warp has such a slot), its V row
// is zero, and Σp over the padded slots (rescaled with the row sum) times
// b_v is added to the output before the division by the row sum. Only the
// real queries are stored, each warp's rows staged through shared memory
// so a row leaves as ten 16-byte stores.
//
// The grid is persistent, one CTA an SM walking a list of work items, the
// next item's loads in flight under the current one's products. A
// warpgroup runs its units (stage, tile) in order, a round each: S of the
// unit with P·V of the one before, the two warpgroups alternating on the
// tensor cores (named barriers 1 and 2); inside each, the softmax of a
// unit runs while P·V of the one before is in flight (FA3's two
// pipelines).
// - Windowed (BX 16: SAM ViT-H's 14 × 14 windows) is bound by bytes (q, k,
//   v read once, o written once: 0.050 ms at ViT-H's batch 4) and by
//   latency. An item is a (window, head): the two warpgroups hold all 256
//   padded query slots, two tiles each, so the window's K and V (four
//   stages of 64 keys) are read once, and the next item's Q loads into a
//   second buffer.
// - Global (BX 64: the 64 × 64 grid, 4096 keys) is bound by operations.
//   An item is (head, pair of grid rows), a tile (grid row) a warpgroup;
//   stages hold 128 keys (two grid rows), three in the ring. A thread's
//   rel_w (16 window columns) stays in registers for the item.
//
// Numerics as csrc/attention_fwd.cuh's: the float running max and row sum
// in log2 units, P rounded to bf16 before P·V, the output divided by the
// float row sum after it; the bias terms are float. The exponentials are
// MUFU.EX2's with results under 2^-126 flushed to zero (exp2f keeps them
// as subnormals at two more instructions each: terms 2^-126 under their
// row's largest, which change no float row sum and no bf16 output).
#define MTT_ATTN_FWD_DEVICE_ONLY
#include "attention_fwd.cuh"

#include <stdint.h>

#include <type_traits>

namespace relpos {

using attn_fwd::bar_arrive_256;
using attn_fwd::bar_sync_256;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int DH = 80;                // SAM ViT-H's head dim
constexpr int CA = 64;                // columns of a row's wide box; the narrow one holds 16
constexpr int RA = 128, RB = 32;      // bytes of a row in each box (= their swizzles)
constexpr int ROW = RA + RB;          // a row's 80 columns
constexpr int QT = 64;                // query slots of a consumer warpgroup's tile
constexpr int PING = 1;               // named barriers 1, 2: the global path's turns

// The schedule of each mode (see the note above; ops/relpos_attention.py:
// relpos_plan mirrors it). Shared memory: the Q
// buffers (each: QR rows, then b_k's 8 rows of the head's group), the ring
// of K/V stages, the tables (rel_pos_h's rows, then rel_pos_w's), the
// scratch (a float row of RS for each query slot), the mbarriers. Every tile
// of R rows lies as its wide box (R × 128 bytes) and then its narrow one
// (R × 32).
template <int BX>
struct Plan {
  static constexpr int NC = 2;                 // consumer warpgroups
  static constexpr int MT = BX == 16 ? 2 : 1;  // query tiles a consumer warpgroup
  static constexpr int QBY = QT / BX;          // window rows of a query tile
  static constexpr int KBY = BX == 16 ? 4 : 2; // window rows of a stage
  static constexpr int KC = BX * KBY;          // keys a stage: 64, 128
  static constexpr int XG = BX / 8;            // 8-slot groups a tile row spans
  static constexpr int XN = 2 * XG;            // window columns of a thread's slots
  static constexpr int STAGES = BX == 16 ? 4 : 3;
  static constexpr int QB = BX == 16 ? 2 : 1;  // Q buffers
  // chunks of an item loaded before its Q (one buffer: after the stages the
  // last item frees, so they load under its tail)
  static constexpr int QPRE = QB == 2 ? 0 : STAGES;
  static constexpr int QR = NC * MT * QT;      // query slots an item
  static constexpr int TH = 2 * BX;            // rows of each table (2·k − 1 and zeros)
  // floats of a scratch row: rel_h's up to BX keys, then 8 rows (odd
  // multiples of 4 floats apart) in distinct banks; a warp's rows hold its
  // 16 rows of output (160 bytes each) on the way out
  static constexpr int RS = BX == 16 ? 20 : 65;
  static constexpr int THREADS = (NC + 1) * 128;  // the consumers, then the producer's warpgroup
  // registers a thread after setmaxnreg (168 at the launch)
  static constexpr int REG_CONSUMER = 232, REG_PRODUCER = 40;
  static constexpr int Q_BYTES = (QR + 8) * ROW;
  static constexpr int QBUF = (Q_BYTES + 1023) / 1024 * 1024;
  static constexpr int STAGE = 2 * KC * ROW;  // K, then V
  static constexpr int TABLE = 2 * TH * ROW;
  static constexpr int O_ST = QB * QBUF;
  static constexpr int O_TAB = O_ST + STAGES * STAGE;
  static constexpr int O_SCR = O_TAB + TABLE;
  static constexpr int O_BAR = O_SCR + QR * RS * 4;
  // tables, QB × (full, empty), STAGES × (full, empty)
  static constexpr int SMEM = 1024 + O_BAR + 8 * (1 + 2 * QB + 2 * STAGES);
};

// The token grid, its windows and the work list.
struct RelposGeom {
  int h, w;     // grid rows and columns
  int wh, ww;   // a window's rows and columns (the grid's in a global block)
  int nwx, nw;  // windows along a row of the grid, windows a batch element
  int heads;
  int npq;      // items a (window, head): groups of NC query tiles
  int nch;      // stages a window's keys fill
  int items;    // batch · nw · heads · npq
};

// The tensor maps of one call: each operand's wide and narrow box.
struct Maps {
  CUtensorMap q64, q16, k64, k16, v64, v16;  // 4-D over the packed qkv
  CUtensorMap h64, h16, w64, w16;            // rel_pos_h, rel_pos_w
  CUtensorMap b64, b16;                      // b_k, 8 heads a box
};

// Box (c0 = column, c1 = x, c2 = y, c3 = batch) of a 4-D tensor map into
// shared memory; the bytes land on mbarrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

#define RP_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 × 128) = (scale_d ? d : 0) + A (64 × 16)·B (128 × 16)ᵀ, both K-major
// in shared memory
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : RP_F8(0), RP_F8(8), RP_F8(16), RP_F8(24), RP_F8(32), RP_F8(40), RP_F8(48), RP_F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}
#undef RP_F8

// 2^x on the MUFU unit; a result below 2^-126 is flushed to zero (a term
// under 2^-126 of its row's largest, which no bf16 output can show)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 × N) = A·Bᵀ over the 80 columns, both K-major in shared memory as
// their two boxes: k16 steps 0-3 in the wide box, step 4 in the narrow one.
template <int N, int M>
__device__ __forceinline__ void prod80(float (&d)[M], uint32_t a_wide, uint32_t a_narrow,
                                       uint32_t b_wide, uint32_t b_narrow) {
#pragma unroll
  for (int ks = 0; ks < 5; ++ks) {
    const uint64_t da = ks < 4 ? wgmma_desc_sw(a_wide + ks * 32, RA) : wgmma_desc_sw(a_narrow, RB);
    const uint64_t db = ks < 4 ? wgmma_desc_sw(b_wide + ks * 32, RA) : wgmma_desc_sw(b_narrow, RB);
    if constexpr (N == 128)
      wgmma_ss128(d, da, db, ks > 0);
    else
      wgmma_ss<N>(d, da, db, ks > 0);
  }
}

// O += P·V over a stage's KC keys: V MN-major (the transpose bit), its wide
// box into columns 0-63, its narrow box into 64-79.
template <int KC>
__device__ __forceinline__ void pv80(float (&lo)[32], float (&hi)[8], uint32_t (&p)[KC / 16][4],
                                     uint32_t v_wide, uint32_t v_narrow) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    wgmma_rs<64, 1>(lo, p[kk], wgmma_desc_mn_sw(v_wide + kk * 16 * RA, KC * RA, RA));
    wgmma_rs<16, 1>(hi, p[kk], wgmma_desc_mn_sw(v_narrow + kk * 16 * RB, KC * RB, RB));
  }
}

}  // namespace relpos

// At file scope, so the profiler's name starts with relpos_attn (the
// benchmark reads this op's device time by that prefix).
template <int BX, bool PAD>
__global__ void __launch_bounds__(relpos::Plan<BX>::THREADS, 1)
    relpos_attn_kernel(const __grid_constant__ relpos::Maps maps, bf16* __restrict__ o,
                       const bf16* __restrict__ bias_v, relpos::RelposGeom g, float scale_log2) {
  using namespace relpos;
  using P = Plan<BX>;
  constexpr int NC = P::NC, KC = P::KC, S = P::STAGES, QB = P::QB;
  constexpr int XG = P::XG, XN = P::XN, KBY = P::KBY, RS = P::RS, TH = P::TH;
  extern __shared__ unsigned char rp_smem[];
  const uint32_t raw = smem_u32(rp_smem);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's period
  const uint32_t tab = base + P::O_TAB, tab_narrow = tab + 2 * TH * RA;
  const uint32_t tbar = base + P::O_BAR, qfull = tbar + 8, qempty = qfull + 8 * QB;
  const uint32_t full = qempty + 8 * QB, empty = full + 8 * S;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(tbar, 1);
    for (int i = 0; i < QB; ++i) {
      mbar_init(qfull + 8 * i, 1);
      mbar_init(qempty + 8 * i, 4 * NC);  // every consumer warp
    }
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp_all = __shfl_sync(0xffffffffu, tid / 32, 0);

  // item → batch element, the window's first column and row, head, and the
  // group of query tiles
  auto decode = [&](int item, int& b, int& x0, int& y0, int& h, int& pr) {
    pr = item % g.npq;
    item /= g.npq;
    h = item % g.heads;
    item /= g.heads;
    const int wi = item % g.nw;
    b = item / g.nw;
    const int wy = wi / g.nwx;
    x0 = (wi - wy * g.nwx) * g.ww;
    y0 = wy * g.wh;
  };

  // --------------------------------------------------------- the producer
  if (warp_all >= 4 * NC) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P::REG_PRODUCER));
    if (tid != 128 * NC) return;
    mbar_expect_tx(tbar, P::TABLE);
    tma_load_3d(tab, &maps.h64, tbar, 0, 0, 0);
    tma_load_3d(tab + TH * RA, &maps.w64, tbar, 0, 0, 0);
    tma_load_3d(tab_narrow, &maps.h16, tbar, CA, 0, 0);
    tma_load_3d(tab_narrow + TH * RB, &maps.w16, tbar, CA, 0, 0);
    int k = 0, gc = 0;
    for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++k) {
      int b, x0, y0, h, pr;
      decode(item, b, x0, y0, h, pr);
      const int col = h * DH;
      auto load_q = [&] {
        const int qi = k % QB;
        const uint32_t qs = base + qi * P::QBUF, bar = qfull + 8 * qi;
        if (k >= QB) mbar_wait(qempty + 8 * qi, ((k / QB) - 1) & 1);
        mbar_expect_tx(bar, P::Q_BYTES);
        const int yq = y0 + pr * NC * P::MT * P::QBY;
        tma_load_4d(qs, &maps.q64, bar, col, x0, yq, b);
        tma_load_4d(qs + P::QR * RA, &maps.q16, bar, col + CA, x0, yq, b);
        tma_load_3d(qs + P::QR * ROW, &maps.b64, bar, 0, h & ~7, 0);
        tma_load_3d(qs + P::QR * ROW + 8 * RA, &maps.b16, bar, CA, h & ~7, 0);
      };
      for (int c = 0; c < g.nch; ++c, ++gc) {
        if (c == P::QPRE) load_q();
        const int st = gc % S;
        if (gc >= S) mbar_wait(empty + 8 * st, ((gc / S) - 1) & 1);
        const uint32_t sa = base + P::O_ST + st * P::STAGE, bar = full + 8 * st;
        mbar_expect_tx(bar, P::STAGE);
        const int yk = y0 + c * KBY;
        tma_load_4d(sa, &maps.k64, bar, col, x0, yk, b);
        tma_load_4d(sa + KC * RA, &maps.k16, bar, col + CA, x0, yk, b);
        tma_load_4d(sa + KC * ROW, &maps.v64, bar, col, x0, yk, b);
        tma_load_4d(sa + KC * ROW + KC * RA, &maps.v16, bar, col + CA, x0, yk, b);
      }
      if (g.nch <= P::QPRE) load_q();
    }
    return;
  }

  // -------------------------------------------------------- the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::REG_CONSUMER));
  constexpr int MT = P::MT;
  using T0 = std::integral_constant<int, 0>;
  using TL = std::integral_constant<int, MT - 1>;
  const int wg = warp_all >> 2, warp = warp_all & 3, lane = tid & 31, tig = lane & 3;
  // this warp's 16 rows of each of its warpgroup's tiles in the scratch,
  // tile after tile: rel_w for a moment, then rel_h, then the output
  float* scr0 = reinterpret_cast<float*>(rp_smem + (base - raw) + P::O_SCR) +
                (wg * 4 + warp) * MT * 16 * RS;
  const int rr[2] = {lane >> 2, (lane >> 2) + 8};  // this thread's rows of them
  const int d = g.heads * DH;

  float o_lo[MT][32], o_hi[MT][8], s[KC / 2];
  uint32_t p[MT][KC / 16][4];
  float rw[MT][2][XN], rh[2][KBY], qb[MT][2];
  float m_run[MT][2], l_run[MT][2], lp_run[MT][2];
  // a thread's slots past the grid (bit i: s[i]'s key): those in padded
  // window columns (fixed for the item), those in a stage's padded rows
  uint64_t xmask = 0, ymask = 0;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    qb[t][0] = qb[t][1] = 0.f;
#pragma unroll
    for (int i = 0; i < KC / 16; ++i) p[t][i][0] = p[t][i][1] = p[t][i][2] = p[t][i][3] = 0u;
  }

  // a T product's (acc) columns [c0, c0 + TH) into the scratch rows `scr`
  // at pos + n − 1 − c (log2 units), the slots 0 .. n − 1 of each row
  auto scatter = [&](const auto& acc, float* scr, int c0, const int (&pos)[2], int n) {
    constexpr int NA = std::extent<std::remove_reference_t<decltype(acc)>>::value;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int j = i >> 2, hf = (i >> 1) & 1;
      if (j * 8 < c0 || j * 8 >= c0 + TH) continue;
      const int at = pos[hf] + n - 1 - (j * 8 + 2 * tig + (i & 1) - c0);
      if (at >= 0 && at < n) scr[rr[hf] * RS + at] = acc[i] * LOG2E;
    }
  };
  // rel_w of the window columns of this thread's keys, from the scratch
  auto gather_rw = [&](int t, const float* scr) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int xi = 0; xi < XN; ++xi) {
        const int kx = (xi >> 1) * 8 + 2 * tig + (xi & 1);
        rw[t][hf][xi] = kx < g.ww ? scr[rr[hf] * RS + kx] : -INFINITY;
      }
  };
  // rel_h of tile t's rows at stage c's key rows (−∞ past the window), and
  // which key rows lie past the grid
  auto load_rh = [&](auto tc, int c, int y0) {
    const float* scr = scr0 + decltype(tc)::value * 16 * RS;
#pragma unroll
    for (int yc = 0; yc < KBY; ++yc) {
      const int ky = c * KBY + yc;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) rh[hf][yc] = ky < g.wh ? scr[rr[hf] * RS + ky] : -INFINITY;
    }
    if constexpr (PAD) {
      ymask = 0;  // key row yc holds slots 4·XG·yc .. 4·XG·(yc + 1) − 1 of s
#pragma unroll
      for (int yc = 0; yc < KBY; ++yc) {
        const int ky = c * KBY + yc;
        if (ky < g.wh && y0 + ky >= g.h) ymask |= ((1ull << (4 * XG)) - 1) << (4 * XG * yc);
      }
    }
  };
  // tile t's scores of a stage in log2 units with their bias, padded slots
  // (`padded`: the warp has some; `padm`: this thread's) scored q·b_k; the
  // running max, the row sums rescaled by corr, s ← P
  auto scores = [&](auto tc, auto padded, uint64_t padm, float (&corr)[2]) {
    constexpr int t = decltype(tc)::value;
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) {
      const int j = i >> 2, hf = (i >> 1) & 1, xi = (j % XG) * 2 + (i & 1), yc = j / XG;
      float x = s[i];
      if constexpr (decltype(padded)::value) x = (padm >> i) & 1u ? qb[t][hf] : x;
      s[i] = fmaf(x, scale_log2, rh[hf][yc] + rw[t][hf][xi]);
    }
    float cmax[2] = {-INFINITY, -INFINITY}, m_use[2];
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) cmax[(i >> 1) & 1] = fmaxf(cmax[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      cmax[hf] = fmaxf(cmax[hf], __shfl_xor_sync(0xffffffffu, cmax[hf], 1));
      cmax[hf] = fmaxf(cmax[hf], __shfl_xor_sync(0xffffffffu, cmax[hf], 2));
      const float m_new = fmaxf(m_run[t][hf], cmax[hf]);
      m_use[hf] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      corr[hf] = ex2(m_run[t][hf] - m_use[hf]);
      m_run[t][hf] = m_new;
      l_run[t][hf] *= corr[hf];
      lp_run[t][hf] *= corr[hf];
    }
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) {
      const int hf = (i >> 1) & 1;
      s[i] = ex2(s[i] - m_use[hf]);
      l_run[t][hf] += s[i];
      if constexpr (decltype(padded)::value)
        if ((padm >> i) & 1u) lp_run[t][hf] += s[i];
    }
  };
  auto softmax = [&](auto tc, float (&corr)[2]) {
    if constexpr (PAD) {
      const uint64_t padm = xmask | ymask;
      if (__any_sync(0xffffffffu, padm != 0)) {
        scores(tc, std::true_type{}, padm, corr);
        return;
      }
    }
    scores(tc, std::false_type{}, 0, corr);
  };
  auto rescale = [&](auto tc, const float (&corr)[2]) {
    constexpr int t = decltype(tc)::value;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o_lo[t][4 * j + 2 * hf] *= corr[hf];
        o_lo[t][4 * j + 2 * hf + 1] *= corr[hf];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        o_hi[t][4 * j + 2 * hf] *= corr[hf];
        o_hi[t][4 * j + 2 * hf + 1] *= corr[hf];
      }
    }
  };
  auto pack = [&](auto tc) {
    constexpr int t = decltype(tc)::value;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      p[t][j >> 1][(j & 1) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
      p[t][j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  };
  auto stage = [&](int gc) { return base + P::O_ST + (gc % S) * P::STAGE; };

  mbar_wait(tbar, 0);
  int k = 0, gc = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x, ++k) {
    int b, x0, y0, h, pr;
    decode(item, b, x0, y0, h, pr);
    const int qi = k % QB, g0 = gc, nch = g.nch;
    const uint32_t qs = base + qi * P::QBUF;
    // tile t of this warpgroup: its Q (wide and narrow box) and first window row
    auto q_wide = [&](int t) { return qs + (wg * MT + t) * QT * RA; };
    auto q_narrow = [&](int t) { return qs + P::QR * RA + (wg * MT + t) * QT * RB; };
    auto first_row = [&](int t) { return ((pr * NC + wg) * MT + t) * P::QBY; };
    // this thread's query slots r = warp·16 + lane/4 + 8·hf of tile t:
    // window column and row
    auto slots = [&](int t, int (&xq)[2], int (&yq)[2]) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        xq[hf] = (warp * 16 + rr[hf]) % BX;
        yq[hf] = first_row(t) + (warp * 16 + rr[hf]) / BX;
      }
    };
    // b_v at this thread's output columns, for the padded keys' values
    uint32_t bv[PAD ? 10 : 1];
    if constexpr (PAD) {
#pragma unroll
      for (int j = 0; j < 10; ++j)
        bv[j] = *reinterpret_cast<const uint32_t*>(bias_v + h * DH + j * 8 + 2 * tig);
    }
    mbar_wait(qfull + 8 * qi, (k / QB) & 1);

    // The bias products: rel_w into registers, rel_h into the scratch, q·b_k.
    // BX 16: both tables (32 rows each) in one product a tile, into o_lo (not
    // yet live), rel_pos_w's at columns TH and up; BX 64: one tile, a table
    // at a time into s.
    int xq[MT][2], yq[MT][2];
#pragma unroll
    for (int t = 0; t < MT; ++t) slots(t, xq[t], yq[t]);
    auto scatter_table = [&](int t, bool w_table) {
      float* scr = scr0 + t * 16 * RS;
      const int(&pos)[2] = w_table ? xq[t] : yq[t];
      const int n = w_table ? g.ww : g.wh;
      if constexpr (BX == 16)
        scatter(o_lo[t], scr, w_table ? TH : 0, pos, n);
      else
        scatter(s, scr, 0, pos, n);
    };
    float t8[MT][4];
    __syncwarp();  // the last item's reads of the scratch are done
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      if constexpr (BX == 16)
        prod80<2 * TH>(o_lo[t], q_wide(t), q_narrow(t), tab, tab_narrow);
      else
        prod80<TH>(s, q_wide(t), q_narrow(t), tab + TH * RA, tab_narrow + TH * RB);
      if constexpr (PAD)
        prod80<8>(t8[t], q_wide(t), q_narrow(t), qs + P::QR * ROW, qs + P::QR * ROW + 8 * RA);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      if constexpr (BX == 16)
        fence_regs(o_lo[t]);
      else
        fence_regs(s);
      if constexpr (PAD) {
        fence_regs(t8[t]);
        // column h & 7 of the b_k product lies with lane tig = (h & 7) / 2
        const int hc = h & 7, src = (lane & ~3) | (hc >> 1);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          qb[t][hf] =
              __shfl_sync(0xffffffffu, (hc & 1) ? t8[t][2 * hf + 1] : t8[t][2 * hf], src);
      }
      scatter_table(t, true);
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < MT; ++t) gather_rw(t, scr0 + t * 16 * RS);
    if constexpr (PAD) {  // the keys past the grid: the same columns in every tile
      xmask = 0;
#pragma unroll
      for (int i = 0; i < KC / 2; ++i) {
        const int kx = ((i >> 2) % XG) * 8 + 2 * tig + (i & 1);
        if (kx < g.ww && x0 + kx >= g.w) xmask |= 1ull << i;
      }
    }
    __syncwarp();  // rel_w is read; rel_h overwrites it
    if constexpr (BX != 16) {
      wgmma_fence();
      prod80<TH>(s, q_wide(0), q_narrow(0), tab, tab_narrow);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
    }
#pragma unroll
    for (int t = 0; t < MT; ++t) scatter_table(t, false);
    __syncwarp();

#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o_lo[t][i] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) o_hi[t][i] = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        m_run[t][hf] = -INFINITY;
        l_run[t][hf] = 0.f;
        lp_run[t][hf] = 0.f;
      }
    }

    // Units (stage c, tile t) in order, a round each: S of the unit with
    // P·V of the one before, the two warpgroups in turn on the tensor cores
    // (named barriers); the softmax of a unit runs while P·V of the one
    // before (and the other's products) are in flight. A stage is released
    // once P·V of its last tile is done.
    float corr[2];
    auto issue_s = [&](auto tc, int c) {
      const uint32_t sa = stage(g0 + c);
      prod80<KC>(s, q_wide(decltype(tc)::value), q_narrow(decltype(tc)::value), sa,
                 sa + KC * RA);
      wgmma_commit();
    };
    auto issue_pv = [&](auto tc, int c) {
      constexpr int t = decltype(tc)::value;
      const uint32_t sv = stage(g0 + c) + KC * ROW;
      pv80<KC>(o_lo[t], o_hi[t], p[t], sv, sv + KC * RA);
      wgmma_commit();
    };
    auto pv_done = [&](auto tc, int c) {
      constexpr int t = decltype(tc)::value;
      fence_regs(o_lo[t]);
      fence_regs(o_hi[t]);
      keep_frags(p[t]);
      if (t == MT - 1 && lane == 0) mbar_arrive(empty + 8 * ((g0 + c) % S));
    };
    auto wait_full = [&](int c) { mbar_wait(full + 8 * ((g0 + c) % S), ((g0 + c) / S) & 1); };
    // a unit after the first: (c, tc), after (cp, tp)
    auto unit = [&](auto tc, int c, auto tp, int cp) {
      if constexpr (decltype(tc)::value == 0) wait_full(c);
      bar_sync_256(PING + wg);
      wgmma_fence();
      issue_s(tc, c);
      issue_pv(tp, cp);
      bar_arrive_256(PING + 1 - wg);
      load_rh(tc, c, y0);
      wgmma_wait<1>();
      fence_regs(s);
      softmax(tc, corr);
      wgmma_wait<0>();
      pv_done(tp, cp);
      rescale(tc, corr);
      pack(tc);
    };
    wait_full(0);
    if (wg == 1) bar_sync_256(PING + 1);
    wgmma_fence();
    issue_s(T0{}, 0);
    bar_arrive_256(PING + 1 - wg);
    load_rh(T0{}, 0, y0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(T0{}, corr);  // o is still 0: nothing to rescale
    pack(T0{});
    if constexpr (MT == 2) unit(std::integral_constant<int, 1>{}, 0, T0{}, 0);
    for (int c = 1; c < nch; ++c) {
      unit(T0{}, c, TL{}, c - 1);
      if constexpr (MT == 2) unit(std::integral_constant<int, 1>{}, c, T0{}, c);
    }
    bar_sync_256(PING + wg);
    wgmma_fence();
    issue_pv(TL{}, nch - 1);
    if (wg == 0) bar_arrive_256(PING + 1);
    wgmma_wait<0>();
    pv_done(TL{}, nch - 1);
    gc += nch;
    if (lane == 0) mbar_arrive(qempty + 8 * qi);  // every product of this Q is done

    // The output, a tile at a time through this warp's scratch rows (160
    // bytes each), so each row leaves as ten 16-byte stores: (o + Σp_pad ·
    // b_v) / l in bf16, the real queries alone.
    unsigned char* stage_out = reinterpret_cast<unsigned char*>(scr0);
#pragma unroll
    for (int t = 0; t < MT; ++t) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float l = l_run[t][hf], lp = lp_run[t][hf];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        lp += __shfl_xor_sync(0xffffffffu, lp, 1);
        lp += __shfl_xor_sync(0xffffffffu, lp, 2);
        const float inv = 1.f / l;
#pragma unroll
        for (int j = 0; j < 10; ++j) {
          const int col = j * 8 + 2 * tig;
          float v0 = j < 8 ? o_lo[t][4 * j + 2 * hf] : o_hi[t][4 * (j - 8) + 2 * hf];
          float v1 = j < 8 ? o_lo[t][4 * j + 2 * hf + 1] : o_hi[t][4 * (j - 8) + 2 * hf + 1];
          if constexpr (PAD) {
            const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[j]));
            v0 += lp * b2.x;
            v1 += lp * b2.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(stage_out + rr[hf] * ROW + col * 2) =
              __floats2bfloat162_rn(v0 * inv, v1 * inv);
        }
      }
      __syncwarp();
#pragma unroll
      for (int e = lane; e < 16 * DH / 8; e += 32) {  // 16-byte pieces of the 16 rows
        const int row = e / (DH / 8), piece = e - row * (DH / 8);
        const int x = (warp * 16 + row) % BX, y = first_row(t) + (warp * 16 + row) / BX;
        if (x >= g.ww || y >= g.wh || x0 + x >= g.w || y0 + y >= g.h)
          continue;  // a slot past the window or the grid
        bf16* ob = o + (((long long)b * g.h + y0 + y) * g.w + x0 + x) * d + h * DH;
        *reinterpret_cast<uint4*>(ob + piece * 8) =
            *reinterpret_cast<const uint4*>(stage_out + row * ROW + piece * 16);
      }
      __syncwarp();  // read out before the next tile (or item) overwrites it
    }
  }
}

// ------------------------------------------------------------------ host

namespace relpos {

// A 4-D map (column, x, y, batch) over one third of the packed qkv (H, W
// rows of 3D columns a batch element), in boxes of `cols` columns (64:
// 128-byte swizzle, 16: 32-byte) × box_x × box_y; positions past the grid
// read as zeros.
static bool relpos_map(CUtensorMap* map, const void* ptr, const RelposGeom& g, int batch,
                       int cols, int box_x, int box_y) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t width = 3ull * g.heads * DH;
  const cuuint64_t dims[4] = {(cuuint64_t)g.heads * DH, (cuuint64_t)g.w, (cuuint64_t)g.h,
                              (cuuint64_t)batch};
  const cuuint64_t pitch[3] = {width * sizeof(bf16), width * g.w * sizeof(bf16),
                               width * g.w * g.h * sizeof(bf16)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)box_x, (cuuint32_t)box_y, 1};
  const cuuint32_t elem_stride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, pitch, box,
            elem_stride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cols == CA ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (rows, 80) bf16 table in boxes of box_rows × 64 and × 16 columns;
// rows past `rows` read as zeros.
static bool table_maps(CUtensorMap* wide, CUtensorMap* narrow, const void* ptr, int rows,
                       int box_rows) {
  return cached_map_3d(wide, {ptr, DH, rows, 1, DH, (long long)rows * DH, box_rows, CA}) &&
         cached_map_3d(narrow, {ptr, DH, rows, 1, DH, (long long)rows * DH, box_rows, DH - CA});
}

template <int BX, bool PAD>
static int launch(const bf16* qkv, const bf16* bias, const bf16* tab_h, const bf16* tab_w,
                  void* out, int batch, RelposGeom g, float scale, cudaStream_t s) {
  using P = Plan<BX>;
  static SmemLimit limit;
  if (int err = set_smem(relpos_attn_kernel<BX, PAD>, P::SMEM, limit)) return err;
  const int d = g.heads * DH;
  g.npq = ((g.wh + P::QBY - 1) / P::QBY + P::NC * P::MT - 1) / (P::NC * P::MT);
  g.nch = (g.wh + P::KBY - 1) / P::KBY;
  g.items = batch * g.nw * g.heads * g.npq;
  Maps m;
  constexpr int QBOX = P::NC * P::MT * P::QBY;  // window rows of an item's queries
  if (!relpos_map(&m.q64, qkv, g, batch, CA, BX, QBOX) ||
      !relpos_map(&m.q16, qkv, g, batch, DH - CA, BX, QBOX) ||
      !relpos_map(&m.k64, qkv + d, g, batch, CA, BX, P::KBY) ||
      !relpos_map(&m.k16, qkv + d, g, batch, DH - CA, BX, P::KBY) ||
      !relpos_map(&m.v64, qkv + 2 * d, g, batch, CA, BX, P::KBY) ||
      !relpos_map(&m.v16, qkv + 2 * d, g, batch, DH - CA, BX, P::KBY) ||
      !table_maps(&m.h64, &m.h16, tab_h, 2 * g.wh - 1, P::TH) ||
      !table_maps(&m.w64, &m.w16, tab_w, 2 * g.ww - 1, P::TH) ||
      !table_maps(&m.b64, &m.b16, bias + d, g.heads, 8))
    return (int)cudaErrorInvalidValue;
  const int grid = max(1, min(g.items, sm_count()));
  relpos_attn_kernel<BX, PAD><<<grid, P::THREADS, P::SMEM, s>>>(
      m, static_cast<bf16*>(out), bias + 2 * d, g, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace relpos

// qkv (B, H, W, 3D) bf16 and its bias (3D,), the tables (2·wh − 1, dh) and
// (2·ww − 1, dh) bf16, out (B, H, W, D) bf16; windows up to 64 × 64 (the
// grid's in a global block).
extern "C" int mtt_relpos_attn(const void* qkv, const void* bias, const void* tab_h,
                               const void* tab_w, void* out, int batch, int h, int w, int heads,
                               int dh, int wh, int ww, float scale, void* stream) {
  using namespace relpos;
  if (dh != DH || batch <= 0 || h <= 0 || w <= 0 || heads <= 0 || wh <= 0 || ww <= 0 ||
      wh > 64 || ww > 64)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {qkv, bias, tab_h, tab_w, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nwx = (w + ww - 1) / ww;
  const RelposGeom g{h, w, wh, ww, nwx, nwx * ((h + wh - 1) / wh), heads, 0, 0, 0};
  const bf16* q16 = static_cast<const bf16*>(qkv);
  const bf16* b16 = static_cast<const bf16*>(bias);
  const bf16* th = static_cast<const bf16*>(tab_h);
  const bf16* tw = static_cast<const bf16*>(tab_w);
  const bool pad = h % wh || w % ww;
  if (wh <= 16 && ww <= 16)
    return pad ? launch<16, true>(q16, b16, th, tw, out, batch, g, scale, s)
               : launch<16, false>(q16, b16, th, tw, out, batch, g, scale, s);
  return pad ? launch<64, true>(q16, b16, th, tw, out, batch, g, scale, s)
             : launch<64, false>(q16, b16, th, tw, out, batch, g, scale, s);
}
