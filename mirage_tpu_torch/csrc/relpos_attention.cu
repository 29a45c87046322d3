// Attention with SAM's decomposed relative-position bias (the SAM ViT image
// encoder's attention core, ops/relpos_attention.py): for each window of
// wh × ww positions of the token grid (the whole grid in a global block) and
// each head, softmax((q·dh^-½)·kᵀ + rel_h + rel_w)·v, on the packed bf16 qkv
// of the real tokens (B, H, W, 3D), out (B, H, W, D). The grid is padded at
// the bottom and right to a multiple of the window; a padded position's
// query, key and value are the qkv bias. Two kernels a call:
//
// - relpos_attn_bias_kernel: the products of every real query with the
//   tables, one product T = Q·[rel_pos_h; rel_pos_w; each head's b_k]ᵀ on the
//   tensor cores (mma.sync, float accumulators), a row a (token, head): the
//   q of a token's head is read where it lies in the packed qkv, the tables
//   stay in shared memory, each CTA walks tiles of 128 rows. rel_h[i, kh] =
//   T[i, y − kh + wh − 1] and rel_w[i, kw] = T[i, 2·wh − 1 + x − kw + ww − 1]
//   (q unscaled), q·b_k a padded key's score.
// - relpos_attn_fwd_kernel: the bf16 forward of csrc/attention_fwd.cuh (two
//   consumer warpgroups of 64 query rows in ping-pong on named barriers, K
//   and V streamed by TMA through its ring of stages, S = Q·Kᵀ by wgmma from
//   shared memory, P·V with P in registers) with the window in its
//   addressing: the Q, K and V tensor maps are 4-D (column, x, y, batch)
//   over the grid and a 64-row tile is BX columns × 64/BX rows of a window
//   (BX 16 for windows up to 16 wide, 64 for a grid row up to 64), so a
//   window is read where it lies and nothing is partitioned or copied. Each
//   logits tile takes its bias before the running max: t = s·scale·log2e +
//   (rel_h + rel_w)·log2e in one FMA, a slot past the window at −∞. A slot
//   past the grid is padding: the maps read it as zeros, so its score is
//   replaced by q·b_k, its V row is zero, and Σp over the padded slots
//   (rescaled with the row sum) times b_v is added to the output before the
//   division by the row sum. Only the real queries are stored.
//
// Numerics as csrc/attention_fwd.cuh's: the float running max and row sum
// in log2 units, P rounded to bf16 before P·V, the output divided by the
// float row sum after it; the bias terms are float.
#define MTT_ATTN_FWD_DEVICE_ONLY
#include "attention_fwd.cuh"

constexpr float RP_LOG2E = 1.4426950408889634f;
constexpr int RP_BIAS_THREADS = 256, RP_BIAS_ROWS = 128;  // eight warps of 16 rows
constexpr int RP_DH = 80;                                 // SAM ViT-H's head dim
// the bias products' column tiles of 8 the two instantiations hold: up to
// 128 columns (windows of 14 at 16 heads: 27 + 27 + 16 → 80), up to 288
// (a 64 × 64 grid: 127 + 127 + 16 → 272)
constexpr int RP_NT8_NARROW = 16, RP_NT8_WIDE = 36;

// The token grid and its windows.
struct RelposGeom {
  int h, w;     // grid rows and columns
  int wh, ww;   // a window's rows and columns (the grid's in a global block)
  int nwx, nw;  // windows along a row of the grid, windows a batch element
  int heads;
  int nt;       // the bias products' row: rel_pos_h's 2·wh − 1, rel_pos_w's
                // 2·ww − 1, each head's q·b_k, zeros to a multiple of 16
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

// ------------------------------------------------------------ bias products

// Shared-memory rows of the product's operands are dh plus RP_PAD elements,
// so the eight 16-byte rows an ldmatrix reads fall in distinct banks.
constexpr int RP_PAD = 8;

// T (M, NT) = Q·[rel_pos_h; rel_pos_w; b_k of each head; 0]ᵀ in float, where
// row m = token·heads + head of Q is that head's q of a real token (read in
// place from the packed qkv). The table's NT rows (a multiple of 16) stay in
// shared memory; each CTA walks tiles of 128 rows (eight warps of 16, mma.sync
// m16n8k16, the A and B fragments by ldmatrix), at most NT8MAX column tiles
// of 8.
template <int DH, int NT8MAX>
__global__ void __launch_bounds__(RP_BIAS_THREADS, 1)
    relpos_attn_bias_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                            const bf16* __restrict__ tab_h, const bf16* __restrict__ tab_w,
                            float* __restrict__ t_out, long long m_rows, int heads, int nth,
                            int ntw, int nt) {
  constexpr int AS = DH + RP_PAD, CH = DH / 8;  // a row; its 16-byte chunks
  extern __shared__ __align__(16) unsigned char rp_bias_smem[];
  bf16* sb = reinterpret_cast<bf16*>(rp_bias_smem);  // nt rows
  bf16* sa = sb + nt * AS;                            // RP_BIAS_ROWS rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nt8 = nt / 8;
  const bf16* bias_k = bias + (long long)heads * DH;
  for (int e = tid; e < nt * CH; e += RP_BIAS_THREADS) {
    const int r = e / CH, c = (e - r * CH) * 8;
    const bf16* src = r < nth                ? tab_h + r * DH
                      : r < nth + ntw        ? tab_w + (r - nth) * DH
                      : r < nth + ntw + heads ? bias_k + (r - nth - ntw) * DH
                                              : nullptr;
    *reinterpret_cast<uint4*>(sb + r * AS + c) =
        src ? *reinterpret_cast<const uint4*>(src + c) : make_uint4(0, 0, 0, 0);
  }
  const long long width = 3LL * heads * DH;
  const uint32_t a_frag = smem_u32(sa + (warp * 16 + (lane & 15)) * AS + (lane >> 4) * 8);
  const uint32_t b_frag = smem_u32(sb + ((lane >> 4) * 8 + (lane & 7)) * AS + ((lane >> 3) & 1) * 8);
  for (long long m0 = (long long)blockIdx.x * RP_BIAS_ROWS; m0 < m_rows;
       m0 += (long long)gridDim.x * RP_BIAS_ROWS) {
    __syncthreads();  // the table is in; the last tile's fragments are read
    for (int e = tid; e < RP_BIAS_ROWS * CH; e += RP_BIAS_THREADS) {
      const int r = e / CH, c = (e - r * CH) * 8;
      const long long m = m0 + r;
      *reinterpret_cast<uint4*>(sa + r * AS + c) =
          m < m_rows ? *reinterpret_cast<const uint4*>(qkv + (m / heads) * width +
                                                       (m % heads) * DH + c)
                     : make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    float acc[NT8MAX][4];
#pragma unroll
    for (int j = 0; j < NT8MAX; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, a_frag + ks * 32);
#pragma unroll
      for (int j = 0; j < NT8MAX; j += 2) {
        if (j < nt8) {
          uint32_t b[4];
          ldmatrix_x4(b, b_frag + j * 8 * AS * 2 + ks * 32);
          mma_bf16_16816(acc[j], a, b[0], b[1]);
          mma_bf16_16816(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
    const long long r0 = m0 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NT8MAX; ++j) {
      if (j >= nt8) break;
      const int col = j * 8 + 2 * (lane & 3);
      if (r0 < m_rows)
        *reinterpret_cast<float2*>(t_out + r0 * nt + col) = make_float2(acc[j][0], acc[j][1]);
      if (r0 + 8 < m_rows)
        *reinterpret_cast<float2*>(t_out + (r0 + 8) * nt + col) =
            make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// ----------------------------------------------------------- the attention

template <int DH, int BX>
__global__ void __launch_bounds__(attn_fwd::THREADS, 1)
    relpos_attn_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                           const float* __restrict__ t_bias, const bf16* __restrict__ bias_v,
                           RelposGeom g, float scale_log2) {
  using namespace attn_fwd;
  using G = Geom<DH>;
  constexpr int S = G::STAGES;
  constexpr int BY = KC / BX;  // window rows a 64-row tile holds
  constexpr int XG = BX / 8;   // 8-slot groups a tile row spans
  constexpr int XN = 2 * XG;   // the tile columns a thread's slots fall on
  extern __shared__ unsigned char rp_fwd_smem[];
  const uint32_t sq = (smem_u32(rp_fwd_smem) + 1023) & ~1023u;  // the swizzle's period
  const uint32_t sst = sq + CONSUMERS * G::TILE_BYTES;           // stage s: K, then V
  const uint32_t full = sst + S * 2 * G::TILE_BYTES, empty = full + 8 * S, qbar = empty + 8 * S;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int h = blockIdx.y, bw = blockIdx.z, b = bw / g.nw, wi = bw - b * g.nw;
  const int wy = wi / g.nwx, wx = wi - wy * g.nwx;
  const int x0 = wx * g.ww, y0 = wy * g.wh;  // the window's first column and row
  const int nch = (g.wh + BY - 1) / BY;      // key chunks of a window, and its query tiles
  const int t0 = blockIdx.x * CONSUMERS;
  const int active = min(CONSUMERS, nch - t0);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * active);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg >= active) return;

  const bool loader = wg == active - 1 && (tid & 127) == 0;
  auto load_chunk = [&](int c) {
    const uint32_t st = sst + (c % S) * 2 * G::TILE_BYTES, bar = full + 8 * (c % S);
    mbar_expect_tx(bar, 2 * G::TILE_BYTES);
#pragma unroll
    for (int x = 0; x < G::NBOX; ++x) {
      tma_load_4d(st + x * G::BOX_BYTES, &map_k, bar, h * DH + x * G::BOXC, x0, y0 + c * BY, b);
      tma_load_4d(st + G::TILE_BYTES + x * G::BOX_BYTES, &map_v, bar, h * DH + x * G::BOXC, x0,
                  y0 + c * BY, b);
    }
  };
  if (loader) {
    mbar_expect_tx(qbar, active * G::TILE_BYTES);
    for (int w = 0; w < active; ++w)
#pragma unroll
      for (int x = 0; x < G::NBOX; ++x)
        tma_load_4d(sq + w * G::TILE_BYTES + x * G::BOX_BYTES, &map_q, qbar,
                    h * DH + x * G::BOXC, x0, y0 + (t0 + w) * BY, b);
    for (int c = 0; c < min(S, nch); ++c) load_chunk(c);
  }
  const bool pingpong = active == CONSUMERS;
  const int warp = (tid >> 5) & 3, lane = tid & 31, tig = lane & 3;
  const uint32_t my_q = sq + wg * G::TILE_BYTES;
  const int tile = t0 + wg;

  // This thread's two query rows r = warp·16 + lane/4 + 8·hf of the tile:
  // their rows of the bias products (null for a row past the window or the
  // grid), q·b_k, and rel_w at the XN tile columns of its slots (slot
  // 8·j + 2·tig + e of a chunk lies in column (j % XG)·8 + 2·tig + e, window
  // row j / XG of the chunk's BY), in log2 units, −∞ past the window.
  const float* trow[2];
  int qy[2];
  float qb[2], rw[2][XN];
  uint32_t padx = 0;  // bit xi: the column lies past the grid
  const int nth = 2 * g.wh - 1;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = warp * 16 + (lane >> 2) + 8 * hf;
    const int xl = r % BX, yl = tile * BY + r / BX;
    const bool real = xl < g.ww && yl < g.wh && x0 + xl < g.w && y0 + yl < g.h;
    trow[hf] = real ? t_bias + ((((long long)b * g.h + y0 + yl) * g.w + x0 + xl) * g.heads + h) *
                                   g.nt
                    : nullptr;
    qy[hf] = yl + g.wh - 1;
    qb[hf] = real ? trow[hf][nth + 2 * g.ww - 1 + h] : 0.f;
#pragma unroll
    for (int xi = 0; xi < XN; ++xi) {
      const int kx = (xi >> 1) * 8 + 2 * tig + (xi & 1);
      rw[hf][xi] = kx >= g.ww ? -INFINITY
                   : real     ? trow[hf][nth + xl - kx + g.ww - 1] * RP_LOG2E
                              : 0.f;
      if (hf == 0 && kx < g.ww && x0 + kx >= g.w) padx |= 1u << xi;
    }
  }
  // rel_h of a chunk's BY window rows (log2 units, −∞ past the window) and
  // which of them lie past the grid: loaded a round ahead into rh_next
  float rh[2][BY], rh_next[2][BY];
  uint32_t pady = 0, pady_next = 0;
  auto load_bias = [&](int r) {
    if (r >= nch) return;
    pady_next = 0;
#pragma unroll
    for (int yc = 0; yc < BY; ++yc) {
      const int ky = r * BY + yc;
      if (y0 + ky >= g.h) pady_next |= 1u << yc;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        rh_next[hf][yc] = ky >= g.wh ? -INFINITY
                          : trow[hf] ? trow[hf][qy[hf] - ky] * RP_LOG2E
                                     : 0.f;
    }
  };
  auto take_bias = [&](int r) {
#pragma unroll
    for (int yc = 0; yc < BY; ++yc) {
      rh[0][yc] = rh_next[0][yc];
      rh[1][yc] = rh_next[1][yc];
    }
    pady = pady_next;
    load_bias(r + 1);
  };
  load_bias(0);

  float o_acc[G::NPV / 2], s_acc[KC / 2];
  uint32_t p_frag[KC / 16][4];
#pragma unroll
  for (int i = 0; i < G::NPV / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KC / 2; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KC / 16; ++i) p_frag[i][0] = p_frag[i][1] = p_frag[i][2] = p_frag[i][3] = 0u;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, lp_run[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  auto kaddr = [&](int c) { return sst + (c % S) * 2 * G::TILE_BYTES; };
  auto begin = [&](int r) {
    if (r < nch) mbar_wait(full + 8 * (r % S), (r / S) & 1);
    if (pingpong && (wg == 1 || r > 0)) bar_sync_256(ORDER_BAR + wg);
  };
  auto end = [&](int r) {
    if (pingpong && (wg == 0 || r < nch)) bar_arrive_256(ORDER_BAR + 1 - wg);
    wgmma_wait<0>();
    fence_regs(s_acc);
    fence_regs(o_acc);
    keep_frags(p_frag);
    if (r > 0) {
      if (lane == 0) mbar_arrive(empty + 8 * ((r - 1) % S));
      if (loader && r - 1 + S < nch) {
        mbar_wait(empty + 8 * ((r - 1) % S), ((r - 1) / S) & 1);
        load_chunk(r - 1 + S);
      }
    }
    if (r == nch) return;

    // the logits in log2 units with their bias; padded slots scored q·b_k
    uint32_t padbits = 0;
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) {
      const int j = i >> 2, hf = (i >> 1) & 1, xi = (j % XG) * 2 + (i & 1), yc = j / XG;
      const bool pad = ((padx >> xi) | (pady >> yc)) & 1u;
      padbits |= (uint32_t)pad << i;
      s_acc[i] = fmaf(pad ? qb[hf] : s_acc[i], scale_log2, rh[hf][yc] + rw[hf][xi]);
    }
    float cmax[2] = {-INFINITY, -INFINITY}, m_use[2];
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) cmax[(i >> 1) & 1] = fmaxf(cmax[(i >> 1) & 1], s_acc[i]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      cmax[hf] = fmaxf(cmax[hf], __shfl_xor_sync(0xffffffffu, cmax[hf], 1));
      cmax[hf] = fmaxf(cmax[hf], __shfl_xor_sync(0xffffffffu, cmax[hf], 2));
      const float m_new = fmaxf(m_run[hf], cmax[hf]);
      m_use[hf] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      const float corr = exp2f(m_run[hf] - m_use[hf]);
      m_run[hf] = m_new;
      l_run[hf] *= corr;
      lp_run[hf] *= corr;
#pragma unroll
      for (int j = 0; j < G::NPV / 8; ++j) {
        o_acc[4 * j + 2 * hf] *= corr;
        o_acc[4 * j + 2 * hf + 1] *= corr;
      }
    }
#pragma unroll
    for (int i = 0; i < KC / 2; ++i) {
      const int hf = (i >> 1) & 1;
      s_acc[i] = exp2f(s_acc[i] - m_use[hf]);
      l_run[hf] += s_acc[i];
      if ((padbits >> i) & 1u) lp_run[hf] += s_acc[i];
    }
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      p_frag[j >> 1][(j & 1) * 2] = pack_bf16(s_acc[4 * j], s_acc[4 * j + 1]);
      p_frag[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s_acc[4 * j + 2], s_acc[4 * j + 3]);
    }
  };
  // rounds 0 .. nch − 1: S of chunk r (every chunk 64 slots wide) with P·V
  // of chunk r − 1; round nch: P·V of the last chunk
  if (nch > 1) {
    begin(0);
    take_bias(0);
    issue<DH, KC, 0>(s_acc, o_acc, p_frag, my_q, kaddr(0), 0);
    end(0);
  }
  for (int r = 1; r < nch - 1; ++r) {
    begin(r);
    take_bias(r);
    issue<DH, KC, KC / 16>(s_acc, o_acc, p_frag, my_q, kaddr(r), kaddr(r - 1) + G::TILE_BYTES);
    end(r);
  }
  const int last = nch - 1;
  begin(last);
  take_bias(last);
  if (last > 0)
    issue<DH, KC, KC / 16>(s_acc, o_acc, p_frag, my_q, kaddr(last),
                           kaddr(last - 1) + G::TILE_BYTES);
  else
    issue<DH, KC, 0>(s_acc, o_acc, p_frag, my_q, kaddr(last), 0);
  end(last);
  begin(nch);
  issue<DH, 0, KC / 16>(s_acc, o_acc, p_frag, my_q, 0, kaddr(last) + G::TILE_BYTES);
  end(nch);

  const int d = g.heads * DH;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf], lp = lp_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lp += __shfl_xor_sync(0xffffffffu, lp, 1);
    lp += __shfl_xor_sync(0xffffffffu, lp, 2);
    const int r = warp * 16 + (lane >> 2) + 8 * hf;
    const int gx = x0 + r % BX, gy = y0 + tile * BY + r / BX;
    if (trow[hf] == nullptr) continue;
    const float inv = 1.f / l;
    bf16* ob = o + (((long long)b * g.h + gy) * g.w + gx) * d + h * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = j * 8 + 2 * tig;
      const float2 bv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias_v + h * DH + col));
      *reinterpret_cast<__nv_bfloat162*>(ob + col) =
          __floats2bfloat162_rn((o_acc[4 * j + 2 * hf] + lp * bv.x) * inv,
                                (o_acc[4 * j + 2 * hf + 1] + lp * bv.y) * inv);
    }
  }
}

// ------------------------------------------------------------------ host

// A 4-D map (column, x, y, batch) over one third of the packed qkv (H, W
// rows of 3D columns a batch element), in boxes of 64 columns × BX × BY,
// 128-byte swizzled; positions past the grid read as zeros.
static bool relpos_map(CUtensorMap* map, const void* ptr, const RelposGeom& g, int batch, int dh,
                       int box_x, int box_y) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t width = 3ull * g.heads * dh;
  const cuuint64_t dims[4] = {(cuuint64_t)g.heads * dh, (cuuint64_t)g.w, (cuuint64_t)g.h,
                              (cuuint64_t)batch};
  const cuuint64_t pitch[3] = {width * sizeof(bf16), width * g.w * sizeof(bf16),
                               width * g.w * g.h * sizeof(bf16)};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_x, (cuuint32_t)box_y, 1};
  const cuuint32_t elem_stride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, pitch, box,
            elem_stride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int BX>
static int launch_fwd(const void* qkv, const bf16* bias_v, const float* t_bias, void* out,
                      int batch, const RelposGeom& g, float scale, cudaStream_t s) {
  using G = attn_fwd::Geom<DH>;
  constexpr int BY = attn_fwd::KC / BX;
  static SmemLimit limit;
  if (int err = set_smem(relpos_attn_fwd_kernel<DH, BX>, G::SMEM, limit)) return err;
  const bf16* base = static_cast<const bf16*>(qkv);
  const int d = g.heads * DH;
  CUtensorMap mq, mk, mv;
  if (!relpos_map(&mq, base, g, batch, DH, BX, BY) ||
      !relpos_map(&mk, base + d, g, batch, DH, BX, BY) ||
      !relpos_map(&mv, base + 2 * d, g, batch, DH, BX, BY))
    return (int)cudaErrorInvalidValue;
  const int tiles = (g.wh + BY - 1) / BY;
  const dim3 grid((tiles + attn_fwd::CONSUMERS - 1) / attn_fwd::CONSUMERS, g.heads, batch * g.nw);
  relpos_attn_fwd_kernel<DH, BX><<<grid, attn_fwd::THREADS, G::SMEM, s>>>(
      mq, mk, mv, static_cast<bf16*>(out), t_bias, bias_v, g, scale * RP_LOG2E);
  return (int)cudaGetLastError();
}

template <int NT8MAX>
static int launch_bias(const bf16* qkv, const bf16* bias, const bf16* tab_h, const bf16* tab_w,
                       float* t_bias, int batch, const RelposGeom& g, cudaStream_t s) {
  static SmemLimit limit(48 * 1024);
  const size_t smem = (size_t)(g.nt + RP_BIAS_ROWS) * (RP_DH + RP_PAD) * sizeof(bf16);
  if (int err = set_smem(relpos_attn_bias_kernel<RP_DH, NT8MAX>, smem, limit)) return err;
  const long long m = (long long)batch * g.h * g.w * g.heads;
  const int tiles = (int)((m + RP_BIAS_ROWS - 1) / RP_BIAS_ROWS);
  relpos_attn_bias_kernel<RP_DH, NT8MAX><<<max(1, min(tiles, 2 * sm_count())), RP_BIAS_THREADS,
                                                   smem, s>>>(
      qkv, bias, tab_h, tab_w, t_bias, m, g.heads, 2 * g.wh - 1, 2 * g.ww - 1, g.nt);
  return (int)cudaGetLastError();
}

// The bias products' row width: rel_pos_h's and rel_pos_w's rows and each
// head's b_k, rounded up to 16.
static int relpos_nt(int wh, int ww, int heads) {
  return (2 * wh - 1 + 2 * ww - 1 + heads + 15) / 16 * 16;
}

// qkv (B, H, W, 3D) bf16 and its bias (3D,), the tables (2·wh − 1, dh) and
// (2·ww − 1, dh) bf16, t_bias (B·H·W·heads, relpos_nt) float scratch, out
// (B, H, W, D) bf16.
extern "C" int mtt_relpos_attn(const void* qkv, const void* bias, const void* tab_h,
                               const void* tab_w, float* t_bias, void* out, int batch, int h,
                               int w, int heads, int dh, int wh, int ww, float scale,
                               void* stream) {
  const int nt = relpos_nt(wh, ww, heads);
  if (dh != RP_DH || batch <= 0 || h <= 0 || w <= 0 || heads <= 0 || wh <= 0 || ww <= 0 ||
      ww > attn_fwd::KC || nt > 8 * RP_NT8_WIDE)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {qkv, bias, tab_h, tab_w, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nwx = (w + ww - 1) / ww;
  const RelposGeom g{h, w, wh, ww, nwx, nwx * ((h + wh - 1) / wh), heads, nt};
  const bf16* q16 = static_cast<const bf16*>(qkv);
  const bf16* b16 = static_cast<const bf16*>(bias);
  const bf16* th = static_cast<const bf16*>(tab_h);
  const bf16* tw = static_cast<const bf16*>(tab_w);
  const int err = nt <= 8 * RP_NT8_NARROW
                      ? launch_bias<RP_NT8_NARROW>(q16, b16, th, tw, t_bias, batch, g, s)
                      : launch_bias<RP_NT8_WIDE>(q16, b16, th, tw, t_bias, batch, g, s);
  if (err) return err;
  const bf16* bias_v = b16 + 2 * heads * RP_DH;
  if (ww <= 16) return launch_fwd<RP_DH, 16>(qkv, bias_v, t_bias, out, batch, g, scale, s);
  return launch_fwd<RP_DH, 64>(qkv, bias_v, t_bias, out, batch, g, scale, s);
}
