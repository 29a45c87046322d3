// A whole pre-LN transformer block in one launch:
//   h = x + proj(softmax(q·kᵀ·dh^-½)·v),  q|k|v = LN1(x)·Wqkvᵀ + bqkv
//   out = h + fc2(GELU_erf(fc1(LN2(h))))
// Replaces mirage_tpu/ops/fused_block.py:_block_fwd / _block_kernel, the
// TPU kernel that runs both halves of a block in one grid program per batch
// element with every weight resident in VMEM.
//
// An SM's shared memory holds neither the weights nor a batch element's
// activations, so the launch is one persistent, cooperative grid over the
// whole batch: as many CTAs as the card holds at once (the occupancy times
// the SM count, never the batch; ops/fused_block.py:fused_block_plan), which
// walk each stage's work items and meet at a grid-wide barrier between
// stages. The intermediates go through a scratch the wrapper allocates (y:
// the LN outputs, qkv, the pre-proj attention output, the MLP hidden),
// tiled over all B·N rows as the two halves' kernels tile them, so each
// weight tile serves every batch element and a 128-row tile pads at most
// 127 rows of the whole batch:
//
//   1. LN1 over rows (a warp a row) -> y                         | barrier
//   2. qkv = y·Wqkvᵀ + bqkv, 128 × tile_n tiles -> qkv           | barrier
//   3. attention, items (batch element, head) -> attn            | barrier
//   4. h = x + T(attn·Wprojᵀ + bproj), tiles -> out              | barrier
//   5. LN2 of h over rows -> y                                   | barrier
//   6. T(GELU(y·W1ᵀ + b1)), tiles -> act                         | barrier
//   7. out = h + T(act·W2ᵀ + b2), tiles, in place
//
// The barrier is a release/acquire counter in the scratch (zeroed by the
// launcher): each CTA adds one after a device-scope fence and waits for
// the k-th multiple of the grid, and every thread fences the async proxy on
// both sides, so TMA reads see what other CTAs wrote with plain stores;
// every other read of data another CTA wrote goes through L2 (cp.async.cg,
// ld.global.cg). A cooperative launch refuses a grid that cannot be
// resident at once, so the barrier cannot wait on a CTA that never runs
// (and traps after ≈ 10 s rather than hang the card).
//
// bf16 runs every projection on Hopper's warpgroup MMA (wgmma, float
// accumulation) with TMA loads, csrc/gemm.cu's main loop: 128 × tile_n
// tiles (tile_n 256 or 128, chosen at run time), K-slices of 64 (one
// 128-byte swizzled row) in a four-stage ring of shared memory, two
// warpgroups each multiplying 64 rows of the tile. There is no loader
// warpgroup (with one, ptxas caps the kernel at 168 registers): thread 0
// keeps the ring four slices ahead, in the order both warpgroups consume
// them, across tiles, so the next tile's slices land during an epilogue.
// The epilogue stages each warp's rows through shared memory (the tile's
// bias loaded there when the tile starts), so the output and the residual
// move in 16-byte rows, as gemm.cu's store_tile does. Attention runs
// mma.sync m16n8k16 with an online softmax (the running maximum rescales in
// float) over key chunks of 64 (32 at wide heads, to bound the registers),
// as the port's attention kernel does: an item's K and V are loaded whole
// into shared memory (two items' at MIRAGE's shapes, so the next load
// overlaps the products; ops/fused_block.py:attention_buffers) and each
// warp walks the item's 16-query tiles with no barrier between them; where
// one head's K and V do not fit (head dim 128 above ≈ 380 tokens), passes
// of 128 queries stream them in chunks. A LayerNorm row of up to
// 1024 bf16 is read once into registers. float runs FMA tiles (64 × 64 GEMM
// tiles; a 64-query tile's scores in shared memory) in the same persistent
// walk, for the float32 golden. Rounding follows _block_kernel: the LN
// outputs, qkv, the unnormalised probabilities (before P·V; the division by
// the float row sum after it), proj + b, GELU (computed in float) and fc2 +
// b2 are rounded to the working type T where the TPU kernel rounds them;
// erf is exact (the TPU's polynomial erf is a Mosaic workaround). LN takes
// two passes over the row (ROADMAP queue C, fault 2).
//
// Bound: operations (2·N·D·12D + 4·N²·D per batch element). With stamps
// (the launcher's optional buffer) CTA 0 records when each stage's barrier
// completes. What a later PR changes first: a loader warp of its own so
// the ring stays full across epilogues, the LN stages folded into the GEMMs
// around them (two of the six barriers fewer), and attention items that
// balance the warps (17 query tiles on 8 warps at 257 tokens).
#include <math.h>

#include <initializer_list>

#include "mma_tiles.cuh"
#include "wgmma.cuh"

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_TOKENS = 512;
constexpr int BM = 128, BK = 64, STAGES = 4, MAX_BN = 256;  // bf16 GEMM tile, K-slice, ring
constexpr int A_BYTES = BM * BK * 2, STAGE_BYTES = (BM + MAX_BN) * BK * 2;
// per-warp epilogue scratch: the tile's bias as float, then a 16-row ×
// EPI_COLS staging tile (rows padded so fragment writes fall on distinct banks)
constexpr int EPI_COLS = 64, EPI_STRIDE = EPI_COLS + 8;
constexpr int EPI_WARP_BYTES = MAX_BN * 4 + 16 * EPI_STRIDE * 2;
constexpr int AQT = 128;            // bf16 attention: queries per pass
constexpr int FT = 64, FK = 16;     // float GEMM tile and K-slice
constexpr int FQT = 64;             // float attention: queries per pass

struct BlockArgs {
  const void* x;
  void* out;
  const void *ln1_w, *ln1_b, *bqkv, *bproj, *ln2_w, *ln2_b, *b1, *b2;  // param dtype pdtype
  const void *wqkv, *wproj, *w1, *w2;                                 // working type, (out, in)
  void *y, *qkv, *attn, *act;                                         // scratch, working type
  unsigned int* bar;                                                  // grid barrier counter
  unsigned long long* stamps;  // null, or the stage boundaries' %globaltimer (7 + grid)
  int batch, n, d, hidden, heads, dh, pdtype, tile_n;
  int attn_buffers;  // bf16 attention: 1 or 2 heads' K and V resident, 0 streamed
  float scale, eps;
};

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every CTA of the grid arrives once per barrier; the k-th barrier is done
// when the counter reaches k·gridDim.x (`target` counts them per CTA).
__device__ __forceinline__ void grid_barrier(unsigned int* bar, unsigned int& target) {
  asm volatile("fence.proxy.async;\n" ::: "memory");  // this thread's stores before later TMA reads
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    if (ld_acquire(bar) < target) {
      const long long t0 = clock64();
      while (ld_acquire(bar) < target) {
        __nanosleep(64);
        if (clock64() - t0 > (1ll << 34)) __trap();
      }
    }
  }
  __syncthreads();
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// 16 bytes of T from L2 (bypassing L1) as floats
template <typename T>
__device__ __forceinline__ void load16_cg(const T* p, float (&v)[16 / sizeof(T)]) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) v[i] = to_f(e[i]);
}

// ------------------------------------------------------------- LayerNorm

// One warp's LayerNorm of one row, xr -> yr: two passes for the
// statistics, 16-byte loads (d is a multiple of 16 elements). CACHED: the
// row (at most 32·LN_CHUNKS 16-byte chunks) is read once and kept in
// registers; otherwise it is read from L2 once per pass.
constexpr int LN_CHUNKS = 4;
template <typename T, bool CACHED>
__device__ __forceinline__ void ln_row(const T* xr, T* yr, const void* gamma, const void* beta,
                                       int pdtype, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  uint4 row[CACHED ? LN_CHUNKS : 1];  // chunk c: elements (lane + 32·c)·VEC ...
  if constexpr (CACHED) {
#pragma unroll
    for (int c = 0; c < LN_CHUNKS; ++c)
      if ((lane + 32 * c) * VEC < d)
        row[c] = __ldcg(reinterpret_cast<const uint4*>(xr + (lane + 32 * c) * VEC));
  }
  float v[VEC];
  auto chunk = [&](int c, int i) {  // the lane's chunk c (element i) as floats into v
    if constexpr (CACHED) {
      const T* e = reinterpret_cast<const T*>(&row[c]);
#pragma unroll
      for (int q = 0; q < VEC; ++q) v[q] = to_f(e[q]);
    } else {
      load16_cg<T>(xr + i, v);
    }
  };
  float s = 0.f;
#pragma unroll
  for (int c = 0; !CACHED || c < LN_CHUNKS; ++c) {
    const int i = (lane + 32 * c) * VEC;
    if (i >= d) break;
    chunk(c, i);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += v[e];
  }
  const float mean = warp_sum(s) / d;
  float var = 0.f;
#pragma unroll
  for (int c = 0; !CACHED || c < LN_CHUNKS; ++c) {
    const int i = (lane + 32 * c) * VEC;
    if (i >= d) break;
    chunk(c, i);
#pragma unroll
    for (int e = 0; e < VEC; ++e) var += (v[e] - mean) * (v[e] - mean);
  }
  const float rstd = rsqrtf(warp_sum(var) / d + eps);
#pragma unroll
  for (int c = 0; !CACHED || c < LN_CHUNKS; ++c) {
    const int i = (lane + 32 * c) * VEC;
    if (i >= d) break;
    chunk(c, i);
    uint4 u;
    T* o = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o[e] = from_f<T>((v[e] - mean) * rstd * load_param(gamma, i + e, pdtype) +
                       load_param(beta, i + e, pdtype));
    *reinterpret_cast<uint4*>(yr + i) = u;
  }
}

// dst[r] = T(LN(src[r])) for every row r < m: global warp w of the grid
// takes rows w, w + gridDim.x·WARPS, ...
template <typename T>
__device__ void ln_rows(const T* src, const void* gamma, const void* beta, int pdtype, T* dst,
                        int m, int d, float eps) {
  const bool cached = d <= 32 * (16 / (int)sizeof(T)) * LN_CHUNKS;
  for (int r = blockIdx.x * WARPS + (threadIdx.x >> 5); r < m; r += gridDim.x * WARPS) {
    if (cached)
      ln_row<T, true>(src + (long)r * d, dst + (long)r * d, gamma, beta, pdtype, d, eps);
    else
      ln_row<T, false>(src + (long)r * d, dst + (long)r * d, gamma, beta, pdtype, d, eps);
  }
}

// ------------------------------------------------------------ bf16 GEMM

// The ring of STAGES K-slices in shared memory: slice i (counted over the
// whole launch) sits in stage i % STAGES; full[s] counts its bytes in,
// empty[s] the eight warps done with it.
struct Ring {
  uint32_t base, full, empty;
  unsigned char* scratch;  // the eight warps' epilogue scratch, EPI_WARP_BYTES each
};

// One GEMM stage: dst[r, c] = epi(A[r, :k] · W[c, :k]ᵀ) for r < m, c <
// ncols: v = acc + bias[c] in float, GELU if asked, rounded to bf16; with a
// residual, T(res[r, c] + T(v)). A and W are read by TMA through their
// maps (A boxes of 128 × 64, W boxes of bn × 64; out-of-range rows read as
// zero); dst and res have row stride ldd (res may be dst: each element is
// read, then written, by one thread). CTA b walks tiles b, b + gridDim.x,
// ... of the 128 × bn tiling (row-major); pos counts the slices the CTA
// has put through the ring before this stage and is returned advanced.
__device__ int gemm_stage(const CUtensorMap* map_a, const CUtensorMap* map_w, int m, int ncols,
                          int k, int bn, const void* bias, int pdtype, bool gelu, const bf16* res,
                          bf16* dst, int ldd, Ring ring, int pos) {
  const int tid = threadIdx.x, cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int tiles_n = (ncols + bn - 1) / bn, tiles = tiles_n * ((m + BM - 1) / BM);
  const int ktiles = (k + BK - 1) / BK;
  const int mine = (int)blockIdx.x < tiles ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int total = mine * ktiles, w_bytes = bn * BK * 2;
  // thread 0: the load of this stage's slice j, once its ring stage is free
  auto issue = [&](int j) {
    const int idx = pos + j, s = idx % STAGES;
    const int t = blockIdx.x + (j / ktiles) * gridDim.x, kt = j % ktiles;
    mbar_wait(ring.empty + 8 * s, ((idx / STAGES) & 1) ^ 1);  // first round: free
    const uint32_t st = ring.base + s * STAGE_BYTES;
    mbar_expect_tx(ring.full + 8 * s, A_BYTES + w_bytes);
    tma_load_2d(st, map_a, ring.full + 8 * s, kt * BK, t / tiles_n * BM);
    tma_load_2d(st + A_BYTES, map_w, ring.full + 8 * s, kt * BK, t % tiles_n * bn);
  };
  // thread 0 keeps STAGES slices in flight: after the products on slice i - 1
  // are handed back, it loads slice i + STAGES - 1 into that stage
  int next = 0;  // thread 0's next slice to load
  if (tid == 0)
    for (; next < STAGES && next < total; ++next) issue(next);
  float* sbias = reinterpret_cast<float*>(ring.scratch + (tid >> 5) * EPI_WARP_BYTES);
  bf16* stage = reinterpret_cast<bf16*>(sbias + MAX_BN);
  int j = 0;
  for (int tt = 0; tt < mine; ++tt) {
    const int t = blockIdx.x + tt * gridDim.x;
    {  // the tile's bias into the warp's scratch (zero past ncols or without one)
      const int c0 = t % tiles_n * bn;
      for (int c = lane; c < bn; c += 32)
        sbias[c] = bias != nullptr && c0 + c < ncols ? load_param(bias, c0 + c, pdtype) : 0.f;
    }
    float acc[MAX_BN / 2];
#pragma unroll
    for (int e = 0; e < MAX_BN / 2; ++e) acc[e] = 0.f;
    fence_regs(acc);
    for (int kt = 0; kt < ktiles; ++kt, ++j) {
      const int idx = pos + j, s = idx % STAGES;
      mbar_wait(ring.full + 8 * s, (idx / STAGES) & 1);
      const uint32_t st = ring.base + s * STAGE_BYTES;
      const uint64_t da = wgmma_desc(st + cw * 64 * 128), db = wgmma_desc(st + A_BYTES);
      wgmma_fence();
      if (bn == MAX_BN) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_n256(acc, da + 2 * kk, db + 2 * kk);  // +32 B
      } else {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_n128(acc, da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the products on slice idx - 1 are done: hand its stage back
      if (kt > 0) {
        if (lane == 0) mbar_arrive(ring.empty + 8 * ((idx - 1) % STAGES));
        if (tid == 0 && next < total) issue(next++);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(ring.empty + 8 * ((pos + j - 1) % STAGES));
    if (tid == 0 && next < total) issue(next++);  // lands during the epilogue

    // the warp's 16 rows, EPI_COLS columns at a time: bias and GELU on the
    // fragments (rows gid, gid + 8; columns 8·jj + 2·tig, + 1), rounded to
    // bf16 into the staging tile, then 16-byte rows out of it, the residual
    // read 16 bytes at a time (res may be dst: each chunk is read, then
    // written, by one lane)
    const long row0 = (long)(t / tiles_n) * BM + cw * 64 + warp * 16;
    const int n0 = t % tiles_n * bn;
    __syncwarp();  // every lane's bias is in the scratch
#pragma unroll  // fully: acc must stay in registers (constant indices)
    for (int cc = 0; cc < MAX_BN / EPI_COLS; ++cc) {
      const int c0 = n0 + cc * EPI_COLS;
      if (cc * EPI_COLS >= bn || c0 >= ncols) break;
#pragma unroll
      for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
        const int jn = cc * (EPI_COLS / 8) + jj, c = jj * 8 + 2 * tig;
        const float2 bv = *reinterpret_cast<const float2*>(sbias + cc * EPI_COLS + c);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v0 = acc[4 * jn + 2 * half] + bv.x, v1 = acc[4 * jn + 2 * half + 1] + bv.y;
          if (gelu) {
            v0 = gelu_exact(v0);
            v1 = gelu_exact(v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(stage + (gid + 8 * half) * EPI_STRIDE + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      __syncwarp();
      // 16 rows × 8 chunks of 16 bytes: four per lane, two residual loads in
      // flight at a time
#pragma unroll
      for (int i0 = 0; i0 < 4; i0 += 2) {
        uint4 rv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = lane + 32 * (i0 + i), r = e >> 3, c = (e & 7) * 8;
          if (res != nullptr && row0 + r < m && c0 + c < ncols)
            rv[i] = __ldcg(reinterpret_cast<const uint4*>(res + (row0 + r) * ldd + c0 + c));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = lane + 32 * (i0 + i), r = e >> 3, c = (e & 7) * 8;
          if (row0 + r >= m || c0 + c >= ncols) continue;
          uint4 out = *reinterpret_cast<const uint4*>(stage + r * EPI_STRIDE + c);
          if (res != nullptr) {
            __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
            const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv[i]);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 x = __bfloat1622float2(r2[q]), y = __bfloat1622float2(o2[q]);
              o2[q] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
            }
          }
          *reinterpret_cast<uint4*>(dst + (row0 + r) * ldd + c0 + c) = out;
        }
      }
      __syncwarp();  // the lanes have read the staging tile before it is refilled
    }
  }
  return pos + total;
}

// ----------------------------------------------------------- float GEMM

// The same contract in float: 64 × 64 tiles walked as above, 4 × 4 outputs
// per thread, A and W read through L2.
__device__ void gemm_stage_f32(const float* A, int lda, const float* W, int m, int ncols, int k,
                               const void* bias, int pdtype, bool gelu, const float* res,
                               float* dst, int ldd, unsigned char* smem) {
  float(*as)[FT + 4] = reinterpret_cast<float(*)[FT + 4]>(smem);  // as[k][m]
  float(*bs)[FT + 4] = as + FK;                                   // bs[k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tiles_n = (ncols + FT - 1) / FT, tiles = tiles_n * ((m + FT - 1) / FT);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / tiles_n * FT, n0 = t % tiles_n * FT;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < k; k0 += FK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = tid + i * THREADS, r = e / FK, kk = e % FK;
        const int gk = k0 + kk, gr = m0 + r, gn = n0 + r;
        as[kk][r] = (gr < m && gk < k) ? __ldcg(A + (long)gr * lda + gk) : 0.f;
        bs[kk][r] = (gn < ncols && gk < k) ? __ldcg(W + (long)gn * k + gk) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
        if (row >= m || col >= ncols) continue;
        float v = acc[i][j] + (bias != nullptr ? load_param(bias, col, pdtype) : 0.f);
        if (gelu) v = gelu_exact(v);
        const long off = (long)row * ldd + col;
        if (res != nullptr) v = __ldcg(res + off) + v;
        dst[off] = v;
      }
  }
}

// -------------------------------------------------------- bf16 attention

// One warp's 16 queries (A fragments qf) against the KC keys [key0, key0 +
// KC) of a chunk in shared memory (kc, vc: KC × (DH + 8) rows; keys at or
// past n masked): the online softmax in exp2 (the running maximum rescales
// the float row sums and the output), P rounded to bf16 A fragments of P·V.
template <int DH, int KC>
__device__ __forceinline__ void attend_chunk(uint32_t (&qf)[DH / 16][4], float (&oacc)[DH / 8][4],
                                             float (&m_run)[2], float (&l_run)[2],
                                             const bf16* kc, const bf16* vc, int key0, int n,
                                             float scale_log2) {
  constexpr int NT = DH / 8;
  const int tig = threadIdx.x & 3;
  float s[KC / 8][4];
#pragma unroll
  for (int j = 0; j < KC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  mma_abt<DH, KC / 8>(s, qf, kc);
  float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < KC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + 2 * tig + (e & 1);
      s[j][e] = key < n ? s[j][e] * scale_log2 : -INFINITY;
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
    for (int t = 0; t < NT; ++t) {
      oacc[t][2 * hf] *= corr;
      oacc[t][2 * hf + 1] *= corr;
    }
  }
  // P = exp2(s - m): float row sums, bf16 A fragments of P·V
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
  mma_ab<DH, KC / 16>(oacc, pf, vc);
}

// A warp's 16 output rows q0 + gid (+ 8), divided by the float row sums, into
// o (row stride ors); rows at or past n are not written.
template <int DH>
__device__ __forceinline__ void store_rows(const float (&oacc)[DH / 8][4], const float (&l_run)[2],
                                           bf16* o, int ors, int q0, int n) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int gq = q0 + gid + 8 * hf;
    if (gq >= n) continue;
#pragma unroll
    for (int t = 0; t < DH / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(o + (long)gq * ors + t * 8 + 2 * tig) =
          __floats2bfloat162_rn(oacc[t][2 * hf] * inv, oacc[t][2 * hf + 1] * inv);
  }
}

// Shared memory of the resident attention stage: a 16-query tile per warp
// and `buffers` heads' K and V (rows padded to the key chunk, zero past n).
__host__ __device__ constexpr size_t attention_resident_bytes(int n, int dh, int buffers) {
  return 2 * (size_t)WARPS * 16 * (dh + 8) +
         (size_t)buffers * 2 * 2 * ((n + (dh <= 64 ? 64 : 32) - 1) / (dh <= 64 ? 64 : 32) *
                                   (dh <= 64 ? 64 : 32)) * (dh + 8);
}

// The resident attention stage: CTA b walks (batch element, head) items b,
// b + gridDim.x, ... of the packed qkv (row stride 3d) into attn (row stride
// d). An item's K and V are loaded whole into shared memory (with two
// buffers, the next item's load overlaps this one's products); each warp
// then walks the item's 16-query tiles w, w + WARPS, ... with no barrier
// between them, its next tile's queries loaded into registers while it
// computes the current one (at head dims up to 64: wider, the registers
// spill).
template <int DH>
__device__ __forceinline__ void attention_resident(const bf16* qkv, bf16* attn, int batch,
                                                   int heads, int n, int d, int buffers,
                                                   float scale_log2, unsigned char* smem) {
  constexpr int DS = DH + 8, CPR = DH / 8, KT = DH / 16, NT = DH / 8, KC = chunk_rows<DH>();
  constexpr int QPL = (16 * CPR + 31) / 32;  // 16-byte chunks of a query tile per lane
  constexpr bool PREFETCH = DH <= 64;  // the next tile's queries in registers (wider: spills)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nkc = (n + KC - 1) / KC * KC, items = batch * heads, ntile = (n + 15) / 16;
  const long rs = 3L * d;
  bf16* qw = reinterpret_cast<bf16*>(smem) + warp * 16 * DS;
  bf16* kv = reinterpret_cast<bf16*>(smem) + WARPS * 16 * DS;  // per buffer: K, then V
  auto load_kv = [&](int item, int buf) {
    const int b = item / heads, h = item - b * heads;
    const bf16* k = qkv + (long)b * n * rs + d + h * DH;
    bf16* dst = kv + (size_t)buf * 2 * nkc * DS;
    for (int e = tid; e < 2 * nkc * CPR; e += THREADS) {
      const int r = e / CPR, c = (e - r * CPR) * 8, key = r < nkc ? r : r - nkc;
      const bool ok = key < n;
      cp_async16(smem_u32(dst + r * DS + c), ok ? k + (r < nkc ? 0 : d) + key * rs + c : k,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // this lane's share of query tile t of q (zero past n) into registers
  auto load_q = [&](uint4 (&qr)[QPL], const bf16* q, int t) {
#pragma unroll
    for (int i = 0; i < QPL; ++i) {
      const int e = lane + 32 * i, r = e / CPR, c = (e - r * CPR) * 8, g = t * 16 + r;
      qr[i] = make_uint4(0, 0, 0, 0);
      if (e < 16 * CPR && t < ntile && g < n)
        qr[i] = __ldcg(reinterpret_cast<const uint4*>(q + g * rs + c));
    }
  };
  if ((int)blockIdx.x < items) load_kv(blockIdx.x, 0);
  int k = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int nxt = item + gridDim.x, buf = buffers == 2 ? (k & 1) : 0;
    if (buffers == 2) {
      if (nxt < items) load_kv(nxt, buf ^ 1);  // that buffer's item is done (the barrier below)
      else cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this item's K and V are in
    const int b = item / heads, h = item - b * heads;
    const bf16* q = qkv + (long)b * n * rs + h * DH;
    const bf16* ks = kv + (size_t)buf * 2 * nkc * DS;
    const bf16* vs = ks + (size_t)nkc * DS;
    uint4 qr[QPL];
    if constexpr (PREFETCH) load_q(qr, q, warp);
    for (int t = warp; t < ntile; t += WARPS) {
      if constexpr (!PREFETCH) load_q(qr, q, t);
      __syncwarp();  // every lane has read the last tile's queries
#pragma unroll
      for (int i = 0; i < QPL; ++i) {
        const int e = lane + 32 * i, r = e / CPR, c = (e - r * CPR) * 8;
        if (e < 16 * CPR) *reinterpret_cast<uint4*>(qw + r * DS + c) = qr[i];
      }
      __syncwarp();
      uint32_t qf[KT][4];
      load_a<DH>(qf, qw, 0);
      if constexpr (PREFETCH) load_q(qr, q, t + WARPS);  // lands while this tile computes
      float oacc[NT][4];
#pragma unroll
      for (int u = 0; u < NT; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[u][e] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows gid, gid + 8
      for (int c = 0; c < nkc / KC; ++c)
        attend_chunk<DH, KC>(qf, oacc, m_run, l_run, ks + c * KC * DS, vs + c * KC * DS, c * KC,
                             n, scale_log2);
      store_rows<DH>(oacc, l_run, attn + (long)b * n * d + h * DH, d, t * 16, n);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
    if (buffers == 1 && nxt < items) load_kv(nxt, 0);
  }
}

// The streaming attention stage, where one head's K and V do not fit: one
// head of one batch element at a time, passes of 128 queries (16 per warp),
// keys streamed through shared memory in chunks, double-buffered by
// cp.async, all warps meeting at each chunk. q, k, v are column windows
// (row stride rs) of the packed qkv, o one of attn (row stride ors).
template <int DH>
__device__ __forceinline__ void attention_stage(const bf16* q, const bf16* k, const bf16* v,
                                                int rs, bf16* o, int ors, int n,
                                                float scale_log2, unsigned char* smem) {
  constexpr int DS = DH + 8, CPR = DH / 8, KT = DH / 16, NT = DH / 8, KC = chunk_rows<DH>();
  bf16* qs = reinterpret_cast<bf16*>(smem);  // AQT × DS
  bf16* ks = qs + AQT * DS;                  // 2 × KC × DS
  bf16* vs = ks + 2 * KC * DS;               // 2 × KC × DS
  const int tid = threadIdx.x, warp = tid >> 5;
  auto stage = [&](bf16* dst, const bf16* src, int row0, int rows) {
    for (int e = tid; e < rows * CPR; e += THREADS) {
      const int r = e / CPR, c = (e - r * CPR) * 8, g = row0 + r;
      const bool ok = g < n;
      cp_async16(smem_u32(dst + r * DS + c), ok ? src + (long)g * rs + c : src, ok ? 16 : 0);
    }
  };
  const int nchunks = (n + KC - 1) / KC;
  for (int q0 = 0; q0 < n; q0 += AQT) {
    stage(qs, q, q0, AQT);
    stage(ks, k, 0, KC);
    stage(vs, v, 0, KC);
    cp_async_commit();
    const bool active = q0 + warp * 16 < n;  // a warp past the last query only helps load
    uint32_t qf[KT][4];
    float oacc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[t][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows gid, gid + 8
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) {
        const int nb = (c + 1) & 1;
        stage(ks + nb * KC * DS, k, (c + 1) * KC, KC);
        stage(vs + nb * KC * DS, v, (c + 1) * KC, KC);
      }
      cp_async_commit();
      cp_async_wait<1>();  // chunk c (and Q) have landed
      __syncthreads();
      if (active) {
        if (c == 0) load_a<DH>(qf, qs, warp * 16);
        attend_chunk<DH, KC>(qf, oacc, m_run, l_run, ks + (c & 1) * KC * DS,
                             vs + (c & 1) * KC * DS, c * KC, n, scale_log2);
      }
      __syncthreads();  // every warp is done with this buffer before it is refilled
    }
    if (active) store_rows<DH>(oacc, l_run, o, ors, q0 + warp * 16, n);
  }
}

// The two stages as calls (not inlined), which the kernel takes above head
// dim 64: ptxas then allocates their registers apart from the GEMM's
// 128-float accumulator, and the kernel does not spill at 255 registers
// (inlined at those widths, it does; at 64 and below, inlined is faster).
template <int DH>
__device__ __noinline__ void attention_resident_call(const bf16* qkv, bf16* attn, int batch,
                                                     int heads, int n, int d, int buffers,
                                                     float scale_log2, unsigned char* smem) {
  attention_resident<DH>(qkv, attn, batch, heads, n, d, buffers, scale_log2, smem);
}
template <int DH>
__device__ __noinline__ void attention_stage_call(const bf16* q, const bf16* k, const bf16* v,
                                                  int rs, bf16* o, int ors, int n,
                                                  float scale_log2, unsigned char* smem) {
  attention_stage<DH>(q, k, v, rs, o, ors, n, scale_log2, smem);
}

// ------------------------------------------------------- float attention

// The same in float: a 64-query tile's scores for every key in shared
// memory, register-tiled FMAs, exp of the max-shifted scores, the output
// divided by the float row sum.
__device__ void attention_stage_f32(const float* q, const float* k, const float* v, int rs,
                                    float* o, int ors, int n, int dh, float scale,
                                    unsigned char* smem) {
  float* sm = reinterpret_cast<float*>(smem);
  const int nk_pad = (n + FQT - 1) / FQT * FQT;
  const int ds = dh + 1, ss = nk_pad + 1;
  float* qs = sm;              // FQT × ds
  float* kvs = qs + FQT * ds;  // FQT × ds
  float* s = kvs + FQT * ds;   // FQT × ss
  float* lsum = s + FQT * ss;  // FQT
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int nc = dh / 16;
  for (int q0 = 0; q0 < n; q0 += FQT) {
    __syncthreads();  // the previous pass is done with every buffer
    for (int e = tid; e < FQT * dh; e += THREADS) {
      const int r = e / dh, c = e - r * dh, gq = q0 + r;
      qs[r * ds + c] = gq < n ? __ldcg(q + (long)gq * rs + c) : 0.f;
    }
    for (int j0 = 0; j0 < nk_pad; j0 += FQT) {
      __syncthreads();
      for (int e = tid; e < FQT * dh; e += THREADS) {
        const int r = e / dh, c = e - r * dh, gj = j0 + r;
        kvs[r * ds + c] = gj < n ? __ldcg(k + (long)gj * rs + c) : 0.f;
      }
      __syncthreads();
      float acc[4][4] = {};
      for (int c = 0; c < dh; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ds + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = kvs[(tx + 16 * j) * ds + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[(ty * 4 + i) * ss + j0 + tx + 16 * j] = acc[i][j] * scale;
    }
    __syncthreads();
    for (int rr = 0; rr < FQT / WARPS; ++rr) {
      const int r = warp * (FQT / WARPS) + rr;
      float* row = s + r * ss;
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      float l = 0.f;
      for (int j = lane; j < nk_pad; j += 32) {
        const float e = j < n ? expf(row[j] - mx) : 0.f;
        l += e;
        row[j] = e;
      }
      l = warp_sum(l);
      if (lane == 0) lsum[r] = l;
    }
    float acc[4][8] = {};  // rows ty·4 + i, columns tx + 16·c (dh ≤ 128)
    for (int j0 = 0; j0 < nk_pad; j0 += FQT) {
      __syncthreads();
      for (int e = tid; e < FQT * dh; e += THREADS) {
        const int r = e / dh, c = e - r * dh, gj = j0 + r;
        kvs[r * ds + c] = gj < n ? __ldcg(v + (long)gj * rs + c) : 0.f;
      }
      __syncthreads();
      const int jn = min(FQT, n - j0);
      for (int j = 0; j < jn; ++j) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = s[(ty * 4 + i) * ss + j0 + j];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (c < nc) {
            const float vv = kvs[j * ds + tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, gq = q0 + r;
      if (gq >= n) continue;
      const float inv = 1.f / lsum[r];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c < nc) o[(long)gq * ors + tx + 16 * c] = acc[i][c] * inv;
    }
  }
}

// ----------------------------------------------------------------- kernel

// Persistent, launched cooperatively: CTA b of the grid walks items b,
// b + gridDim.x, ... of each stage. The seven stages are one loop (not
// unrolled), so each stage's code appears once. DH is the head dim of the
// bf16 kernels (0 for float, which reads it at run time and ignores the
// tensor maps).
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1)
    fused_block_kernel(const BlockArgs a, const __grid_constant__ CUtensorMap map_y,
                       const __grid_constant__ CUtensorMap map_wqkv,
                       const __grid_constant__ CUtensorMap map_attn,
                       const __grid_constant__ CUtensorMap map_wproj,
                       const __grid_constant__ CUtensorMap map_act,
                       const __grid_constant__ CUtensorMap map_w1,
                       const __grid_constant__ CUtensorMap map_w2) {
  extern __shared__ __align__(16) unsigned char fb_smem[];
  const int n = a.n, d = a.d, hid = a.hidden, dh = DH ? DH : a.dh, pd = a.pdtype;
  const int m = a.batch * n;
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  T* y = static_cast<T*>(a.y);
  T* qkv = static_cast<T*>(a.qkv);
  T* attn = static_cast<T*>(a.attn);
  T* act = static_cast<T*>(a.act);
  unsigned int target = 0;
  Ring ring = {0, 0, 0, nullptr};
  int pos = 0;  // slices this CTA has put through the ring
  if constexpr (DH != 0) {
    // the ring, the epilogue scratch (attention reuses both), then the barriers
    ring.base = (smem_u32(fb_smem) + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
    ring.scratch = fb_smem + (ring.base + STAGES * STAGE_BYTES - smem_u32(fb_smem));
    ring.full = ring.base + STAGES * STAGE_BYTES + WARPS * EPI_WARP_BYTES;
    ring.empty = ring.full + 8 * STAGES;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(ring.full + 8 * s, 1);
        mbar_init(ring.empty + 8 * s, 8);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // with stamps: CTA 0 records the start and each barrier's completion,
  // every CTA its end (the host takes the latest)
  const bool stamp = a.stamps != nullptr && threadIdx.x == 0;
  if (stamp && blockIdx.x == 0) a.stamps[0] = global_ns();
#pragma unroll 1
  for (int stage = 0; stage < 7; ++stage) {
    if (stage == 0 || stage == 4) {  // 1. LN1(x) and 5. LN2(h) -> y
      ln_rows<T>(stage == 0 ? x : out, stage == 0 ? a.ln1_w : a.ln2_w,
                 stage == 0 ? a.ln1_b : a.ln2_b, pd, y, m, d, a.eps);
    } else if (stage == 2) {  // 3. attention of every (batch element, head)
      const float scale_log2 = a.scale * 1.4426950408889634f;
      if constexpr (DH > 64) {
        if (a.attn_buffers > 0)
          attention_resident_call<DH>(qkv, attn, a.batch, a.heads, n, d, a.attn_buffers,
                                      scale_log2, fb_smem);
      } else if constexpr (DH != 0) {
        if (a.attn_buffers > 0)
          attention_resident<DH>(qkv, attn, a.batch, a.heads, n, d, a.attn_buffers, scale_log2,
                                 fb_smem);
      }
      if (DH == 0 || a.attn_buffers == 0) {
        for (int item = blockIdx.x; item < a.batch * a.heads; item += gridDim.x) {
          const int b = item / a.heads, h = item - b * a.heads;
          const T* qb = qkv + (long)b * n * 3 * d + h * dh;
          T* ob = attn + (long)b * n * d + h * dh;
          if constexpr (DH == 0)
            attention_stage_f32(qb, qb + d, qb + 2 * d, 3 * d, ob, d, n, dh, a.scale, fb_smem);
          else if constexpr (DH > 64)
            attention_stage_call<DH>(qb, qb + d, qb + 2 * d, 3 * d, ob, d, n, scale_log2,
                                     fb_smem);
          else
            attention_stage<DH>(qb, qb + d, qb + 2 * d, 3 * d, ob, d, n, scale_log2, fb_smem);
          __syncthreads();
        }
      }
    } else {
      // 2. qkv = y·Wqkvᵀ + bqkv; 4. h = x + T(attn·Wprojᵀ + bproj) -> out;
      // 6. act = T(GELU(y·W1ᵀ + b1)); 7. out = h + T(act·W2ᵀ + b2), in place
      const bool qkv_s = stage == 1, proj_s = stage == 3, fc1_s = stage == 5;
      const int ncols = qkv_s ? 3 * d : fc1_s ? hid : d, k = stage == 6 ? hid : d;
      const void* bias = qkv_s ? a.bqkv : proj_s ? a.bproj : fc1_s ? a.b1 : a.b2;
      const T* res = proj_s ? x : stage == 6 ? out : nullptr;
      T* dst = qkv_s ? qkv : fc1_s ? act : out;
      if constexpr (DH == 0) {
        const T* A = proj_s ? attn : stage == 6 ? act : y;
        const T* W = static_cast<const T*>(qkv_s ? a.wqkv : proj_s ? a.wproj
                                                    : fc1_s ? a.w1 : a.w2);
        gemm_stage_f32(A, k, W, m, ncols, k, bias, pd, fc1_s, res, dst, ncols, fb_smem);
      } else {
        const CUtensorMap* ma = proj_s ? &map_attn : stage == 6 ? &map_act : &map_y;
        const CUtensorMap* mw = qkv_s ? &map_wqkv : proj_s ? &map_wproj
                                                  : fc1_s ? &map_w1 : &map_w2;
        pos = gemm_stage(ma, mw, m, ncols, k, a.tile_n, bias, pd, fc1_s, res, dst, ncols, ring,
                         pos);
      }
    }
    if (stage < 6) {
      grid_barrier(a.bar, target);
      if (stamp && blockIdx.x == 0) a.stamps[1 + stage] = global_ns();
    }
  }
  if (stamp) a.stamps[7 + blockIdx.x] = global_ns();
}

// ----------------------------------------------------------------- launch

static size_t smem_bytes(bool bf16_path, int n, int dh) {
  if (bf16_path) {  // the ring, the epilogue scratch (attention reuses both), the barriers
    static_assert(sizeof(bf16) * (AQT + 4 * 64) * (128 + 8) <= STAGES * STAGE_BYTES,
                  "the streaming attention's buffers fit the ring");
    return 1024 + (size_t)STAGES * STAGE_BYTES + 16 * STAGES + (size_t)WARPS * EPI_WARP_BYTES;
  }
  const int nk_pad = (n + FQT - 1) / FQT * FQT;
  const size_t gemm = sizeof(float) * 2 * FK * (FT + 4);
  const size_t attn =
      sizeof(float) * ((size_t)2 * FQT * (dh + 1) + (size_t)FQT * (nk_pad + 1) + FQT);
  return gemm > attn ? gemm : attn;
}

struct Maps {
  CUtensorMap y, wqkv, attn, wproj, act, w1, w2;
};

template <typename T, int DH>
static int configure(int n, int dh, size_t* bytes) {
  static SmemLimit limit;
  *bytes = smem_bytes(DH != 0, n, dh);
  return set_smem(fused_block_kernel<T, DH>, *bytes, limit);
}

template <typename T, int DH>
static int occupancy(int n, int dh, int* blocks) {
  size_t bytes;
  if (int err = configure<T, DH>(n, dh, &bytes)) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fused_block_kernel<T, DH>,
                                                            THREADS, bytes);
}

template <typename T, int DH>
static int launch(const BlockArgs& a, const Maps& mp, int grid, cudaStream_t s) {
  size_t bytes;
  if (int err = configure<T, DH>(a.n, a.dh, &bytes)) return err;
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fused_block_kernel<T, DH>, THREADS, bytes);
  if (err != cudaSuccess) return (int)err;
  if (grid > blocks * sm_count()) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(a.bar, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_block_kernel<T, DH>, a, mp.y, mp.wqkv, mp.attn, mp.wproj,
                           mp.act, mp.w1, mp.w2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#define MTT_FB_DISPATCH(FN, ...)                          \
  if (dtype != MTT_BF16) return FN<float, 0>(__VA_ARGS__); \
  switch (dh) {                                           \
    case 16: return FN<bf16, 16>(__VA_ARGS__);            \
    case 32: return FN<bf16, 32>(__VA_ARGS__);            \
    case 48: return FN<bf16, 48>(__VA_ARGS__);            \
    case 64: return FN<bf16, 64>(__VA_ARGS__);            \
    case 80: return FN<bf16, 80>(__VA_ARGS__);            \
    case 96: return FN<bf16, 96>(__VA_ARGS__);            \
    case 112: return FN<bf16, 112>(__VA_ARGS__);          \
    case 128: return FN<bf16, 128>(__VA_ARGS__);          \
  }                                                       \
  return (int)cudaErrorInvalidValue;

// CTAs of the kernel for (n tokens, head dim dh, working type dtype) that
// one SM holds at once, into *blocks: the grid is this times the SM count.
extern "C" int mtt_fused_block_occupancy(int n, int dh, int dtype, int* blocks) {
  if (n <= 0 || n > MAX_TOKENS || dh <= 0 || dh > 128 || dh % 16 || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  MTT_FB_DISPATCH(occupancy, n, dh, blocks)
}

// x, out: (batch, n, d) in the working type (dtype); the four weights in
// the working type, (out, in) layout; the eight vectors in the parameter
// type pdtype (bqkv may be null); scratch y, attn (batch, n, d), qkv
// (batch, n, 3d), act (batch, n, hidden) in the working type and a 4-byte
// barrier counter (zeroed here, on the stream, before the launch). grid
// CTAs (at most what the card holds at once: mtt_fused_block_occupancy ×
// SMs); tile_n the bf16 GEMM tile's width, 128 or 256; attn_buffers the
// bf16 attention stage's resident K/V buffers (1 or 2; 0 streams them: the
// float path ignores it). stamps: null, or
// 7 + grid uint64 for the stage timestamps (ns of %globaltimer: the start,
// the six barriers as CTA 0 leaves them, each CTA's end).
extern "C" int mtt_fused_block(const void* x, void* out, const void* ln1_w, const void* ln1_b,
                               const void* wqkv, const void* bqkv, const void* wproj,
                               const void* bproj, const void* ln2_w, const void* ln2_b,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* y, void* qkv, void* attn, void* act, void* bar, int batch,
                               int n, int d, int hidden, int heads, int grid, int tile_n,
                               int attn_buffers, int pdtype, float scale, float eps, int dtype,
                               void* stamps, void* stream) {
  if (batch <= 0 || n <= 0 || n > MAX_TOKENS || heads <= 0 || d % heads || hidden <= 0 ||
      hidden % 16 || grid <= 0 || (tile_n != 128 && tile_n != MAX_BN) || bar == nullptr ||
      (long long)batch * n > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  const int dh = d / heads;
  if (dh % 16 || dh > 128 || attn_buffers < 0 || attn_buffers > 2 ||
      attention_resident_bytes(n, dh, attn_buffers) >
          (size_t)STAGES * STAGE_BYTES + WARPS * EPI_WARP_BYTES)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, (const void*)out, wqkv, wproj, w1, w2, (const void*)y,
                        (const void*)qkv, (const void*)attn, (const void*)act})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(bar) % 4) return (int)cudaErrorInvalidValue;
  const BlockArgs a = {x,      out,   ln1_w, ln1_b, bqkv,   bproj,  ln2_w, ln2_b,
                       b1,     b2,    wqkv,  wproj, w1,     w2,     y,     qkv,
                       attn,   act,   static_cast<unsigned int*>(bar),
                       static_cast<unsigned long long*>(stamps), batch, n, d,
                       hidden, heads, dh,    pdtype, tile_n, attn_buffers, scale, eps};
  Maps mp = {};
  if (dtype == MTT_BF16) {
    const int m = batch * n;
    if (!make_map(&mp.y, y, m, d, BM, BK) || !make_map(&mp.wqkv, wqkv, 3 * d, d, tile_n, BK) ||
        !make_map(&mp.attn, attn, m, d, BM, BK) ||
        !make_map(&mp.wproj, wproj, d, d, tile_n, BK) ||
        !make_map(&mp.act, act, m, hidden, BM, BK) ||
        !make_map(&mp.w1, w1, hidden, d, tile_n, BK) ||
        !make_map(&mp.w2, w2, d, hidden, tile_n, BK))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MTT_FB_DISPATCH(launch, a, mp, grid, s)
}
