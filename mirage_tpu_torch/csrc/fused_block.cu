// A whole pre-LN transformer block in one launch:
//   h = x + proj(softmax(q·kᵀ·dh^-½)·v),  q|k|v = LN1(x)·Wqkvᵀ + bqkv
//   out = h + fc2(GELU_erf(fc1(LN2(h))))
// Replaces mirage_tpu/ops/fused_block.py:_block_fwd / _block_kernel, the
// TPU kernel that runs both halves of a block in one grid program per batch
// element with every weight resident in VMEM.
//
// An SM's shared memory holds neither the weights nor a batch element's
// activations, so one batch element is a thread-block cluster of C CTAs
// (C ≤ 8 divides the head count) that meets at cluster barriers, and its
// intermediates go through a scratch the wrapper allocates (y: the LN
// outputs, qkv, the pre-proj attention output, the MLP hidden; each is
// written and read back within the cluster's lifetime, so a cluster's
// working set stays in L2). CTA c of the cluster owns heads [c·H/C,
// (c+1)·H/C), columns [c·D/C, (c+1)·D/C) of proj and fc2, and columns
// [c·4D/C, (c+1)·4D/C) of fc1:
//
//   1. LN1 of its share of the rows -> y                      | cluster barrier
//   2. q, k, v of its heads for every row -> qkv              | (its own data)
//   3. attention of its heads for every query -> attn         | cluster barrier
//   4. its columns of h = x + T(attn·Wprojᵀ + bproj) -> out   | cluster barrier
//   5. LN2 of its share of the rows of h -> y                 | cluster barrier
//   6. its columns of T(GELU(y·W1ᵀ + b1)) -> act              | cluster barrier
//   7. its columns of out = h + T(act·W2ᵀ + b2), in place
//
// The barriers are barrier.cluster arrive.release / wait.acquire after a
// device-scope fence, and every read of data another CTA wrote goes
// through L2 (cp.async.cg, ld.global.cg), so no stale L1 line is read.
// Rounding follows _block_kernel: the LN outputs, qkv, the unnormalised
// probabilities (before P·V; the division by the float row sum after it),
// proj + b, GELU (computed in float) and fc2 + b2 are rounded to the working
// type T where the TPU kernel rounds them. The softmax runs online over
// chunks of 64 keys (the running maximum rescales in float), as the port's
// attention kernel does; erf is exact (the TPU's polynomial erf is a
// Mosaic workaround). LN takes two passes (ROADMAP queue C, fault 2).
//
// Bound: operations (2·N·D·12D + 4·N²·D per batch element). bf16 runs every
// product on mma.sync m16n8k16 tensor-core MMAs with float accumulation:
// the GEMM stages in 128 × 128 tiles of 8 warps (32 × 64 each) over
// K-slices of 64 in a three-stage cp.async ring, attention in passes of 128 queries
// (16 per warp) over key chunks of 64 with the scores in registers. float
// runs FMA tiles (64 × 64 GEMM tiles; a 64-query tile's scores in shared
// memory), for the float32 golden. What a later PR changes first: wgmma
// (and TMA) for the stages' products, keeping qkv and the MLP hidden in
// distributed shared memory instead of L2, and fewer barriers.
#include <math.h>

#include <initializer_list>

#include "mma_tiles.cuh"

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_TOKENS = 512, MAX_CLUSTER = 8;
constexpr int GBM = 128, GBN = 128, GBK = 64, GSTAGES = 3;  // bf16 GEMM tile, K-slice, ring
constexpr int AQT = 128, AKC = 64;            // bf16 attention: queries per pass, keys per chunk
constexpr int FT = 64, FK = 16;               // float GEMM tile and K-slice
constexpr int FQT = 64;                       // float attention: queries per pass

struct BlockArgs {
  const void* x;
  void* out;
  const void *ln1_w, *ln1_b, *bqkv, *bproj, *ln2_w, *ln2_b, *b1, *b2;  // param dtype pdtype
  const void *wqkv, *wproj, *w1, *w2;                                 // working type, (out, in)
  void *y, *qkv, *attn, *act;                                         // scratch, working type
  int n, d, hidden, heads, dh, pdtype;
  float scale, eps;
};

__device__ __forceinline__ void cluster_barrier() {
  __threadfence();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ const void* param_at(const void* p, long i, int pdtype) {
  return p == nullptr ? nullptr
                      : static_cast<const char*>(p) + i * (pdtype == MTT_BF16 ? 2 : 4);
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

// dst[r] = T(LN(src[r])) for rows [row0, row1): one warp per row, two passes
// for the statistics, 16-byte loads (d is a multiple of 16 elements).
template <typename T>
__device__ void ln_rows(const T* src, const void* gamma, const void* beta, int pdtype, T* dst,
                        int row0, int row1, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = row0 + warp; r < row1; r += WARPS) {
    const T* xr = src + (long)r * d;
    float v[VEC];
    float s = 0.f;
    for (int i = lane * VEC; i < d; i += 32 * VEC) {
      load16_cg<T>(xr + i, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += v[e];
    }
    const float mean = warp_sum(s) / d;
    float var = 0.f;
    for (int i = lane * VEC; i < d; i += 32 * VEC) {
      load16_cg<T>(xr + i, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) var += (v[e] - mean) * (v[e] - mean);
    }
    const float rstd = rsqrtf(warp_sum(var) / d + eps);
    T* yr = dst + (long)r * d;
    for (int i = lane * VEC; i < d; i += 32 * VEC) {
      load16_cg<T>(xr + i, v);
      uint4 u;
      T* o = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[e] = from_f<T>((v[e] - mean) * rstd * load_param(gamma, i + e, pdtype) +
                         load_param(beta, i + e, pdtype));
      *reinterpret_cast<uint4*>(yr + i) = u;
    }
  }
}

// ------------------------------------------------------------ bf16 GEMM

// dst[r, c] = epi(A[r, :k] · W[c, :k]ᵀ) for r < m, c < ncols: v = acc +
// bias[c] in float, GELU if asked, rounded to bf16; with a residual,
// T(res[r, c] + T(v)). A has row stride lda, W row stride k, dst and res
// row stride ldd (res may be dst: each element is read, then written, by
// one thread). k and lda are multiples of 8, ncols of 16. 128 × 128 tiles:
// warp (wr, wc) owns rows 32·wr .. +31 and columns 64·wc .. +63; K-slices
// of 64 in a ring of GSTAGES, one barrier per slice; a warp whose columns
// are all past ncols skips its products.
__device__ void gemm_stage(const bf16* A, int lda, const bf16* W, int m, int ncols, int k,
                           const void* bias, int pdtype, bool gelu, const bf16* res, bf16* dst,
                           int ldd, unsigned char* smem) {
  constexpr int DS = GBK + 8, CPR = GBK / 8, STAGE = (GBM + GBN) * DS;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // GSTAGES × (A GBM × DS, then W GBN × DS)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int ktiles = (k + GBK - 1) / GBK;
  for (int m0 = 0; m0 < m; m0 += GBM)
    for (int n0 = 0; n0 < ncols; n0 += GBN) {
      auto stage = [&](int kt) {
        const int k0 = kt * GBK;
        bf16* a = ring + (kt % GSTAGES) * STAGE;
        bf16* w = a + GBM * DS;
        for (int e = tid; e < (GBM + GBN) * CPR; e += THREADS) {
          const int r = e / CPR, c = (e - r * CPR) * 8;
          if (r < GBM) {
            const int g = m0 + r;
            const bool ok = g < m && k0 + c < k;
            cp_async16(smem_u32(a + r * DS + c), ok ? A + (long)g * lda + k0 + c : A, ok ? 16 : 0);
          } else {
            const int g = n0 + r - GBM;
            const bool ok = g < ncols && k0 + c < k;
            cp_async16(smem_u32(w + (r - GBM) * DS + c), ok ? W + (long)g * k + k0 + c : W,
                       ok ? 16 : 0);
          }
        }
      };
      const bool busy = n0 + wc * 64 < ncols && m0 + wr * 32 < m;
      float acc[2][8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
      for (int st = 0; st < GSTAGES - 1; ++st) {
        if (st < ktiles) stage(st);
        cp_async_commit();
      }
      for (int kt = 0; kt < ktiles; ++kt) {
        cp_async_wait<GSTAGES - 2>();  // slice kt has landed
        __syncthreads();               // and every warp is done with slice kt - 1's buffer
        if (kt + GSTAGES - 1 < ktiles) stage(kt + GSTAGES - 1);
        cp_async_commit();
        if (!busy) continue;
        const bf16* a = ring + (kt % GSTAGES) * STAGE;
        const bf16* w = a + GBM * DS + wc * 64 * DS;
        uint32_t af[2][GBK / 16][4];
        load_a<GBK>(af[0], a, wr * 32);
        load_a<GBK>(af[1], a, wr * 32 + 16);
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            uint32_t r[4];
            ldmatrix_x4(r, smem_u32(w + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * DS + kk * 16 +
                                    ((lane >> 3) & 1) * 8));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16_16816(acc[i][j], af[i][kk], r[0], r[1]);
              mma_bf16_16816(acc[i][j + 1], af[i][kk], r[2], r[3]);
            }
          }
      }
      __syncthreads();  // the ring is free for the next tile's first slices
      if (!busy) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wc * 64 + 8 * j + 2 * tig;
        if (col >= ncols) continue;  // ncols is even: a column pair is wholly in or out
        const float b0 = bias != nullptr ? load_param(bias, col, pdtype) : 0.f;
        const float b1 = bias != nullptr ? load_param(bias, col + 1, pdtype) : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = m0 + wr * 32 + i * 16 + gid + 8 * half;
            if (row >= m) continue;
            float v0 = acc[i][j][2 * half] + b0, v1 = acc[i][j][2 * half + 1] + b1;
            if (gelu) {
              v0 = gelu_exact(v0);
              v1 = gelu_exact(v1);
            }
            __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
            const long off = (long)row * ldd + col;
            if (res != nullptr) {
              const unsigned int rb = __ldcg(reinterpret_cast<const unsigned int*>(res + off));
              const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rb));
              const float2 f = __bfloat1622float2(o);
              o = __floats2bfloat162_rn(r.x + f.x, r.y + f.y);
            }
            *reinterpret_cast<__nv_bfloat162*>(dst + off) = o;
          }
      }
    }
}

// ----------------------------------------------------------- float GEMM

// The same contract in float: 64 × 64 tiles, 4 × 4 outputs per thread.
__device__ void gemm_stage(const float* A, int lda, const float* W, int m, int ncols, int k,
                           const void* bias, int pdtype, bool gelu, const float* res, float* dst,
                           int ldd, unsigned char* smem) {
  float(*as)[FT + 4] = reinterpret_cast<float(*)[FT + 4]>(smem);  // as[k][m]
  float(*bs)[FT + 4] = as + FK;                                   // bs[k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int m0 = 0; m0 < m; m0 += FT)
    for (int n0 = 0; n0 < ncols; n0 += FT) {
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

// softmax(q kᵀ·scale) v of one head for every query, into o: q, k, v are
// column windows (row stride rs) of the packed qkv, o one of attn (row
// stride ors). Passes of 128 queries (16 per warp, scores, probabilities
// and the output in registers); keys stream through shared memory in
// chunks of 64, double-buffered by cp.async.
template <int DH>
__device__ void attention_stage(const bf16* q, const bf16* k, const bf16* v, int rs, bf16* o,
                                int ors, int n, float scale_log2, unsigned char* smem) {
  constexpr int DS = DH + 8, CPR = DH / 8, KT = DH / 16, NT = DH / 8;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // AQT × DS
  bf16* ks = qs + AQT * DS;                  // 2 × AKC × DS
  bf16* vs = ks + 2 * AKC * DS;              // 2 × AKC × DS
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  auto stage = [&](bf16* dst, const bf16* src, int row0, int rows) {
    for (int e = tid; e < rows * CPR; e += THREADS) {
      const int r = e / CPR, c = (e - r * CPR) * 8, g = row0 + r;
      const bool ok = g < n;
      cp_async16(smem_u32(dst + r * DS + c), ok ? src + (long)g * rs + c : src, ok ? 16 : 0);
    }
  };
  const int nchunks = (n + AKC - 1) / AKC;
  for (int q0 = 0; q0 < n; q0 += AQT) {
    stage(qs, q, q0, AQT);
    stage(ks, k, 0, AKC);
    stage(vs, v, 0, AKC);
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
        stage(ks + nb * AKC * DS, k, (c + 1) * AKC, AKC);
        stage(vs + nb * AKC * DS, v, (c + 1) * AKC, AKC);
      }
      cp_async_commit();
      cp_async_wait<1>();  // chunk c (and Q) have landed
      __syncthreads();
      if (active) {
        if (c == 0) load_a<DH>(qf, qs, warp * 16);
        const bf16* kc = ks + (c & 1) * AKC * DS;
        const bf16* vc = vs + (c & 1) * AKC * DS;
        float s[AKC / 8][4];
#pragma unroll
        for (int j = 0; j < AKC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        mma_abt<DH, AKC / 8>(s, qf, kc);
        const int key0 = c * AKC;
        float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < AKC / 8; ++j)
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
        uint32_t pf[AKC / 16][4];
#pragma unroll
        for (int j = 0; j < AKC / 8; ++j) {
          const float p0 = exp2f(s[j][0] - m_run[0]), p1 = exp2f(s[j][1] - m_run[0]);
          const float p2 = exp2f(s[j][2] - m_run[1]), p3 = exp2f(s[j][3] - m_run[1]);
          l_run[0] += p0 + p1;
          l_run[1] += p2 + p3;
          pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
          pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
        mma_ab<DH, AKC / 16>(oacc, pf, vc);
      }
      __syncthreads();  // every warp is done with this buffer before it is refilled
    }
    if (active) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float l = l_run[hf];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / l;
        const int gq = q0 + warp * 16 + gid + 8 * hf;
        if (gq >= n) continue;
#pragma unroll
        for (int t = 0; t < NT; ++t)
          *reinterpret_cast<__nv_bfloat162*>(o + (long)gq * ors + t * 8 + 2 * tig) =
              __floats2bfloat162_rn(oacc[t][2 * hf] * inv, oacc[t][2 * hf + 1] * inv);
      }
    }
  }
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

// Grid (C, B), cluster (C, 1, 1): blockIdx.x is the CTA's rank in the
// cluster of batch element blockIdx.y. DH is the head dim of the bf16
// kernels (0 for float, which reads it at run time).
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1) fused_block_kernel(const BlockArgs a) {
  extern __shared__ __align__(16) unsigned char fb_smem[];
  const int C = gridDim.x, c = blockIdx.x, b = blockIdx.y;
  const int n = a.n, d = a.d, hid = a.hidden, dh = DH ? DH : a.dh, pd = a.pdtype;
  const long nd = (long)n * d;
  const T* x = static_cast<const T*>(a.x) + b * nd;
  T* out = static_cast<T*>(a.out) + b * nd;
  T* y = static_cast<T*>(a.y) + b * nd;
  T* qkv = static_cast<T*>(a.qkv) + b * 3 * nd;
  T* attn = static_cast<T*>(a.attn) + b * nd;
  T* act = static_cast<T*>(a.act) + b * (long)n * hid;
  const T* wqkv = static_cast<const T*>(a.wqkv);
  const T* wproj = static_cast<const T*>(a.wproj);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  const int hpc = a.heads / C, cols = hpc * dh, hcols = hid / C;
  const int rpc = (n + C - 1) / C, r0 = min(n, c * rpc), r1 = min(n, r0 + rpc);

  // 1. LN1 of this CTA's rows
  ln_rows<T>(x, a.ln1_w, a.ln1_b, pd, y, r0, r1, d, a.eps);
  cluster_barrier();
  // 2. q, k and v of this CTA's heads, every row
  for (int part = 0; part < 3; ++part) {
    const long col = (long)part * d + (long)c * cols;
    gemm_stage(y, d, wqkv + col * d, n, cols, d, param_at(a.bqkv, col, pd), pd, false, nullptr,
               qkv + col, 3 * d, fb_smem);
  }
  __syncthreads();
  // 3. attention of this CTA's heads
  for (int h = c * hpc; h < (c + 1) * hpc; ++h) {
    if constexpr (DH == 0)
      attention_stage_f32(reinterpret_cast<const float*>(qkv) + h * dh,
                          reinterpret_cast<const float*>(qkv) + d + h * dh,
                          reinterpret_cast<const float*>(qkv) + 2 * d + h * dh, 3 * d,
                          reinterpret_cast<float*>(attn) + h * dh, d, n, dh, a.scale, fb_smem);
    else
      attention_stage<DH>(qkv + h * dh, qkv + d + h * dh, qkv + 2 * d + h * dh, 3 * d,
                          attn + h * dh, d, n, a.scale * 1.4426950408889634f, fb_smem);
    __syncthreads();
  }
  cluster_barrier();
  // 4. h = x + T(attn·Wprojᵀ + bproj), this CTA's columns, into out
  gemm_stage(attn, d, wproj + (long)c * cols * d, n, cols, d, param_at(a.bproj, c * cols, pd), pd,
             false, x + c * cols, out + c * cols, d, fb_smem);
  cluster_barrier();
  // 5. LN2 of this CTA's rows of h
  ln_rows<T>(out, a.ln2_w, a.ln2_b, pd, y, r0, r1, d, a.eps);
  cluster_barrier();
  // 6. T(GELU(y·W1ᵀ + b1)), this CTA's hidden columns
  gemm_stage(y, d, w1 + (long)c * hcols * d, n, hcols, d, param_at(a.b1, (long)c * hcols, pd), pd,
             true, nullptr, act + (long)c * hcols, hid, fb_smem);
  cluster_barrier();
  // 7. out = h + T(act·W2ᵀ + b2), this CTA's columns, in place
  gemm_stage(act, hid, w2 + (long)c * cols * hid, n, cols, hid, param_at(a.b2, c * cols, pd), pd,
             false, out + c * cols, out + c * cols, d, fb_smem);
}

// ----------------------------------------------------------------- launch

static size_t smem_bytes(bool bf16_path, int n, int dh) {
  if (bf16_path) {
    const size_t gemm = sizeof(bf16) * GSTAGES * (GBM + GBN) * (GBK + 8);
    const size_t attn = sizeof(bf16) * (AQT + 4 * AKC) * (dh + 8);
    return gemm > attn ? gemm : attn;
  }
  const int nk_pad = (n + FQT - 1) / FQT * FQT;
  const size_t gemm = sizeof(float) * 2 * FK * (FT + 4);
  const size_t attn =
      sizeof(float) * ((size_t)2 * FQT * (dh + 1) + (size_t)FQT * (nk_pad + 1) + FQT);
  return gemm > attn ? gemm : attn;
}

template <typename T, int DH>
static int launch(const BlockArgs& a, int batch, int cluster, cudaStream_t s) {
  static size_t configured = 0;
  const size_t bytes = smem_bytes(DH != 0, a.n, a.dh);
  if (int err = set_smem(fused_block_kernel<T, DH>, bytes, &configured)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fused_block_kernel<T, DH>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// x, out: (batch, n, d) in the working type (dtype); the four weights in
// the working type, (out, in) layout; the eight vectors in the parameter
// type pdtype (bqkv may be null); scratch y, attn (batch, n, d), qkv
// (batch, n, 3d), act (batch, n, hidden) in the working type. cluster CTAs
// per batch element: it divides heads and hidden, at most 8.
extern "C" int mtt_fused_block(const void* x, void* out, const void* ln1_w, const void* ln1_b,
                               const void* wqkv, const void* bqkv, const void* wproj,
                               const void* bproj, const void* ln2_w, const void* ln2_b,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* y, void* qkv, void* attn, void* act, int batch, int n, int d,
                               int hidden, int heads, int cluster, int pdtype, float scale,
                               float eps, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || n > MAX_TOKENS || heads <= 0 || d % heads ||
      cluster <= 0 || cluster > MAX_CLUSTER || heads % cluster || hidden <= 0 ||
      hidden % cluster || (hidden / cluster) % 16)
    return (int)cudaErrorInvalidValue;
  const int dh = d / heads;
  if (dh % 16 || dh > 128) return (int)cudaErrorInvalidValue;
  for (const void* p : {x, (const void*)out, wqkv, wproj, w1, w2, (const void*)y,
                        (const void*)qkv, (const void*)attn, (const void*)act})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const BlockArgs a = {x,     out,   ln1_w, ln1_b, bqkv, bproj, ln2_w, ln2_b, b1,     b2,
                       wqkv,  wproj, w1,    w2,    y,    qkv,   attn,  act,   n,      d,
                       hidden, heads, dh,   pdtype, scale, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != MTT_BF16) return launch<float, 0>(a, batch, cluster, s);
  switch (dh) {
    case 16: return launch<bf16, 16>(a, batch, cluster, s);
    case 32: return launch<bf16, 32>(a, batch, cluster, s);
    case 48: return launch<bf16, 48>(a, batch, cluster, s);
    case 64: return launch<bf16, 64>(a, batch, cluster, s);
    case 80: return launch<bf16, 80>(a, batch, cluster, s);
    case 96: return launch<bf16, 96>(a, batch, cluster, s);
    case 112: return launch<bf16, 112>(a, batch, cluster, s);
    case 128: return launch<bf16, 128>(a, batch, cluster, s);
  }
  return (int)cudaErrorInvalidValue;
}
