// Backward of multi-head softmax(q·kᵀ·scale)·v on the packed (B, N, 3D) qkv
// (column order q|k|v × heads × dh), for up to 512 tokens: dqkv in the same
// packed layout, plus float column partials of dqkv for the qkv bias grad.
//
// Replaces mirage_tpu/ops/block_attention.py:_block_attn_bwd_kernel (B6's
// backward) and the attention core of :_attn_half_bwd_dx_kernel (B4). The TPU
// kernels hold two per-head (N, N) float scratches (P and dP) in VMEM; at
// N = 256 and 8 heads that is 4 MB, and an SM has 227 KB. So the work is
// split the way FlashAttention-2 splits it, but without atomics:
//
// - attn_bwd_dq_kernel: one block per (batch, head, 64 queries), four warps
//   of 16 query rows. Pass 1 streams K and V in chunks and carries the row
//   max, the row sum of exp and the row sum of exp·dP, which give the
//   log-sum-exp and delta = rowsum(P∘dP) (exactly the TPU's delta, taken
//   from the float P and dP, not from the rounded output). Pass 2 streams
//   them again and accumulates dQ = T(dS)·K with dS = P∘(dP − delta)·scale.
//   It writes T(dQ), lse and delta.
// - attn_bwd_dkv_kernel: one block per (batch, head, 64 keys), four warps of
//   16 key rows. It streams Q, dO, lse and delta and accumulates
//   dV = T(P)ᵀ·dO and dK = T(dS)ᵀ·Q in registers.
//
// Each block owns its output rows, so every sum has a fixed order. P is
// normalised in float and rounded to the working type before dV, and dS
// before dQ and dK, where the TPU kernel rounds. The column partials are sums
// over 16-row groups of the float dQ, dK and dV before rounding (the TPU
// kernel takes dbqkv from the float dqkv too); the caller sums the groups.
//
// Bound: operations (10·N²·dh FLOPs per head against reading q, k, v and dO
// once; this design spends 9 N²·dh matrix products where the minimum is 5:
// S and dP are recomputed in both kernels and in both passes of the first).
// bf16 runs every product on the tensor cores (mma.sync m16n8k16, float
// accumulation); float runs plain FMAs with one block per 16 rows, for the
// float32 checks. What a later PR changes first: one kernel with dQ summed by
// atomics (FlashAttention-2), wgmma, and fusing this between the dattn and
// dyln GEMMs of B4 so the packed qkv, dattn and dqkv stop going through
// device memory.
#include <math.h>

#include <initializer_list>

#include "mma_tiles.cuh"

constexpr int MAX_KEYS = 512;
constexpr int MAX_DH = 128;
constexpr float LOG2E = 1.4426950408889634f;

// A warp's 16 × DH float result: rows row0 + gid (+ 8) below n rounded into
// out (row stride rs), and its column sums over those rows, in float, into
// part[0 .. DH)
template <int DH>
__device__ __forceinline__ void store_rows(float (&acc)[DH / 8][4], bf16* out, int rs,
                                           int row0, int n, float* part) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const bool v0 = row0 + gid < n, v1 = row0 + gid + 8 < n;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int c = j * 8 + 2 * tig;
    if (v0)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(row0 + gid) * rs + c) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (v1)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(row0 + gid + 8) * rs + c) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    float s0 = (v0 ? acc[j][0] : 0.f) + (v1 ? acc[j][2] : 0.f);
    float s1 = (v0 ? acc[j][1] : 0.f) + (v1 ? acc[j][3] : 0.f);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (gid == 0) {
      part[c] = s0;
      part[c + 1] = s1;
    }
  }
}

// ---------------------------------------------------------------- bf16 path

template <int DH>
__global__ void __launch_bounds__(128)
    attn_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                       bf16* __restrict__ dqkv, float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ part, int n, int dim,
                       int heads, int groups, float scale) {
  constexpr int DS = DH + 8, CH = chunk_rows<DH>(), NB = CH / 8, KT = DH / 16, NT = DH / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* qs = reinterpret_cast<bf16*>(bwd_smem);  // BT × DS
  bf16* dos = qs + BT * DS;                      // BT × DS
  bf16* ks = dos + BT * DS;                      // 2 × CH × DS
  bf16* vs = ks + 2 * CH * DS;                   // 2 × CH × DS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT, rs = 3 * dim;
  const bf16* qb = qkv + (long long)b * n * rs + h * DH;
  const bf16* kb = qb + dim;
  const bf16* vb = qb + 2 * dim;
  const bf16* db = dout + (long long)b * n * dim + h * DH;
  stage_rows<DH>(qs, qb, q0, BT, n, rs);
  stage_rows<DH>(dos, db, q0, BT, n, dim);
  stage_rows<DH>(ks, kb, 0, CH, n, rs);
  stage_rows<DH>(vs, vb, 0, CH, n, rs);
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  const int row0 = q0 + warp * 16;
  const bool active = row0 < n;  // a warp past the last query only helps load
  uint32_t qf[KT][4], df[KT][4];
  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  // rows gid, gid + 8: running max (log2 units), sum of exp, sum of exp·dP
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, u_run[2] = {0.f, 0.f};
  float lse_r[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};

  const int nch = (n + CH - 1) / CH;
  for (int it = 0; it < 2 * nch; ++it) {  // pass 1: chunks 0..nch-1, pass 2: again
    if (it + 1 < 2 * nch) {
      const int nb = (it + 1) & 1, c0 = ((it + 1) % nch) * CH;
      stage_rows<DH>(ks + nb * CH * DS, kb, c0, CH, n, rs);
      stage_rows<DH>(vs + nb * CH * DS, vb, c0, CH, n, rs);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this chunk (and Q, dO) have landed
    __syncthreads();
    if (active) {
      if (it == 0) {
        load_a<DH>(qf, qs, warp * 16);
        load_a<DH>(df, dos, warp * 16);
      }
      const bf16* kc = ks + (it & 1) * CH * DS;
      const bf16* vc = vs + (it & 1) * CH * DS;
      const int key0 = (it % nch) * CH;
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<DH, NB>(s, qf, kc);   // S = Q Kᵀ
      mma_abt<DH, NB>(dp, df, vc);  // dP = dO Vᵀ
      if (it < nch) {
        float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + j * 8 + 2 * tig + (e & 1);
            s[j][e] = key < n ? s[j][e] * sl2 : -INFINITY;
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
          u_run[hf] *= corr;
        }
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[j][e] - m_run[e >> 1]);
            l_run[e >> 1] += p;
            u_run[e >> 1] += p * dp[j][e];
          }
        if (it == nch - 1) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float l = l_run[hf], u = u_run[hf];
            l += __shfl_xor_sync(0xffffffffu, l, 1);
            l += __shfl_xor_sync(0xffffffffu, l, 2);
            u += __shfl_xor_sync(0xffffffffu, u, 1);
            u += __shfl_xor_sync(0xffffffffu, u, 2);
            lse_r[hf] = m_run[hf] + log2f(l);
            del_r[hf] = u / l;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + j * 8 + 2 * tig + (e & 1);
            const float p = key < n ? exp2f(s[j][e] * sl2 - lse_r[e >> 1]) : 0.f;
            s[j][e] = p * (dp[j][e] - del_r[e >> 1]) * scale;  // dS
          }
        uint32_t dsf[NB / 2][4];
        to_a<NB>(dsf, s);
        mma_ab<DH, NB / 2>(dq, dsf, kc);  // dQ += T(dS) K
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  if (!active) return;
  if (tig == 0) {
    const long long base = ((long long)b * heads + h) * n;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + gid + 8 * hf;
      if (r < n) {
        lse[base + r] = lse_r[hf];
        delta[base + r] = del_r[hf];
      }
    }
  }
  store_rows<DH>(dq, dqkv + (long long)b * n * rs + h * DH, rs, row0, n,
                 part + ((long long)b * groups + row0 / 16) * rs + h * DH);
}

template <int DH>
__global__ void __launch_bounds__(128)
    attn_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                        bf16* __restrict__ dqkv, const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ part, int n,
                        int dim, int heads, int groups, float scale) {
  constexpr int DS = DH + 8, CH = chunk_rows<DH>(), NB = CH / 8, KT = DH / 16, NT = DH / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* ks = reinterpret_cast<bf16*>(bwd_smem);  // BT × DS
  bf16* vs = ks + BT * DS;                       // BT × DS
  bf16* qs = vs + BT * DS;                       // 2 × CH × DS
  bf16* dos = qs + 2 * CH * DS;                  // 2 × CH × DS
  float* ls = reinterpret_cast<float*>(dos + 2 * CH * DS);  // 2 × CH lse
  float* dls = ls + 2 * CH;                                 // 2 × CH delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BT, rs = 3 * dim;
  const bf16* qb = qkv + (long long)b * n * rs + h * DH;
  const bf16* kb = qb + dim;
  const bf16* vb = qb + 2 * dim;
  const bf16* db = dout + (long long)b * n * dim + h * DH;
  const float* lb = lse + ((long long)b * heads + h) * n;
  const float* dlb = delta + ((long long)b * heads + h) * n;
  // a chunk's lse and delta; queries past n get lse = +inf, so P = 0 there
  auto stats = [&](int buf, int c0) {
    for (int i = tid; i < CH; i += blockDim.x) {
      const int g = c0 + i;
      ls[buf * CH + i] = g < n ? lb[g] : INFINITY;
      dls[buf * CH + i] = g < n ? dlb[g] : 0.f;
    }
  };
  stage_rows<DH>(ks, kb, k0, BT, n, rs);
  stage_rows<DH>(vs, vb, k0, BT, n, rs);
  stage_rows<DH>(qs, qb, 0, CH, n, rs);
  stage_rows<DH>(dos, db, 0, CH, n, dim);
  cp_async_commit();
  stats(0, 0);

  const float sl2 = scale * LOG2E;
  const int row0 = k0 + warp * 16;
  const bool active = row0 < n;
  uint32_t kf[KT][4], vf[KT][4];
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int nch = (n + CH - 1) / CH;
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      const int nb = (c + 1) & 1;
      stage_rows<DH>(qs + nb * CH * DS, qb, (c + 1) * CH, CH, n, rs);
      stage_rows<DH>(dos + nb * CH * DS, db, (c + 1) * CH, CH, n, dim);
      stats(nb, (c + 1) * CH);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      if (c == 0) {
        load_a<DH>(kf, ks, warp * 16);
        load_a<DH>(vf, vs, warp * 16);
      }
      const bf16* qc = qs + (c & 1) * CH * DS;
      const bf16* dc = dos + (c & 1) * CH * DS;
      const float* lsc = ls + (c & 1) * CH;
      const float* dlc = dls + (c & 1) * CH;
      float st[NB][4], dpt[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      mma_abt<DH, NB>(st, kf, qc);   // Sᵀ = K Qᵀ
      mma_abt<DH, NB>(dpt, vf, dc);  // dPᵀ = V dOᵀ
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * tig + (e & 1);
          const float p = exp2f(st[j][e] * sl2 - lsc[qi]);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dlc[qi]) * scale;  // dSᵀ
        }
      uint32_t pf[NB / 2][4], dsf[NB / 2][4];
      to_a<NB>(pf, st);
      to_a<NB>(dsf, dpt);
      mma_ab<DH, NB / 2>(dv, pf, dc);   // dV += T(P)ᵀ dO
      mma_ab<DH, NB / 2>(dk, dsf, qc);  // dK += T(dS)ᵀ Q
    }
    __syncthreads();
  }
  if (!active) return;
  bf16* out = dqkv + (long long)b * n * rs + h * DH;
  float* pr = part + ((long long)b * groups + row0 / 16) * rs + h * DH;
  store_rows<DH>(dk, out + dim, rs, row0, n, pr + dim);
  store_rows<DH>(dv, out + 2 * dim, rs, row0, n, pr + 2 * dim);
}

// --------------------------------------------------------------- float path

constexpr int FR = 16;  // rows per block: one 16-row group of the partials

// one block per (batch, head, 16 queries): S and dP rows for every key in
// shared memory, softmax and delta per row, then dQ = dS·K
__global__ void __launch_bounds__(256)
    attn_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                           float* __restrict__ dqkv, float* __restrict__ lse,
                           float* __restrict__ delta, float* __restrict__ part, int n, int dim,
                           int heads, int dh, int groups, float scale) {
  extern __shared__ float fsm[];
  float* qr = fsm;             // FR × dh
  float* dr = qr + FR * dh;    // FR × dh
  float* P = dr + FR * dh;     // FR × n
  float* dP = P + FR * n;      // FR × n
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * FR, rs = 3 * dim;
  const float* base = qkv + (long long)b * n * rs + h * dh;
  const float* dbase = dout + (long long)b * n * dim + h * dh;
  for (int e = tid; e < FR * dh; e += 256) {
    const int r = e / dh, d = e - r * dh, g = r0 + r;
    qr[e] = g < n ? base[(long long)g * rs + d] : 0.f;
    dr[e] = g < n ? dbase[(long long)g * dim + d] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < FR * n; e += 256) {
    const int r = e / n, j = e - r * n;
    const float* kj = base + (long long)j * rs + dim;
    const float* vj = kj + dim;
    float s = 0.f, t = 0.f;
    for (int d = 0; d < dh; ++d) {
      s = fmaf(qr[r * dh + d], kj[d], s);
      t = fmaf(dr[r * dh + d], vj[d], t);
    }
    P[e] = s * scale;
    dP[e] = t;
  }
  __syncthreads();
  for (int r = warp; r < FR; r += 8) {
    float* pr = P + r * n;
    float* dpr = dP + r * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      pr[j] = expf(pr[j] - m);
      l += pr[j];
    }
    l = warp_sum(l);
    float dl = 0.f;
    for (int j = lane; j < n; j += 32) {
      pr[j] /= l;
      dl += pr[j] * dpr[j];
    }
    dl = warp_sum(dl);
    for (int j = lane; j < n; j += 32) dpr[j] = pr[j] * (dpr[j] - dl) * scale;
    if (lane == 0 && r0 + r < n) {
      lse[((long long)b * heads + h) * n + r0 + r] = m + logf(l);
      delta[((long long)b * heads + h) * n + r0 + r] = dl;
    }
  }
  __syncthreads();
  for (int e = tid; e < FR * dh; e += 256) {
    const int r = e / dh, d = e - r * dh;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(dP[r * n + j], base[(long long)j * rs + dim + d], acc);
    const bool ok = r0 + r < n;
    if (ok) dqkv[(long long)b * n * rs + (long long)(r0 + r) * rs + h * dh + d] = acc;
    qr[e] = ok ? acc : 0.f;
  }
  __syncthreads();
  for (int d = tid; d < dh; d += 256) {
    float s = 0.f;
    for (int r = 0; r < FR; ++r) s += qr[r * dh + d];
    part[((long long)b * groups + blockIdx.x) * rs + h * dh + d] = s;
  }
}

// one block per (batch, head, 16 keys): Pᵀ and dSᵀ rows for every query in
// shared memory, then dV = Pᵀ·dO and dK = dSᵀ·Q
__global__ void __launch_bounds__(256)
    attn_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                            float* __restrict__ dqkv, const float* __restrict__ lse,
                            const float* __restrict__ delta, float* __restrict__ part, int n,
                            int dim, int heads, int dh, int groups, float scale) {
  extern __shared__ float fsm[];
  float* kr = fsm;             // FR × dh
  float* vr = kr + FR * dh;    // FR × dh
  float* Pt = vr + FR * dh;    // FR × n
  float* dSt = Pt + FR * n;    // FR × n
  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * FR, rs = 3 * dim;
  const float* base = qkv + (long long)b * n * rs + h * dh;
  const float* dbase = dout + (long long)b * n * dim + h * dh;
  const float* lb = lse + ((long long)b * heads + h) * n;
  const float* dlb = delta + ((long long)b * heads + h) * n;
  for (int e = tid; e < FR * dh; e += 256) {
    const int r = e / dh, d = e - r * dh, g = r0 + r;
    kr[e] = g < n ? base[(long long)g * rs + dim + d] : 0.f;
    vr[e] = g < n ? base[(long long)g * rs + 2 * dim + d] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < FR * n; e += 256) {
    const int r = e / n, q = e - r * n;
    const float* qv = base + (long long)q * rs;
    const float* dv = dbase + (long long)q * dim;
    float s = 0.f, t = 0.f;
    for (int d = 0; d < dh; ++d) {
      s = fmaf(kr[r * dh + d], qv[d], s);
      t = fmaf(vr[r * dh + d], dv[d], t);
    }
    const float p = expf(s * scale - lb[q]);
    Pt[e] = p;
    dSt[e] = p * (t - dlb[q]) * scale;
  }
  __syncthreads();
  for (int e = tid; e < FR * dh; e += 256) {
    const int r = e / dh, d = e - r * dh;
    float gk = 0.f, gv = 0.f;
    for (int q = 0; q < n; ++q) {
      gv = fmaf(Pt[r * n + q], dbase[(long long)q * dim + d], gv);
      gk = fmaf(dSt[r * n + q], base[(long long)q * rs + d], gk);
    }
    const bool ok = r0 + r < n;
    if (ok) {
      float* row = dqkv + (long long)b * n * rs + (long long)(r0 + r) * rs + h * dh + d;
      row[dim] = gk;
      row[2 * dim] = gv;
    }
    kr[e] = ok ? gk : 0.f;
    vr[e] = ok ? gv : 0.f;
  }
  __syncthreads();
  for (int d = tid; d < dh; d += 256) {
    float sk = 0.f, sv = 0.f;
    for (int r = 0; r < FR; ++r) {
      sk += kr[r * dh + d];
      sv += vr[r * dh + d];
    }
    float* pr = part + ((long long)b * groups + blockIdx.x) * rs + h * dh + d;
    pr[dim] = sk;
    pr[2 * dim] = sv;
  }
}

// ----------------------------------------------------------------- launch

template <int DH>
static int launch_bf16(dim3 grid, cudaStream_t s, const void* qkv, const void* dout, void* dqkv,
                       float* lse, float* delta, float* part, int n, int dim, int heads,
                       int groups, float scale) {
  constexpr int CH = chunk_rows<DH>();
  static size_t conf_dq = 0, conf_dkv = 0;
  const size_t dq_bytes = sizeof(bf16) * (2 * BT + 4 * CH) * (DH + 8);
  const size_t dkv_bytes = dq_bytes + sizeof(float) * 4 * CH;
  if (int err = set_smem(attn_bwd_dq_kernel<DH>, dq_bytes, &conf_dq)) return err;
  if (int err = set_smem(attn_bwd_dkv_kernel<DH>, dkv_bytes, &conf_dkv)) return err;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* g = static_cast<const bf16*>(dout);
  bf16* out = static_cast<bf16*>(dqkv);
  attn_bwd_dq_kernel<DH><<<grid, 128, dq_bytes, s>>>(q, g, out, lse, delta, part, n, dim, heads,
                                                     groups, scale);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  attn_bwd_dkv_kernel<DH><<<grid, 128, dkv_bytes, s>>>(q, g, out, lse, delta, part, n, dim, heads,
                                                       groups, scale);
  return (int)cudaGetLastError();
}

// qkv (B, n, 3·heads·dh), dout (B, n, heads·dh) -> dqkv (B, n, 3·heads·dh);
// lse and delta are (B, heads, n) float scratch; part is (B·ceil(n/16),
// 3·heads·dh) float, the column sums of dqkv over each 16-row group.
extern "C" int mtt_attention_bwd(const void* qkv, const void* dout, void* dqkv, void* lse,
                                 void* delta, void* part, int batch, int n, int heads, int dh,
                                 float scale, int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || n > MAX_KEYS || heads <= 0 || dh <= 0 || dh > MAX_DH || dh % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dim = heads * dh, groups = (n + FR - 1) / FR;
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* p = static_cast<float*>(part);
  if (dtype == MTT_BF16) {
    for (const void* ptr : {qkv, dout, (const void*)dqkv})
      if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
    const dim3 grid((n + BT - 1) / BT, heads, batch);
#define MTT_ATTN_BWD(D) \
  case D:               \
    return launch_bf16<D>(grid, s, qkv, dout, dqkv, l, dl, p, n, dim, heads, groups, scale);
    switch (dh) {
      MTT_ATTN_BWD(16)
      MTT_ATTN_BWD(32)
      MTT_ATTN_BWD(48)
      MTT_ATTN_BWD(64)
      MTT_ATTN_BWD(80)
      MTT_ATTN_BWD(96)
      MTT_ATTN_BWD(112)
      MTT_ATTN_BWD(128)
    }
#undef MTT_ATTN_BWD
    return (int)cudaErrorInvalidValue;
  }
  static size_t conf_dq = 0, conf_dkv = 0;
  const size_t bytes = sizeof(float) * (2 * FR * (size_t)dh + 2 * FR * (size_t)n);
  if (int err = set_smem(attn_bwd_dq_f32_kernel, bytes, &conf_dq)) return err;
  if (int err = set_smem(attn_bwd_dkv_f32_kernel, bytes, &conf_dkv)) return err;
  const dim3 grid(groups, heads, batch);
  const float* q = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(dout);
  float* out = static_cast<float*>(dqkv);
  attn_bwd_dq_f32_kernel<<<grid, 256, bytes, s>>>(q, g, out, l, dl, p, n, dim, heads, dh, groups,
                                                  scale);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  attn_bwd_dkv_f32_kernel<<<grid, 256, bytes, s>>>(q, g, out, l, dl, p, n, dim, heads, dh, groups,
                                                   scale);
  return (int)cudaGetLastError();
}
