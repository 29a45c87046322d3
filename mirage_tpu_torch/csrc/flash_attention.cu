// Flash attention for any number of queries and keys: softmax(q·kᵀ·scale)·v
// for every (batch, head), its per-row log-sum-exp, and its backward.
//
// Replaces mirage_tpu/ops/flash_attention.py:_flash_fwd / _attn_kernel and
// _flash_bwd / _attn_bwd_kernel (B8, the attention core the JAX package runs
// at 512 keys or more: the encoder at 1025 tokens in segmentation tuning, the
// decoders' cross-attention over 769 context tokens). The TPU kernels keep a
// query block's scores against ALL keys of one (batch, head) in VMEM (keys
// padded to 128 and masked); an SM's shared memory cannot hold that, so the
// keys stream through shared memory in chunks and the softmax runs online
// (FlashAttention-2):
//
// - the bf16 forward: csrc/attention_fwd.cuh (TMA, wgmma, two consumer
//   warpgroups in ping-pong), shared with csrc/attention.cu; the running max
//   and sum in float, keys at or past nk masked to -inf, queries past nq not
//   written, the output divided by the float row sum at the end, and lse =
//   m + log2(l) (log2 units) written for the backward.
// - flash_bwd_dq_kernel: one block per (batch, head, 64 queries). Pass 1
//   streams K and V for delta = rowsum(P∘dP) from the float P = exp2(s −
//   lse) and dP = dO·Vᵀ (the TPU's delta, not rowsum(dO∘O) from the rounded
//   output); pass 2 streams them again and accumulates dQ = T(dS)·K with dS =
//   P∘(dP − delta)·scale. Writes T(dQ) and delta.
// - flash_bwd_dkv_kernel: one block per (batch, head, 64 keys); streams Q,
//   dO, lse and delta and accumulates dV = T(P)ᵀ·dO and dK = T(dS)ᵀ·Q in
//   float registers over every query, rounding each once at the end (the
//   TPU sums dk and dv in float across its sequential query grid and casts
//   once, _flash_bwd :196-217).
//
// Each block owns its output rows: no atomics, every sum in a fixed order.
// Q, K, V, O, dO, dQ, dK and dV are (B, rows, ·) views addressed through
// batch and row strides and a per-head column offset, so a packed qkv (or a
// packed kv) is read and its gradient written in place, never transposed.
//
// Numerics against the TPU kernel: it rounds the unnormalised exp(s − m)
// with m the row max over ALL keys; online rescaling rounds exp(s − m_run)
// against the running max of the chunks so far and rescales the float
// accumulator when the max grows. The rounded values differ in their last
// bf16 bit where the max changes; the float32 path has no rounding and
// matches to float precision.
//
// Bound: operations (4·nq·nk·dh FLOPs per head forward against reading q, k,
// v once; the backward's 5 products per score spend 9 here: S and dP are
// recomputed in both kernels and in both passes of the first). The float
// path runs one warp per query (or key) row on plain FMAs, for the float32
// checks. What a later PR changes first: wgmma for the backward's products,
// and one backward kernel with dQ summed by atomics.
#include <math.h>

#include <initializer_list>

#include "attention_fwd.cuh"
#include "mma_tiles.cuh"

constexpr int MAX_DH = 128;
constexpr float LOG2E = 1.4426950408889634f;

// Batch and row strides (elements) of q, k, v, dout (or o), dq, dk, dv, in
// that order; a kernel parameter passed by value.
struct Strides {
  long long s[14];
};

// a warp's 16 × DH float accumulator, rows row0 + gid (+ 8) below n, rounded
// into out (row stride rs)
template <int DH>
__device__ __forceinline__ void store_rows(float (&acc)[DH / 8][4], bf16* out, int rs, int row0,
                                           int n) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + gid + 8 * hf;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * rs + j * 8 + 2 * tig) =
          __floats2bfloat162_rn(acc[j][2 * hf], acc[j][2 * hf + 1]);
  }
}

// ---------------------------------------------------------------- bf16 path

template <int DH>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        bf16* __restrict__ dq, const float* __restrict__ lse,
                        float* __restrict__ delta, int nq, int nk, int heads,
                        const Strides st, float scale) {
  constexpr int DS = DH + 8, CH = chunk_rows<DH>(), NB = CH / 8, KT = DH / 16, NT = DH / 8;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  bf16* qs = reinterpret_cast<bf16*>(flash_smem);  // BT × DS
  bf16* dos = qs + BT * DS;                        // BT × DS
  bf16* ks = dos + BT * DS;                        // 2 × CH × DS
  bf16* vs = ks + 2 * CH * DS;                     // 2 × CH × DS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  // st: q, k, v, dout, dq batch and row strides, in that order
  const bf16* qb = q + b * st.s[0] + (long long)h * DH;
  const bf16* kb = k + b * st.s[2] + (long long)h * DH;
  const bf16* vb = v + b * st.s[4] + (long long)h * DH;
  const bf16* db = dout + b * st.s[6] + (long long)h * DH;
  const int q_rs = (int)st.s[1], k_rs = (int)st.s[3];
  const int v_rs = (int)st.s[5], d_rs = (int)st.s[7];
  stage_rows<DH>(qs, qb, q0, BT, nq, q_rs);
  stage_rows<DH>(dos, db, q0, BT, nq, d_rs);
  stage_rows<DH>(ks, kb, 0, CH, nk, k_rs);
  stage_rows<DH>(vs, vb, 0, CH, nk, v_rs);
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  const int row0 = q0 + warp * 16;
  const bool active = row0 < nq;
  const long long sbase = ((long long)b * heads + h) * nq;
  float lse_r[2], u_run[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + gid + 8 * hf;
    lse_r[hf] = r < nq ? lse[sbase + r] : 0.f;
  }
  uint32_t qf[KT][4], df[KT][4];
  float dqa[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  const int nch = (nk + CH - 1) / CH;
  for (int it = 0; it < 2 * nch; ++it) {  // pass 1: chunks 0..nch-1, pass 2: again
    if (it + 1 < 2 * nch) {
      const int nb = (it + 1) & 1, c0 = ((it + 1) % nch) * CH;
      stage_rows<DH>(ks + nb * CH * DS, kb, c0, CH, nk, k_rs);
      stage_rows<DH>(vs + nb * CH * DS, vb, c0, CH, nk, v_rs);
    }
    cp_async_commit();
    cp_async_wait<1>();
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
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + j * 8 + 2 * tig + (e & 1);
          const float p = key < nk ? exp2f(s[j][e] * sl2 - lse_r[e >> 1]) : 0.f;
          if (it < nch)
            u_run[e >> 1] += p * dp[j][e];
          else
            s[j][e] = p * (dp[j][e] - del_r[e >> 1]) * scale;  // dS
        }
      if (it == nch - 1) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float u = u_run[hf];
          u += __shfl_xor_sync(0xffffffffu, u, 1);
          u += __shfl_xor_sync(0xffffffffu, u, 2);
          del_r[hf] = u;
        }
      }
      if (it >= nch) {
        uint32_t dsf[NB / 2][4];
        to_a<NB>(dsf, s);
        mma_ab<DH, NB / 2>(dqa, dsf, kc);  // dQ += T(dS) K
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  if (!active) return;
  if (tig == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + gid + 8 * hf;
      if (r < nq) delta[sbase + r] = del_r[hf];
    }
  }
  store_rows<DH>(dqa, dq + b * st.s[8] + (long long)h * DH, (int)st.s[9], row0, nq);
}

template <int DH>
__global__ void __launch_bounds__(128)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         const float* __restrict__ lse, const float* __restrict__ delta, int nq,
                         int nk, int heads, const Strides st, float scale) {
  constexpr int DS = DH + 8, CH = chunk_rows<DH>(), NB = CH / 8, KT = DH / 16, NT = DH / 8;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  bf16* ks = reinterpret_cast<bf16*>(flash_smem);  // BT × DS
  bf16* vs = ks + BT * DS;                         // BT × DS
  bf16* qs = vs + BT * DS;                         // 2 × CH × DS
  bf16* dos = qs + 2 * CH * DS;                    // 2 × CH × DS
  float* ls = reinterpret_cast<float*>(dos + 2 * CH * DS);  // 2 × CH lse
  float* dls = ls + 2 * CH;                                 // 2 × CH delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BT;
  // st: q, k, v, dout, dq, dk, dv batch and row strides, in that order
  const bf16* qb = q + b * st.s[0] + (long long)h * DH;
  const bf16* kb = k + b * st.s[2] + (long long)h * DH;
  const bf16* vb = v + b * st.s[4] + (long long)h * DH;
  const bf16* db = dout + b * st.s[6] + (long long)h * DH;
  const int q_rs = (int)st.s[1], d_rs = (int)st.s[7];
  const float* lb = lse + ((long long)b * heads + h) * nq;
  const float* dlb = delta + ((long long)b * heads + h) * nq;
  // a chunk's lse and delta; queries past nq get lse = +inf, so P = 0 there
  auto stats = [&](int buf, int c0) {
    for (int i = tid; i < CH; i += blockDim.x) {
      const int g = c0 + i;
      ls[buf * CH + i] = g < nq ? lb[g] : INFINITY;
      dls[buf * CH + i] = g < nq ? dlb[g] : 0.f;
    }
  };
  stage_rows<DH>(ks, kb, k0, BT, nk, (int)st.s[3]);
  stage_rows<DH>(vs, vb, k0, BT, nk, (int)st.s[5]);
  stage_rows<DH>(qs, qb, 0, CH, nq, q_rs);
  stage_rows<DH>(dos, db, 0, CH, nq, d_rs);
  cp_async_commit();
  stats(0, 0);

  const float sl2 = scale * LOG2E;
  const int row0 = k0 + warp * 16;
  const bool active = row0 < nk;
  uint32_t kf[KT][4], vf[KT][4];
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int nch = (nq + CH - 1) / CH;
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      const int nb = (c + 1) & 1;
      stage_rows<DH>(qs + nb * CH * DS, qb, (c + 1) * CH, CH, nq, q_rs);
      stage_rows<DH>(dos + nb * CH * DS, db, (c + 1) * CH, CH, nq, d_rs);
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
      float sT[NB][4], dpt[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpt[j][e] = 0.f;
      mma_abt<DH, NB>(sT, kf, qc);  // Sᵀ = K Qᵀ
      mma_abt<DH, NB>(dpt, vf, dc);  // dPᵀ = V dOᵀ
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * tig + (e & 1);
          const float p = exp2f(sT[j][e] * sl2 - lsc[qi]);
          sT[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dlc[qi]) * scale;  // dSᵀ
        }
      uint32_t pf[NB / 2][4], dsf[NB / 2][4];
      to_a<NB>(pf, sT);
      to_a<NB>(dsf, dpt);
      mma_ab<DH, NB / 2>(dva, pf, dc);   // dV += T(P)ᵀ dO
      mma_ab<DH, NB / 2>(dka, dsf, qc);  // dK += T(dS)ᵀ Q
    }
    __syncthreads();
  }
  if (!active) return;
  store_rows<DH>(dka, dk + b * st.s[10] + (long long)h * DH, (int)st.s[11], row0, nk);
  store_rows<DH>(dva, dv + b * st.s[12] + (long long)h * DH, (int)st.s[13], row0, nk);
}

// --------------------------------------------------------------- float path
//
// One warp per query row (forward, dq) or key row (dk/dv); the lanes take
// 32 keys (queries) at a time, each one dot product, and each lane owns the
// output columns lane, lane + 32, ... of the row. Any nq, nk; dh ≤ 128.

constexpr int FW = 8;  // warps (rows) per block

__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int nq, int nk, int heads, int dh,
                         const Strides st, float scale_log2) {
  __shared__ float qrow[FW][MAX_DH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, r = blockIdx.x * FW + warp;
  if (r >= nq) return;
  const float* qr = q + b * st.s[0] + (long long)r * st.s[1] + (long long)h * dh;
  const float* kb = k + b * st.s[2] + (long long)h * dh;
  const float* vb = v + b * st.s[4] + (long long)h * dh;
  for (int d = lane; d < dh; d += 32) qrow[warp][d] = qr[d];
  __syncwarp();
  float m = -INFINITY, l = 0.f, acc[MAX_DH / 32] = {};
  for (int j0 = 0; j0 < nk; j0 += 32) {
    const int j = j0 + lane;
    float s = -INFINITY;
    if (j < nk) {
      const float* kj = kb + (long long)j * st.s[3];
      float dot = 0.f;
      for (int d = 0; d < dh; ++d) dot = fmaf(qrow[warp][d], kj[d], dot);
      s = dot * scale_log2;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float corr = exp2f(m - m_new);
    m = m_new;
    const float p = j < nk ? exp2f(s - m) : 0.f;
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int c = 0; c < MAX_DH / 32; ++c) acc[c] *= corr;
    const int jn = min(32, nk - j0);
    for (int t = 0; t < jn; ++t) {
      const float pt = __shfl_sync(0xffffffffu, p, t);
      const float* vt = vb + (long long)(j0 + t) * st.s[5];
#pragma unroll
      for (int c = 0; c < MAX_DH / 32; ++c)
        if (lane + 32 * c < dh) acc[c] = fmaf(pt, vt[lane + 32 * c], acc[c]);
    }
  }
  float* orow = o + b * st.s[6] + (long long)r * st.s[7] + (long long)h * dh;
#pragma unroll
  for (int c = 0; c < MAX_DH / 32; ++c)
    if (lane + 32 * c < dh) orow[lane + 32 * c] = acc[c] / l;
  if (lane == 0) lse[((long long)b * heads + h) * nq + r] = m + log2f(l);
}

__global__ void __launch_bounds__(256)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            float* __restrict__ dq, const float* __restrict__ lse,
                            float* __restrict__ delta, int nq, int nk, int heads, int dh,
                            const Strides st, float scale) {
  __shared__ float qrow[FW][MAX_DH], drow[FW][MAX_DH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, r = blockIdx.x * FW + warp;
  if (r >= nq) return;
  const float* kb = k + b * st.s[2] + (long long)h * dh;
  const float* vb = v + b * st.s[4] + (long long)h * dh;
  const float* qr = q + b * st.s[0] + (long long)r * st.s[1] + (long long)h * dh;
  const float* dr = dout + b * st.s[6] + (long long)r * st.s[7] + (long long)h * dh;
  for (int d = lane; d < dh; d += 32) {
    qrow[warp][d] = qr[d];
    drow[warp][d] = dr[d];
  }
  __syncwarp();
  const long long srow = ((long long)b * heads + h) * nq + r;
  const float sl2 = scale * LOG2E, ls = lse[srow];
  // lane j's key: P (float) and dP of this row
  auto p_dp = [&](int j, float* p, float* dp) {
    const float* kj = kb + (long long)j * st.s[3];
    const float* vj = vb + (long long)j * st.s[5];
    float s = 0.f, t = 0.f;
    for (int d = 0; d < dh; ++d) {
      s = fmaf(qrow[warp][d], kj[d], s);
      t = fmaf(drow[warp][d], vj[d], t);
    }
    *p = exp2f(s * sl2 - ls);
    *dp = t;
  };
  float u = 0.f;
  for (int j = lane; j < nk; j += 32) {
    float p, dp;
    p_dp(j, &p, &dp);
    u += p * dp;
  }
  const float dl = warp_sum(u);
  float acc[MAX_DH / 32] = {};
  for (int j0 = 0; j0 < nk; j0 += 32) {
    const int j = j0 + lane;
    float ds = 0.f;
    if (j < nk) {
      float p, dp;
      p_dp(j, &p, &dp);
      ds = p * (dp - dl) * scale;
    }
    const int jn = min(32, nk - j0);
    for (int t = 0; t < jn; ++t) {
      const float dst = __shfl_sync(0xffffffffu, ds, t);
      const float* kt = kb + (long long)(j0 + t) * st.s[3];
#pragma unroll
      for (int c = 0; c < MAX_DH / 32; ++c)
        if (lane + 32 * c < dh) acc[c] = fmaf(dst, kt[lane + 32 * c], acc[c]);
    }
  }
  float* out = dq + b * st.s[8] + (long long)r * st.s[9] + (long long)h * dh;
#pragma unroll
  for (int c = 0; c < MAX_DH / 32; ++c)
    if (lane + 32 * c < dh) out[lane + 32 * c] = acc[c];
  if (lane == 0) delta[srow] = dl;
}

__global__ void __launch_bounds__(256)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             float* __restrict__ dk, float* __restrict__ dv,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             int nq, int nk, int heads, int dh, const Strides st,
                             float scale) {
  __shared__ float krow[FW][MAX_DH], vrow[FW][MAX_DH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, r = blockIdx.x * FW + warp;
  if (r >= nk) return;
  const float* qb = q + b * st.s[0] + (long long)h * dh;
  const float* db = dout + b * st.s[6] + (long long)h * dh;
  const float* kr = k + b * st.s[2] + (long long)r * st.s[3] + (long long)h * dh;
  const float* vr = v + b * st.s[4] + (long long)r * st.s[5] + (long long)h * dh;
  for (int d = lane; d < dh; d += 32) {
    krow[warp][d] = kr[d];
    vrow[warp][d] = vr[d];
  }
  __syncwarp();
  const float* lb = lse + ((long long)b * heads + h) * nq;
  const float* dlb = delta + ((long long)b * heads + h) * nq;
  const float sl2 = scale * LOG2E;
  float gk[MAX_DH / 32] = {}, gv[MAX_DH / 32] = {};
  for (int i0 = 0; i0 < nq; i0 += 32) {
    const int i = i0 + lane;
    float p = 0.f, ds = 0.f;
    if (i < nq) {
      const float* qi = qb + (long long)i * st.s[1];
      const float* di = db + (long long)i * st.s[7];
      float s = 0.f, t = 0.f;
      for (int d = 0; d < dh; ++d) {
        s = fmaf(krow[warp][d], qi[d], s);
        t = fmaf(vrow[warp][d], di[d], t);
      }
      p = exp2f(s * sl2 - lb[i]);
      ds = p * (t - dlb[i]) * scale;
    }
    const int in = min(32, nq - i0);
    for (int t = 0; t < in; ++t) {
      const float pt = __shfl_sync(0xffffffffu, p, t);
      const float dst = __shfl_sync(0xffffffffu, ds, t);
      const float* qt = qb + (long long)(i0 + t) * st.s[1];
      const float* dt = db + (long long)(i0 + t) * st.s[7];
#pragma unroll
      for (int c = 0; c < MAX_DH / 32; ++c)
        if (lane + 32 * c < dh) {
          gv[c] = fmaf(pt, dt[lane + 32 * c], gv[c]);
          gk[c] = fmaf(dst, qt[lane + 32 * c], gk[c]);
        }
    }
  }
  float* ok = dk + b * st.s[10] + (long long)r * st.s[11] + (long long)h * dh;
  float* ov = dv + b * st.s[12] + (long long)r * st.s[13] + (long long)h * dh;
#pragma unroll
  for (int c = 0; c < MAX_DH / 32; ++c)
    if (lane + 32 * c < dh) {
      ok[lane + 32 * c] = gk[c];
      ov[lane + 32 * c] = gv[c];
    }
}

// ----------------------------------------------------------------- launch

template <int DH>
static int bwd_bf16(int nq, int nk, int heads, int batch, cudaStream_t s, const void* q,
                    const void* k, const void* v, const void* dout, void* dq, void* dk, void* dv,
                    const float* lse, float* delta, const Strides& st, float scale) {
  constexpr int CH = chunk_rows<DH>();
  static size_t conf_dq = 0, conf_dkv = 0;
  const size_t dq_bytes = sizeof(bf16) * (2 * BT + 4 * CH) * (DH + 8);
  const size_t dkv_bytes = dq_bytes + sizeof(float) * 4 * CH;
  if (int err = set_smem(flash_bwd_dq_kernel<DH>, dq_bytes, &conf_dq)) return err;
  if (int err = set_smem(flash_bwd_dkv_kernel<DH>, dkv_bytes, &conf_dkv)) return err;
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v), *d_ = static_cast<const bf16*>(dout);
  flash_bwd_dq_kernel<DH><<<dim3((nq + BT - 1) / BT, heads, batch), 128, dq_bytes, s>>>(
      q_, k_, v_, d_, static_cast<bf16*>(dq), lse, delta, nq, nk, heads, st, scale);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  flash_bwd_dkv_kernel<DH><<<dim3((nk + BT - 1) / BT, heads, batch), 128, dkv_bytes, s>>>(
      q_, k_, v_, d_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse, delta, nq, nk, heads,
      st, scale);
  return (int)cudaGetLastError();
}

static bool bad_args(int batch, int nq, int nk, int heads, int dh) {
  return batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 || dh < 16 || dh > MAX_DH || dh % 16;
}

// 16-byte rows for cp.async and 4-byte pair stores in the bf16 path
static bool bf16_layout_ok(const Strides& st, int n, std::initializer_list<const void*> ptrs) {
  for (int i = 0; i < n; ++i)
    if (st.s[i] % 8) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

static Strides copy_strides(const long long* strides, int n) {
  Strides st = {};
  for (int i = 0; i < n; ++i) st.s[i] = strides[i];
  return st;
}

#define MTT_DH_SWITCH(CALL) \
  switch (dh) {             \
    CALL(16)                \
    CALL(32)                \
    CALL(48)                \
    CALL(64)                \
    CALL(80)                \
    CALL(96)                \
    CALL(112)               \
    CALL(128)               \
  }

// q (B, nq, ·), k and v (B, nk, ·), o (B, nq, ·): head h reads and writes
// columns [h·dh, (h+1)·dh) of its rows. strides: q, k, v, o batch and row
// strides in elements (host memory). lse: (B, heads, nq) float, log2 units.
extern "C" int mtt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const long long* strides, int batch, int nq, int nk, int heads,
                             int dh, float scale, int dtype, void* stream) {
  if (bad_args(batch, nq, nk, heads, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const Strides st = copy_strides(strides, 8);
  if (dtype == MTT_BF16)
    return attn_fwd::run(q, k, v, o, l, batch, nq, nk, heads, dh, st.s, scale, s);
  flash_fwd_f32_kernel<<<dim3((nq + FW - 1) / FW, heads, batch), 32 * FW, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), l, nq, nk, heads, dh, st, scale * LOG2E);
  return (int)cudaGetLastError();
}

// strides: q, k, v, dout, dq, dk, dv batch and row strides (host memory);
// lse (B, heads, nq) from the forward, delta (B, heads, nq) float scratch.
extern "C" int mtt_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, const void* lse, void* delta,
                             const long long* strides, int batch, int nq, int nk, int heads,
                             int dh, float scale, int dtype, void* stream) {
  if (bad_args(batch, nq, nk, heads, dh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const Strides st = copy_strides(strides, 14);
  if (dtype == MTT_BF16) {
    if (!bf16_layout_ok(st, 14, {q, k, v, dout, dq, dk, dv})) return (int)cudaErrorInvalidValue;
#define MTT_BWD(D) \
  case D:          \
    return bwd_bf16<D>(nq, nk, heads, batch, s, q, k, v, dout, dq, dk, dv, l, dl, st, scale);
    MTT_DH_SWITCH(MTT_BWD)
#undef MTT_BWD
    return (int)cudaErrorInvalidValue;
  }
  const float *q_ = static_cast<const float*>(q), *k_ = static_cast<const float*>(k),
              *v_ = static_cast<const float*>(v), *d_ = static_cast<const float*>(dout);
  flash_bwd_dq_f32_kernel<<<dim3((nq + FW - 1) / FW, heads, batch), 32 * FW, 0, s>>>(
      q_, k_, v_, d_, static_cast<float*>(dq), l, dl, nq, nk, heads, dh, st, scale);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  flash_bwd_dkv_f32_kernel<<<dim3((nk + FW - 1) / FW, heads, batch), 32 * FW, 0, s>>>(
      q_, k_, v_, d_, static_cast<float*>(dk), static_cast<float*>(dv), l, dl, nq, nk, heads,
      dh, st, scale);
  return (int)cudaGetLastError();
}
