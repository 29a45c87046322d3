// Backward of multi-head softmax(q·kᵀ·scale)·v on the packed (B, N, 3D) qkv
// (column order q|k|v × heads × dh), for up to 512 tokens: dqkv in the same
// packed layout, plus float column partials of dqkv for the qkv bias grad.
//
// Replaces mirage_tpu/ops/block_attention.py:_block_attn_bwd_kernel (B6's
// backward) and the attention core of :_attn_half_bwd_dx_kernel (B4) and
// :_attn_half_bwd_kernel (B7). The TPU kernels hold two per-head (N, N)
// float scratches (P and dP) in VMEM; at N = 256 and 8 heads that is 4 MB,
// and an SM has 227 KB.
//
// bf16 is the Hopper backward of csrc/attention_bwd.cuh (TMA, wgmma; a dQ
// kernel that also computes the log-sum-exp and delta, then a dK/dV kernel;
// no atomics), shared with csrc/flash_attention.cu. Its dQ kernel writes the
// column sums of the float dQ over each 16-row group of queries, its dK/dV
// kernel those of dK and dV over each 16-row group of keys (the TPU kernel
// takes dbqkv from the float dqkv too); the caller sums the groups. float
// keeps a 16-row group's P and dP rows for every key in shared memory and
// runs plain FMAs, one block per 16 rows, for the float32 checks.
#include <math.h>

#include "attention_bwd.cuh"

constexpr int MAX_KEYS = 512;
constexpr int MAX_DH = 128;

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
    const char* q = static_cast<const char*>(qkv);
    char* g = static_cast<char*>(dqkv);
    const long long bs = (long long)n * 3 * dim, rs = 3 * dim, off = (long long)dim * sizeof(bf16);
    const long long st[14] = {bs, rs, bs, rs, bs, rs, (long long)n * dim, dim, bs, rs, bs, rs, bs, rs};
    return attn_bwd::run(q, q + off, q + 2 * off, dout, g, g + off, g + 2 * off, l, dl, p, batch, n,
                         n, heads, dh, st, scale, true, s);
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
