// One AdamW step over many float32 leaves in one launch, in place.
//
// Replaces mirage_tpu/ops/fused_adamw.py:fused_adamw_leaf / _adamw_kernel
// (B11), which the TPU launches once per leaf over a sequential grid of row
// blocks with the six scalars in one (1, 8) SMEM operand and m, n, p aliased
// to their outputs. Per element:
//
//   gs = g·gscale
//   m' = b1·m + (1 − b1)·gs
//   n' = b2·n + (1 − b2)·gs²
//   p' = p − lr·((m'/c1) / (√(n'/c2) + eps) + wd·p)
//   keep ≤ 0: m, n and p pass through exactly.
//
// Bound: bytes. Each parameter reads g, m, n, p and writes m, n, p: 28 B, so
// the 86 M trainable float32 parameters of a ViT-B classification step are
// 2.4 GB, 0.72 ms at 3.35 TB/s. The design moves nothing else: one launch for
// every routed leaf (a table of leaves in device memory; blockIdx.y picks the
// leaf, the blocks of that row walk it with 16-byte loads), m, n and p
// updated where they lie (the TPU's input_output_aliases), and gscale, c1,
// c2 and keep read from a device buffer, so the host never waits for the
// gradient norm. Each leaf's lr (its lr scale folded in) and wd ride in its
// table row. Every operation is an explicitly rounded intrinsic (no FMA
// contraction; sqrt and division IEEE), so the kernel computes the plain
// version's float32 arithmetic step by step. No atomics: a rerun is
// bit-identical.
#include "common.cuh"

struct AdamwLeaf {
  const float* g;
  float* m;
  float* n;
  float* p;
  long long numel;
  float lr;
  float wd;
};
static_assert(sizeof(AdamwLeaf) == 48, "the host packs six int64 per leaf");

struct AdamwConsts {
  float gscale, c1, c2, b1, omb1, b2, omb2, eps, lr, wd;
};

__device__ __forceinline__ void adamw_elem(float g, float& m, float& n, float& p,
                                           const AdamwConsts& k) {
  const float gs = __fmul_rn(g, k.gscale);
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, gs));
  n = __fadd_rn(__fmul_rn(k.b2, n), __fmul_rn(k.omb2, __fmul_rn(gs, gs)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(n, k.c2)), k.eps);
  const float step = __fadd_rn(__fdiv_rn(__fdiv_rn(m, k.c1), den), __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(k.lr, step));
}

__global__ void __launch_bounds__(256)
    adamw_kernel(const AdamwLeaf* __restrict__ leaves, const float* __restrict__ sc, float b1,
                 float omb1, float b2, float omb2, float eps) {
  if (!(sc[3] > 0.f)) return;  // a skipped step: every leaf passes through
  const AdamwLeaf leaf = leaves[blockIdx.y];
  const AdamwConsts k{sc[0], sc[1], sc[2], b1, omb1, b2, omb2, eps, leaf.lr, leaf.wd};
  const long long nvec = leaf.numel >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float4* g4 = reinterpret_cast<const float4*>(leaf.g);
  float4* m4 = reinterpret_cast<float4*>(leaf.m);
  float4* n4 = reinterpret_cast<float4*>(leaf.n);
  float4* p4 = reinterpret_cast<float4*>(leaf.p);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    const float4 g = __ldcs(g4 + i);
    float4 m = m4[i], n = n4[i], p = p4[i];
    adamw_elem(g.x, m.x, n.x, p.x, k);
    adamw_elem(g.y, m.y, n.y, p.y, k);
    adamw_elem(g.z, m.z, n.z, p.z, k);
    adamw_elem(g.w, m.w, n.w, p.w, k);
    m4[i] = m;
    n4[i] = n;
    p4[i] = p;
  }
  if (blockIdx.x == 0) {  // the last numel mod 4 elements
    for (long long i = (nvec << 2) + threadIdx.x; i < leaf.numel; i += blockDim.x) {
      float m = leaf.m[i], n = leaf.n[i], p = leaf.p[i];
      adamw_elem(leaf.g[i], m, n, p, k);
      leaf.m[i] = m;
      leaf.n[i] = n;
      leaf.p[i] = p;
    }
  }
}

// table: n_leaves AdamwLeaf rows in device memory (16-byte aligned g, m, n,
// p); scalars: float[4] in device memory = gscale, c1, c2, keep. blocks_x
// blocks walk each leaf.
extern "C" int mtt_adamw(const void* table, int n_leaves, int blocks_x, const void* scalars,
                         float b1, float omb1, float b2, float omb2, float eps, void* stream) {
  if (table == nullptr || scalars == nullptr || n_leaves <= 0 || n_leaves > 65535 ||
      blocks_x <= 0 || blocks_x > 65535)
    return (int)cudaErrorInvalidValue;
  adamw_kernel<<<dim3(blocks_x, n_leaves), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AdamwLeaf*>(table), static_cast<const float*>(scalars), b1, omb1, b2,
      omb2, eps);
  return (int)cudaGetLastError();
}
