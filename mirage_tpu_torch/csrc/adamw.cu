// The AdamW step over many float32 leaves in two launches, in place: the
// gradient norm (and the step's scalars), then the update.
//
// Replaces mirage_tpu/ops/fused_adamw.py:fused_adamw_leaf / _adamw_kernel
// (B11), which the TPU launches once per leaf over a sequential grid of row
// blocks with the six scalars in one (1, 8) SMEM operand and m, n, p aliased
// to their outputs, and the global norm that mirage_tpu/train/optim.py
// leaves to XLA. Per element of the update:
//
//   gs = g·gscale
//   m' = b1·m + (1 − b1)·gs
//   n' = b2·n + (1 − b2)·gs²
//   p' = p − lr·((m'/c1) / (√(n'/c2) + eps) + wd·p)
//   keep ≤ 0: m, n and p pass through exactly.
//
// Bound: bytes. The update reads g, m, n, p and writes m, n, p: 28 B a
// parameter, so MIRAGE-Large's 317.2 M trainable parameters are 8.9 GB,
// 2.65 ms at 3.35 TB/s; the norm reads g once, 4 B a parameter, 0.38 ms.
// A step's leaves range from 7 elements to 4.2 M, so both kernels walk one
// flat list of (leaf, tile) pairs of `tile` elements each, built once with
// the leaf table (ops/fused_adamw.py:LeafTable): one CTA a tile, so a
// 7-element bias and a 4 M weight share one balanced grid. A tile moves
// 16-byte vectors, two a thread in flight per array (with several CTAs an
// SM, well over the bytes in flight the card's bandwidth needs), and a leaf
// whose pointers are not all 16-byte aligned walks its tiles element by
// element. The leaf table (m, n, p, length) stays on the card across steps;
// the host writes only the gradients' pointers and each leaf's (lr, wd) to
// the step buffer. gscale, c1, c2 and keep are device scalars written by the
// norm kernel, so the host never waits for the gradient norm.
//
// Every operation of the update is an explicitly rounded intrinsic (no FMA
// contraction; sqrt and division IEEE), so the kernel computes the foreach
// route's float32 arithmetic step by step. The norm kernel writes each
// tile's sum of squares into the tile's own slot; the last CTA to arrive sums
// the slots in a fixed order (in double), so a rerun is bit-identical, and
// then computes the step's scalars as train/optim.py's foreach route does.
#include "common.cuh"

struct AdamwLeaf {
  float* m;
  float* n;
  float* p;
  long long numel;
};
static_assert(sizeof(AdamwLeaf) == 32, "the host packs four int64 per leaf");

struct AdamwConsts {
  float gscale, c1, c2, b1, omb1, b2, omb2, eps, lr, wd;
};

constexpr int ADAMW_THREADS = 256;
// flags of mtt_adamw_norm
constexpr int ADAMW_CLIP = 1, ADAMW_SKIP = 2;

__device__ __forceinline__ void adamw_elem(float g, float& m, float& n, float& p,
                                           const AdamwConsts& k) {
  const float gs = __fmul_rn(g, k.gscale);
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, gs));
  n = __fadd_rn(__fmul_rn(k.b2, n), __fmul_rn(k.omb2, __fmul_rn(gs, gs)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(n, k.c2)), k.eps);
  const float step = __fadd_rn(__fdiv_rn(__fdiv_rn(m, k.c1), den), __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(k.lr, step));
}

__device__ __forceinline__ void adamw_vec(const float4& g, float4& m, float4& n, float4& p,
                                          const AdamwConsts& k) {
  adamw_elem(g.x, m.x, n.x, p.x, k);
  adamw_elem(g.y, m.y, n.y, p.y, k);
  adamw_elem(g.z, m.z, n.z, p.z, k);
  adamw_elem(g.w, m.w, n.w, p.w, k);
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// tiles: (leaf, tile index in the leaf) pairs; step: n_leaves gradient
// pointers, then n_leaves (lr, wd) float pairs.
__global__ void __launch_bounds__(ADAMW_THREADS)
    adamw_tiles_kernel(const int2* __restrict__ tiles, long long tile,
                       const AdamwLeaf* __restrict__ leaves, const long long* __restrict__ step,
                       int n_leaves, const float* __restrict__ sc, float b1, float omb1, float b2,
                       float omb2, float eps) {
  if (!(sc[3] > 0.f)) return;  // a skipped step: every leaf passes through
  const int2 t = tiles[blockIdx.x];
  const AdamwLeaf leaf = leaves[t.x];
  const float* g = reinterpret_cast<const float*>(step[t.x]);
  const float2 lw = reinterpret_cast<const float2*>(step + n_leaves)[t.x];
  const AdamwConsts k{sc[0], sc[1], sc[2], b1, omb1, b2, omb2, eps, lw.x, lw.y};
  const long long start = (long long)t.y * tile;
  const long long end = min(start + tile, leaf.numel);
  long long done = start;  // the elements below this one are taken
  if (aligned16(g) && aligned16(leaf.m) && aligned16(leaf.n) && aligned16(leaf.p)) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(leaf.m);
    float4* n4 = reinterpret_cast<float4*>(leaf.n);
    float4* p4 = reinterpret_cast<float4*>(leaf.p);
    const long long v1 = end >> 2;  // start is a multiple of 4
    for (long long v = (start >> 2) + threadIdx.x; v < v1; v += 2 * ADAMW_THREADS) {
      const long long w = v + ADAMW_THREADS;
      const bool two = w < v1;
      const float4 ga = __ldcs(g4 + v);
      float4 ma = m4[v], na = n4[v], pa = p4[v];
      float4 gb, mb, nb, pb;
      if (two) {
        gb = __ldcs(g4 + w);
        mb = m4[w];
        nb = n4[w];
        pb = p4[w];
      }
      adamw_vec(ga, ma, na, pa, k);
      m4[v] = ma;
      n4[v] = na;
      p4[v] = pa;
      if (two) {
        adamw_vec(gb, mb, nb, pb, k);
        m4[w] = mb;
        n4[w] = nb;
        p4[w] = pb;
      }
    }
    done = v1 << 2;
  }
  for (long long i = done + threadIdx.x; i < end; i += ADAMW_THREADS) {
    float m = leaf.m[i], n = leaf.n[i], p = leaf.p[i];
    adamw_elem(g[i], m, n, p, k);
    leaf.m[i] = m;
    leaf.n[i] = n;
    leaf.p[i] = p;
  }
}

// Sum of v over the CTA, in a fixed order; the result in thread 0.
template <typename V>
__device__ __forceinline__ V cta_sum(V v, V* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  V s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < ADAMW_THREADS / 32; ++w) s += red[w];
  return s;
}

// The gradient norm over the tiles (gnorm_in null), then the scalars of the
// step from it: keep (finite and under skip, with ADAMW_SKIP), gscale =
// min(clip · 1/(gnorm + 1e-6), 1) (with ADAMW_CLIP; torch's clip / t is
// reciprocal, then product), count += keep, c1 = 1 − b1^max(count, 1),
// c2 = 1 − b2^max(count, 1). extra (or null): the squared sum of gradients
// outside the table, added before the root. With gnorm_in the grid is one
// CTA and only the scalars are computed.
__global__ void __launch_bounds__(ADAMW_THREADS)
    adamw_norm_kernel(const int2* __restrict__ tiles, int n_tiles, long long tile,
                      const AdamwLeaf* __restrict__ leaves, const long long* __restrict__ step,
                      float* slots, unsigned int* arrived, const float* extra,
                      const float* gnorm_in, float* gnorm_out, int* count, float* sc, int flags,
                      float clip, float skip, float b1, float b2) {
  __shared__ float redf[ADAMW_THREADS / 32];
  __shared__ double redd[ADAMW_THREADS / 32];
  __shared__ bool last;
  if (gnorm_in == nullptr && (int)blockIdx.x < n_tiles) {
    const int2 t = tiles[blockIdx.x];
    const long long numel = leaves[t.x].numel;
    const float* g = reinterpret_cast<const float*>(step[t.x]);
    const long long start = (long long)t.y * tile;
    const long long end = min(start + tile, numel);
    long long done = start;
    float s = 0.f;
    if (aligned16(g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const long long v1 = end >> 2;
      for (long long v = (start >> 2) + threadIdx.x; v < v1; v += 2 * ADAMW_THREADS) {
        const long long w = v + ADAMW_THREADS;
        const float4 a = __ldcs(g4 + v);
        const float4 b = w < v1 ? __ldcs(g4 + w) : make_float4(0.f, 0.f, 0.f, 0.f);
        s = fmaf(a.x, a.x, s);
        s = fmaf(a.y, a.y, s);
        s = fmaf(a.z, a.z, s);
        s = fmaf(a.w, a.w, s);
        s = fmaf(b.x, b.x, s);
        s = fmaf(b.y, b.y, s);
        s = fmaf(b.z, b.z, s);
        s = fmaf(b.w, b.w, s);
      }
      done = v1 << 2;
    }
    for (long long i = done + threadIdx.x; i < end; i += ADAMW_THREADS) s = fmaf(g[i], g[i], s);
    s = cta_sum(s, redf);
    if (threadIdx.x == 0) slots[blockIdx.x] = s;
  }
  // the last CTA to arrive finishes (the slots written before the arrival)
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(arrived, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double total = 0.0;
  if (gnorm_in == nullptr)
    for (int i = threadIdx.x; i < n_tiles; i += ADAMW_THREADS) total += (double)__ldcg(slots + i);
  __syncthreads();
  total = cta_sum(total, redd);
  if (threadIdx.x != 0) return;
  float gn;
  if (gnorm_in != nullptr) {
    gn = *gnorm_in;
  } else {
    if (extra != nullptr) total += (double)*extra;
    gn = __fsqrt_rn((float)total);
    *gnorm_out = gn;
  }
  const bool keep = !(flags & ADAMW_SKIP) || (isfinite(gn) && gn < skip);
  float gscale = 1.f;
  if (flags & ADAMW_CLIP) {
    gscale = __fmul_rn(__frcp_rn(__fadd_rn(gn, 1e-6f)), clip);
    gscale = gscale > 1.f ? 1.f : gscale;  // a NaN stays NaN, as torch.clamp
  }
  const int cnt = *count + (keep ? 1 : 0);
  *count = cnt;
  const float c = fmaxf((float)cnt, 1.f);
  sc[0] = gscale;
  sc[1] = __fsub_rn(1.f, powf(b1, c));
  sc[2] = __fsub_rn(1.f, powf(b2, c));
  sc[3] = keep ? 1.f : 0.f;
  *arrived = 0u;  // ready for the next launch
}

// tiles: n_tiles int2 (leaf, tile in the leaf) in device memory; leaves:
// AdamwLeaf rows; step: int64[2 · n_leaves] (gradient pointers, then (lr,
// wd) float pairs); scalars: float[4] = gscale, c1, c2, keep.
extern "C" int mtt_adamw_tiles(const void* tiles, int n_tiles, long long tile, const void* leaves,
                               const void* step, int n_leaves, const void* scalars, float b1,
                               float omb1, float b2, float omb2, float eps, void* stream) {
  if (tiles == nullptr || leaves == nullptr || step == nullptr || scalars == nullptr ||
      n_tiles <= 0 || n_leaves <= 0 || tile <= 0 || tile % 4)
    return (int)cudaErrorInvalidValue;
  adamw_tiles_kernel<<<n_tiles, ADAMW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(tiles), tile, static_cast<const AdamwLeaf*>(leaves),
      static_cast<const long long*>(step), n_leaves, static_cast<const float*>(scalars), b1, omb1,
      b2, omb2, eps);
  return (int)cudaGetLastError();
}

// The norm over the same tiles into slots (float[n_tiles]) and gnorm_out,
// or, with gnorm_in, the scalars alone; arrived: an unsigned int in device
// memory, zero before the first launch (each launch leaves it zero).
extern "C" int mtt_adamw_norm(const void* tiles, int n_tiles, long long tile, const void* leaves,
                              const void* step, void* slots, void* arrived, const void* extra,
                              const void* gnorm_in, void* gnorm_out, void* count, void* scalars,
                              int flags, float clip, float skip, float b1, float b2,
                              void* stream) {
  if (arrived == nullptr || count == nullptr || scalars == nullptr || n_tiles < 0 || tile <= 0 ||
      tile % 4)
    return (int)cudaErrorInvalidValue;
  if (gnorm_in == nullptr &&
      (gnorm_out == nullptr || (n_tiles > 0 && (tiles == nullptr || leaves == nullptr ||
                                                step == nullptr || slots == nullptr))))
    return (int)cudaErrorInvalidValue;
  const int grid = gnorm_in != nullptr || n_tiles == 0 ? 1 : n_tiles;
  adamw_norm_kernel<<<grid, ADAMW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(tiles), gnorm_in != nullptr ? 0 : n_tiles, tile,
      static_cast<const AdamwLeaf*>(leaves), static_cast<const long long*>(step),
      static_cast<float*>(slots), static_cast<unsigned int*>(arrived),
      static_cast<const float*>(extra), static_cast<const float*>(gnorm_in),
      static_cast<float*>(gnorm_out), static_cast<int*>(count), static_cast<float*>(scalars),
      flags, clip, skip, b1, b2);
  return (int)cudaGetLastError();
}
