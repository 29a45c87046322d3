// Weight gradients and column sums reduced over many rows, in a fixed order:
// C (N1, N2) = Aᵀ·B over the M rows of A (M, N1) and B (M, N2), in float,
// and the float column sums of a (M, N) matrix.
//
// Replaces the in-kernel weight-gradient accumulation of mirage_tpu/ops/
// fused_mlp.py:_mlp_bwd_stash_kernel (B9's backward, :713-727): dW2 = actᵀ·dy
// and dW1 = yᵀ·dh summed in float over the rows, db2 = Σ dy. The TPU kernel
// adds each row block's products into one float accumulator across its
// sequential grid; blocks on Hopper run in parallel, so the rows are split
// into fixed chunks, each block writes its chunk's float partial of one
// 128 × 128 tile of C, and a second kernel sums the chunks in chunk order.
// No atomics: a rerun is bit-identical.
//
// wgrad_bf16_kernel: four warps, each a 64 × 64 quarter of the tile; the
// rows stream through shared memory 32 at a time in a three-stage cp.async
// ring, and the products are mma.sync m16n8k16 (bf16 in, float accumulate)
// with both operands read transposed by ldmatrix.trans (A and B are row-major
// with the reduction over their rows). Bound: operations at the seg head's
// shapes (2·M·N1·N2 FLOPs against reading A and B once). The float path is
// a 64 × 64 FMA tile, for the float32 checks. What a later PR changes first:
// wgmma with transposed shared-memory operands fed by TMA.
#include "common.cuh"

constexpr int WT = 128;       // C tile: WT × WT
constexpr int WK = 32;        // rows per step
constexpr int WSTAGES = 3;    // steps in flight
constexpr int WS = WT + 8;    // padded shared row (elements): ldmatrix rows on distinct banks

__global__ void __launch_bounds__(128)
    wgrad_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                      float* __restrict__ part, int M, int N1, int N2, int rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char wgrad_smem[];
  bf16* as = reinterpret_cast<bf16*>(wgrad_smem);  // WSTAGES × WK × WS
  bf16* bs = as + WSTAGES * WK * WS;               // WSTAGES × WK × WS
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int i0 = blockIdx.y * WT, j0 = blockIdx.x * WT, z = blockIdx.z;
  const int r_begin = z * rows_per_chunk, r_end = min(M, r_begin + rows_per_chunk);
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;

  // rows [k0, k0 + WK) of the tile's A and B columns into stage st; rows
  // past the chunk and columns past N1 / N2 (multiples of 8) are zero-filled
  auto stage = [&](int st, int k0) {
    bf16* ad = as + st * WK * WS;
    bf16* bd = bs + st * WK * WS;
    for (int e = tid; e < WK * (WT / 8); e += 128) {
      const int r = e / (WT / 8), c = (e % (WT / 8)) * 8, row = k0 + r;
      const bool in = row < r_end;
      const bool oka = in && i0 + c < N1, okb = in && j0 + c < N2;
      cp_async16(smem_u32(ad + r * WS + c), oka ? A + (long long)row * N1 + i0 + c : A,
                 oka ? 16 : 0);
      cp_async16(smem_u32(bd + r * WS + c), okb ? B + (long long)row * N2 + j0 + c : B,
                 okb ? 16 : 0);
    }
  };

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int steps = (r_end - r_begin + WK - 1) / WK;
#pragma unroll
  for (int t = 0; t < WSTAGES - 1; ++t) {
    if (t < steps) stage(t, r_begin + t * WK);
    cp_async_commit();
  }
  const int q = lane >> 3, r8 = lane & 7;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<WSTAGES - 2>();  // step t has landed
    __syncthreads();               // and every warp is done with step t - 1
    if (t + WSTAGES - 1 < steps)
      stage((t + WSTAGES - 1) % WSTAGES, r_begin + (t + WSTAGES - 1) * WK);
    cp_async_commit();
    const bf16* at = as + (t % WSTAGES) * WK * WS;
    const bf16* bt = bs + (t % WSTAGES) * WK * WS;
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      // A fragments of Aᵀ (rows i, reduction k): 8 × 8 blocks (i, k), (i+8, k),
      // (i, k+8), (i+8, k+8), each read transposed from the (k, i) tile
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(af[mt], smem_u32(at + (kk * 16 + r8 + (q >> 1) * 8) * WS + wm +
                                           mt * 16 + (q & 1) * 8));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // B fragments of two 8-column tiles: blocks (k, j), (k+8, j), (k, j+8),
        // (k+8, j+8) of the (k, j) tile, read transposed
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(bt + (kk * 16 + r8 + (q & 1) * 8) * WS + wn + np * 16 +
                                      (q >> 1) * 8));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], af[mt], r[0], r[1]);
          mma_bf16_16816(acc[mt][2 * np + 1], af[mt], r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = part + (long long)z * N1 * N2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + wm + mt * 16 + gid + 8 * hf;
      if (i >= N1) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int j = j0 + wn + nt * 8 + 2 * tig;
        if (j < N2)
          *reinterpret_cast<float2*>(out + (long long)i * N2 + j) =
              make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
      }
    }
}

constexpr int FT = 64, FK = 16;

__global__ void __launch_bounds__(256)
    wgrad_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ part, int M, int N1, int N2, int rows_per_chunk) {
  __shared__ float at[FK][FT + 4];  // at[k][i]
  __shared__ float bt[FK][FT + 4];  // bt[k][j]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * FT, j0 = blockIdx.x * FT, z = blockIdx.z;
  const int r_begin = z * rows_per_chunk, r_end = min(M, r_begin + rows_per_chunk);
  float acc[4][4] = {};
  for (int k0 = r_begin; k0 < r_end; k0 += FK) {
#pragma unroll
    for (int e0 = 0; e0 < FK * FT; e0 += 256) {
      const int e = e0 + tid, kk = e / FT, c = e % FT, row = k0 + kk;
      at[kk][c] = row < r_end && i0 + c < N1 ? A[(long long)row * N1 + i0 + c] : 0.f;
      bt[kk][c] = row < r_end && j0 + c < N2 ? B[(long long)row * N2 + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = at[kk][ty + 16 * u];
#pragma unroll
      for (int u = 0; u < 4; ++u) b[u] = bt[kk][tx + 16 * u];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(a[u], b[w], acc[u][w]);
    }
    __syncthreads();
  }
  float* out = part + (long long)z * N1 * N2;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = i0 + ty + 16 * u, j = j0 + tx + 16 * w;
      if (i < N1 && j < N2) out[(long long)i * N2 + j] = acc[u][w];
    }
}

// float column sums of rows [z·rows_per_chunk, ...) of X (M, N), one column
// per thread, rows in order
template <typename T>
__global__ void __launch_bounds__(256)
    colsum_kernel(const T* __restrict__ X, float* __restrict__ part, int M, int N,
                  int rows_per_chunk) {
  const int col = blockIdx.x * 256 + threadIdx.x, z = blockIdx.y;
  if (col >= N) return;
  const int r_end = min(M, (z + 1) * rows_per_chunk);
  float s = 0.f;
  for (int r = z * rows_per_chunk; r < r_end; ++r) s += to_f(X[(long long)r * N + col]);
  part[(long long)z * N + col] = s;
}

// out[i] = Σ_z part[z][i], z in order
__global__ void __launch_bounds__(256)
    chunk_sum_kernel(const float* __restrict__ part, float* __restrict__ out, long long n,
                     int chunks) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < chunks; ++z) s += part[z * n + i];
  out[i] = s;
}

static int chunk_sum(const float* part, float* out, long long n, int chunks, cudaStream_t s) {
  chunk_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, out, n, chunks);
  return (int)cudaGetLastError();
}

// a (M, N1), b (M, N2) -> c (N1, N2) float = aᵀ·b. The rows are split into
// `chunks` chunks of rows_per_chunk; with more than one, part (chunks, N1,
// N2) float holds the partials, summed into c in chunk order. bf16 needs N1
// and N2 multiples of 8 and 16-byte aligned a and b.
extern "C" int mtt_wgrad(const void* a, const void* b, void* c, void* part, int M, int N1,
                         int N2, int chunks, int rows_per_chunk, int dtype, void* stream) {
  if (M <= 0 || N1 <= 0 || N2 <= 0 || chunks <= 0 || rows_per_chunk <= 0 ||
      (long long)chunks * rows_per_chunk < M || (chunks > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(chunks > 1 ? part : c);
  if (dtype == MTT_BF16) {
    if (N1 % 8 || N2 % 8 || reinterpret_cast<uintptr_t>(a) % 16 ||
        reinterpret_cast<uintptr_t>(b) % 16)
      return (int)cudaErrorInvalidValue;
    static bool configured = false;
    constexpr int bytes = 2 * WSTAGES * WK * WS * sizeof(bf16);
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          wgrad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
    wgrad_bf16_kernel<<<dim3((N2 + WT - 1) / WT, (N1 + WT - 1) / WT, chunks), 128, bytes, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), dst, M, N1, N2,
        rows_per_chunk);
  } else {
    wgrad_f32_kernel<<<dim3((N2 + FT - 1) / FT, (N1 + FT - 1) / FT, chunks), 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), dst, M, N1, N2,
        rows_per_chunk);
  }
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  if (chunks == 1) return 0;
  return chunk_sum(dst, static_cast<float*>(c), (long long)N1 * N2, chunks, s);
}

// x (M, N) -> out (N) float column sums, rows split as in mtt_wgrad; part
// (chunks, N) float when chunks > 1.
extern "C" int mtt_colsum(const void* x, void* out, void* part, int M, int N, int chunks,
                          int rows_per_chunk, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || chunks <= 0 || rows_per_chunk <= 0 ||
      (long long)chunks * rows_per_chunk < M || (chunks > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(chunks > 1 ? part : out);
  const dim3 grid((N + 255) / 256, chunks);
  if (dtype == MTT_BF16)
    colsum_kernel<bf16><<<grid, 256, 0, s>>>(static_cast<const bf16*>(x), dst, M, N,
                                             rows_per_chunk);
  else
    colsum_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), dst, M, N,
                                              rows_per_chunk);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  if (chunks == 1) return 0;
  return chunk_sum(dst, static_cast<float*>(out), N, chunks, s);
}
