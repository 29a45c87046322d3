// Weight gradients and column sums reduced over many rows, in a fixed order:
// C (N1, N2) = Aᵀ·B over the M rows of A (M, N1) and B (M, N2), in float,
// and the float column sums of a (M, N) matrix.
//
// Replaces the in-kernel weight-gradient accumulation of mirage_tpu/ops/
// fused_mlp.py:_mlp_bwd_stash_kernel (B9's backward, :713-727) and of the
// accumulating backwards (B7: fused_mlp.py:_mlp_bwd_kernel, block_attention.py:
// _attn_half_bwd_kernel): dW2 = actᵀ·dy and dW1 = yᵀ·dh summed in float over
// the rows, db2 = Σ dy. The TPU kernel adds each row block's products into
// one float accumulator across its sequential grid; blocks on Hopper run in
// parallel, so the rows are split into fixed chunks, each block writes its
// chunk's float partial of one tile of C, and a second kernel sums the
// chunks in chunk order. No atomics: a rerun is bit-identical.
//
// wgrad_bf16_kernel: one CTA a 128 × 256 tile of C and a row chunk, three
// warpgroups: one thread of the first keeps a ring of four 48 KB stages
// filled by TMA (64 rows of the chunk a stage: A's 128 tile columns in two
// 64 × 64 boxes, B's 256 in four, 128-byte swizzled), the other two each
// multiply 64 rows of C on the tensor cores (wgmma m64n256k16, float
// accumulate). Both operands are MN-major, the reduction running over
// their rows: wgmma reads them as they lie, with its transpose bits set,
// so nothing is transposed in registers or in memory. Rows past the chunk
// never enter a stage (chunks are whole 64-row slices) and rows past M
// read as zeros. Bound: operations at the MLP's shapes (2·M·N1·N2 FLOPs
// against reading A and B once). The float path is a 64 × 64 FMA tile,
// for the float32 checks. The first version ran mma.sync on four warps
// with cp.async and ldmatrix.trans (≈ 170 TFLOP/s). What a later PR
// changes first: a persistent grid (the last wave of tiles × chunks runs
// part-empty) and the epilogue's 8-byte float stores straight from the
// fragments.
//
// The task-strided entries (mtt_wgrad_tasks, mtt_colsum_tasks: the
// task-batched decoder tails) reduce T stacks of one shape in one launch:
// one (N1, N2) gradient (or N column sums) a task, the task and the row
// chunk sharing the grid's z axis (z = task · chunks + chunk), A and B as
// 3-D tensor maps over the task stack (a chunk never reads another task's
// rows), the partials (T, chunks, ·) summed per task in chunk order. Each
// task's result is bit-equal to a one-task launch's.
#include "common.cuh"
#include "wgmma.cuh"

constexpr int WM = 128, WN = 256, WK = 64, WSTAGES = 4;  // C tile, rows a stage
constexpr int WBOX = WK * 64 * 2;                        // a 64-row × 64-column box
constexpr int W_B = (WM / 64) * WBOX, W_STAGE_BYTES = W_B + (WN / 64) * WBOX;
constexpr int W_SMEM = 1024 + WSTAGES * W_STAGE_BYTES + 16 * WSTAGES;

// Block (x, y, z) computes C[y·WM.., x·WN..] over rows [z·rows_per_chunk,
// ...) into part (chunks, N1, N2) (C itself when there is one chunk).
// full[s] counts a stage's bytes in, empty[s] the eight computing warps
// done with it.
template <bool TASKS>
__global__ void __launch_bounds__(384, 1)
    wgrad_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, float* __restrict__ part, int M,
                      int N1, int N2, int rows_per_chunk, int chunks) {
  extern __shared__ unsigned char wgrad_smem_raw[];
  const uint32_t sbase = (smem_u32(wgrad_smem_raw) + 1023) & ~1023u;  // the swizzle's period
  const uint32_t full = sbase + WSTAGES * W_STAGE_BYTES, empty = full + 8 * WSTAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int i0 = blockIdx.y * WM, j0 = blockIdx.x * WN, z = blockIdx.z;
  // z = task · chunks + chunk (a one-task launch: the chunk)
  const int task = TASKS ? z / chunks : 0, chunk = z - task * chunks;
  const int r0 = chunk * rows_per_chunk, rows = min(M, r0 + rows_per_chunk) - r0;
  const int slices = (rows + WK - 1) / WK;
  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < slices; ++kt) {
        const int s = kt % WSTAGES, r = r0 + kt * WK;
        mbar_wait(empty + 8 * s, ((kt / WSTAGES) & 1) ^ 1);  // first round: free
        const uint32_t st = sbase + s * W_STAGE_BYTES, bar = full + 8 * s;
        mbar_expect_tx(bar, W_STAGE_BYTES);
        if constexpr (TASKS) {
#pragma unroll
          for (int b = 0; b < WM / 64; ++b)
            tma_load_3d(st + b * WBOX, &map_a, bar, i0 + 64 * b, r, task);
#pragma unroll
          for (int b = 0; b < WN / 64; ++b)
            tma_load_3d(st + W_B + b * WBOX, &map_b, bar, j0 + 64 * b, r, task);
        } else {
#pragma unroll
          for (int b = 0; b < WM / 64; ++b)
            tma_load_2d(st + b * WBOX, &map_a, bar, i0 + 64 * b, r);
#pragma unroll
          for (int b = 0; b < WN / 64; ++b)
            tma_load_2d(st + W_B + b * WBOX, &map_b, bar, j0 + 64 * b, r);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    float acc[WN / 2];
#pragma unroll
    for (int j = 0; j < WN / 2; ++j) acc[j] = 0.f;
    fence_regs(acc);
    for (int kt = 0; kt < slices; ++kt) {
      const int s = kt % WSTAGES;
      mbar_wait(full + 8 * s, (kt / WSTAGES) & 1);
      const uint32_t st = sbase + s * W_STAGE_BYTES;
      const uint64_t da = wgmma_desc_mn(st + cw * WBOX, WBOX), db = wgmma_desc_mn(st + W_B, WBOX);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < WK / 16; ++k) wgmma_n256<1, 1>(acc, da + 128 * k, db + 128 * k);
      wgmma_commit();
      wgmma_wait<1>();  // the products on slice kt-1 are done: hand its stage back
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % WSTAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // fragments: rows l/4 and l/4 + 8 of the warp's 16, columns 8j + 2(l%4)
    float* out = part + (long long)z * N1 * N2;
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + cw * 64 + warp * 16 + gid + 8 * half;
      if (i >= N1) continue;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = j0 + 8 * j + 2 * tig;
        if (col < N2)  // N2 % 8 == 0: a column pair is wholly in or out
          *reinterpret_cast<float2*>(out + (long long)i * N2 + col) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

constexpr int FT = 64, FK = 16;

__global__ void __launch_bounds__(256)
    wgrad_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ part, int M, int N1, int N2, int rows_per_chunk,
                     int chunks) {
  __shared__ float at[FK][FT + 4];  // at[k][i]
  __shared__ float bt[FK][FT + 4];  // bt[k][j]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * FT, j0 = blockIdx.x * FT, z = blockIdx.z;
  const int task = z / chunks, chunk = z - task * chunks;
  A += (long long)task * M * N1;
  B += (long long)task * M * N2;
  const int r_begin = chunk * rows_per_chunk, r_end = min(M, r_begin + rows_per_chunk);
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
// (blockIdx.y = task · chunks + chunk: task's rows of X (tasks, M, N))
template <typename T>
__global__ void __launch_bounds__(256)
    colsum_kernel(const T* __restrict__ X, float* __restrict__ part, int M, int N,
                  int rows_per_chunk, int chunks) {
  const int col = blockIdx.x * 256 + threadIdx.x, z = blockIdx.y;
  if (col >= N) return;
  const int task = z / chunks, chunk = z - task * chunks;
  X += (long long)task * M * N;
  const int r_end = min(M, (chunk + 1) * rows_per_chunk);
  float s = 0.f;
  for (int r = chunk * rows_per_chunk; r < r_end; ++r) s += to_f(X[(long long)r * N + col]);
  part[(long long)z * N + col] = s;
}

// out[t][i] = Σ_z part[t][z][i], z in order, for each of `tasks` tasks of
// n elements
__global__ void __launch_bounds__(256)
    chunk_sum_kernel(const float* __restrict__ part, float* __restrict__ out, long long n,
                     int chunks, int tasks) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= n * tasks) return;
  const long long t = e / n, i = e - t * n;
  const float* p = part + t * chunks * n;
  float s = 0.f;
  for (int z = 0; z < chunks; ++z) s += p[z * n + i];
  out[e] = s;
}

static int chunk_sum(const float* part, float* out, long long n, int chunks, int tasks,
                     cudaStream_t s) {
  chunk_sum_kernel<<<(unsigned)((n * tasks + 255) / 256), 256, 0, s>>>(part, out, n, chunks,
                                                                       tasks);
  return (int)cudaGetLastError();
}

static int wgrad(const void* a, const void* b, void* c, void* part, int M, int N1, int N2,
                 int tasks, int chunks, int rows_per_chunk, int dtype, void* stream) {
  if (M <= 0 || N1 <= 0 || N2 <= 0 || tasks <= 0 || chunks <= 0 || rows_per_chunk <= 0 ||
      (long long)tasks * chunks > 65535 || (long long)chunks * rows_per_chunk < M ||
      (chunks > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(chunks > 1 ? part : c);
  if (dtype == MTT_BF16) {
    if (N1 % 8 || N2 % 8 || rows_per_chunk % WK || reinterpret_cast<uintptr_t>(a) % 16 ||
        reinterpret_cast<uintptr_t>(b) % 16)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((N2 + WN - 1) / WN, (N1 + WM - 1) / WM, tasks * chunks);
    CUtensorMap map_a, map_b;
    if (tasks > 1) {
      static SmemLimit limit;
      if (int err = set_smem(wgrad_bf16_kernel<true>, W_SMEM, limit)) return err;
      if (!make_task_map(&map_a, a, tasks, M, N1, WK, 64) ||
          !make_task_map(&map_b, b, tasks, M, N2, WK, 64))
        return (int)cudaErrorInvalidValue;
      wgrad_bf16_kernel<true><<<grid, 384, W_SMEM, s>>>(map_a, map_b, dst, M, N1, N2,
                                                        rows_per_chunk, chunks);
    } else {
      static SmemLimit limit;
      if (int err = set_smem(wgrad_bf16_kernel<false>, W_SMEM, limit)) return err;
      if (!make_map(&map_a, a, M, N1, WK, 64) || !make_map(&map_b, b, M, N2, WK, 64))
        return (int)cudaErrorInvalidValue;
      wgrad_bf16_kernel<false><<<grid, 384, W_SMEM, s>>>(map_a, map_b, dst, M, N1, N2,
                                                         rows_per_chunk, chunks);
    }
  } else {
    wgrad_f32_kernel<<<dim3((N2 + FT - 1) / FT, (N1 + FT - 1) / FT, tasks * chunks), 256, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), dst, M, N1, N2,
        rows_per_chunk, chunks);
  }
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  if (chunks == 1) return 0;
  return chunk_sum(dst, static_cast<float*>(c), (long long)N1 * N2, chunks, tasks, s);
}

// a (M, N1), b (M, N2) -> c (N1, N2) float = aᵀ·b. The rows are split into
// `chunks` chunks of rows_per_chunk; with more than one, part (chunks, N1,
// N2) float holds the partials, summed into c in chunk order. bf16 needs N1
// and N2 multiples of 8, rows_per_chunk a multiple of 64 and 16-byte
// aligned a and b (ops/runtime.py:wgrad_chunks plans the chunks).
extern "C" int mtt_wgrad(const void* a, const void* b, void* c, void* part, int M, int N1,
                         int N2, int chunks, int rows_per_chunk, int dtype, void* stream) {
  return wgrad(a, b, c, part, M, N1, N2, 1, chunks, rows_per_chunk, dtype, stream);
}

// The task-strided form: a (tasks, M, N1), b (tasks, M, N2) -> c (tasks,
// N1, N2), each task's rows split as mtt_wgrad splits M rows; part (tasks,
// chunks, N1, N2) when chunks > 1.
extern "C" int mtt_wgrad_tasks(const void* a, const void* b, void* c, void* part, int M, int N1,
                               int N2, int tasks, int chunks, int rows_per_chunk, int dtype,
                               void* stream) {
  return wgrad(a, b, c, part, M, N1, N2, tasks, chunks, rows_per_chunk, dtype, stream);
}

static int colsum(const void* x, void* out, void* part, int M, int N, int tasks, int chunks,
                  int rows_per_chunk, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || tasks <= 0 || chunks <= 0 || rows_per_chunk <= 0 ||
      (long long)tasks * chunks > 65535 || (long long)chunks * rows_per_chunk < M ||
      (chunks > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(chunks > 1 ? part : out);
  const dim3 grid((N + 255) / 256, tasks * chunks);
  if (dtype == MTT_BF16)
    colsum_kernel<bf16><<<grid, 256, 0, s>>>(static_cast<const bf16*>(x), dst, M, N,
                                             rows_per_chunk, chunks);
  else
    colsum_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), dst, M, N,
                                              rows_per_chunk, chunks);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  if (chunks == 1) return 0;
  return chunk_sum(dst, static_cast<float*>(out), N, chunks, tasks, s);
}

// x (M, N) -> out (N) float column sums, rows split as in mtt_wgrad; part
// (chunks, N) float when chunks > 1.
extern "C" int mtt_colsum(const void* x, void* out, void* part, int M, int N, int chunks,
                          int rows_per_chunk, int dtype, void* stream) {
  return colsum(x, out, part, M, N, 1, chunks, rows_per_chunk, dtype, stream);
}

// The task-strided form: x (tasks, M, N) -> out (tasks, N); part (tasks,
// chunks, N) when chunks > 1.
extern "C" int mtt_colsum_tasks(const void* x, void* out, void* part, int M, int N, int tasks,
                                int chunks, int rows_per_chunk, int dtype, void* stream) {
  return colsum(x, out, part, M, N, tasks, chunks, rows_per_chunk, dtype, stream);
}
