// Warp-level tile helpers of the mma.sync attention stage of csrc/fused_block.cu:
// staging rows of a (rows, DH) bf16 operand into shared
// memory, loading a warp's 16 rows as A fragments, and the two products of
// attention, S = A·tileᵀ and O += P·tile, on m16n8k16 tensor-core MMAs with
// float accumulation. Tiles are stored with a padded row stride of DH + 8
// elements, so the eight rows an ldmatrix reads fall on distinct banks.
#pragma once

#include "common.cuh"

constexpr int BT = 64;  // rows a block owns: queries or keys

// rows streamed per chunk: 64, or 32 at wide heads to bound the registers
template <int DH>
__host__ __device__ constexpr int chunk_rows() {
  return DH <= 64 ? 64 : 32;
}

// rows [row0, row0 + rows) of src (row stride rs) into a rows × (DH + 8)
// shared tile; rows at or past n are zero-filled
template <int DH>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int rows, int n,
                                           int rs) {
  constexpr int DS = DH + 8, CPR = DH / 8;
  for (int e = threadIdx.x; e < rows * CPR; e += blockDim.x) {
    const int r = e / CPR, c = (e - r * CPR) * 8, g = row0 + r;
    const bool ok = g < n;
    cp_async16(smem_u32(dst + r * DS + c), ok ? src + (long long)g * rs + c : src, ok ? 16 : 0);
  }
}

// this warp's 16 rows of a shared tile, from row row0, as A fragments
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4], const bf16* tile, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kt = 0; kt < DH / 16; ++kt)
    ldmatrix_x4(a[kt], smem_u32(tile + (row0 + (lane & 15)) * (DH + 8) + kt * 16 + (lane >> 4) * 8));
}

// acc (16 × 8·NB) += A (16 × DH) · tileᵀ, tile = 8·NB rows × DH
template <int DH, int NB>
__device__ __forceinline__ void mma_abt(float (&acc)[NB][4], uint32_t (&a)[DH / 16][4],
                                        const bf16* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kt = 0; kt < DH / 16; ++kt)
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, smem_u32(tile + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * (DH + 8) +
                              kt * 16 + ((lane >> 3) & 1) * 8));
      mma_bf16_16816(acc[j], a[kt], r[0], r[1]);
      mma_bf16_16816(acc[j + 1], a[kt], r[2], r[3]);
    }
}

// acc (16 × DH) += P (16 × 16·KB) · tile, tile = 16·KB rows × DH
template <int DH, int KB>
__device__ __forceinline__ void mma_ab(float (&acc)[DH / 8][4], uint32_t (&p)[KB][4],
                                       const bf16* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk)
#pragma unroll
    for (int n = 0; n < DH / 8; n += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, smem_u32(tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * (DH + 8) +
                                    n * 8 + (lane >> 4) * 8));
      mma_bf16_16816(acc[n], p[kk], r[0], r[1]);
      mma_bf16_16816(acc[n + 1], p[kk], r[2], r[3]);
    }
}

// an accumulator (rows gid and gid + 8, columns 8j + 2·tig and + 1) rounded
// to bf16 A fragments of the next product (its columns become the k index)
template <int NB>
__device__ __forceinline__ void to_a(uint32_t (&a)[NB / 2][4], float (&c)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    a[j >> 1][(j & 1) * 2] = pack_bf16(c[j][0], c[j][1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(c[j][2], c[j][3]);
  }
}
