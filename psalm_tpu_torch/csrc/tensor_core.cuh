// Tensor-core and asynchronous-copy helpers for the bf16 attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): cp.async tile copies into
// shared memory, ldmatrix fragment loads and the warp-level bf16 product
// mma.sync m16n8k16 with f32 accumulators.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (lane = 4 g + t):
//   A, 16 x 16 (rows x depth), 4 registers of two bf16 each:
//     a0 (row g, depth 2t..2t+1), a1 (row g+8, 2t..), a2 (row g, 8+2t..),
//     a3 (row g+8, 8+2t..);
//   B, 16 x 8 (depth x columns), 2 registers: b0 (depth 2t..2t+1, column
//     g), b1 (depth 8+2t.., column g);
//   C, 16 x 8 f32: c0, c1 (row g, columns 2t, 2t+1), c2, c3 (row g+8, ...).
// So the C fragments of two neighbouring 8-column blocks are, rounded to
// bf16 in pairs, the A fragment of a product over those 16 columns: a
// probability tile goes from one product into the next without leaving the
// registers.
//
// Shared-memory tiles hold rows of HD bf16 followed by kPad bf16 of
// padding: a row stride of HD + 8 elements moves each row by 16 bytes
// against the 128-byte bank window, so the eight 16-byte rows that one
// ldmatrix phase reads lie in different banks.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace psalm {

constexpr int kPad = 8;  // bf16 of padding after each shared-memory row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-fills the destination when
// !valid (then nothing is read from src).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-fills when !valid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + kRows) of a row-major [L, HD] bf16 matrix into a
// [kRows, HD + kPad] shared tile, 16 bytes per copy, rows >= L zero-filled.
template <int HD, int kRows, int kThreads>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int r0, int L) {
  constexpr int kChunks = HD / 8;  // 16-byte pieces per row
  static_assert((kRows * kChunks) % kThreads == 0, "whole copy rounds");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int c = i * kThreads + static_cast<int>(threadIdx.x);
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool valid = r0 + r < L;
    const __nv_bfloat16* s =
        src + static_cast<long long>(valid ? r0 + r : 0) * HD + col;
    cp_async_16(dst + r * (HD + kPad) + col, s, valid);
  }
}

// Entries [r0, r0 + n) of an f32 vector into shared memory, 0 past L.
__device__ __forceinline__ void load_vec_async(float* dst, const float* src,
                                               int r0, int n, int L) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const bool valid = r0 + r < L;
    cp_async_4(dst + r, src + (valid ? r0 + r : 0), valid);
  }
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and receives row lane / 4, elements 2 (lane % 4) and +1, of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed: lane receives column lane / 4, rows
// 2 (lane % 4) and +1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The A fragment of rows [row0, row0 + 16), depth [k0, k0 + 16) of a padded
// row-major tile (row stride `stride` bf16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int stride,
                                       int row0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * stride + k0 + (lane >> 4) * 8);
}

// B fragments for two 8-column blocks [n0, n0 + 16) at depth [k0, k0 + 16)
// where the tile holds B transposed (row n = column n of B, as keys hold
// the columns of q k^T): b[0], b[1] for columns n0.., b[2], b[3] for n0+8...
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile,
                                            int stride, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments for two 8-column blocks [n0, n0 + 16) at depth [k0, k0 + 16)
// where the tile holds B as it is (row = depth, as values hold the rows of
// p v): b[0], b[1] for columns n0.., b[2], b[3] for n0+8...
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile,
                                            int stride, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  stride + n0 + (lane >> 4) * 8);
}

// d += a b, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Zeroes N C fragments.
template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int b = 0; b < N; ++b) {
    acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;
  }
}

// Two f32 rounded to bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment over 16 columns from the C fragments of their two 8-column
// blocks, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Max and sum over the four lanes of a quad (the lanes that share row g).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace psalm
