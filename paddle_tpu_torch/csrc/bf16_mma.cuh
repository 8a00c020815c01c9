// Device helpers of K4-bf16 (flash_bwd_fused_bf16.cu), the mma.sync bf16
// attention kernel; the bf16 type and pack_bf16 serve the wgmma kernels
// K1-bf16 and K2-bf16 (sm90.cuh) as well.
//
// The arithmetic. Every product is mma.sync.m16n8k16 with bf16 operands and
// an fp32 accumulator (HMMA.16816.F32.BF16 on sm_90a): the products of two
// bf16 values are exact in fp32, and the sum is fp32, as the Pallas bodies'
// jnp.dot(..., preferred_element_type=f32) on bf16 operands. A value that
// the reference rounds to bf16 before a product (P, dS) is rounded to
// nearest even by cvt.rn.bf16x2.f32 as it is packed into the next product's
// A operand.
//
// The fragments (g = lane / 4, c = lane % 4). A (16 x 16) holds rows g and
// g + 8, depth columns 2c, 2c + 1 (a0, a1) and 2c + 8, 2c + 9 (a2, a3); B
// (16 x 8) depth rows 2c, 2c + 1 (b0) and 2c + 8, 2c + 9 (b1) of column g;
// the accumulator rows g (d0, d1) and g + 8 (d2, d3), columns 2c, 2c + 1.
// So the accumulators of two neighbouring 8-wide column tiles are, packed
// in pairs, the A operand of a product whose depth is those 16 columns
// (acc_pair_to_a). ldmatrix moves 16-bit pairs; its .trans form hands a
// thread two elements of one column, so a tile can feed a product as it
// lies or transposed: A or B^T from a row-major tile by ldmatrix, B or A^T
// by ldmatrix.trans. Tiles in shared memory have rows of D + 8 bf16: 16-byte
// aligned for cp.async and ldmatrix, and the 8 rows that one ldmatrix
// matrix reads fall on 8 distinct 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tf32x3.cuh"  // cp.async (16 and 4 bytes) and its group helpers

namespace {

typedef __nv_bfloat16 bf16;

// d += a b: a 16 x 16, b 16 x 8, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to nearest even and packed: lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// four 8 x 8 matrices of 16-bit values; lane l gives the address of row
// l % 8 of matrix l / 8. Without .trans a thread gets elements 2c, 2c + 1
// of row g of each; with .trans elements (2c, g) and (2c + 1, g)
__device__ __forceinline__ void ldsm4_b16(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm4_b16t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Lane offsets into a tile of rows of STR bf16, at the top-left corner of
// a 16 x 16 block:
// - off_a: rows 0-15 of columns 0-7, then of columns 8-15. Without .trans
//   it gives the A fragment of the block (a0..a3); with .trans the B
//   fragments of the block taken as B (rows = depth) for its two 8-wide
//   column tiles (b0, b1 of columns 0-7, then b0, b1 of columns 8-15).
// - off_b: columns 0-15 of rows 0-7, then of rows 8-15. Without .trans it
//   gives the B fragments of B = block^T for its two 8-row tiles (b0, b1
//   of rows 0-7, then of rows 8-15); with .trans the A fragment of
//   A = block^T.
template <int STR>
__device__ __forceinline__ int off_a(int lane) {
  return (lane & 15) * STR + 8 * (lane >> 4);
}

template <int STR>
__device__ __forceinline__ int off_b(int lane) {
  return ((lane & 7) + 8 * (lane >> 4)) * STR + 8 * ((lane >> 3) & 1);
}

// The accumulators of column tiles x0 (columns 0-7) and x1 (8-15), rounded
// to bf16, as the A operand of a product over those 16 columns
__device__ __forceinline__ void acc_pair_to_a(uint32_t (&a)[4],
                                              const float (&x0)[4],
                                              const float (&x1)[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

// acc[n] += A B for the D / 8 column tiles of a tile B whose rows are the
// depth (16 of them at p = tile + k0 * STR), read by ldmatrix.trans
template <int ND, int STR>
__device__ __forceinline__ void mma_rows_bf16(float (&acc)[ND][4],
                                              const uint32_t (&a)[4],
                                              const bf16* p, int lane) {
  const bf16* at = p + off_a<STR>(lane);
#pragma unroll
  for (int n = 0; n < ND; n += 2) {
    uint32_t f[4];
    ldsm4_b16t(f, at + 8 * n);
    mma_bf16(acc[n], a, f[0], f[1]);
    mma_bf16(acc[n + 1], a, f[2], f[3]);
  }
}

// Row i (g or g + 8) of accumulators acc[ND] (column tile n holds columns
// 8n + 2c, 8n + 2c + 1), times mul and rounded to bf16, into out (the row's
// first element; 4-byte stores)
template <int ND>
__device__ __forceinline__ void store_row_bf16(bf16* out,
                                               const float (&acc)[ND][4],
                                               int i, int c, float mul) {
#pragma unroll
  for (int n = 0; n < ND; ++n)
    *reinterpret_cast<uint32_t*>(out + 8 * n + 2 * c) =
        pack_bf16(mul * acc[n][2 * i], mul * acc[n][2 * i + 1]);
}

// start copying rows [r0, r0 + ROWS) of a (rows, D) bf16 head slice with
// row stride st into a tile of rows of D + 8 bf16, THREADS threads taking
// 16 bytes (8 values) each in turn; rows at or past n are zero-filled
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void copy_tile_bf16(bf16* dst, const bf16* src,
                                               long long st, int r0, int n) {
  constexpr int D8 = D / 8;
  for (int i = threadIdx.x; i < ROWS * D8; i += THREADS) {
    const int r = i / D8, c = (i % D8) * 8;
    const bool ok = r0 + r < n;
    cp_async16(reinterpret_cast<float*>(dst + r * (D + 8) + c),
               reinterpret_cast<const float*>(ok ? src + (r0 + r) * st + c
                                                 : src),
               ok);
  }
}

}  // namespace
