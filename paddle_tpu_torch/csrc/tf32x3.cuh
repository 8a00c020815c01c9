// Device helpers of the attention kernels that run their fp32 products on
// Hopper's tensor cores in 3xTF32: K1 (flash_fwd.cu), K2 (flash_bwd.cu) and
// K4 (flash_bwd_fused.cu).
//
// The arithmetic. An fp32 operand x is split into big = x rounded to TF32
// and small = x - big, and a product is small*big + big*small, then
// big*big, summed in fp32 (the order of CUTLASS's OpMultiplyAddFastF32;
// small*small is dropped), each as one mma.sync.m16n8k8 TF32 (HMMA on
// sm_90a). big is rounded to nearest, ties away from zero, by adding 0x1000
// to the bits and masking the low 13: for finite x that is what
// cvt.rna.tf32.f32 gives, in two integer instructions, where the cvt
// compiles to a longer sequence on sm_90a (it also sorts out NaN and
// infinity). small is exact in fp32 and goes to the tensor core as it is;
// the tensor core reads its top 19 bits (a truncation to TF32), so its
// error is below 2^-21 of x, the order of the small*small term that 3xTF32
// drops anyway. tests/test_torch_tf32x3.py emulates all of it on the CPU.
//
// The fragments. An m16n8k8 A fragment holds rows g and g + 8, depth
// columns c and c + 4 (g = lane / 4, c = lane % 4); a B fragment depth rows
// c and c + 4, column g; the accumulator rows g, g + 8, columns 2c, 2c + 1.
// A and transposed-B fragments come from shared memory by ldmatrix
// (ldmatrix moves 32-bit words intact); an accumulator is the A operand of
// the next product when its 8 columns are taken as the depth in the order
// 0, 2, 4, 6, 1, 3, 5, 7, and the B operand is then read in the same order
// (mma_rows). Tiles in shared memory have rows of STR = D + 4 floats:
// 16-byte aligned for cp.async and ldmatrix, whose 8 row addresses then
// fall on 8 distinct 4-bank groups.

#pragma once

#include <stdint.h>

namespace {

// x = big + small: big rounded to TF32 (nearest, ties away), small exact
template <int N>
struct Frag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    big[i] = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small[i] = __float_as_uint(x - __uint_as_float(big[i]));
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b to fp32 accuracy (3xTF32): the cross terms, then big x big
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// The same with the cross terms summed in an accumulator of their own, dc
// (add it to d at the end): they are 2^-11 of the product and are then
// summed at their own scale, and the two chains of dependent HMMAs run
// side by side
__device__ __forceinline__ void mma3_apart(float (&d)[4], float (&dc)[4],
                                           const Frag<4>& a,
                                           const Frag<2>& b) {
  mma_tf32(dc, a.small, b.big);
  mma_tf32(dc, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// four 8x8 matrices of 32-bit words; lane l gives the address of row l % 8
// of matrix l / 8 and gets word l % 4 of row l / 4 of each
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Lane offsets into a tile of rows of STR floats for ldsm4: an A fragment
// (rows 0-7 and 8-15 of columns 0-3, then of columns 4-7), and the B
// fragments of two 8-wide slices of the tile's rows, B = tile^T (columns
// 0-3 and 4-7 of rows 0-7, then of rows 8-15).
template <int STR>
__device__ __forceinline__ int a_offset(int lane) {
  const int m = lane >> 3, r = lane & 7;
  return (r + 8 * (m & 1)) * STR + 4 * (m >> 1);
}

template <int STR>
__device__ __forceinline__ int bt_offset(int lane) {
  const int m = lane >> 3, r = lane & 7;
  return (r + 8 * (m >> 1)) * STR + 4 * (m & 1);
}

// A (16 rows x 8 deep) at p = tile + r0 * STR + k0 + a_offset
__device__ __forceinline__ void load_a(Frag<4>& a, const float* p) {
  uint32_t x[4];
  ldsm4(x, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) a.set(i, __uint_as_float(x[i]));
}

// An A fragment already split: big and small from two tiles of the same
// layout, at the same offset
__device__ __forceinline__ void load_a_split(Frag<4>& a, const float* big,
                                             const float* small) {
  ldsm4(a.big, big);
  ldsm4(a.small, small);
}

// B (8 deep x 8 wide) = tile^T for tile rows n0.. and n0 + 8.., depth
// columns k0..; p = tile + n0 * STR + k0 + bt_offset
__device__ __forceinline__ void load_bt2(Frag<2>& b0, Frag<2>& b1,
                                         const float* p) {
  uint32_t x[4];
  ldsm4(x, p);
  b0.set(0, __uint_as_float(x[0]));
  b0.set(1, __uint_as_float(x[1]));
  b1.set(0, __uint_as_float(x[2]));
  b1.set(1, __uint_as_float(x[3]));
}

// An accumulator fragment (16 x 8: rows g, g + 8, columns 2c, 2c + 1) as
// the A operand of a product whose depth is its 8 columns, in the order
// 0, 2, 4, 6, 1, 3, 5, 7
__device__ __forceinline__ void acc_to_a(Frag<4>& a, const float (&x)[4]) {
  a.set(0, x[0]);
  a.set(1, x[2]);
  a.set(2, x[1]);
  a.set(3, x[3]);
}

// acc[n] += A B for N interleaved head-dim slices n of a tile whose rows
// are the depth: B's depth slots c and c + 4 are rows p and p + STR (rows
// 2c and 2c + 1 of the 8-row step), its column g of slice n is column
// g * W + n of the W slices interleaved across the head dim, so
// p = tile + (k0 + 2c) * STR + g * W (+ the first slice taken, where N < W)
template <int N, int STR, int W = N>
__device__ __forceinline__ void mma_rows(float (&acc)[N][4], const Frag<4>& a,
                                         const float* p) {
  float r0[N], r1[N];
#pragma unroll
  for (int u = 0; u < N / 4; ++u) {
    const float4 x = reinterpret_cast<const float4*>(p)[u];
    const float4 y = reinterpret_cast<const float4*>(p + STR)[u];
    r0[4 * u] = x.x;
    r0[4 * u + 1] = x.y;
    r0[4 * u + 2] = x.z;
    r0[4 * u + 3] = x.w;
    r1[4 * u] = y.x;
    r1[4 * u + 1] = y.y;
    r1[4 * u + 2] = y.z;
    r1[4 * u + 3] = y.w;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    Frag<2> b;
    b.set(0, r0[n]);
    b.set(1, r1[n]);
    mma3(acc[n], a, b);
  }
}

// Row i (g or g + 8) of interleaved accumulators, times mul, as the 2N
// contiguous head-dim columns 2cN.. that this thread holds: out[n] is
// slice n's column 2c, out[N + n] its column 2c + 1
template <int N>
__device__ __forceinline__ void store_row(float* out, const float (&acc)[N][4],
                                          int i, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < N / 4; ++u)
      reinterpret_cast<float4*>(out + h * N)[u] = make_float4(
          mul * acc[4 * u][2 * i + h], mul * acc[4 * u + 1][2 * i + h],
          mul * acc[4 * u + 2][2 * i + h], mul * acc[4 * u + 3][2 * i + h]);
}

// cp.async of 16 or 4 bytes; with valid false the destination is zeroed
// and nothing is read
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// start copying rows [r0, r0 + ROWS) of a (rows, D) head slice with row
// stride st into a tile of rows of D + 4 floats, THREADS threads taking
// 16 bytes each in turn; rows at or past n are zero-filled
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long st, int r0, int n) {
  constexpr int D4 = D / 4;
  for (int i = threadIdx.x; i < ROWS * D4; i += THREADS) {
    const int r = i / D4, c = (i % D4) * 4;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * (D + 4) + c, ok ? src + (r0 + r) * st + c : src, ok);
  }
}

}  // namespace
