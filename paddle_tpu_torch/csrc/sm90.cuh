// Hopper (sm_90a) building blocks of the bf16 attention kernels K1-bf16
// (flash_fwd_bf16.cu), K2-bf16 (flash_bwd_bf16.cu) and K4-bf16
// (flash_bwd_fused_bf16.cu): the bf16 type, mbarriers, TMA tile copies and
// reductions, warpgroup matrix multiplies (wgmma) and their shared-memory
// descriptors, stmatrix, register hand-over between warpgroups
// (setmaxnreg), and the host side's tensor maps.
//
// The tiles. Every bf16 tile in shared memory is one or more "boxes" of
// rows x 64 values: 128-byte rows, the 16-byte chunks of row r stored at
// chunk c ^ (r % 8) (the 128-byte swizzle), each box 1024-byte aligned. A
// TMA copy with CU_TENSOR_MAP_SWIZZLE_128B writes exactly that, and a
// wgmma descriptor of layout "128B swizzle" reads it either way round:
// - K-major (rows are M or N, the 64 values of a row the depth): 8-row
//   groups 1024 bytes apart (SBO); a 16-deep step is +32 bytes of the
//   start address inside the box, the next 64 of the depth the next box.
// - N-major (rows are the depth, the values of a row N; only B, through
//   the descriptor's transpose bit): 8-row groups of the depth 1024 bytes
//   apart (SBO), the next 64 of N the next box (LBO = the box's bytes); a
//   16-deep step is +2048 bytes.
// So a row-major tile of K, V, Q or dO is read as it lies, as B^T or as
// B, and no tile is ever transposed. A may be read N-major too ("MN-major",
// the transpose bit of A; wgmma_ss_ta_n32), with the same offsets.
//
// The fragments (one warpgroup, 128 threads; warp w, lane l, g = l / 4,
// c = l % 4). An m64nN accumulator holds d[4j + 2i + e] = element (16w + g
// + 8i, 8j + 2c + e). A register A operand (64 x 16 bf16) holds, in four
// bf16 pairs, rows 16w + g and + 8 at depth 2c, 2c + 1 and 2c + 8, 2c + 9:
// the accumulator's columns 16k .. 16k + 15, rounded and packed in order
// (acc_to_a), are the A operand of a product whose depth is those columns.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <unordered_map>
#include <utility>
#include <vector>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;

// two fp32 values rounded to nearest even (cvt.rn.bf16x2.f32) and packed:
// lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces the bytes the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// until the phase of parity ``parity`` has completed. The loop is inside
// the asm, so the compiler sees no divergent branch before the products
// that follow (a divergent one makes ptxas serialise every wgmma).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one arrival from lane 0 of the warp, as a predicated instruction (no
// branch)
__device__ __forceinline__ void mbar_arrive_lane0(uint64_t* bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(lane)
      : "memory");
}

// the warpgroup (and warp) of the calling thread, which the compiler then
// knows to be the same across the warp
__device__ __forceinline__ int warpgroup_idx() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
}

__device__ __forceinline__ int warp_in_warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x % 128 / 32),
                     0);
}

// ---- TMA: one thread copies a box; the barrier counts its bytes

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// ---- TMA reductions: one thread adds a box of shared memory into global
// memory (elements past the map's ends are left out); each thread tracks
// its own bulk groups. ``pred`` 0 makes each a no-op, without a branch.

__device__ __forceinline__ void tma_reduce_add_4d(int pred, const void* src,
                                                  const CUtensorMap* map,
                                                  int c0, int c1, int c2,
                                                  int c3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"(pred),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit(int pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.commit_group;\n}\n" ::"r"(pred)
      : "memory");
}

// until this thread's bulk groups have read their shared memory
__device__ __forceinline__ void bulk_wait_read(int pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.wait_group.read 0;\n}\n" ::"r"(pred)
      : "memory");
}

// until this thread's bulk groups have completed
__device__ __forceinline__ void bulk_wait(int pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
      "@p cp.async.bulk.wait_group 0;\n}\n" ::"r"(pred)
      : "memory");
}

// makes this thread's shared-memory stores visible to the async proxy
// (wgmma operands, TMA sources) once a barrier has ordered them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// four 8 x 8 bf16 matrices, each held as an accumulator's fragment (thread
// l: row l / 4, columns 2 (l % 4) and + 1, one bf16 pair a register),
// stored transposed: lane l gives the address of stored row l % 8 (the
// matrix's column) of matrix l / 8
__device__ __forceinline__ void stmatrix_x4_trans(void* p,
                                                  const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};"
      ::"r"(smem_u32(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// ---- named barriers (id 0 is __syncthreads'): ``n`` threads meet

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Two consumer warpgroups take turns to issue their first products of a
// tile (ping-pong): warpgroup w waits on barrier 1 + w before it issues
// and then lets the other go, so one warpgroup's softmax runs while the
// other's products hold the tensor cores. Both must take the same number
// of turns; warpgroup 1 gives warpgroup 0 the first one.
__device__ __forceinline__ void turns_begin(int wg) {
  if (wg == 1) named_arrive(1, 256);
}

__device__ __forceinline__ void turn_wait(int wg) { named_sync(1 + wg, 256); }

__device__ __forceinline__ void turn_pass(int wg) {
  named_arrive(2 - wg, 256);
}

// ---- warp roles: registers handed from the producer to the consumers

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// ---- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a 128-byte-swizzled tile at p (see the top of this file);
// lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// d (+)= A B, A (64 x 16) and B (16 x 32) in shared memory (descriptors),
// both K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B, A (64 x 16) N-major ("MN-major": rows are the depth, through
// the transpose bit of A) and B (16 x 32) K-major, both in shared memory;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_ta_n32(float (&d)[16], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B, A (64 x 16) and B (16 x 64) in shared memory (descriptors),
// both K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, A (64 x 16, bf16 pairs) in registers, B (16 x 64) in shared
// memory N-major (read through the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (+)= A B, A (64 x 16) and B (16 x 128) in shared memory (descriptors),
// both K-major; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, A (64 x 16, bf16 pairs) in registers, B (16 x 128) in shared
// memory N-major (read through the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the products by N: S-like (both operands K-major in shared memory) and
// P V-like (A in registers, B N-major in shared memory)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32)
    wgmma_ss_n32(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n128(d, a, db);
}

// the accumulator's columns 16k .. 16k + 15, rounded to bf16, as the A
// operand of the next product's k-th 16-deep step
template <int NA>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[NA / 8][4],
                                         const float (&x)[NA]) {
#pragma unroll
  for (int k = 0; k < NA / 8; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[k][r] = pack_bf16(x[8 * k + 2 * r], x[8 * k + 2 * r + 1]);
}

// ---- host: what a launch needs besides its arguments, cached
//
// The bf16 step is host-bound (thousands of launches a step), so a launch
// asks the runtime and the driver nothing that an earlier launch on the
// same host thread has had answered: the card's SM count and each kernel's
// shared-memory limit once a device, each tensor map once for each exact
// set of its inputs.

// the card's SMs, the persistent grids' size (0 if the runtime cannot say)
inline int sm_count(int device) {
  static thread_local std::vector<int> sms;
  if (static_cast<size_t>(device) >= sms.size()) sms.resize(device + 1, 0);
  int& n = sms[device];
  if (n == 0 &&
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    n = 0;
  return n;
}

// lets ``kernel`` take ``bytes`` of dynamic shared memory on ``device``,
// the current one. The setting lasts as long as the device's context, so
// it is made once a device; ``bytes`` is a constant of the kernel.
inline cudaError_t allow_smem(const void* kernel, int device, int bytes) {
  static thread_local std::vector<std::pair<const void*, int>> done;
  for (const auto& e : done)
    if (e.first == kernel && e.second == device) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.emplace_back(kernel, device);
  return err;
}

// what a kernel entry point returns when a map cannot be made: this plus
// the CUresult (cuda.h), or this alone when the driver has no encoder;
// map_refusal then describes the map
constexpr int MAP_ERROR = 100000;
thread_local char map_refusal[512];

// everything a tensor map is encoded from: the map holds nothing else, so
// a map cached under its key is the one the driver would encode again
struct MapKey {
  const void* base;
  cuuint64_t dims[4];
  cuuint64_t strides[3];  // bytes, of axes 1 .. rank - 1
  cuuint32_t box[4];
  uint32_t rank, type, swizzle, l2;
};
static_assert(sizeof(MapKey) == 96, "MapKey must have no padding");

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {  // FNV-1a over its words
    const uint64_t* w = reinterpret_cast<const uint64_t*>(&k);
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < sizeof(MapKey) / 8; ++i)
      h = (h ^ w[i]) * 1099511628211ull;
    return static_cast<size_t>(h ^ (h >> 32));
  }
};

struct MapKeyEq {
  bool operator()(const MapKey& a, const MapKey& b) const {
    return memcmp(&a, &b, sizeof(MapKey)) == 0;
  }
};

struct MapBytes {  // a CUtensorMap's bytes, without its 64-byte alignment
  uint64_t w[16];
};
static_assert(sizeof(CUtensorMap) == sizeof(MapBytes), "CUtensorMap size");

// at most this many maps a host thread; past it the cache starts again
constexpr size_t MAP_CACHE_MAX = 4096;

inline int refused(CUresult r, const char* what, const MapKey& key) {
  int n = snprintf(map_refusal, sizeof map_refusal,
                   "cuTensorMapEncodeTiled refused the tensor map of %s "
                   "(CUresult %d): base %p, dims", what, static_cast<int>(r),
                   key.base);
  for (uint32_t i = 0; i < key.rank; ++i)
    n += snprintf(map_refusal + n, sizeof map_refusal - n, " %llu",
                  static_cast<unsigned long long>(key.dims[i]));
  n += snprintf(map_refusal + n, sizeof map_refusal - n, ", byte strides");
  for (uint32_t i = 0; i + 1 < key.rank; ++i)
    n += snprintf(map_refusal + n, sizeof map_refusal - n, " %llu",
                  static_cast<unsigned long long>(key.strides[i]));
  n += snprintf(map_refusal + n, sizeof map_refusal - n, ", box");
  for (uint32_t i = 0; i < key.rank; ++i)
    n += snprintf(map_refusal + n, sizeof map_refusal - n, " %u",
                  key.box[i]);
  return MAP_ERROR + static_cast<int>(r);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// the map of ``key`` (``what`` names it), from this thread's cache or
// encoded (elements one apart, not interleaved, no fill past the ends).
// Returns 0 or a MAP_ERROR code; a refused map is not cached.
inline int tensor_map(CUtensorMap* map, const char* what, const MapKey& key) {
  static thread_local std::unordered_map<MapKey, MapBytes, MapKeyHash,
                                         MapKeyEq>
      cache;
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    memcpy(map, &hit->second, sizeof(CUtensorMap));
    return 0;
  }
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return MAP_ERROR;
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, static_cast<CUtensorMapDataType>(key.type), key.rank,
      const_cast<void*>(key.base), key.dims, key.strides, key.box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      static_cast<CUtensorMapSwizzle>(key.swizzle),
      static_cast<CUtensorMapL2promotion>(key.l2),
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return refused(r, what, key);
  if (cache.size() >= MAP_CACHE_MAX) cache.clear();
  memcpy(&cache[key], map, sizeof(CUtensorMap));
  return 0;
}

// A bf16 head tensor (``what`` names it) as a 4-D map over (Dh, H, T, B),
// its (batch, time, head) element strides as given (the head dim
// contiguous), read in boxes of 64 values x 1 head x ``rows`` rows x 1
// batch, 128-byte swizzled; reads past T fill zeros. With ``fp32`` the
// tensor holds fp32 values, in boxes of 32 (128 bytes a row, as well).
// Returns 0 or a MAP_ERROR code.
inline int head_map(CUtensorMap* map, const char* what, const void* base,
                    int D, int H, int T, int B, const long long* st,
                    int rows, bool fp32 = false) {
  const int size = fp32 ? 4 : 2;
  MapKey key{};
  key.base = base;
  key.dims[0] = static_cast<cuuint64_t>(D);
  key.dims[1] = static_cast<cuuint64_t>(H);
  key.dims[2] = static_cast<cuuint64_t>(T);
  key.dims[3] = static_cast<cuuint64_t>(B);
  // a stride of an axis of size 1 is never used: any valid one will do
  key.strides[0] = H > 1 ? static_cast<cuuint64_t>(st[2]) * size : 16;
  key.strides[1] = T > 1 ? static_cast<cuuint64_t>(st[1]) * size : 16;
  key.strides[2] = B > 1 ? static_cast<cuuint64_t>(st[0]) * size : 16;
  key.box[0] = 128 / size;
  key.box[1] = 1;
  key.box[2] = static_cast<cuuint32_t>(rows);
  key.box[3] = 1;
  key.rank = 4;
  key.type = fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  key.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  key.l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;
  return tensor_map(map, what, key);
}

// n fp32 values (``what`` names them) as a 1-D map read in boxes of
// ``box`` values (zeros past n). Returns 0 or a MAP_ERROR code.
inline int row_map(CUtensorMap* map, const char* what, const float* base,
                   long long n, int box) {
  MapKey key{};
  key.base = base;
  key.dims[0] = static_cast<cuuint64_t>(n);
  key.strides[0] = 16;  // none for one axis; never read
  key.box[0] = static_cast<cuuint32_t>(box);
  key.rank = 1;
  key.type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  key.swizzle = CU_TENSOR_MAP_SWIZZLE_NONE;
  key.l2 = CU_TENSOR_MAP_L2_PROMOTION_NONE;
  return tensor_map(map, what, key);
}

// the message of an entry point's error code
inline const char* error_string(int err) {
  if (err == MAP_ERROR)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (err > MAP_ERROR) return map_refusal;
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace
