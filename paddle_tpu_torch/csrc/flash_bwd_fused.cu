// K4: single-pass exact (flash) attention backward for Hopper, fp32 in and
// out, on the tensor cores in 3xTF32.
//
// Replaces paddle_tpu/ops/attention.py:_mha_bwd_fused_kernel (the Pallas
// TPU kernel launched by _pallas_mha_bwd and _pallas_mha_bthd_bwd under
// PADDLE_TPU_FLASH_FUSED_BWD=1). It computes the same function as the K2
// pair (flash_bwd.cu) but makes each probability tile once, where the pair
// makes it twice: five products per tile instead of seven.
//
// The TPU kernel walks q tiles in order along a sequential grid axis and
// keeps dk/dv for the whole row resident in VMEM from one grid step to the
// next. A CUDA grid has no such order: its blocks run in parallel. So the
// counterpart turns the loop around: one block per (KV tile of 64 keys,
// head, batch) walks the 32-row q tiles from the causal lower bound, keeps
// its dk and dv in registers for the whole walk (written once, at the end,
// with no atomics), and adds its share of each q tile's dq into a zeroed
// fp32 buffer with atomics. fp32 atomics add in an order that changes from
// run to run, so dq is not bitwise reproducible; it agrees with K2 and the
// plain version within the tolerance of reordered fp32 sums.
//
// What bounds it on the H100: operations. At the causal training shape
// (B=16, H=16, T=1024, Dh=64) its five products of 2*T*T*Dh/2 per (batch,
// head) are 86 GFLOP on 0.3 GB: 0.52 ms for fp32-accurate products on the
// tensor cores (3xTF32, 165 TFLOP/s), 1.28 ms on CUDA cores (67 TFLOP/s).
// The atomics add 32 x Dh floats per (q tile, KV tile) pair through L2 (dq,
// 64 MB at the training shape, mostly stays there).
//
// What the design does about it: the body is K2's dk/dv kernel
// (flash_bwd_kv.cuh), which runs four of the five products on the tensor
// cores in 3xTF32 (tf32x3.cuh) with q, dO, lse and delta streamed by
// cp.async, double-buffered, and P and dS kept in registers. The fifth,
// dq += scale dS k, takes dS through shared memory (it is held with keys in
// rows; the product wants queries in rows), into the dO stage once the
// block is done with it, so the block needs no more shared memory than
// K2's dk/dv kernel; the resident k tile is its B operand. Each warp adds
// 16 queries x half the head dim of the q tile's dq, each thread its own
// elements, with the 16-byte red.global.add.v4.f32 of sm_90 (atomicAdd on
// a float4): a quarter of the atomics of scalar adds.

#include <cuda_runtime.h>

#include "flash_bwd_kv.cuh"
#include "launch_count.cuh"

LAUNCH_COUNTERS(flash_bwd_fused, 1)

namespace {

template <int D>
__global__ void __launch_bounds__(TC_THREADS, TcLayout<D>::MIN_BLOCKS)
    flash_bwd_fused_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, float* __restrict__ dk,
                           float* __restrict__ dv,
                           const int* __restrict__ kv_lens, int H, int Tq,
                           int Tk, Strides st, float scale, int causal) {
  count_launch(&flash_bwd_fused_launches[0]);
  kv_outer<D, true>(q, k, v, dout, lse, delta, dq, dk, dv, kv_lens, H, Tq,
                    Tk, st, scale, causal);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dq, float* dk,
           float* dv, const int* kv_lens, int B, int H, int Tq, int Tk,
           const Strides& st, float scale, int causal, cudaStream_t s) {
  const size_t smem = TcLayout<D>::KV_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tk + TC_ROWS - 1) / TC_ROWS, H, B);
  flash_bwd_fused_kernel<D><<<grid, TC_THREADS, smem, s>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, kv_lens, H, Tq, Tk, st, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are 21 element strides, (batch, time, head) for q, k, v, dO, dq,
// dk and dv in that order; every head dim is contiguous, and every stride
// and base pointer is a multiple of 4 floats (16-byte cp.async and
// atomics). lse and delta are (B*H, Tq) fp32, contiguous. dq must hold
// zeros: the kernel adds into it. kv_lens (int32, B) may be null. Returns
// the CUDA error of the launch (0 on success).
extern "C" int flash_bwd_fused_f32(const float* q, const float* k,
                                   const float* v, const float* dout,
                                   const float* lse, const float* delta,
                                   float* dq, float* dk, float* dv,
                                   const int* kv_lens, int B, int H, int Tq,
                                   int Tk, int D, const long long* strides,
                                   float scale, int causal, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Tk <= 0 || B <= 0 || H <= 0) return 0;
  const Strides st = unpack_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, kv_lens, B, H,
                       Tq, Tk, st, scale, causal, s);
  if (D == 64)
    return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, kv_lens, B, H,
                      Tq, Tk, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
