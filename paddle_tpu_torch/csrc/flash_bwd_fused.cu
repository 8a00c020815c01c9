// K4: single-pass exact (flash) attention backward for Hopper, fp32.
//
// Replaces paddle_tpu/ops/attention.py:_mha_bwd_fused_kernel (the Pallas
// TPU kernel launched by _pallas_mha_bwd and _pallas_mha_bthd_bwd under
// PADDLE_TPU_FLASH_FUSED_BWD=1). It computes the same function as the K2
// pair (csrc/flash_bwd.cu) but makes each probability tile once, where the
// pair makes it twice: five products per tile instead of seven.
//
// The TPU kernel walks q tiles in order along a sequential grid axis and
// keeps dk/dv for the whole row resident in VMEM from one grid step to the
// next. A CUDA grid has no such order: its blocks run in parallel. So the
// counterpart turns the loop around: one block per (KV tile, head, batch)
// walks the q tiles from the causal lower bound, keeps its dk and dv in
// registers for the whole walk (written once, at the end, with no
// atomics), and adds its share of each q tile's dq into a zeroed fp32
// buffer with atomicAdd. fp32 atomics add in an order that changes from
// run to run, so dq is not bitwise reproducible; it agrees with K2 and the
// plain version within the tolerance of reordered fp32 sums.
//
// What bounds it on the H100: the same work as K2 (five products of
// 2*T*T*Dh/2 per (batch, head) at the causal training shape, 86 GFLOP on
// 0.3 GB), bound by operations at 1.3 ms. The atomics add 64*Dh adds per
// (q tile, KV tile) pair through L2 (dq, 64 MB at the training shape,
// mostly stays there).
//
// The kernel is K2's KV-outer dk/dv kernel with the dq share added
// (flash_bwd_common.cuh): 64-row tiles, 256 threads with 4x4 score
// patches, P = 0 for rows past T, keys past the length and rows whose lse
// is -inf, (batch, time, head) element strides with a contiguous head dim.

#include "flash_bwd_common.cuh"

// Strides are 21 element strides, (batch, time, head) for q, k, v, dO, dq,
// dk and dv in that order; every head dim is contiguous. lse and delta are
// (B*H, Tq) fp32, contiguous. dq must hold zeros: the kernel adds into it.
// kv_lens (int32, B) may be null. Returns the CUDA error of the launch.
extern "C" int flash_bwd_fused_f32(const float* q, const float* k,
                                   const float* v, const float* dout,
                                   const float* lse, const float* delta,
                                   float* dq, float* dk, float* dv,
                                   const int* kv_lens, int B, int H, int Tq,
                                   int Tk, int D, const long long* strides,
                                   float scale, int causal, int device,
                                   void* stream) {
  return run_kv<true>(q, k, v, dout, lse, delta, dq, dk, dv, kv_lens, B, H,
                      Tq, Tk, D, strides, scale, causal, device, stream);
}

extern "C" const char* flash_bwd_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
