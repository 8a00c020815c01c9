// K4-bf16: the single-pass exact (flash) attention backward for Hopper on
// bf16 q, k, v and dO, the AMP twin of K4 (flash_bwd_fused.cu), on the
// tensor cores by wgmma. Runs under PADDLE_TPU_FLASH_FUSED_BWD=1 as the
// reference's switch has it; K2-bf16 (flash_bwd_bf16.cu) is the default.
//
// Replaces paddle_tpu/ops/attention.py:_mha_bwd_fused_kernel as the
// reference runs it under bf16 AMP. It computes the same function in the
// same rounding order, from the pre-scaled bf16 q (qs), the forward's fp32
// lse and the fp32 delta = rowsum(dO * O) (made by the wrapper from the
// bf16 dO and out): each score tile is recomputed in fp32 as s = qs k^T,
// P = exp(s - lse) and dS = P * (dO v^T - delta), then, per KV tile,
//   dv = bf16(P)^T dO, dk = bf16(dS)^T qs
// with bf16 operands and fp32 sums, each written once in bf16, and each q
// tile's fp32 share of dqs = bf16(dS) k added into a zeroed fp32 buffer
// (the wrapper rounds it to bf16 once), as the reference's fused kernel
// sums dq in fp32 and writes it in bf16. dqs is the gradient of the
// pre-scaled q: the wrapper multiplies it by the scale in bf16, as the
// chain rule through the reference's q * scale does.
//
// What bounds it on the H100: the backward's five products are 86.0 GFLOP
// at the causal training shape (B=16, H=16, T=1024, Dh=64), 0.087 ms at
// 989 TFLOP/s; its bf16 q, k, v, dO, dq, dk, dv and fp32 lse and delta are
// 0.24 GB, 0.070 ms at 3.35 TB/s: operations bound it. What a single pass
// adds is the dq sum across KV tiles: every 128-key tile adds its share of
// each q tile it sees, 302 MB of fp32 adds a call at that shape by the
// tile walk (4.5x the 67 MB fp32 dq buffer; the kernel counts the bytes it
// adds, flash_bwd_fused_bf16_take_dq_bytes). Timed with parts left out
// (K4_BF16_OMIT, chip_smoke.py --k4-ablations; PERF.md gives the run), the
// reductions cost about a fifth of the kernel's time at Dh 64, though half
// of them cost almost nothing (they hide under the products), and a tenth
// at Dh 128 (151 MB); staging the fp32 part for them costs a further
// ~0.06 ms (Dh 64) and ~0.02 ms (Dh 128) on an H100.
//
// The design:
// - The dk/dv part is K2-dkv-bf16's body, shared through
//   flash_bwd_kv_bf16.cuh with the DQ flag set: a persistent grid of
//   128-key KV tiles, heaviest causal tiles first; K and V resident in two
//   slots, each of the two consumer warpgroups owning 64 keys; qs, dO, lse
//   and delta streamed by TMA through an mbarrier ring from one producer
//   thread (setmaxnreg 24 / 240); the transposed scores S^T = K qs^T and
//   dP^T = V dO^T, so that bf16(P^T) and bf16(dS^T) are the register A
//   operands of dV += P^T dO and dK += dS^T qs; the two warpgroups take
//   turns at the tensor cores. With DQ both warpgroups compute every q tile
//   from the first that sees the block's keys (a warpgroup's masked tiles
//   give P = 0), since the dq product needs both halves of dS.
// - The dq share, dqs_tile += bf16(dS) K over the block's 128 keys, on
//   wgmma. dS^T sits in the accumulator fragments with keys as rows; its
//   bf16 pack (the dK product's A operand) is stored transposed by
//   stmatrix into a 128-byte-swizzled dS slot, queries as rows, each
//   warpgroup's 64 keys one box. wgmma needs 64 rows of M, and at Dh 128
//   the streamed q tiles have 32 rows (registers: dK and dV hold 128 a
//   thread there), so the product is taken transposed at both head dims:
//   dqs^T = K^T dS^T, M the head dim, K^T read N-major from the resident K
//   through the transpose bit of A (sm90.cuh, wgmma_ss_ta_n32), dS^T K-major,
//   m64n32k16 over 128 keys. Warpgroup w takes queries 32w.. at Dh 64 and
//   head-dim values 64w.. at Dh 128, so the tile is split, and each of its
//   elements is added once per block.
// - The dq product of q tile i is issued first in the turn of tile i + 2,
//   before tile i + 2's scores and tile i + 1's dk/dv products: by then the
//   turn order has put the other warpgroup's half of dS in (an mbarrier
//   confirms it), so no warpgroup waits on the other's softmax. It is
//   staged once it and the scores are in, before the softmax, so that its
//   16 registers are free there (dK, dV, both score tiles and their bf16
//   operands fill the 240 a thread has). Three dS slots, an mbarrier each
//   for "stored" and "read".
// - The add: the finished fp32 part (32 queries x 64 values) is staged in
//   shared memory as two 128-byte-swizzled boxes (conflict-free 4-byte
//   stores), and one thread adds each box into dq with a TMA reduction
//   (cp.reduce.async.bulk.tensor .add, fp32, 4-D map over (Dh, H, T, B)
//   with dq's strides; rows past T are left out by the map), never waiting
//   for it: before the next stage it waits until the last one was read.
//   Tried and dropped (slower, PERF.md): a cluster of two CTAs over 256
//   keys that sums its two parts in shared memory before one reduction
//   (half the bytes, but a shallower ring and spills cost more), and
//   16-byte red.global.add from the stage instead of TMA.
// - Shared memory: two K/V slots, the q ring (5 x 16.75 KB at Dh 64, 3 at
//   Dh 128), three dS slots (16 or 8 KB) and 16 KB of stage: 213 KB at
//   Dh 64, 219 KB at Dh 128.
// - dk and dv are register sums per block: two calls on the same inputs
//   give the same bits. dq's adds land in an order that changes from run
//   to run.
// - P = 0 for rows past T, keys at or past the per-batch length, masked
//   causal entries and rows whose lse is -inf, so a length-0 batch gets
//   zero gradients and no NaN enters a product. (batch, time, head) element
//   strides are taken as given (head dim contiguous), so BTHD and BHTD are
//   one kernel; any T, Tq apart from Tk; Dh 64 or 128.
//
// chip_smoke.py prints its HGMMA count, registers, stack and local memory
// (0; at Dh 128 the consumers spill a few words to the stack).

#include "flash_bwd_kv_bf16.cuh"
#include "launch_count.cuh"

LAUNCH_COUNTERS(flash_bwd_fused_bf16, 1)

namespace {

// the bytes of fp32 adds into dq since the count was last taken
__device__ unsigned long long dq_bytes;

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_fused_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                const __grid_constant__ CUtensorMap do_map,
                                const __grid_constant__ CUtensorMap lse_map,
                                const __grid_constant__ CUtensorMap delta_map,
                                const __grid_constant__ CUtensorMap dq_map,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                const int* __restrict__ kv_lens, int H, int B,
                                int Tq, int Tk, OutStrides sk, OutStrides sv,
                                int causal) {
  count_launch(&flash_bwd_fused_bf16_launches[0]);
  kv_walk_bf16<D, true>(q_map, k_map, v_map, do_map, lse_map, delta_map,
                        &dq_map, &dq_bytes, dk, dv, kv_lens, H, B, Tq, Tk,
                        sk, sv, causal);
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
           const float* lse, const float* delta, float* dq, bf16* dk,
           bf16* dv, const int* kv_lens, int B, int H, int Tq, int Tk,
           const BwdStrides& st, int device, int sms, cudaStream_t s,
           int causal) {
  using L = DkvLayout<D, true>;
  CUtensorMap m[6], dqm;
  int err =
      kv_walk_maps<D, true>(m, q, k, v, dout, lse, delta, B, H, Tq, Tk, st);
  // dq, fp32, added to in boxes of 32 values x 32 rows; with no queries it
  // is never touched, and the map describes k instead
  if (!err)
    err = Tq > 0 ? head_map(&dqm, "dq", dq, D, H, Tq, B, st.dq, 32, true)
                 : head_map(&dqm, "dq", k, D, H, Tk, B, st.k, 32);
  if (err) return err;
  const cudaError_t cerr = allow_smem(
      reinterpret_cast<const void*>(flash_bwd_fused_bf16_kernel<D>), device,
      static_cast<int>(L::BYTES));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const OutStrides sk = {{st.dk[0], st.dk[1], st.dk[2]}};
  const OutStrides sv = {{st.dv[0], st.dv[1], st.dv[2]}};
  const int tiles = (Tk + RES - 1) / RES * H * B;
  flash_bwd_fused_bf16_kernel<D><<<tiles < sms ? tiles : sms, THREADS,
                                   L::BYTES, s>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], dqm, dk, dv, kv_lens, H, B, Tq, Tk,
      sk, sv, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q is pre-scaled (qs); dq receives dqs. Strides are 21 element strides,
// (batch, time, head) for q, k, v, dO, dq, dk and dv in that order; every
// head dim is contiguous, and every stride and base pointer is a multiple
// of 16 bytes (8 bf16 or 4 fp32 values, as TMA needs). lse and delta are
// (B*H, Tq) fp32, contiguous. kv_lens (int32, B) may be null. dq (fp32,
// the dq strides in fp32 elements) must hold zeros: the kernel adds into
// it. Returns 0 on success, the CUDA error of the launch, or a tensor-map
// error (flash_bwd_fused_bf16_error_string names each).
extern "C" int flash_bwd_fused_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    float* dq, void* dk, void* dv,
                                    const int* kv_lens, int B, int H, int Tq,
                                    int Tk, int D, const long long* strides,
                                    int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Tk <= 0 || B <= 0 || H <= 0) return 0;
  const BwdStrides st = unpack(strides);
  const int sms = sm_count(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qq = static_cast<const bf16*>(q),
             *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v),
             *oo = static_cast<const bf16*>(dout);
  bf16* gk = static_cast<bf16*>(dk);
  bf16* gv = static_cast<bf16*>(dv);
  if (D == 128)
    return launch<128>(qq, kk, vv, oo, lse, delta, dq, gk, gv, kv_lens, B, H,
                       Tq, Tk, st, device, sms, s, causal);
  if (D == 64)
    return launch<64>(qq, kk, vv, oo, lse, delta, dq, gk, gv, kv_lens, B, H,
                      Tq, Tk, st, device, sms, s, causal);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bytes of fp32 adds that K4-bf16 made into dq on ``device`` since the
// count was last taken, into *bytes, and the count set to 0. Waits for the
// device's work. Returns 0 or the CUDA error.
extern "C" int flash_bwd_fused_bf16_take_dq_bytes(int device,
                                                  unsigned long long* bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(bytes, dq_bytes, 8);
  const unsigned long long zero = 0;
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(dq_bytes, &zero, 8);
  return static_cast<int>(err);
}

extern "C" const char* flash_bwd_fused_bf16_error_string(int err) {
  return error_string(err);
}
