// K2: exact (flash) attention backward for Hopper, fp32 in and out, as two
// kernels on the tensor cores: dq, and dk with dv.
//
// Replaces paddle_tpu/ops/attention.py:_mha_dq_kernel and _mha_dkv_kernel
// (the Pallas TPU kernels launched by _pallas_mha_bwd and
// _pallas_mha_bthd_bwd). They compute the same functions from the forward's
// saved per-row logsumexp (lse, laid out (B*H, Tq) as K1 writes it) and
// delta = rowsum(dO * O) (the same layout, made by the wrapper): each score
// tile is recomputed as s = scale * q k^T, P = exp(s - lse),
// dS = P * (dO v^T - delta), and
//   dq = scale * dS k                  (dq kernel: one block per q tile)
//   dv = P^T dO, dk = scale * dS^T q   (dk/dv kernel: one block per KV tile)
// The reference folds the scale into q before its kernels and lets the
// chain rule rescale dq; here the scale is an argument, applied to the
// score tile and to dq and dk on the way out.
//
// What bounds it on the H100: operations. At the training shape (B=16,
// H=16, T=1024, Dh=64, causal) the backward's work is five products of
// 2*T*T*Dh/2 per (batch, head), 86 GFLOP on 0.3 GB of q/k/v/dO/dq/dk/dv
// (0.1 ms of bytes at 3.35 TB/s). The split form does seven: both kernels
// recompute the score tile and dO v^T (dq kernel 3 products, 51.6 GFLOP;
// dk/dv kernel 4, 68.8 GFLOP). On CUDA cores (67 TFLOP/s fp32) the five
// take at least 1.28 ms. The tensor cores do 495 TFLOP/s dense in TF32;
// fp32-accurate products cost three TF32 passes (below), so the bound
// there is 3 * flops / 495 TFLOP/s: 0.31 ms for dq, 0.42 ms for dk/dv.
//
// Why 3xTF32 and not TF32: TF32 keeps 10 mantissa bits. The emulation of
// this backward in tests/test_torch_tf32x3.py (causal, T 64 and 200, Dh 64
// and 128, unit-normal inputs, against the XLA vjp, error over each
// gradient's largest element) gives 4.2e-4 to 1.1e-3 with one TF32 pass,
// against at most 1.0e-6 with 3xTF32 and 1.1e-6 in plain fp32. One pass
// would break the 1e-4 gate that holds the kernels to the plain backward.
// So every fp32 operand is split in registers, as its fragment is loaded,
// into a TF32 big part and a small rest, and each product is three TF32
// products (tf32x3.cuh, shared with K1 and K4, gives the arithmetic).
//
// What the design does about it:
// - mma.sync.m16n8k8 TF32 products (HMMA on sm_90a). Fragments come from
//   shared memory by ldmatrix or by 16-byte loads (tf32x3.cuh), so any
//   orientation of a tile can feed either operand: three of the five
//   products read a tile transposed. No wgmma: for .tf32 both of its
//   shared-memory operands must be K-major, which would need transposed
//   copies of q and dO (or k) staged again.
// - A block of 4 warps; each warp owns 16 rows of the 64-row resident tile
//   for every product. The dq kernel keeps its q and dO rows resident (and
//   each thread its two rows' lse and delta) and walks the KV tiles up to
//   the diagonal; the dk/dv kernel keeps its 64 keys of k and v resident
//   and walks the q tiles from the first that can see them. Accumulators
//   stay in registers.
// - P and dS never leave registers: an accumulator fragment is the A
//   operand of the next product (acc_to_a). The B operand's 8-wide column
//   slices are interleaved: column g of slice n is head-dim column
//   g * Dh/8 + n, so a thread reads its B values for all slices with
//   16-byte loads, and writes dq, dk and dv rows as 16-byte stores.
// - Shared-memory rows are padded to Dh + 4 floats.
// - The streamed tiles (k and v for dq; q, dO, lse and delta for dk/dv)
//   are 32 rows, double-buffered with cp.async: tile i + 1 is in flight
//   while tile i is multiplied. Rows past T or past a KV length are
//   zero-filled. At Dh 64 a block takes 68 KB of shared memory and at most
//   168 registers a thread (launch bounds), so three blocks share an SM
//   (Dh 128: 132 KB, one block).
// - Causal bounds for q tiles of BQ rows and KV tiles of BK rows: the dq
//   loop ends at the KV tile that holds the q tile's last row; the dk/dv
//   loop starts at q tile k0 / BQ, the first holding a row >= k0.
// - P = 0 for rows past T, keys at or past the per-batch length, masked
//   causal entries and rows whose lse is -inf (no valid key), set before
//   the split, so no NaN enters a product and a length-0 batch gets zero
//   gradients.
// - (batch, time, head) element strides are taken as given (head dim
//   contiguous, strides and base pointers multiples of 4 floats, checked by
//   the wrapper), so BTHD and BHTD are one kernel.
// - The dk/dv kernel's body (flash_bwd_kv.cuh) is K4's as well, which adds
//   its share of dq to it.
//
// chip_smoke.py prints each kernel's registers, local memory and HMMA
// count (cuobjdump).
//
// Not yet used: wgmma, TMA, bf16.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_bwd_kv.cuh"
#include "launch_count.cuh"

// one counter per kernel, in the order below
LAUNCH_COUNTERS(flash_bwd, 2)

namespace {

// One block per (q tile, head, batch): dq = scale * sum over KV tiles of
// dS k, the KV loop ending at the diagonal tile under the causal mask.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, TcLayout<D>::MIN_BLOCKS)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq,
                        const int* __restrict__ kv_lens, int H, int Tq,
                        int Tk, Strides st, float scale, int causal) {
  count_launch(&flash_bwd_launches[0]);
  constexpr int STR = TcLayout<D>::STR, BQ = TC_ROWS, BK = TC_STREAM;
  constexpr int NK = BK / 8, ND = D / 8;  // 8-wide slices of keys, head dim
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + BQ * STR;
  float* Ks = Os + BQ * STR;      // two stages
  float* Vs = Ks + 2 * BK * STR;  // two stages

  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);  // this warp's rows of the tile
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  int kv_len = Tk;
  if (kv_lens != nullptr) kv_len = max(0, min(kv_lens[b], Tk));
  int n_kv = (kv_len + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, Tq) - 1) / BK + 1);

  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];
  if (n_kv > 0) {
    copy_tile<D, BQ, TC_THREADS>(Qs, q + b * st.q[0] + h * st.q[2], st.q[1],
                                 q0, Tq);
    copy_tile<D, BQ, TC_THREADS>(Os, dout + b * st.dout[0] + h * st.dout[2],
                                 st.dout[1], q0, Tq);
    copy_tile<D, BK, TC_THREADS>(Ks, kb, st.k[1], 0, kv_len);
    copy_tile<D, BK, TC_THREADS>(Vs, vb, st.v[1], 0, kv_len);
    cp_async_commit();
  }
  // this thread's rows q0 + m0 + g and that + 8; rows past Tq get lse
  // -inf, which masks them
  const long long bh = (long long)b * H + h;
  const int row[2] = {q0 + m0 + g, q0 + m0 + g + 8};
  float l[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = row[i] < Tq ? lse[bh * Tq + row[i]] : -INFINITY;
    dl[i] = row[i] < Tq ? delta[bh * Tq + row[i]] : 0.f;
  }
  const float* qa_at = Qs + m0 * STR + a_offset<STR>(lane);
  const float* oa_at = Os + m0 * STR + a_offset<STR>(lane);
  const int bt_at = bt_offset<STR>(lane), b_at = 2 * c * STR + g * ND;

  float acc[ND][4];  // dq, head-dim slices interleaved
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_kv) {
      copy_tile<D, BK, TC_THREADS>(Ks + (cur ^ 1) * BK * STR, kb, st.k[1],
                                   (kt + 1) * BK, kv_len);
      copy_tile<D, BK, TC_THREADS>(Vs + (cur ^ 1) * BK * STR, vb, st.v[1],
                                   (kt + 1) * BK, kv_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* K = Ks + cur * BK * STR;
    const float* V = Vs + cur * BK * STR;

    // s = q k^T and dp = dO v^T: this warp's 16 rows x BK keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < ND; ++kd) {
      Frag<4> qa, oa;
      load_a(qa, qa_at + 8 * kd);
      load_a(oa, oa_at + 8 * kd);
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        Frag<2> k0f, k1f, v0f, v1f;
        load_bt2(k0f, k1f, K + 8 * j * STR + 8 * kd + bt_at);
        load_bt2(v0f, v1f, V + 8 * j * STR + 8 * kd + bt_at);
        mma3(s[j], qa, k0f);
        mma3(dp[j], oa, v0f);
        mma3(s[j + 1], qa, k1f);
        mma3(dp[j + 1], oa, v1f);
      }
    }
    // dS = P * (dp - delta), P = exp(scale s - lse), 0 where masked
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = k0 + 8 * j + 2 * c + (e & 1);
        const bool ok = l[i] != -INFINITY && col < kv_len &&
                        (!causal || col <= row[i]);
        const float p = ok ? expf(scale * s[j][e] - l[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[i]);
      }
    // acc += dS k, keys as the depth
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      Frag<4> da;
      acc_to_a(da, s[j]);
      mma_rows<ND, STR>(acc, da, K + 8 * j * STR + b_at);
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  float* qout = dq + b * st.dq[0] + h * st.dq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (row[i] < Tq)
      store_row<ND>(qout + row[i] * st.dq[1] + 2 * c * ND, acc, i, scale);
}

// One block per (KV tile, head, batch): dk and dv (flash_bwd_kv.cuh).
template <int D>
__global__ void __launch_bounds__(TC_THREADS, TcLayout<D>::MIN_BLOCKS)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const int* __restrict__ kv_lens, int H, int Tq,
                         int Tk, Strides st, float scale, int causal) {
  count_launch(&flash_bwd_launches[1]);
  kv_outer<D, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, kv_lens, H,
                     Tq, Tk, st, scale, causal);
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, const int* kv_lens, int B, int H, int Tq, int Tk,
              const Strides& st, float scale, int causal, cudaStream_t s) {
  const size_t smem = TcLayout<D>::TILE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + TC_ROWS - 1) / TC_ROWS, H, B);
  flash_bwd_dq_kernel<D><<<grid, TC_THREADS, smem, s>>>(
      q, k, v, dout, lse, delta, dq, kv_lens, H, Tq, Tk, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, const int* kv_lens, int B, int H, int Tq,
               int Tk, const Strides& st, float scale, int causal,
               cudaStream_t s) {
  const size_t smem = TcLayout<D>::KV_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tk + TC_ROWS - 1) / TC_ROWS, H, B);
  flash_bwd_dkv_kernel<D><<<grid, TC_THREADS, smem, s>>>(
      q, k, v, dout, lse, delta, dk, dv, kv_lens, H, Tq, Tk, st, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are 21 element strides, (batch, time, head) for q, k, v, dO, dq,
// dk and dv in that order; every head dim is contiguous, and every stride
// and base pointer is a multiple of 4 floats (16-byte cp.async). lse and
// delta are (B*H, Tq) fp32, contiguous. kv_lens (int32, B) may be null.
// Each returns the CUDA error of its launch (0 on success).
extern "C" int flash_bwd_dq_f32(const float* q, const float* k,
                                const float* v, const float* dout,
                                const float* lse, const float* delta,
                                float* dq, const int* kv_lens, int B, int H,
                                int Tq, int Tk, int D,
                                const long long* strides, float scale,
                                int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Tq <= 0 || B <= 0 || H <= 0) return 0;
  const Strides st = unpack_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, kv_lens, B, H, Tq,
                          Tk, st, scale, causal, s);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, kv_lens, B, H, Tq,
                         Tk, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv_f32(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 const float* lse, const float* delta,
                                 float* dk, float* dv, const int* kv_lens,
                                 int B, int H, int Tq, int Tk, int D,
                                 const long long* strides, float scale,
                                 int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Tk <= 0 || B <= 0 || H <= 0) return 0;
  const Strides st = unpack_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, kv_lens, B, H,
                           Tq, Tk, st, scale, causal, s);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, kv_lens, B, H,
                          Tq, Tk, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
