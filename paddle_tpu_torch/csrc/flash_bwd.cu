// K2: exact (flash) attention backward for Hopper, fp32, as two kernels:
// dq, and dk with dv.
//
// Replaces paddle_tpu/ops/attention.py:_mha_dq_kernel and _mha_dkv_kernel
// (the Pallas TPU kernels launched by _pallas_mha_bwd and
// _pallas_mha_bthd_bwd). They compute the same functions from the forward's
// saved per-row logsumexp (lse, laid out (B*H, Tq) as K1 writes it) and
// delta = rowsum(dO * O) (the same layout, made by the wrapper): each score
// tile is recomputed as s = (q * scale) k^T exactly as K1 made it,
// P = exp(s - lse), dS = P * (dO v^T - delta), and
//   dq = scale * dS k           (dq kernel: one block per q tile)
//   dv = P^T dO, dk = dS^T (q * scale)   (dkv kernel: one block per KV tile)
// The reference folds the scale into q before its kernels and lets the
// chain rule rescale dq; here the scale is an argument, so dq carries it
// explicitly and dk picks it up through the scaled q tile.
//
// What bounds it on the H100: at the training shape (B=16, H=16, T=1024,
// Dh=64, causal) the backward's work is five products of 2*T*T*Dh/2 per
// (batch, head), 86 GFLOP on 0.3 GB of q/k/v/dO/dq/dk/dv, so it is bound by
// operations (1.3 ms at the 67 TFLOP/s fp32 CUDA-core peak), not by bytes
// (0.1 ms at 3.35 TB/s). The split form does seven products, not five:
// both kernels recompute the score tile and dO v^T. The arithmetic runs on
// CUDA cores in fp32 (no tensor cores, no TF32), as K1 does.
//
// What the design does about it: K1's tiling (flash_bwd_common.cuh). One
// block of 256 threads per (64-row tile, head, batch); each thread owns a
// 4x4 patch of the 64x64 score tile and a 4 x Dh/16 patch of its
// accumulators, so every value read from shared memory feeds 2-4 FMAs. The
// block's own tile (q and dO for dq; k and v for dkv) stays in shared
// memory for the whole loop; the other side's tiles are staged there per
// iteration. Causal bounds are derived for these tiles: the dq loop stops
// at the KV tile that holds the diagonal, the dkv loop starts at the q tile
// that holds its first key. Rows past T, keys at or past the per-batch
// length and rows whose lse is -inf (no valid key at all) get P = 0, so
// their gradients are zero and never NaN. Element strides for the batch,
// time and head axes are taken as given (head dim contiguous), so BTHD and
// BHTD are one kernel. The dk/dv kernel is the KV-outer kernel of
// flash_bwd_common.cuh, which K4 shares, without K4's dq atomics.
//
// Not yet used: tensor cores (wgmma), TMA, bf16.

#include "flash_bwd_common.cuh"

namespace {

// One block per (q tile, head, batch): dq = scale * sum over KV tiles of
// dS k, the KV loop ending at the diagonal tile under the causal mask.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, const int* __restrict__ kv_lens, int H, int Tq,
    int Tk, Strides st, float scale, int causal) {
  using L = Layout<D>;
  constexpr int STR = L::STR;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;  // q * scale
  float* Os = Qs + L::TILE;  // dO
  float* Ks = Os + L::TILE;
  float* Vs = Ks + L::TILE;
  float* Ss = Vs + L::TILE;  // dS (the second P/dS tile goes unused)
  float* Ls = Ss + 2 * L::PT;
  float* Ds = Ls + BT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BT;
  int kv_len = Tk;
  if (kv_lens != nullptr) kv_len = max(0, min(kv_lens[b], Tk));

  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];
  load_tile<D>(Qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0, Tq, scale);
  load_tile<D>(Os, dout + b * st.dout[0] + h * st.dout[2], st.dout[1], q0, Tq,
               1.f);
  load_stats(Ls, Ds, lse, delta, (long long)b * H + h, q0, Tq);

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int n_kv = (kv_len + BT - 1) / BT;
  if (causal) n_kv = min(n_kv, (min(q0 + BT, Tq) - 1) / BT + 1);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's readers of K, V and dS are done
    load_tile<D>(Ks, kb, st.k[1], k0, kv_len, 1.f);
    load_tile<D>(Vs, vb, st.v[1], k0, kv_len, 1.f);
    __syncthreads();

    // s = (q scale) k^T and dp = dO v^T for rows ty + 16i, keys tx + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty + 16 * i) * STR + d];
        oa[i] = Os[(ty + 16 * i) * STR + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = Ks[(tx + 16 * j) * STR + d];
        va[j] = Vs[(tx + 16 * j) * STR + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      const float l = Ls[r], dl = Ds[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = l != -INFINITY && col < kv_len && (!causal || col <= row);
        const float p = ok ? expf(s[i][j] - l) : 0.f;
        Ss[r * PSTR + tx + 16 * j] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();

    // acc += dS k for rows ty + 16i, columns tx + 16c
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float sa[4], ka[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = Ss[(ty + 16 * i) * PSTR + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) ka[c] = Ks[kk * STR + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(sa[i], ka[c], acc[i][c]);
    }
  }

  float* qb = dq + b * st.dq[0] + h * st.dq[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) qb[row * st.dq[1] + tx + 16 * c] = scale * acc[i][c];
  }
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, const int* kv_lens, int B, int H, int Tq, int Tk,
              const Strides& st, float scale, int causal, cudaStream_t s) {
  const size_t smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + BT - 1) / BT, H, B);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, s>>>(
      q, k, v, dout, lse, delta, dq, kv_lens, H, Tq, Tk, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are 21 element strides, (batch, time, head) for q, k, v, dO, dq,
// dk and dv in that order; every head dim is contiguous. lse and delta are
// (B*H, Tq) fp32, contiguous. kv_lens (int32, B) may be null. Each returns
// the CUDA error of its launch (0 on success).
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
  return run_kv<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, kv_lens,
                       B, H, Tq, Tk, D, strides, scale, causal, device,
                       stream);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
