// K1: exact (flash) attention forward for Hopper, fp32 in and out, on the
// tensor cores in 3xTF32.
//
// Replaces paddle_tpu/ops/attention.py:_mha_fwd_kernel (the Pallas TPU
// kernel reached through _mha_fwd_call_bthd and _mha_fwd_call). It computes
// the same function: q pre-scaled, an fp32 online softmax over KV tiles,
// an optional causal mask that ends the KV loop at the diagonal, out in the
// input layout and the per-row logsumexp (natural log) laid out as
// (B*H, 1, Tq). A row with no valid key gets out 0 and lse -inf.
//
// What bounds it on the H100: operations. Its two products (S = q k^T and
// O = P V) are 4 * Dh FLOPs per (query, valid key) pair: 34.4 GFLOP at the
// causal training shape (B=16, T=1024, H=16, Dh=64) and 17.2 at the serving
// prefill shape (B=8, T=1024, H=8, Dh=128), on 0.27 and 0.13 GB of q, k, v
// and out (0.08 and 0.04 ms at 3.35 TB/s). fp32-accurate products run on
// the tensor cores in 3xTF32 at 495 / 3 = 165 TFLOP/s: 0.21 and 0.10 ms.
//
// What the design does about it:
// - Both products are mma.sync.m16n8k8 TF32 (HMMA) in 3xTF32: each fp32
//   operand is split into a TF32 big part and a small rest, and a product
//   is three TF32 products (tf32x3.cuh, shared with K2 and K4). In S the
//   cross terms are summed in accumulators of their own (mma3_apart):
//   they are then summed at their own scale, which halves the error of S
//   (the card: 5.7e-6 -> 4.0e-6 of out at the serving shape).
// - One block of 4 warps per (64-row q tile, head, batch), the heaviest
//   causal tiles first; each warp owns 16 rows of the tile for both
//   products. Three blocks an SM at Dh 64, two at Dh 128.
// - The q tile is resident for the whole KV loop, so it is read once and
//   multiplied by scale * log2(e). At Dh 64 it is also split once and kept
//   in shared memory as its big and small parts, so its A fragments come
//   by ldmatrix with no split work in the loop (half of the split work of
//   S). At Dh 128 the two parts would take the shared memory of the second
//   block an SM, which is worth more: its fragments are split as loaded.
// - k and v tiles of 32 keys are streamed by cp.async, double-buffered
//   (tile i + 1 in flight while tile i is multiplied), and zero-filled past
//   T and past the KV length.
// - The online softmax runs on the accumulator fragments: a thread holds
//   rows g and g + 8; the row max is reduced over the quad by
//   __shfl_xor_sync 1 and 2, the row sum is kept per thread and reduced
//   once at the end. Scores are in log2 units (q carries log2(e)), so
//   P = exp2(s - m); lse = m ln 2 + log(l). Only a tile that reaches past
//   the KV length, or under the causal mask past the warp's first row,
//   is masked: the others skip the mask.
// - P stays in registers as the A operand of P V (acc_to_a), 0 for masked
//   and out-of-range keys before the split; v's 8-wide head-dim slices are
//   interleaved so that a thread reads its B values with 16-byte loads and
//   writes its out rows as 16-byte stores.
// - Under the causal mask a warp skips the products of a KV tile that
//   starts after its last row (its P would be all 0).
// - (batch, time, head) element strides are taken as given (head dim
//   contiguous, strides and base pointers multiples of 4 floats, checked by
//   the wrapper), so BTHD and BHTD are one kernel; any T.
//
// chip_smoke.py prints the kernel's registers, local memory and HMMA count
// (cuobjdump).
//
// Not yet used: wgmma (for .tf32 both of its shared-memory operands must
// be K-major, and v is not), TMA, bf16.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"
#include "launch_count.cuh"

LAUNCH_COUNTERS(flash_fwd, 1)

namespace {

constexpr int BK = 32;  // keys of a streamed k or v tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int THREADS = 128;  // 4 warps, 16 q rows each
constexpr int BQ = 64;        // q rows of a block

// Head dim D: whether the q tile is kept split (its big and small parts)
// or as it is (split as its fragments are loaded), rows of STR floats,
// shared memory (the q tile, two stages of k and v) and blocks an SM
template <int D>
struct FwdLayout {
  static constexpr bool Q_SPLIT = D == 64;
  static constexpr int STR = D + 4;
  static constexpr size_t BYTES =
      sizeof(float) * ((Q_SPLIT ? 2 : 1) * BQ + 4 * BK) * STR;
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 2;
};

// 2^x by the SFU alone (exp2f adds a scaling for results below 2^-126,
// where P is negligible); relative error about 2^-22
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// element strides of the (batch, time, head) axes of q, k, v and out
struct FwdStrides {
  long long q[3], k[3], v[3], o[3];
};

template <int D>
__global__ void __launch_bounds__(THREADS, FwdLayout<D>::MIN_BLOCKS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ kv_lens,
                     int H, int Tq, int Tk, FwdStrides st, float scale,
                     int causal) {
  count_launch(&flash_fwd_launches[0]);
  using L = FwdLayout<D>;
  constexpr int STR = L::STR;
  constexpr int NK = BK / 8, ND = D / 8;  // 8-wide slices of keys, head dim
  extern __shared__ float4 smem4[];
  float* Qb = reinterpret_cast<float*>(smem4);  // q, or its big parts
  float* Qm = Qb + BQ * STR;                     // q small parts
  float* Ks = Qb + (L::Q_SPLIT ? 2 : 1) * BQ * STR;  // two stages
  float* Vs = Ks + 2 * BK * STR;                 // two stages

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
    copy_tile<D, BK, THREADS>(Ks, kb, st.k[1], 0, kv_len);
    copy_tile<D, BK, THREADS>(Vs, vb, st.v[1], 0, kv_len);
    cp_async_commit();
  }
  // the q tile times scale * log2(e) (at Dh 64 split once); rows past Tq
  // are 0
  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float qmul = scale * LOG2E;
  for (int i = threadIdx.x; i < BQ * D / 4; i += THREADS) {
    const int r = i / (D / 4), col = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Tq)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * st.q[1] + col);
    x = make_float4(x.x * qmul, x.y * qmul, x.z * qmul, x.w * qmul);
    if constexpr (L::Q_SPLIT) {
      Frag<4> f;
      f.set(0, x.x);
      f.set(1, x.y);
      f.set(2, x.z);
      f.set(3, x.w);
      *reinterpret_cast<uint4*>(Qb + r * STR + col) =
          make_uint4(f.big[0], f.big[1], f.big[2], f.big[3]);
      *reinterpret_cast<uint4*>(Qm + r * STR + col) =
          make_uint4(f.small[0], f.small[1], f.small[2], f.small[3]);
    } else {
      *reinterpret_cast<float4*>(Qb + r * STR + col) = x;
    }
  }

  // this thread's rows q0 + m0 + g and that + 8: running max (log2 units),
  // its own part of the running sum, and the output accumulator
  const int row[2] = {q0 + m0 + g, q0 + m0 + g + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[ND][4];  // head-dim slices interleaved
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int qa_at = m0 * STR + a_offset<STR>(lane);
  const int bt_at = bt_offset<STR>(lane), b_at = 2 * c * STR + g * ND;
  // a warp whose rows are all past Tq has nothing to compute
  const bool rows_live = q0 + m0 < Tq;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_kv) {
      copy_tile<D, BK, THREADS>(Ks + (cur ^ 1) * BK * STR, kb, st.k[1],
                                (kt + 1) * BK, kv_len);
      copy_tile<D, BK, THREADS>(Vs + (cur ^ 1) * BK * STR, vb, st.v[1],
                                (kt + 1) * BK, kv_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and, the first time, the q tile) is in
    const int k0 = kt * BK;
    if (rows_live && !(causal && k0 > q0 + m0 + 15)) {
      const float* K = Ks + cur * BK * STR;
      const float* V = Vs + cur * BK * STR;

      // s = q k^T: this warp's 16 rows x BK keys, the cross terms apart
      float s[NK][4], sc[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = sc[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < ND; ++kd) {
        Frag<4> qa;
        if constexpr (L::Q_SPLIT)
          load_a_split(qa, Qb + qa_at + 8 * kd, Qm + qa_at + 8 * kd);
        else
          load_a(qa, Qb + qa_at + 8 * kd);
#pragma unroll
        for (int j = 0; j < NK; j += 2) {
          Frag<2> k0f, k1f;
          load_bt2(k0f, k1f, K + 8 * j * STR + 8 * kd + bt_at);
          mma3_apart(s[j], sc[j], qa, k0f);
          mma3_apart(s[j + 1], sc[j + 1], qa, k1f);
        }
      }
      // the online softmax: s = -inf where masked (only a tile that
      // reaches past the length, or under the causal mask past this warp's
      // first row, has masked keys), the row max over the quad
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += sc[j][e];
      if (k0 + BK > kv_len || (causal && k0 + BK - 1 > q0 + m0)) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * c + (e & 1);
            if (col >= kv_len || (causal && col > row[e >> 1]))
              s[j][e] = -INFINITY;
          }
      }
      float mx[2] = {-INFINITY, -INFINITY}, corr[2], mu[2];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // a row with every key so far masked keeps m = -inf and l = 0; it
        // subtracts 0 instead, so that exp2 gives 0 and never NaN
        mu[i] = m_new == -INFINITY ? 0.f : m_new;
        corr[i] = exp2_approx(m[i] - mu[i]);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2_approx(s[j][e] - mu[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      // acc = acc * corr + P v, keys as the depth. The tile's product
      // has an accumulator of its own, added to acc in fp32: the chain of
      // truncating HMMA adds is then 3 BK / 8 long, not 3 T / 8
      float pv[ND][4];
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        Frag<4> pa;
        acc_to_a(pa, s[j]);
        mma_rows<ND, STR>(pv, pa, V + 8 * j * STR + b_at);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(acc[n][e], corr[e >> 1], pv[n][e]);
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  float* ob = out + b * st.o[0] + h * st.o[2];
  const long long bh = (long long)b * H + h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (row[i] >= Tq) continue;
    const bool live = l[i] > 0.f;  // a row with no valid key writes zeros
    store_row<ND>(ob + row[i] * st.o[1] + 2 * c * ND, acc, i,
                  live ? 1.f / l[i] : 0.f);
    if (c == 0)
      lse[bh * Tq + row[i]] = live ? m[i] * LN2 + logf(l[i]) : -INFINITY;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out,
           float* lse, const int* kv_lens, int B, int H, int Tq, int Tk,
           const long long* s, float scale, int causal, cudaStream_t stream) {
  using L = FwdLayout<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdStrides st = {{s[0], s[1], s[2]},
                         {s[3], s[4], s[5]},
                         {s[6], s[7], s[8]},
                         {s[9], s[10], s[11]}};
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, L::BYTES, stream>>>(
      q, k, v, out, lse, kv_lens, H, Tq, Tk, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements, ordered (batch, time, head) for q, k, v and out;
// the head dim must be contiguous, and every stride and base pointer a
// multiple of 4 floats (16-byte loads and cp.async). kv_lens (int32, B)
// may be null. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_fwd_f32(const float* q, const float* k, const float* v,
                             float* out, float* lse, const int* kv_lens,
                             int B, int H, int Tq, int Tk, int D,
                             const long long* strides, float scale,
                             int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Tq <= 0 || B <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, out, lse, kv_lens, B, H, Tq, Tk, strides,
                       scale, causal, s);
  if (D == 64)
    return launch<64>(q, k, v, out, lse, kv_lens, B, H, Tq, Tk, strides,
                      scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
