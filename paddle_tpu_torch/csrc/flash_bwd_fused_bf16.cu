// K4-bf16: the single-pass exact (flash) attention backward for Hopper on
// bf16 q, k, v and dO, the AMP twin of K4 (flash_bwd_fused.cu), on the
// tensor cores (mma.sync). Runs under PADDLE_TPU_FLASH_FUSED_BWD=1 as the
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
// with atomics (the wrapper rounds it to bf16 once), as the reference's
// fused kernel sums dq in fp32 and writes it in bf16. dqs is the gradient
// of the pre-scaled q: the wrapper multiplies it by the scale in bf16, as
// the chain rule through the reference's q * scale does.
//
// What bounds it on the H100: the backward's five products are 86.0 GFLOP
// at the causal training shape (B=16, H=16, T=1024, Dh=64), 0.087 ms at
// 989 TFLOP/s; its bf16 q, k, v, dO, dq, dk, dv and fp32 lse and delta are
// 0.24 GB, 0.070 ms at 3.35 TB/s: operations bound it.
//
// What the design does about it (a first, simple kernel: mma.sync, no
// wgmma or TMA yet):
// - Every product is mma.sync.m16n8k16 bf16 with fp32 accumulators
//   (bf16_mma.cuh). A block of 4 warps keeps its 64 keys of k and v
//   resident (each warp 16 of them) and walks 32-row q tiles (with their
//   lse and delta) from the first that can see them. Streamed tiles come
//   by cp.async, double-buffered, zero-filled past T or a length.
// - ldmatrix reads any tile in either orientation (.trans for 16-bit
//   values), so the products that read a tile transposed (P^T dO, dS^T q)
//   load it as it lies; P and dS stay in registers as the next product's
//   A operand, rounded to bf16 as they are packed.
// - The dq share needs dS with queries in rows: the block stores its bf16
//   dS^T (keys in rows) in shared memory, and ldmatrix.trans hands it back
//   as the A operand of dS k; each warp takes 16 queries and half the head
//   dim and adds its elements with 8-byte fp32 atomics.
// - P = 0 for rows past T, keys at or past the per-batch length, masked
//   causal entries and rows whose lse is -inf, so a length-0 batch gets
//   zero gradients and no NaN enters a product.
// - (batch, time, head) element strides are taken as given (head dim
//   contiguous, strides and base pointers multiples of 8 values, checked
//   by the wrapper), so BTHD and BHTD are one kernel; any T; Dh 64 or 128.
//
// chip_smoke.py prints its registers and bf16 HMMA count.

#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps, 16 rows of the resident tile each
constexpr int ROWS = 64;      // rows of the resident tile
constexpr int STREAM = 32;    // rows of a streamed tile

// element strides of the (batch, time, head) axes of q, k, v, dO and the
// three gradients, each head dim contiguous
struct BwdStrides {
  long long q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3];
};

// the 21 strides in the order q, k, v, dO, dq, dk, dv
inline BwdStrides unpack(const long long* s) {
  BwdStrides st;
  long long* dst[7] = {st.q, st.k, st.v, st.dout, st.dq, st.dk, st.dv};
  for (int t = 0; t < 7; ++t)
    for (int a = 0; a < 3; ++a) dst[t][a] = s[3 * t + a];
  return st;
}

// Head dim D: rows of STR bf16, shared memory and blocks an SM
template <int D>
struct BwdLayout {
  static constexpr int STR = D + 8;
  // two resident tiles (k, v), two stages of q and dO, two stages of the
  // lse and delta rows, and the dS^T tile
  static constexpr int SSTR = STREAM + 8;
  static constexpr size_t FUSED_BYTES =
      sizeof(bf16) * (2 * ROWS + 4 * STREAM) * STR +
      sizeof(float) * 4 * STREAM + sizeof(bf16) * ROWS * SSTR;
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 2;
};

// The body of one block per (KV tile, head, batch): the block keeps its k
// and v tiles and its dk, dv accumulators for a walk over the q tiles from
// the first that can see its keys; per q tile it recomputes P and dS with
// keys in rows, then dv += bf16(P)^T dO and dk += bf16(dS)^T qs, queries as
// the depth, and it adds the q tile's share of dqs = bf16(dS) k into dq
// (fp32, zeroed by the caller).
template <int D>
__device__ __forceinline__ void kv_outer_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    const int* __restrict__ kv_lens, int H, int Tq, int Tk,
    const BwdStrides& st, int causal) {
  using L = BwdLayout<D>;
  constexpr int STR = L::STR, SSTR = L::SSTR, BK = ROWS, BQ = STREAM;
  constexpr int NQ = BQ / 8, ND = D / 8;  // 8-wide tiles of queries, head dim
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + BK * STR;
  bf16* Qs = Vs + BK * STR;                                // two stages
  bf16* Os = Qs + 2 * BQ * STR;                            // two stages
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * STR);  // two stages
  float* Ds = Ls + 2 * BQ;                                 // two stages
  bf16* Ss = reinterpret_cast<bf16*>(Ds + 2 * BQ);  // dS^T (K4 only)

  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int warp = threadIdx.x >> 5, m0 = 16 * warp;  // this warp's keys
  const int kt = blockIdx.x;  // heaviest causal tiles (the first) first
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  int kv_len = Tk;
  if (kv_lens != nullptr) kv_len = max(0, min(kv_lens[b], Tk));

  // keys of this tile that some query may see: none past the length, and
  // under the causal mask none past the last query
  const bool live = k0 < kv_len && (!causal || k0 < Tq);
  const int n_q = live ? (Tq + BQ - 1) / BQ : 0;
  const int q_first = causal ? k0 / BQ : 0;  // query rows >= k0 see the tile
  const bf16* qbase = q + b * st.q[0] + h * st.q[2];
  const bf16* obase = dout + b * st.dout[0] + h * st.dout[2];
  const long long bh = (long long)b * H + h;

  // start copying q tile qt, its dO, lse and delta rows into stage buf
  auto issue = [&](int buf, int qt) {
    const int r0 = qt * BQ;
    copy_tile_bf16<D, BQ, THREADS>(Qs + buf * BQ * STR, qbase, st.q[1], r0,
                                   Tq);
    copy_tile_bf16<D, BQ, THREADS>(Os + buf * BQ * STR, obase, st.dout[1],
                                   r0, Tq);
    for (int i = threadIdx.x; i < 2 * BQ; i += THREADS) {
      const int r = i % BQ;
      const bool ok = r0 + r < Tq;
      const float* src = i < BQ ? lse : delta;
      cp_async4((i < BQ ? Ls : Ds) + buf * BQ + r,
                ok ? src + bh * Tq + r0 + r : src, ok);
    }
  };
  if (q_first < n_q) {
    copy_tile_bf16<D, BK, THREADS>(Ks, k + b * st.k[0] + h * st.k[2],
                                   st.k[1], k0, kv_len);
    copy_tile_bf16<D, BK, THREADS>(Vs, v + b * st.v[0] + h * st.v[2],
                                   st.v[1], k0, kv_len);
    issue(0, q_first);
    cp_async_commit();
  }

  const int key[2] = {k0 + m0 + g, k0 + m0 + g + 8};
  const bf16* ka_at = Ks + m0 * STR + off_a<STR>(lane);
  const bf16* va_at = Vs + m0 * STR + off_a<STR>(lane);
  const int bt_at = off_b<STR>(lane);
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int qt = q_first; qt < n_q; ++qt) {
    const int cur = (qt - q_first) & 1;
    if (qt + 1 < n_q) {
      issue(cur ^ 1, qt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Q = Qs + cur * BQ * STR;
    const bf16* O = Os + cur * BQ * STR;
    const float* Lq = Ls + cur * BQ;
    const float* Dq = Ds + cur * BQ;

    // s^T = k qs^T and dp^T = v dO^T: this warp's 16 keys x BQ queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t ka[4], va[4];
      ldsm4_b16(ka, ka_at + 16 * kd);
      ldsm4_b16(va, va_at + 16 * kd);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        uint32_t qf[4], of[4];
        ldsm4_b16(qf, Q + 8 * j * STR + 16 * kd + bt_at);
        ldsm4_b16(of, O + 8 * j * STR + 16 * kd + bt_at);
        mma_bf16(s[j], ka, qf[0], qf[1]);
        mma_bf16(s[j + 1], ka, qf[2], qf[3]);
        mma_bf16(dp[j], va, of[0], of[1]);
        mma_bf16(dp[j + 1], va, of[2], of[3]);
      }
    }
    // P^T into s, dS^T = P^T * (dp^T - delta) into dp; 0 where masked
    const int q0 = qt * BQ;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cq = 8 * j + 2 * c + (e & 1), rowq = q0 + cq;
        const int kk = key[e >> 1];
        const float lq = Lq[cq];
        const bool ok = rowq < Tq && lq != -INFINITY && kk < kv_len &&
                        (!causal || kk <= rowq);
        const float p = ok ? expf(s[j][e] - lq) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Dq[cq]);
      }
    // dv += bf16(P)^T dO and dk += bf16(dS)^T qs, queries as the depth
#pragma unroll
    for (int j = 0; j < NQ; j += 2) {
      uint32_t pa[4], da[4];
      acc_pair_to_a(pa, s[j], s[j + 1]);
      acc_pair_to_a(da, dp[j], dp[j + 1]);
      mma_rows_bf16<ND, STR>(dva, pa, O + 8 * j * STR, lane);
      mma_rows_bf16<ND, STR>(dka, da, Q + 8 * j * STR, lane);
    }
    {
      // bf16(dS^T) (BK keys x BQ queries) into Ss; back by ldmatrix.trans
      // as the A operand of dS k, queries in rows
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(Ss + (m0 + g + 8 * i) * SSTR + 8 * j +
                                       2 * c) =
              pack_bf16(dp[j][2 * i], dp[j][2 * i + 1]);
      __syncthreads();
      // this warp's 16 queries r0.. and half hf of the head dim
      constexpr int NH = ND / 2;
      const int r0 = 16 * (warp & 1), hf = warp >> 1;
      float dqa[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t da[4];
        ldsm4_b16t(da, Ss + 16 * kk * SSTR + r0 + off_b<SSTR>(lane));
        mma_rows_bf16<NH, STR>(dqa, da, Ks + 16 * kk * STR + hf * (D / 2),
                               lane);
      }
      float* qout = dq + b * st.dq[0] + h * st.dq[2] + hf * (D / 2);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + r0 + g + 8 * i;
        if (row >= Tq) continue;
#pragma unroll
        for (int n = 0; n < NH; ++n)
          atomicAdd(reinterpret_cast<float2*>(qout + row * st.dq[1] + 8 * n +
                                              2 * c),
                    make_float2(dqa[n][2 * i], dqa[n][2 * i + 1]));
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  bf16* kout = dk + b * st.dk[0] + h * st.dk[2];
  bf16* vout = dv + b * st.dv[0] + h * st.dv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Tk) continue;
    store_row_bf16<ND>(kout + key[i] * st.dk[1], dka, i, c, 1.f);
    store_row_bf16<ND>(vout + key[i] * st.dv[1], dva, i, c, 1.f);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, BwdLayout<D>::MIN_BLOCKS)
    flash_bwd_fused_bf16_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dq, bf16* __restrict__ dk,
                                bf16* __restrict__ dv,
                                const int* __restrict__ kv_lens, int H,
                                int Tq, int Tk, BwdStrides st, int causal) {
  kv_outer_bf16<D>(q, k, v, dout, lse, delta, dq, dk, dv, kv_lens, H,
                         Tq, Tk, st, causal);
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
           const float* lse, const float* delta, float* dq, bf16* dk,
           bf16* dv, const int* kv_lens, int B, int H, int Tq, int Tk,
           const BwdStrides& st, int causal, cudaStream_t s) {
  using L = BwdLayout<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::FUSED_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tk + ROWS - 1) / ROWS, H, B);
  flash_bwd_fused_bf16_kernel<D><<<grid, THREADS, L::FUSED_BYTES, s>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, kv_lens, H, Tq, Tk, st, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q is pre-scaled (qs); dq receives dqs. Strides are 21 element strides,
// (batch, time, head) for q, k, v, dO, dq, dk and dv in that order; every
// head dim is contiguous, and every stride and base pointer is a multiple
// of 8 values (16-byte cp.async). lse and delta are (B*H, Tq) fp32,
// contiguous. kv_lens (int32, B) may be null. dq (fp32, the dq strides in
// fp32 elements, every stride a multiple of 2) must hold zeros: the kernel
// adds into it. Returns the CUDA error of the launch (0 on success).
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const bf16* oo = static_cast<const bf16*>(dout);
  bf16* gk = static_cast<bf16*>(dk);
  bf16* gv = static_cast<bf16*>(dv);
  if (D == 128)
    return launch<128>(qq, kk, vv, oo, lse, delta, dq, gk, gv, kv_lens, B, H,
                       Tq, Tk, st, causal, s);
  if (D == 64)
    return launch<64>(qq, kk, vv, oo, lse, delta, dq, gk, gv, kv_lens, B, H,
                      Tq, Tk, st, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_fused_bf16_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
