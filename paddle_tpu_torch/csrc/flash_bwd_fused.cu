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
// 0.3 GB), bound by operations: 1.28 ms on CUDA cores (67 TFLOP/s fp32),
// where this kernel runs them, and 0.52 ms for fp32-accurate products on
// the tensor cores (3xTF32, as K2 does them). The atomics add 64*Dh adds per
// (q tile, KV tile) pair through L2 (dq, 64 MB at the training shape,
// mostly stays there).
//
// Tiles are 64 rows, q and KV alike, read through (batch, time, head)
// element strides with a contiguous head dim (flash_bwd_strides.cuh, shared
// with K2). A block has 256 threads in a 16 x 16 grid (ty, tx),
// each owning a 4x4 patch of a 64x64 score tile and a 4 x Dh/16 patch of
// its accumulators, as in K1 (flash_fwd.cu). Rows of the staged q, k, v and
// dO tiles are padded to Dh + 1 floats so that column reads are free of
// bank conflicts. q is staged multiplied by the softmax scale, exactly as
// K1 stages it, so the recomputed scores are K1's. P = exp(s - lse) is 0
// for rows past T, for keys at or past the per-batch length, under the
// causal mask, and for rows whose lse is -inf (no valid key at all), so a
// gradient never sees exp(-inf - -inf).

#include <cuda_runtime.h>
#include <math.h>

#include "flash_bwd_strides.cuh"

namespace {

constexpr int BT = 64;         // rows per tile, q and KV alike
constexpr int NT = 256;        // threads: a 16 x 16 grid (ty, tx)
constexpr int PSTR = BT + 16;  // row stride of the P and dS tiles

template <int D>
struct Layout {
  static constexpr int STR = D + 1;
  static constexpr int TILE = BT * STR;
  static constexpr int PT = BT * PSTR;
  // four row tiles, the P and dS tiles, and the lse and delta rows
  static constexpr size_t BYTES = sizeof(float) * (4 * TILE + 2 * PT + 2 * BT);
};

// a 64-row tile of a (rows, D) head slice into padded shared memory, times
// `mul`; rows at or past `n` read as 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int r0, int n,
                                          float mul) {
  constexpr int D4 = D / 4;
  for (int i = threadIdx.x; i < BT * D4; i += NT) {
    const int r = i / D4, c = (i % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = *reinterpret_cast<const float4*>(src + (r0 + r) * st + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x * mul;
    d[1] = x.y * mul;
    d[2] = x.z * mul;
    d[3] = x.w * mul;
  }
}

// rows [r0, r0+64) of one (batch, head)'s lse and delta; rows past n get
// lse -inf, which masks them
__device__ __forceinline__ void load_stats(float* ls, float* ds,
                                           const float* lse,
                                           const float* delta, long long bh,
                                           int r0, int n) {
  for (int i = threadIdx.x; i < BT; i += NT) {
    const bool in = r0 + i < n;
    ls[i] = in ? lse[bh * n + r0 + i] : -INFINITY;
    ds[i] = in ? delta[bh * n + r0 + i] : 0.f;
  }
}

// One block per (KV tile, head, batch). The block keeps its k and v tiles
// and its dk, dv accumulators (registers) for a walk over the q tiles from
// the first that can see its keys (causal: the tile holding its first
// key); per q tile it recomputes P and dS with keys in rows, then
//   dv += P^T dO,  dk += dS^T (q scale)
// and adds this tile's share of dq = scale dS k into the zeroed fp32 dq
// buffer with atomicAdd.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_kv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    const int* __restrict__ kv_lens, int H, int Tq, int Tk, Strides st,
    float scale, int causal) {
  using L = Layout<D>;
  constexpr int STR = L::STR;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::TILE;
  float* Qs = Vs + L::TILE;  // q * scale
  float* Os = Qs + L::TILE;  // dO
  float* Ps = Os + L::TILE;  // P, keys in rows
  float* Ss = Ps + L::PT;    // dS, keys in rows
  float* Ls = Ss + L::PT;
  float* Ds = Ls + BT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt = blockIdx.x;  // heaviest causal tiles (the first) first
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BT;
  int kv_len = Tk;
  if (kv_lens != nullptr) kv_len = max(0, min(kv_lens[b], Tk));

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  // keys of this tile that some query may see: none past the length, and
  // under the causal mask none past the last query
  const bool live = k0 < kv_len && (!causal || k0 < Tq);
  if (live) {
    load_tile<D>(Ks, k + b * st.k[0] + h * st.k[2], st.k[1], k0, kv_len, 1.f);
    load_tile<D>(Vs, v + b * st.v[0] + h * st.v[2], st.v[1], k0, kv_len, 1.f);
  }
  const float* qbase = q + b * st.q[0] + h * st.q[2];
  const float* obase = dout + b * st.dout[0] + h * st.dout[2];
  const int n_q = live ? (Tq + BT - 1) / BT : 0;
  const int q_first = causal ? k0 / BT : 0;  // query rows >= k0 see the tile

  for (int qt = q_first; qt < n_q; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // the previous tile's readers of q, dO, P, dS are done
    load_tile<D>(Qs, qbase, st.q[1], q0, Tq, scale);
    load_tile<D>(Os, obase, st.dout[1], q0, Tq, 1.f);
    load_stats(Ls, Ds, lse, delta, (long long)b * H + h, q0, Tq);
    __syncthreads();

    // transposed tiles: keys ty + 16i in rows, queries tx + 16j in columns
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qa[4], oa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = Ks[(ty + 16 * i) * STR + d];
        va[i] = Vs[(ty + 16 * i) * STR + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qa[j] = Qs[(tx + 16 * j) * STR + d];
        oa[j] = Os[(tx + 16 * j) * STR + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[j], ka[i], s[i][j]);
          dp[i][j] = fmaf(oa[j], va[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, key = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, row = q0 + c;
        const float l = Ls[c];
        const bool ok = l != -INFINITY && key < kv_len && (!causal || key <= row);
        const float p = ok ? expf(s[i][j] - l) : 0.f;
        Ps[r * PSTR + c] = p;
        Ss[r * PSTR + c] = p * (dp[i][j] - Ds[c]);
      }
    }
    __syncthreads();

    // dv += P^T dO and dk += dS^T (q scale), keys ty + 16i, columns tx + 16c
#pragma unroll 2
    for (int qq = 0; qq < BT; ++qq) {
      float pa[4], sa[4], oa[DC], qa[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = Ps[(ty + 16 * i) * PSTR + qq];
        sa[i] = Ss[(ty + 16 * i) * PSTR + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        oa[c] = Os[qq * STR + tx + 16 * c];
        qa[c] = Qs[qq * STR + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dva[i][c] = fmaf(pa[i], oa[c], dva[i][c]);
          dka[i][c] = fmaf(sa[i], qa[c], dka[i][c]);
        }
    }

    // this tile's share of dq = scale * dS k: queries ty + 16i, columns
    // tx + 16c, added into the zeroed fp32 buffer
    float dqa[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) dqa[i][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < BT; ++kk) {
      float sa[4], ka[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = Ss[kk * PSTR + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < DC; ++c) ka[c] = Ks[kk * STR + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dqa[i][c] = fmaf(sa[i], ka[c], dqa[i][c]);
    }
    float* dqbase = dq + b * st.dq[0] + h * st.dq[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row >= Tq) continue;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        atomicAdd(dqbase + row * st.dq[1] + tx + 16 * c, scale * dqa[i][c]);
    }
  }

  float* kout = dk + b * st.dk[0] + h * st.dk[2];
  float* vout = dv + b * st.dv[0] + h * st.dv[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      kout[key * st.dk[1] + tx + 16 * c] = dka[i][c];
      vout[key * st.dv[1] + tx + 16 * c] = dva[i][c];
    }
  }
}

template <int D>
int launch_kv(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, float* dk, float* dv, const int* kv_lens, int B,
              int H, int Tq, int Tk, const Strides& st, float scale,
              int causal, cudaStream_t s) {
  const size_t smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tk + BT - 1) / BT, H, B);
  flash_bwd_kv_kernel<D><<<grid, NT, smem, s>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, kv_lens, H, Tq, Tk, st, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// the KV-outer kernel for head dim D (64 or 128) after setting the device;
// the CUDA error of the launch, 0 on success
int run_kv(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dq, float* dk,
           float* dv, const int* kv_lens, int B, int H, int Tq, int Tk, int D,
           const long long* strides, float scale, int causal, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Tk <= 0 || B <= 0 || H <= 0) return 0;
  const Strides st = unpack_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_kv<128>(q, k, v, dout, lse, delta, dq, dk, dv, kv_lens,
                          B, H, Tq, Tk, st, scale, causal, s);
  if (D == 64)
    return launch_kv<64>(q, k, v, dout, lse, delta, dq, dk, dv, kv_lens,
                         B, H, Tq, Tk, st, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

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
  return run_kv(q, k, v, dout, lse, delta, dq, dk, dv, kv_lens, B, H, Tq,
                Tk, D, strides, scale, causal, device, stream);
}

extern "C" const char* flash_bwd_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
