// What the attention backward kernels share: K2 (flash_bwd.cu, the dq and
// the dk/dv kernels) and K4 (flash_bwd_fused.cu, the single pass). The
// stride set, the tile sizes, and the KV-outer body that K2's dk/dv kernel
// runs and K4 runs with its share of dq added (DQ). flash_bwd.cu's note
// gives the design; tf32x3.cuh the arithmetic.

#pragma once

#include <math.h>

#include "tf32x3.cuh"

namespace {

// element strides of the (batch, time, head) axes of q, k, v, dO and the
// three gradients, each head dim contiguous
struct Strides {
  long long q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3];
};

// the 21 strides in the order q, k, v, dO, dq, dk, dv
inline Strides unpack_strides(const long long* s) {
  Strides st;
  long long* dst[7] = {st.q, st.k, st.v, st.dout, st.dq, st.dk, st.dv};
  for (int t = 0; t < 7; ++t)
    for (int a = 0; a < 3; ++a) dst[t][a] = s[3 * t + a];
  return st;
}

constexpr int TC_THREADS = 128;  // 4 warps, 16 rows of the resident tile each
constexpr int TC_ROWS = 64;      // rows of the resident tile
constexpr int TC_STREAM = 32;    // rows of a streamed tile

// Head dim D: rows of STR floats, shared memory and blocks an SM
template <int D>
struct TcLayout {
  static constexpr int STR = D + 4;
  // two resident tiles and two stages of two streamed tiles; the KV-outer
  // body adds two stages of the lse and delta rows
  static constexpr size_t TILE_BYTES =
      sizeof(float) * (2 * TC_ROWS + 4 * TC_STREAM) * STR;
  static constexpr size_t KV_BYTES = TILE_BYTES + sizeof(float) * 4 * TC_STREAM;
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 1;
};

// The body of one block per (KV tile, head, batch): the block keeps its k
// and v tiles and its dk, dv accumulators for a walk over the q tiles from
// the first that can see its keys; per q tile it recomputes P and dS with
// keys in rows, then dv += P^T dO and dk += dS^T q, queries as the depth.
// With DQ it also adds the q tile's share of dq = scale dS k into dq (fp32,
// zeroed by the caller): dS^T goes through shared memory, into the dO
// stage that no warp reads any more, to come back with queries in rows;
// each warp takes 16 of the 32 queries and half of the head dim, the
// resident k tile is the B operand, and each thread adds its own elements
// with 16-byte atomics (red.global.add.v4.f32, sm_90).
template <int D, bool DQ>
__device__ __forceinline__ void kv_outer(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    const int* __restrict__ kv_lens, int H, int Tq, int Tk,
    const Strides& st, float scale, int causal) {
  constexpr int STR = TcLayout<D>::STR, BK = TC_ROWS, BQ = TC_STREAM;
  constexpr int NQ = BQ / 8, ND = D / 8;  // 8-wide slices of queries, head dim
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * STR;
  float* Qs = Vs + BK * STR;      // two stages
  float* Os = Qs + 2 * BQ * STR;  // two stages
  float* Ls = Os + 2 * BQ * STR;  // two stages of lse rows
  float* Ds = Ls + 2 * BQ;        // two stages of delta rows

  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);  // this warp's keys of the tile
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
  const float* qbase = q + b * st.q[0] + h * st.q[2];
  const float* obase = dout + b * st.dout[0] + h * st.dout[2];
  const long long bh = (long long)b * H + h;

  // start copying q tile qt, its dO, lse and delta rows into stage buf
  auto issue = [&](int buf, int qt) {
    const int r0 = qt * BQ;
    copy_tile<D, BQ, TC_THREADS>(Qs + buf * BQ * STR, qbase, st.q[1], r0, Tq);
    copy_tile<D, BQ, TC_THREADS>(Os + buf * BQ * STR, obase, st.dout[1], r0,
                                 Tq);
    for (int i = threadIdx.x; i < 2 * BQ; i += TC_THREADS) {
      const int r = i % BQ;
      const bool ok = r0 + r < Tq;
      const float* src = i < BQ ? lse : delta;
      cp_async4((i < BQ ? Ls : Ds) + buf * BQ + r,
                ok ? src + bh * Tq + r0 + r : src, ok);
    }
  };
  if (q_first < n_q) {
    copy_tile<D, BK, TC_THREADS>(Ks, k + b * st.k[0] + h * st.k[2], st.k[1],
                                 k0, kv_len);
    copy_tile<D, BK, TC_THREADS>(Vs, v + b * st.v[0] + h * st.v[2], st.v[1],
                                 k0, kv_len);
    issue(0, q_first);
    cp_async_commit();
  }

  const int key[2] = {k0 + m0 + g, k0 + m0 + g + 8};
  const float* ka_at = Ks + m0 * STR + a_offset<STR>(lane);
  const float* va_at = Vs + m0 * STR + a_offset<STR>(lane);
  const int bt_at = bt_offset<STR>(lane), b_at = 2 * c * STR + g * ND;
  float dka[ND][4], dva[ND][4];  // head-dim slices interleaved
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
    const float* Q = Qs + cur * BQ * STR;
    const float* O = Os + cur * BQ * STR;
    const float* Lq = Ls + cur * BQ;
    const float* Dq = Ds + cur * BQ;

    // s^T = k q^T and dp^T = v dO^T: this warp's 16 keys x BQ queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < ND; ++kd) {
      Frag<4> ka, va;
      load_a(ka, ka_at + 8 * kd);
      load_a(va, va_at + 8 * kd);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        Frag<2> q0f, q1f, o0f, o1f;
        load_bt2(q0f, q1f, Q + 8 * j * STR + 8 * kd + bt_at);
        load_bt2(o0f, o1f, O + 8 * j * STR + 8 * kd + bt_at);
        mma3(s[j], ka, q0f);
        mma3(dp[j], va, o0f);
        mma3(s[j + 1], ka, q1f);
        mma3(dp[j + 1], va, o1f);
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
        const float p = ok ? expf(scale * s[j][e] - lq) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Dq[cq]);
      }
    // dv += P^T dO and dk += dS^T q, queries as the depth
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      Frag<4> pa, da;
      acc_to_a(pa, s[j]);
      acc_to_a(da, dp[j]);
      mma_rows<ND, STR>(dva, pa, O + 8 * j * STR + b_at);
      mma_rows<ND, STR>(dka, da, Q + 8 * j * STR + b_at);
    }
    if constexpr (DQ) {
      // dS (BQ queries x BK keys, rows of BK + 4 floats) into the dO
      // stage. Each 8 keys are stored in the order 0, 2, 4, 6, 1, 3, 5, 7,
      // so that an A fragment loaded as it lies has the depth order that
      // mma_rows reads k in; key g of a group goes to g / 2 + 4 (g % 2)
      constexpr int SSTR = BK + 4, NH = ND / 2;
      static_assert(SSTR <= STR, "dS must fit the dO stage");
      float* S = Os + cur * BQ * STR;
      const int kpos = m0 + (g >> 1) + 4 * (g & 1);
      __syncthreads();  // every warp is done reading dO
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          S[(8 * j + 2 * c + (e & 1)) * SSTR + kpos + 8 * (e >> 1)] =
              dp[j][e];
      __syncthreads();
      // this warp's 16 queries r0.. and head-dim slices hf * NH..
      const int warp = threadIdx.x >> 5, r0 = 16 * (warp & 1);
      const int hf = warp >> 1;
      const float* sa_at = S + r0 * SSTR + a_offset<SSTR>(lane);
      const float* kb_at = Ks + 2 * c * STR + g * ND + hf * NH;
      float dqa[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        Frag<4> da;
        load_a(da, sa_at + 8 * kk);
        mma_rows<NH, STR, ND>(dqa, da, kb_at + 8 * kk * STR);
      }
      // row i of the two, columns (2c + u) * ND + hf * NH.. of the head dim
      float* qout = dq + b * st.dq[0] + h * st.dq[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + r0 + g + 8 * i;
        if (row >= Tq) continue;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int n = 0; n < NH; n += 4)
            atomicAdd(reinterpret_cast<float4*>(qout + row * st.dq[1] +
                                                (2 * c + u) * ND + hf * NH + n),
                      make_float4(scale * dqa[n][2 * i + u],
                                  scale * dqa[n + 1][2 * i + u],
                                  scale * dqa[n + 2][2 * i + u],
                                  scale * dqa[n + 3][2 * i + u]));
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  float* kout = dk + b * st.dk[0] + h * st.dk[2];
  float* vout = dv + b * st.dv[0] + h * st.dv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Tk) continue;
    store_row<ND>(kout + key[i] * st.dk[1] + 2 * c * ND, dka, i, scale);
    store_row<ND>(vout + key[i] * st.dv[1] + 2 * c * ND, dva, i, 1.f);
  }
}

}  // namespace
