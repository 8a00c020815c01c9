// What the bf16 attention backward kernels share: K2-bf16 (flash_bwd_bf16.cu,
// the dq and the dk/dv kernels) and K4-bf16 (flash_bwd_fused_bf16.cu, the
// single pass). The stride sets, the persistent tile walk, and the KV-outer
// body that K2-dkv-bf16 runs and K4-bf16 runs with its share of dq added
// (DQ). flash_bwd_bf16.cu's note gives the design of the body,
// flash_bwd_fused_bf16.cu's that of the dq share; sm90.cuh has the building
// blocks and the tile layout.

#pragma once

#include "sm90.cuh"

// A part of K4-bf16's dq share to leave out, for timing what each costs
// (chip_smoke.py --k4-ablations builds each; its dq is then wrong): 1 the
// reductions (the stage is still written), 2 half of them (each
// warpgroup's second box), 3 the stage and the reductions, 4 those and the
// dq product. The library leaves out nothing.
#ifndef K4_BF16_OMIT
#define K4_BF16_OMIT 0
#endif

namespace {

constexpr int CONSUMERS = 2;                    // warpgroups of 64 rows
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer's
constexpr int RES = 64 * CONSUMERS;             // rows of the resident tile
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

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

// element strides of one output's (batch, time, head) axes
struct OutStrides {
  long long o[3];
};

// The KV-outer body's shared memory. With DQ (K4-bf16) it also holds
// DS_SLOTS slots of a q tile's bf16 dS (BQ queries x the 128 keys, keys in
// two 64-key boxes: box w is warpgroup w's) and each warpgroup's fp32 tile
// of dqs staged for its reduction into global memory (32 rows x 64 values
// in two 128-byte-swizzled boxes of 32 values), and it streams fewer q
// tiles ahead to make room.
template <int D, bool DQ = false>
struct DkvLayout {
  // q rows of a streamed tile: 32 at Dh 128, so that dK and dV (64
  // registers each) leave room for the tile's scores
  static constexpr int BQ = D == 64 ? 64 : 32;
  static constexpr int STAGES = DQ ? (D == 64 ? 5 : 3) : (D == 64 ? 8 : 5);
  static constexpr uint32_t RES_BYTES = RES * D * 2;  // K or V
  static constexpr uint32_t Q_BYTES = BQ * D * 2;     // one qs or dO tile
  // a tile's lse or delta rows come as a box of ROW_BOX values that starts
  // on a 16-byte boundary at or up to 3 values before the tile's first
  // row (row_off), in a slot of ROW_SLOT values
  static constexpr int ROW_BOX = BQ + 4, ROW_SLOT = 96;
  static constexpr uint32_t SLOT_TX = 2 * Q_BYTES + 2 * ROW_BOX * 4;
  static constexpr int DS_SLOTS = DQ ? 3 : 0;
  static constexpr uint32_t DS_BYTES = BQ * RES * 2;  // one dS slot
  static constexpr uint32_t STG_BYTES = DQ ? CONSUMERS * 32 * 64 * 4 : 0;
  // two slots of K and V, the ring, the dS slots and the staged dqs, and
  // 1024 bytes to align them; with DQ the dS slots' mbarriers
  static constexpr size_t BYTES =
      1024 + 4 * RES_BYTES + STAGES * (2 * Q_BYTES + 2 * ROW_SLOT * 4) +
      DS_SLOTS * DS_BYTES + STG_BYTES + (DQ ? 2 * DS_SLOTS * 8 : 0);
};

// where a tile's first row (the flat index of its lse) sits in its box
__device__ __forceinline__ int row_off(long long at) {
  return static_cast<int>(at & 3);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// A tile of the persistent walks: its first row (q rows for dq, keys for
// dk/dv), head and batch, the batch's KV length, and the streamed tiles it
// reads. The heaviest causal tiles of every head come first: for dq the
// last q tiles, for dk/dv the first KV tiles.
struct BwdTile {
  int r0, h, b, kv_len;
};

__device__ __forceinline__ BwdTile bwd_tile(int t, int H, int B, int T,
                                            bool last_first, int Tk,
                                            const int* kv_lens) {
  const int n = (T + RES - 1) / RES, hb = t % (H * B), i = t / (H * B);
  BwdTile f;
  f.r0 = (last_first ? n - 1 - i : i) * RES;
  f.h = hb % H;
  f.b = hb / H;
  f.kv_len = Tk;
  if (kv_lens != nullptr) f.kv_len = max(0, min(kv_lens[f.b], Tk));
  return f;
}

// dk and dv for 128-key KV tiles: a persistent grid, block i taking tiles
// i, i + gridDim.x, ...; each tile sums over the q tiles from the first
// that can see its keys. Two slots for the resident K and V, so that the
// next tile's land while this one finishes; the q ring runs on from tile
// to tile. With DQ, each q tile's dqs = bf16(dS) K over the tile's 128
// keys is added into ``dq_map``'s fp32 tensor (zeroed by the caller) as
// well: every q tile from the first is computed by both warpgroups, and
// the dq product of q tile i is issued first in the turn two after its
// scores (see flash_bwd_fused_bf16.cu), and the bytes each block adds
// are added to ``dq_bytes`` once it is done.
template <int D, bool DQ>
__device__ __forceinline__ void kv_walk_bf16(
    const CUtensorMap& q_map, const CUtensorMap& k_map,
    const CUtensorMap& v_map, const CUtensorMap& do_map,
    const CUtensorMap& lse_map, const CUtensorMap& delta_map,
    const CUtensorMap* dq_map, unsigned long long* dq_bytes,
    bf16* __restrict__ dk, bf16* __restrict__ dv,
    const int* __restrict__ kv_lens, int H, int B, int Tq, int Tk,
    const OutStrides& sk, const OutStrides& sv, int causal) {
  using L = DkvLayout<D, DQ>;
  constexpr int S = L::STAGES, NB = D / 64, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t res_full[2], res_empty[2], full[S], empty[S];
  uint8_t* Rs = align1024(smem_raw);  // 2 slots of K then V, NB boxes each
  uint8_t* Qs = Rs + 4 * L::RES_BYTES;  // S slots of NB boxes of BQ x 64
  uint8_t* Os = Qs + S * L::Q_BYTES;    // dO, the same
  uint8_t* DSs = Os + S * L::Q_BYTES;   // DQ: the dS slots
  uint8_t* STG = DSs + L::DS_SLOTS * L::DS_BYTES;  // DQ: staged dqs
  float* Ls = reinterpret_cast<float*>(STG + L::STG_BYTES);  // S row slots
  float* Ds = Ls + S * L::ROW_SLOT;                           // the same
  // DQ: a dS slot is full when all 8 consumer warps have stored their
  // part, empty when all 8 have read it
  uint64_t* ds_full = reinterpret_cast<uint64_t*>(Ds + S * L::ROW_SLOT);
  uint64_t* ds_empty = ds_full + L::DS_SLOTS;
  // DQ: each warpgroup's count of the 128-byte rows it added into dq (at a
  // fixed address, so that no register holds it)
  __shared__ uint32_t dq_rows[CONSUMERS];
  const int tiles = (Tk + RES - 1) / RES * H * B;
  // the q tiles a KV tile reads: from the first that can see its keys
  // (query rows >= k0 under the causal mask), none if no query sees them
  auto q_range = [&](const BwdTile& f, int& q_first, int& n_q) {
    const bool live = f.r0 < f.kv_len && (!causal || f.r0 < Tq);
    n_q = live ? (Tq + BQ - 1) / BQ : 0;
    q_first = causal ? f.r0 / BQ : 0;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&res_full[i], 1);
      mbar_init(&res_empty[i], 4 * CONSUMERS);  // each consumer warp arrives
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);
    }
    if constexpr (DQ) {
      for (int s = 0; s < L::DS_SLOTS; ++s) {
        mbar_init(&ds_full[s], 4 * CONSUMERS);
        mbar_init(&ds_empty[s], 4 * CONSUMERS);
      }
      for (int w = 0; w < CONSUMERS; ++w) dq_rows[w] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup_idx();
  if (wg == CONSUMERS) {
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int it = 0, ri = 0;  // q tiles and resident tiles loaded so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const BwdTile f = bwd_tile(t, H, B, Tk, false, Tk, kv_lens);
        int q_first, n_q;
        q_range(f, q_first, n_q);
        if (q_first >= n_q) continue;
        uint8_t* K = Rs + (ri % 2) * 2 * L::RES_BYTES;
        uint8_t* V = K + L::RES_BYTES;
        mbar_wait(&res_empty[ri % 2], ((ri / 2) & 1) ^ 1);
        mbar_expect_tx(&res_full[ri % 2], 2 * L::RES_BYTES);
        for (int x = 0; x < NB; ++x) {
          tma_load_4d(K + x * RES * 128, &k_map, &res_full[ri % 2], 64 * x,
                      f.h, f.r0, f.b);
          tma_load_4d(V + x * RES * 128, &v_map, &res_full[ri % 2], 64 * x,
                      f.h, f.r0, f.b);
        }
        ++ri;
        const int bhT = (f.b * H + f.h) * Tq;
        for (int qt = q_first; qt < n_q; ++qt, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          uint8_t* Q = Qs + s * L::Q_BYTES;
          uint8_t* O = Os + s * L::Q_BYTES;
          mbar_expect_tx(&full[s], L::SLOT_TX);
          for (int x = 0; x < NB; ++x) {
            tma_load_4d(Q + x * BQ * 128, &q_map, &full[s], 64 * x, f.h,
                        qt * BQ, f.b);
            tma_load_4d(O + x * BQ * 128, &do_map, &full[s], 64 * x, f.h,
                        qt * BQ, f.b);
          }
          // the rows' lse and delta from the 16-byte boundary at or before
          // the first (past this head's Tq rows the box reads the next
          // head's or zeros: those queries are masked)
          const int at = bhT + qt * BQ;
          tma_load_1d(Ls + s * L::ROW_SLOT, &lse_map, &full[s], at & ~3);
          tma_load_1d(Ds + s * L::ROW_SLOT, &delta_map, &full[s], at & ~3);
        }
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    const int warp = warp_in_warpgroup(), lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;
    float dka[D / 2], dva[D / 2], sc[BQ / 2], dp[BQ / 2];
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    float dqa[DQ ? 16 : 1];  // DQ: this warpgroup's part of a q tile's dqs
    // DQ: the thread that issues this warpgroup's reductions
    const int elected = threadIdx.x % 128 == 0;
    turns_begin(wg);
    int it = 0, ri = 0;  // as the producer counts them
    int dsi = 0;         // DQ: q tiles whose dS went through the slots
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const BwdTile f = bwd_tile(t, H, B, Tk, false, Tk, kv_lens);
      const int kv_len = f.kv_len;
      int q_first, n_q;
      q_range(f, q_first, n_q);
      const int kw = f.r0 + 64 * wg;  // this warpgroup's first key
      const int kr = kw + 16 * warp;  // this warp's
      const int key[2] = {kr + g, kr + g + 8};
      const long long bh = (long long)f.b * H + f.h;
#pragma unroll
      for (int n = 0; n < D / 2; ++n) dka[n] = dva[n] = 0.f;
      // this warpgroup's keys of each box of the resident K and V
      const uint8_t* Kw = Rs + (ri % 2) * 2 * L::RES_BYTES + wg * 64 * 128;
      const uint8_t* Vw = Kw + L::RES_BYTES;
      const int n_t = max(n_q - q_first, 0);
      if (n_t > 0) mbar_wait(&res_full[ri % 2], (ri / 2) & 1);

      // Of the n_t q tiles from q_first, [t0, n_t) are computed: none if
      // every key of this warpgroup is past the length, and under the
      // causal mask none that ends before its first key. Turn i issues q
      // tile i's S^T = K qs^T and dP^T = V dO^T, then q tile i - 1's
      // dV += bf16(P^T) dO and dK += bf16(dS^T) qs; tile i's P^T and dS^T
      // are computed once S^T and dP^T are in, while the dk/dv products
      // still run and while the other warpgroup's turn holds the tensor
      // cores; then tile i - 1's slot is freed. The first and the last
      // computed turn are peeled, so that the steady loop issues the same
      // products every time (ptxas serialises wgmma otherwise). A tile that
      // is not computed takes its turn and frees its slot once it has
      // landed. Each warpgroup takes n_t + 1 turns a KV tile (n_t + 2 with
      // DQ, whose last dq product takes a turn of its own).
      int t0 = kw < kv_len ? 0 : n_t;
      if (causal) t0 = max(t0, kw / BQ - q_first);
      t0 = min(t0, n_t);
      // DQ: the dq product reads both warpgroups' dS, so both compute
      // every tile (masked entries give P = 0)
      if constexpr (DQ) t0 = 0;
      auto wait_q = [&](int i) {
        mbar_wait(&full[(it + i) % S], ((it + i) / S) & 1);
      };
      auto scores = [&](int i) {
        // s^T = k qs^T and dp^T = v dO^T: 64 keys x BQ queries
        const uint8_t* Q = Qs + (it + i) % S * L::Q_BYTES;
        const uint8_t* O = Os + (it + i) % S * L::Q_BYTES;
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int x = kd / 4, at = (kd % 4) * 32;
          wgmma_ss<BQ>(sc, desc_sw128(Kw + x * RES * 128 + at, 16, 1024),
                          desc_sw128(Q + x * BQ * 128 + at, 16, 1024),
                          kd > 0);
        }
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int x = kd / 4, at = (kd % 4) * 32;
          wgmma_ss<BQ>(dp, desc_sw128(Vw + x * RES * 128 + at, 16, 1024),
                          desc_sw128(O + x * BQ * 128 + at, 16, 1024),
                          kd > 0);
        }
        wgmma_commit();
        fence_regs(sc);
        fence_regs(dp);
      };
      auto kv_products = [&](int i) {
        // dv += bf16(P^T) dO and dk += bf16(dS^T) qs, queries as the
        // depth: dO and qs read N-major
        const uint8_t* Q = Qs + (it + i) % S * L::Q_BYTES;
        const uint8_t* O = Os + (it + i) % S * L::Q_BYTES;
        fence_regs(dva);
        fence_regs(dka);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<D>(dva, pa[kk],
                         desc_sw128(O + kk * 2048, BQ * 128, 1024));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs<D>(dka, da[kk],
                         desc_sw128(Q + kk * 2048, BQ * 128, 1024));
        wgmma_commit();
        fence_regs(dva);
        fence_regs(dka);
      };
      auto p_ds = [&](int i) {
        // P^T into sc, dS^T = P^T * (dp^T - delta) into dp; 0 where masked
        fence_regs(sc);
        fence_regs(dp);
        const int s = (it + i) % S, q0 = (q_first + i) * BQ;
        const float* Lq = Ls + s * L::ROW_SLOT + row_off(bh * Tq + q0);
        const float* Dq = Ds + s * L::ROW_SLOT + row_off(bh * Tq + q0);
        const bool edge = kr + 15 >= kv_len || (causal && kr + 15 > q0);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cq = 8 * j + 2 * c + (e & 1), kk = key[e >> 1];
            const float lq = Lq[cq];
            const float l2 = q0 + cq < Tq && lq != -INFINITY ? lq * LOG2E
                                                            : INFINITY;
            float p = exp2_approx(fmaf(sc[4 * j + e], LOG2E, -l2));
            if (edge && (kk >= kv_len || (causal && kk > q0 + cq))) p = 0.f;
            sc[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - Dq[cq]);
          }
      };
      auto pack = [&]() {
        acc_to_a<BQ / 2>(pa, sc);
        acc_to_a<BQ / 2>(da, dp);
      };
      auto release = [&](int i) {
        __syncwarp();
        mbar_arrive_lane0(&empty[(it + i) % S], lane);
      };
      for (int i = 0; i < t0; ++i) {
        wait_q(i);
        turn_wait(wg);
        turn_pass(wg);
        release(i);
      }
      if constexpr (!DQ) {
        if (t0 < n_t) {
          wait_q(t0);
          turn_wait(wg);
          scores(t0);
          turn_pass(wg);
          wgmma_wait<0>();
          p_ds(t0);
          pack();
          for (int i = t0 + 1; i < n_t; ++i) {
            wait_q(i);
            turn_wait(wg);
            scores(i);
            kv_products(i - 1);
            turn_pass(wg);
            wgmma_wait<1>();  // S^T and dP^T are in; dk/dv may still run
            p_ds(i);
            wgmma_wait<0>();
            fence_regs(dva);
            fence_regs(dka);
            release(i - 1);
            pack();
          }
          turn_wait(wg);
          kv_products(n_t - 1);
          turn_pass(wg);
          wgmma_wait<0>();
          fence_regs(dva);
          fence_regs(dka);
          release(n_t - 1);
        } else {
          turn_wait(wg);
          turn_pass(wg);
        }
      } else {
        // The dq share. After tile i's dS^T is packed (da, keys as rows),
        // put_ds stores it transposed (stmatrix), queries as rows, into
        // dS slot (dsi + i) % DS_SLOTS, this warpgroup's 64 keys as box wg.
        // Turn i + 2 issues dq_product(i) first: dqs^T = K^T dS^T over all
        // 128 keys, K^T read N-major (the resident K as it lies), dS^T
        // K-major; warpgroup w takes queries 32w.. of the tile at Dh 64 and
        // head-dim values 64w.. at Dh 128, so each element of the tile is
        // added once. By then both warpgroups' halves are in (the turns
        // order the other warpgroup's put_ds(i) before this turn; ds_full
        // checks it). Once it and the scores have run, add_dq(i) stages
        // the fp32 part in shared memory and one thread adds it into dq by
        // two TMA reductions, before the softmax (whose registers the
        // part's would otherwise crowd).
        const uint8_t* Kq = Rs + (ri % 2) * 2 * L::RES_BYTES +
                            (D == 128 ? wg * RES * 128 : 0);
        auto slot = [&](int i) { return (dsi + i) % L::DS_SLOTS; };
        auto phase = [&](int i) { return ((dsi + i) / L::DS_SLOTS) & 1; };
        auto put_ds = [&](int i) {
          mbar_wait(&ds_empty[slot(i)], phase(i) ^ 1);
          uint8_t* box = DSs + slot(i) * L::DS_BYTES + wg * BQ * 128;
          // lane l gives row l % 8 of matrix l / 8: matrix m of da[kk] is
          // queries 16 kk + 8 (m / 2) .. + 7 x keys 16 warp + 8 (m % 2) ..
          const int m = lane / 8, r = lane % 8;
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            const int q = 16 * kk + 8 * (m / 2) + r;
            stmatrix_x4_trans(box + q * 128 + (((2 * warp + m % 2) ^ r) << 4),
                              da[kk]);
          }
          fence_proxy_async();
          __syncwarp();
          mbar_arrive_lane0(&ds_full[slot(i)], lane);
        };
        auto dq_product = [&](int i) {
          if constexpr (K4_BF16_OMIT == 4) return;
          mbar_wait(&ds_full[slot(i)], phase(i));
          const uint8_t* dS = DSs + slot(i) * L::DS_BYTES +
                              (D == 64 ? wg * 32 * 128 : 0);
          fence_regs(dqa);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < RES / 16; ++kk)
            wgmma_ss_ta_n32(
                dqa, desc_sw128(Kq + kk * 2048, RES * 128, 1024),
                desc_sw128(dS + kk / 4 * BQ * 128 + kk % 4 * 32, 16, 1024),
                kk > 0);
          wgmma_commit();
          fence_regs(dqa);
        };
        auto free_ds = [&](int i) {
          __syncwarp();
          mbar_arrive_lane0(&ds_empty[slot(i)], lane);
        };
        auto add_dq = [&](int i) {
          // dqa holds (head-dim value 16 warp + 8 h2 + g, query 8j + 2c + e)
          // of this warpgroup's part; the stage is two boxes of 32 rows
          // (queries) x 32 values, chunk x of row q at x ^ (q % 8)
          if constexpr (K4_BF16_OMIT >= 3) return;
          uint8_t* stg = STG + wg * 32 * 64 * 4;
          bulk_wait_read(elected);  // the last reduction has read the stage
          named_sync(3 + wg, 128);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int dh = 16 * warp + 8 * h2 + g, q = 8 * j + 2 * c + e;
                const int col = dh % 32;
                *reinterpret_cast<float*>(
                    stg + dh / 32 * 4096 + q * 128 +
                    (((col / 4) ^ (q % 8)) << 4) + (col % 4) * 4) =
                    dqa[4 * j + 2 * h2 + e];
              }
          fence_proxy_async();
          named_sync(3 + wg, 128);
          const int dh0 = D == 128 ? 64 * wg : 0;
          const int qr = (q_first + i) * BQ + (D == 64 ? 32 * wg : 0);
          constexpr int boxes = K4_BF16_OMIT == 1   ? 0
                                : K4_BF16_OMIT == 2 ? 1
                                                    : 2;
          if (boxes > 0)
            tma_reduce_add_4d(elected, stg, dq_map, dh0, f.h, qr, f.b);
          if (boxes > 1)
            tma_reduce_add_4d(elected, stg + 4096, dq_map, dh0 + 32, f.h, qr,
                              f.b);
          bulk_commit(elected);
          // counted: 32 fp32 values of each box's rows before Tq (the map
          // leaves the others out)
          const int rows = min(32, Tq - qr);
          if (elected && rows > 0) dq_rows[wg] += boxes * rows;
        };
        if (n_t > 0) {
          wait_q(0);
          turn_wait(wg);
          scores(0);
          turn_pass(wg);
          wgmma_wait<0>();
          p_ds(0);
          pack();
          put_ds(0);
          if (n_t > 1) {
            wait_q(1);
            turn_wait(wg);
            scores(1);
            kv_products(0);
            turn_pass(wg);
            wgmma_wait<1>();  // S^T and dP^T are in; dk/dv may still run
            p_ds(1);
            wgmma_wait<0>();
            fence_regs(dva);
            fence_regs(dka);
            release(0);
            pack();
            put_ds(1);
            for (int i = 2; i < n_t; ++i) {
              wait_q(i);
              turn_wait(wg);
              dq_product(i - 2);
              scores(i);
              kv_products(i - 1);
              turn_pass(wg);
              wgmma_wait<1>();  // the dq product, S^T and dP^T are in
              fence_regs(dqa);
              free_ds(i - 2);
              add_dq(i - 2);
              p_ds(i);
              wgmma_wait<0>();
              fence_regs(dva);
              fence_regs(dka);
              release(i - 1);
              pack();
              put_ds(i);
            }
            turn_wait(wg);
            dq_product(n_t - 2);
            kv_products(n_t - 1);
            turn_pass(wg);
            wgmma_wait<1>();  // the dq product is in
            fence_regs(dqa);
            free_ds(n_t - 2);
            add_dq(n_t - 2);
            wgmma_wait<0>();
            fence_regs(dva);
            fence_regs(dka);
            release(n_t - 1);
          } else {
            turn_wait(wg);
            kv_products(0);
            turn_pass(wg);
            wgmma_wait<0>();
            fence_regs(dva);
            fence_regs(dka);
            release(0);
          }
          turn_wait(wg);
          dq_product(n_t - 1);
          turn_pass(wg);
          wgmma_wait<0>();
          fence_regs(dqa);
          free_ds(n_t - 1);
          add_dq(n_t - 1);
          dsi += n_t;
        } else {
          turn_wait(wg);
          turn_pass(wg);
        }
      }
      it += n_t;
      if (n_t > 0) {  // this resident slot is free for the tile after next
        __syncwarp();
        mbar_arrive_lane0(&res_empty[ri % 2], lane);
        ++ri;
      }

      bf16* kout = dk + f.b * sk.o[0] + f.h * sk.o[2];
      bf16* vout = dv + f.b * sv.o[0] + f.h * sv.o[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (key[i] >= Tk) continue;
        bf16* krow = kout + key[i] * sk.o[1];
        bf16* vrow = vout + key[i] * sv.o[1];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(krow + 8 * n + 2 * c) =
              pack_bf16(dka[4 * n + 2 * i], dka[4 * n + 2 * i + 1]);
          *reinterpret_cast<uint32_t*>(vrow + 8 * n + 2 * c) =
              pack_bf16(dva[4 * n + 2 * i], dva[4 * n + 2 * i + 1]);
        }
      }
    }
    if constexpr (DQ) {
      bulk_wait(elected);  // the stage outlives its reads
      if (elected) atomicAdd(dq_bytes, 128ull * dq_rows[wg]);
    }
  }
}

// the map of a head tensor with T rows, or, when T is 0 and it is never
// read, one that describes ``alt`` (T_alt rows) instead
inline int map_or_alt(CUtensorMap* m, const char* what, const void* p, int T,
                      const void* alt, int T_alt, int D, int H, int B,
                      const long long* st, const long long* st_alt,
                      int rows) {
  return T > 0 ? head_map(m, what, p, D, H, T, B, st, rows)
               : head_map(m, what, alt, D, H, T_alt, B, st_alt, rows);
}

// the six maps that the KV-outer body reads, in the order q, k, v, dO, lse,
// delta (k and v in RES-row boxes, q and dO in BQ-row ones). Returns 0 or
// a MAP_ERROR code.
template <int D, bool DQ>
int kv_walk_maps(CUtensorMap (&m)[6], const bf16* q, const bf16* k,
                 const bf16* v, const bf16* dout, const float* lse,
                 const float* delta, int B, int H, int Tq, int Tk,
                 const BwdStrides& st) {
  using L = DkvLayout<D, DQ>;
  int err = head_map(&m[1], "k", k, D, H, Tk, B, st.k, RES);
  if (!err) err = head_map(&m[2], "v", v, D, H, Tk, B, st.v, RES);
  if (!err)
    err = map_or_alt(&m[0], "q", q, Tq, k, Tk, D, H, B, st.q, st.k, L::BQ);
  if (!err)
    err = map_or_alt(&m[3], "dO", dout, Tq, k, Tk, D, H, B, st.dout, st.k,
                     L::BQ);
  // with no queries the rows are never read: their maps then describe k
  const float* none = reinterpret_cast<const float*>(k);
  const long long rows = static_cast<long long>(B) * H * Tq;
  if (!err)
    err = row_map(&m[4], "lse", rows > 0 ? lse : none, rows > 0 ? rows : 1,
                  L::ROW_BOX);
  if (!err)
    err = row_map(&m[5], "delta", rows > 0 ? delta : none,
                  rows > 0 ? rows : 1, L::ROW_BOX);
  return err;
}

}  // namespace
