// K2-bf16: exact (flash) attention backward for Hopper on bf16 q, k, v and
// dO, the AMP twin of K2 (flash_bwd.cu), on the tensor cores by wgmma. Two
// kernels: dq, and dk/dv. (K4-bf16, the single pass, is
// flash_bwd_fused_bf16.cu.)
//
// Replaces paddle_tpu/ops/attention.py:_mha_dq_kernel and _mha_dkv_kernel
// as the reference runs them under bf16 AMP. They compute the same
// functions in the same rounding order, from the pre-scaled bf16 q (qs),
// the forward's fp32 lse and the fp32 delta = rowsum(dO * O) (made by the
// wrapper from the bf16 dO and out): each score tile is recomputed in fp32
// as s = qs k^T, P = exp(s - lse) and dS = P * (dO v^T - delta), then
//   dqs = bf16(dS) k        (dq kernel: one block per q tile)
//   dv = bf16(P)^T dO, dk = bf16(dS)^T qs   (dk/dv kernel: per KV tile)
// with bf16 operands and fp32 sums, each written once in bf16. dqs is the
// gradient of the pre-scaled q: the wrapper multiplies it by the scale in
// bf16, as the chain rule through the reference's q * scale does. No
// atomics: two calls on the same inputs give the same bits.
//
// What bounds it on the H100: the backward's five products are 86.0 GFLOP
// at the causal training shape (B=16, H=16, T=1024, Dh=64), 0.087 ms at
// 989 TFLOP/s; its bf16 q, k, v, dO, dq, dk, dv and fp32 lse and delta are
// 0.24 GB, 0.070 ms at 3.35 TB/s. The split form does seven products (dq 3,
// dk/dv 4): operations bound it.
//
// The design (sm90.cuh has the building blocks and the tile layout):
// - Each kernel: a persistent grid, one block an SM, walking its tiles
//   with the heaviest causal tiles of every head first; two consumer
//   warpgroups, each owning 64 rows of the block's resident tile, and one
//   producer warpgroup of which one thread issues every TMA copy;
//   setmaxnreg hands the producer's registers to the consumers (24 / 240 a
//   thread). The resident tile has two slots (the next tile's lands while
//   this one finishes); the streamed tiles come through a ring that runs
//   on from tile to tile, a slot with "full" mbarriers (the copy's bytes)
//   and an "empty" one that every consumer warp arrives on. Tensor maps
//   over (Dh, H, T, B) with the strides as given (BTHD and BHTD are one
//   kernel), zero-filled past T; a row of Dh 128 is two 64-wide boxes.
// - dq: 128-row q tiles, qs and dO resident, the lse and delta of each
//   thread's two rows in registers. It walks KV tiles (128 keys at Dh 64,
//   64 at Dh 128; K and V each on its own barrier; 5 or 3 slots) up to the
//   diagonal: S = qs K^T and dP = dO V^T (wgmma, both operands in shared
//   memory, K and V read K-major as B), dS on the accumulator fragments,
//   then dqs += bf16(dS) K with dS as the register A operand and K read as
//   it lies through the descriptor's transpose bit. One fp32 accumulator,
//   written once.
// - dk/dv: 128-key KV tiles, K and V resident, each warpgroup 64 keys. It
//   walks q tiles (64 rows at Dh 64, 32 at Dh 128, so that dK and dV leave
//   room for the tile's scores; qs, dO, and the lse and delta rows by 1-D
//   TMA from the 16-byte boundary before the tile's first row, 8 or 5
//   slots) from the first that can see its keys, computing the transposed
//   scores S^T = K qs^T and dP^T = V dO^T, so that P^T and dS^T land in
//   registers with keys as rows, the A operand of dV += bf16(P^T) dO and
//   dK += bf16(dS^T) qs (dO and qs read N-major). dK and dV stay in
//   registers for the whole walk and are written once.
// - Overlap: each turn of a warpgroup issues tile i's S and dP (or their
//   transposes) and tile i - 1's gradient products together, and tile i's
//   P and dS are computed while those run; the two warpgroups take turns
//   (named barriers, sm90.cuh), so that one's elementwise work runs while
//   the other's products hold the tensor cores. The first and last turn
//   are peeled: a steady loop that issues the same products every time,
//   which ptxas needs to keep wgmma asynchronous.
// - P = 0 for rows past T, keys at or past the per-batch length, masked
//   causal entries and rows whose lse is -inf (their lse is taken as +inf,
//   so exp gives 0), so a length-0 batch gets zero gradients and no NaN
//   enters a product; only tiles that cross a length or the diagonal test
//   each entry. A warpgroup computes no tile whose entries are all masked,
//   but still takes its turn and frees its slot.
// - Shared memory (two resident slots and the ring): dq 64 + 5 x 32 KB at
//   Dh 64, 128 + 3 x 32 KB at Dh 128; dk/dv 64 + 8 x 16.75 KB at Dh 64,
//   128 + 5 x 16.75 KB at Dh 128. chip_smoke.py prints the HGMMA count and
//   the local memory (0) from cuobjdump.

#include "sm90.cuh"

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

template <int D>
struct DqLayout {
  static constexpr int BK = D == 64 ? 128 : 64;  // keys of a K or V tile
  static constexpr int STAGES = D == 64 ? 5 : 3;
  static constexpr uint32_t RES_BYTES = RES * D * 2;  // qs or dO
  static constexpr uint32_t KV_BYTES = BK * D * 2;    // one K or V tile
  // two slots of qs and dO, the ring, and 1024 bytes to align them
  static constexpr size_t BYTES = 1024 + 4 * RES_BYTES + 2 * STAGES * KV_BYTES;
};

template <int D>
struct DkvLayout {
  // q rows of a streamed tile: 32 at Dh 128, so that dK and dV (64
  // registers each) leave room for the tile's scores
  static constexpr int BQ = D == 64 ? 64 : 32;
  static constexpr int STAGES = D == 64 ? 8 : 5;
  static constexpr uint32_t RES_BYTES = RES * D * 2;  // K or V
  static constexpr uint32_t Q_BYTES = BQ * D * 2;     // one qs or dO tile
  // a tile's lse or delta rows come as a box of ROW_BOX values that starts
  // on a 16-byte boundary at or up to 3 values before the tile's first
  // row (row_off), in a slot of ROW_SLOT values
  static constexpr int ROW_BOX = BQ + 4, ROW_SLOT = 96;
  static constexpr uint32_t SLOT_TX = 2 * Q_BYTES + 2 * ROW_BOX * 4;
  // two slots of K and V, the ring, and 1024 bytes to align them
  static constexpr size_t BYTES =
      1024 + 4 * RES_BYTES + STAGES * (2 * Q_BYTES + 2 * ROW_SLOT * 4);
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

// dqs for 128-row q tiles: a persistent grid, block i taking tiles i,
// i + gridDim.x, ...; each tile sums bf16(dS) k over its KV tiles, up to
// the diagonal under the causal mask. Two slots for the resident qs and
// dO, so that the next tile's land while this one finishes; the K/V ring
// runs on from tile to tile.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq,
                             const int* __restrict__ kv_lens, int H, int B,
                             int Tq, int Tk, OutStrides st, int causal) {
  using L = DqLayout<D>;
  constexpr int S = L::STAGES, NB = D / 64, BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t res_full[2], res_empty[2], k_full[S], v_full[S],
      empty[S];
  uint8_t* Rs = align1024(smem_raw);  // 2 slots of qs then dO, NB boxes each
  uint8_t* Ks = Rs + 4 * L::RES_BYTES;  // S slots of NB boxes of BK x 64
  uint8_t* Vs = Ks + S * L::KV_BYTES;   // the same
  const int tiles = (Tq + RES - 1) / RES * H * B;
  auto n_kv_of = [&](const BwdTile& f) {
    int n = (f.kv_len + BK - 1) / BK;
    if (causal) n = min(n, (min(f.r0 + RES, Tq) - 1) / BK + 1);
    return n;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&res_full[i], 1);
      mbar_init(&res_empty[i], 4 * CONSUMERS);  // each consumer warp arrives
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup_idx();
  if (wg == CONSUMERS) {
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int it = 0, ri = 0;  // K/V tiles and resident tiles loaded so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const BwdTile f = bwd_tile(t, H, B, Tq, true, Tk, kv_lens);
        const int n_kv = n_kv_of(f);
        if (n_kv == 0) continue;
        uint8_t* Q = Rs + (ri % 2) * 2 * L::RES_BYTES;
        uint8_t* O = Q + L::RES_BYTES;
        mbar_wait(&res_empty[ri % 2], ((ri / 2) & 1) ^ 1);
        mbar_expect_tx(&res_full[ri % 2], 2 * L::RES_BYTES);
        for (int x = 0; x < NB; ++x) {
          tma_load_4d(Q + x * RES * 128, &q_map, &res_full[ri % 2], 64 * x,
                      f.h, f.r0, f.b);
          tma_load_4d(O + x * RES * 128, &do_map, &res_full[ri % 2], 64 * x,
                      f.h, f.r0, f.b);
        }
        ++ri;
        for (int kt = 0; kt < n_kv; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          uint8_t* K = Ks + s * L::KV_BYTES;
          uint8_t* V = Vs + s * L::KV_BYTES;
          mbar_expect_tx(&k_full[s], L::KV_BYTES);
          for (int x = 0; x < NB; ++x)
            tma_load_4d(K + x * BK * 128, &k_map, &k_full[s], 64 * x, f.h,
                        kt * BK, f.b);
          mbar_expect_tx(&v_full[s], L::KV_BYTES);
          for (int x = 0; x < NB; ++x)
            tma_load_4d(V + x * BK * 128, &v_map, &v_full[s], 64 * x, f.h,
                        kt * BK, f.b);
        }
      }
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    const int warp = warp_in_warpgroup(), lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;
    float acc[D / 2], sc[BK / 2], dp[BK / 2];  // dqs; s and dp, then dS
    uint32_t da[BK / 16][4];
    turns_begin(wg);
    int it = 0, ri = 0;  // as the producer counts them
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const BwdTile f = bwd_tile(t, H, B, Tq, true, Tk, kv_lens);
      const int n_kv = n_kv_of(f), kv_len = f.kv_len;
      const int r0 = f.r0 + 64 * wg;  // this warpgroup's first row
      const int rw = r0 + 16 * warp;  // this warp's
      const int row[2] = {rw + g, rw + g + 8};
      int n_mine = r0 < Tq ? n_kv : 0;
      if (causal) n_mine = min(n_mine, (min(r0 + 64, Tq) - 1) / BK + 1);
      // this thread's rows: lse in log2 units (+inf for a row past Tq or
      // with no valid key, so that P = 0 there) and delta
      const long long bh = (long long)f.b * H + f.h;
      float l2[2], dl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float x = row[i] < Tq ? lse[bh * Tq + row[i]] : -INFINITY;
        l2[i] = x == -INFINITY ? INFINITY : x * LOG2E;
        dl[i] = row[i] < Tq ? delta[bh * Tq + row[i]] : 0.f;
      }
#pragma unroll
      for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
      // this warpgroup's rows of each box of the resident qs and dO
      const uint8_t* Qw = Rs + (ri % 2) * 2 * L::RES_BYTES + wg * 64 * 128;
      const uint8_t* Ow = Qw + L::RES_BYTES;
      if (n_kv > 0) mbar_wait(&res_full[ri % 2], (ri / 2) & 1);

      // Tiles [0, n_mine) are computed, the rest are not. Turn kt issues
      // tile kt's S = qs K^T and dP = dO V^T, then tile kt - 1's
      // dqs += bf16(dS) K; tile kt's dS is computed once S and dP are in,
      // while the dq product still runs and while the other warpgroup's
      // turn holds the tensor cores; then tile kt - 1's slot is freed. The
      // first and the last turn are peeled, so that the steady loop issues
      // the same products every time (ptxas serialises wgmma otherwise). A
      // tile that is not computed takes its turn and frees its slot once
      // its K has landed. Each warpgroup takes n_kv + 1 turns a q tile.
      auto wait_kv = [&](int kt) {
        mbar_wait(&k_full[(it + kt) % S], ((it + kt) / S) & 1);
        mbar_wait(&v_full[(it + kt) % S], ((it + kt) / S) & 1);
      };
      auto scores = [&](int kt) {
        // s = qs k^T and dp = dO v^T: 64 rows x BK keys
        const uint8_t* K = Ks + (it + kt) % S * L::KV_BYTES;
        const uint8_t* V = Vs + (it + kt) % S * L::KV_BYTES;
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int x = kd / 4, at = (kd % 4) * 32;
          wgmma_ss<BK>(sc, desc_sw128(Qw + x * RES * 128 + at, 16, 1024),
                          desc_sw128(K + x * BK * 128 + at, 16, 1024),
                          kd > 0);
        }
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const int x = kd / 4, at = (kd % 4) * 32;
          wgmma_ss<BK>(dp, desc_sw128(Ow + x * RES * 128 + at, 16, 1024),
                          desc_sw128(V + x * BK * 128 + at, 16, 1024),
                          kd > 0);
        }
        wgmma_commit();
        fence_regs(sc);
        fence_regs(dp);
      };
      auto dq_product = [&](int kt) {
        // acc += bf16(dS) k, keys as the depth: k read N-major
        const uint8_t* K = Ks + (it + kt) % S * L::KV_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<D>(acc, da[kk],
                         desc_sw128(K + kk * 2048, BK * 128, 1024));
        wgmma_commit();
        fence_regs(acc);
      };
      auto ds = [&](int kt) {
        // dS = P * (dp - delta), P = exp(s - lse), 0 where masked
        fence_regs(sc);
        fence_regs(dp);
        const int k0 = kt * BK;
        const bool edge = k0 + BK > kv_len || (causal && k0 + BK - 1 > rw);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, col = k0 + 8 * j + 2 * c + (e & 1);
            float p = exp2_approx(fmaf(sc[4 * j + e], LOG2E, -l2[i]));
            if (edge && (col >= kv_len || (causal && col > row[i]))) p = 0.f;
            sc[4 * j + e] = p * (dp[4 * j + e] - dl[i]);
          }
      };
      auto release = [&](int kt) {
        __syncwarp();
        mbar_arrive_lane0(&empty[(it + kt) % S], lane);
      };
      if (n_mine > 0) {
        wait_kv(0);
        turn_wait(wg);
        scores(0);
        turn_pass(wg);
        wgmma_wait<0>();
        ds(0);
        acc_to_a<BK / 2>(da, sc);
        for (int kt = 1; kt < n_mine; ++kt) {
          wait_kv(kt);
          turn_wait(wg);
          scores(kt);
          dq_product(kt - 1);
          turn_pass(wg);
          wgmma_wait<1>();  // S and dP are in; the dq product may still run
          ds(kt);
          wgmma_wait<0>();
          fence_regs(acc);
          release(kt - 1);
          acc_to_a<BK / 2>(da, sc);
        }
        turn_wait(wg);
        dq_product(n_mine - 1);
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs(acc);
        release(n_mine - 1);
      } else {
        turn_wait(wg);
        turn_pass(wg);
      }
      for (int kt = n_mine; kt < n_kv; ++kt) {
        mbar_wait(&k_full[(it + kt) % S], ((it + kt) / S) & 1);
        turn_wait(wg);
        turn_pass(wg);
        release(kt);
      }
      it += n_kv;
      if (n_kv > 0) {  // this resident slot is free for the tile after next
        __syncwarp();
        mbar_arrive_lane0(&res_empty[ri % 2], lane);
        ++ri;
      }

      bf16* qout = dq + f.b * st.o[0] + f.h * st.o[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row[i] >= Tq) continue;
        bf16* orow = qout + row[i] * st.o[1];
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * c) =
              pack_bf16(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
      }
    }
  }
}

// dk and dv for 128-key KV tiles: a persistent grid, block i taking tiles
// i, i + gridDim.x, ...; each tile sums over the q tiles from the first
// that can see its keys. Two slots for the resident K and V, so that the
// next tile's land while this one finishes; the q ring runs on from tile
// to tile.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const __grid_constant__ CUtensorMap lse_map,
                              const __grid_constant__ CUtensorMap delta_map,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              const int* __restrict__ kv_lens, int H, int B,
                              int Tq, int Tk, OutStrides sk, OutStrides sv,
                              int causal) {
  using L = DkvLayout<D>;
  constexpr int S = L::STAGES, NB = D / 64, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t res_full[2], res_empty[2], full[S], empty[S];
  uint8_t* Rs = align1024(smem_raw);  // 2 slots of K then V, NB boxes each
  uint8_t* Qs = Rs + 4 * L::RES_BYTES;  // S slots of NB boxes of BQ x 64
  uint8_t* Os = Qs + S * L::Q_BYTES;    // dO, the same
  float* Ls = reinterpret_cast<float*>(Os + S * L::Q_BYTES);  // S row slots
  float* Ds = Ls + S * L::ROW_SLOT;                           // the same
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
    turns_begin(wg);
    int it = 0, ri = 0;  // as the producer counts them
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
      // landed. Each warpgroup takes n_t + 1 turns a KV tile.
      int t0 = kw < kv_len ? 0 : n_t;
      if (causal) t0 = max(t0, kw / BQ - q_first);
      t0 = min(t0, n_t);
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

template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
              const float* lse, const float* delta, bf16* dq,
              const int* kv_lens, int B, int H, int Tq, int Tk,
              const BwdStrides& st, int device, int sms, cudaStream_t s,
              int causal) {
  using L = DqLayout<D>;
  CUtensorMap qm, km, vm, om;
  int err = head_map(&qm, "q", q, D, H, Tq, B, st.q, RES);
  if (!err) err = head_map(&om, "dO", dout, D, H, Tq, B, st.dout, RES);
  if (!err)
    err = map_or_alt(&km, "k", k, Tk, q, Tq, D, H, B, st.k, st.q, L::BK);
  if (!err)
    err = map_or_alt(&vm, "v", v, Tk, q, Tq, D, H, B, st.v, st.q, L::BK);
  if (err) return err;
  const cudaError_t cerr = allow_smem(
      reinterpret_cast<const void*>(flash_bwd_dq_bf16_kernel<D>), device,
      static_cast<int>(L::BYTES));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const OutStrides so = {{st.dq[0], st.dq[1], st.dq[2]}};
  const int tiles = (Tq + RES - 1) / RES * H * B;
  flash_bwd_dq_bf16_kernel<D><<<tiles < sms ? tiles : sms, THREADS,
                                L::BYTES, s>>>(
      qm, km, vm, om, lse, delta, dq, kv_lens, H, B, Tq, Tk, so, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v,
               const bf16* dout, const float* lse, const float* delta,
               bf16* dk, bf16* dv, const int* kv_lens, int B, int H, int Tq,
               int Tk, const BwdStrides& st, int device, int sms,
               cudaStream_t s, int causal) {
  using L = DkvLayout<D>;
  CUtensorMap qm, km, vm, om, lm, dm;
  int err = head_map(&km, "k", k, D, H, Tk, B, st.k, RES);
  if (!err) err = head_map(&vm, "v", v, D, H, Tk, B, st.v, RES);
  if (!err)
    err = map_or_alt(&qm, "q", q, Tq, k, Tk, D, H, B, st.q, st.k, L::BQ);
  if (!err)
    err = map_or_alt(&om, "dO", dout, Tq, k, Tk, D, H, B, st.dout, st.k,
                     L::BQ);
  // with no queries the rows are never read: their maps then describe k
  const float* none = reinterpret_cast<const float*>(k);
  const long long rows = static_cast<long long>(B) * H * Tq;
  if (!err)
    err = row_map(&lm, "lse", rows > 0 ? lse : none, rows > 0 ? rows : 1,
                  L::ROW_BOX);
  if (!err)
    err = row_map(&dm, "delta", rows > 0 ? delta : none, rows > 0 ? rows : 1,
                  L::ROW_BOX);
  if (err) return err;
  const cudaError_t cerr = allow_smem(
      reinterpret_cast<const void*>(flash_bwd_dkv_bf16_kernel<D>), device,
      static_cast<int>(L::BYTES));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const OutStrides sk = {{st.dk[0], st.dk[1], st.dk[2]}};
  const OutStrides sv = {{st.dv[0], st.dv[1], st.dv[2]}};
  const int tiles = (Tk + RES - 1) / RES * H * B;
  flash_bwd_dkv_bf16_kernel<D><<<tiles < sms ? tiles : sms, THREADS,
                                 L::BYTES, s>>>(
      qm, km, vm, om, lm, dm, dk, dv, kv_lens, H, B, Tq, Tk, sk, sv, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q is pre-scaled (qs); dq receives dqs. Strides are 21 element strides,
// (batch, time, head) for q, k, v, dO, dq, dk and dv in that order; every
// head dim is contiguous, and every stride and base pointer is a multiple
// of 8 values (16 bytes, as TMA needs). lse and delta are (B*H, Tq) fp32,
// contiguous. kv_lens (int32, B) may be null. Each returns 0 on success,
// the CUDA error of its launch, or a tensor-map error
// (flash_bwd_bf16_error_string names each).
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq,
                                 const int* kv_lens, int B, int H, int Tq,
                                 int Tk, int D, const long long* strides,
                                 int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Tq <= 0 || B <= 0 || H <= 0) return 0;
  const BwdStrides st = unpack(strides);
  const int sms = sm_count(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qq = static_cast<const bf16*>(q),
             *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v),
             *oo = static_cast<const bf16*>(dout);
  bf16* g = static_cast<bf16*>(dq);
  if (D == 128)
    return launch_dq<128>(qq, kk, vv, oo, lse, delta, g, kv_lens, B, H, Tq,
                          Tk, st, device, sms, s, causal);
  if (D == 64)
    return launch_dq<64>(qq, kk, vv, oo, lse, delta, g, kv_lens, B, H, Tq, Tk,
                         st, device, sms, s, causal);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
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
    return launch_dkv<128>(qq, kk, vv, oo, lse, delta, gk, gv, kv_lens, B, H,
                           Tq, Tk, st, device, sms, s, causal);
  if (D == 64)
    return launch_dkv<64>(qq, kk, vv, oo, lse, delta, gk, gv, kv_lens, B, H,
                          Tq, Tk, st, device, sms, s, causal);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_bf16_error_string(int err) {
  return error_string(err);
}
