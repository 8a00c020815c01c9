// K1-bf16: exact (flash) attention forward for Hopper on bf16 q, k, v, the
// AMP twin of K1 (flash_fwd.cu), on the tensor cores by wgmma.
//
// Replaces paddle_tpu/ops/attention.py:_mha_fwd_kernel as the reference
// runs it under bf16 AMP (fused_attention is in trace.py's _AMP_BF16_OPS):
// bf16 operands, fp32 accumulation and softmax statistics, P rounded to
// bf16 before P V, out in bf16 and the per-row logsumexp (natural log) in
// fp32, laid out (B*H, 1, Tq). Its q arrives pre-scaled in bf16, as the
// reference's pallas_flash_attention hands it to the kernel (the wrapper,
// ops/attention.py, makes it): the kernel takes no scale. A row with no
// valid key gets out 0 and lse -inf.
//
// What bounds it on the H100: at the causal training shape (B=16, T=1024,
// H=16, Dh=64) its two products are 34.4 GFLOP, 0.035 ms at the bf16
// tensor-core rate (989 TFLOP/s dense), on 134 MB of bf16 q, k, v and out
// and the fp32 lse: 0.040 ms at 3.35 TB/s. So bytes, narrowly. In practice
// the softmax beside the products sets the pace: at Dh 64 a 128 x 128
// tile's exponentials keep the SM's special-function units about as long
// as its two products keep the tensor cores, so the design overlaps them.
//
// The design (sm90.cuh has the building blocks and the tile layout):
// - A persistent grid, one block an SM, walking (128-row q tile, head,
//   batch) tiles, the heaviest causal tiles of every head first. A block is
//   two consumer warpgroups of 64 rows each and one producer warpgroup, of
//   which one thread issues every copy; setmaxnreg hands the producer's
//   registers to the consumers (24 / 240 a thread; the SASS line shows the
//   168 a thread that the launch gives before the hand-over).
// - TMA copies the q tile into one of two slots (the next tile's lands
//   while this one finishes) and 128-key K and V tiles into a ring of
//   STAGES slots (6 at Dh 64, 2 at Dh 128) that runs on from tile to tile,
//   each K and each V on its own "full" mbarrier, a slot freed by an
//   "empty" mbarrier that every consumer warp arrives on. Tensor maps over
//   (Dh, H, T, B) with the strides as given (BTHD and BHTD are one kernel),
//   zero-filled past T; a row of Dh 128 is two 64-wide boxes.
// - S = q K^T is wgmma m64n128k16 with both operands in shared memory (K
//   read K-major as B); the online softmax runs on the fp32 accumulator
//   fragments (row max over the quad by shuffles, exp2 with log2(e) folded
//   into one FMA); P, rounded to bf16 (cvt.rn.bf16x2), is the register A
//   operand of O += P V, which reads the V tile as it lies through the
//   descriptor's transpose bit. O stays in registers, rescaled per tile,
//   divided and rounded once.
// - Overlap: each turn of a warpgroup issues tile kt's S and tile kt - 1's
//   P V together, and tile kt's softmax runs while P V does; the two
//   warpgroups take turns (named barriers, sm90.cuh), so that one's softmax
//   runs while the other's products hold the tensor cores. The first and
//   last turn of a q tile are peeled: a steady loop that issues the same
//   products every time, which ptxas needs to keep wgmma asynchronous.
// - Only a tile that reaches past the KV length, or under the causal mask
//   past a warp's first row, is masked; a warpgroup computes no tile that
//   starts after its last row or whose rows are all past Tq.
// - Shared memory: 2 x 16 KB of q + 6 x (16 + 16) KB at Dh 64, 2 x 32 +
//   2 x (32 + 32) KB at Dh 128. chip_smoke.py prints the HGMMA count and
//   the local memory (0) from cuobjdump.

#include "sm90.cuh"

namespace {

constexpr int CONSUMERS = 2;                    // warpgroups of 64 q rows
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer's
constexpr int BQ = 64 * CONSUMERS;              // q rows of a block
constexpr int BK = 128;                         // keys of a K or V tile
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

template <int D>
struct FwdLayout {
  static constexpr int STAGES = D == 64 ? 6 : 2;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;  // one K or V tile
  // two q slots, the ring, and 1024 bytes to align them
  static constexpr size_t BYTES = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
};

// element strides of out's (batch, time, head) axes
struct OutStrides {
  long long o[3];
};

// s = q k^T for one K tile: this warpgroup's 64 rows x BK keys, the head
// dim as the depth, both operands K-major in shared memory (issued, not
// committed)
template <int D>
__device__ __forceinline__ void fwd_scores(float (&sc)[BK / 2],
                                           const uint8_t* Qw,
                                           const uint8_t* K) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const int x = kd / 4, at = (kd % 4) * 32;  // box, step inside it
    wgmma_ss<BK>(sc, desc_sw128(Qw + x * BQ * 128 + at, 16, 1024),
                    desc_sw128(K + x * BK * 128 + at, 16, 1024), kd > 0);
  }
}

// acc += bf16(P) v for one V tile, keys as the depth: P the register A
// operand, v read N-major (issued, not committed)
template <int D>
__device__ __forceinline__ void fwd_pv(float (&acc)[D / 2],
                                       const uint32_t (&pa)[BK / 16][4],
                                       const uint8_t* V) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(acc, pa[kk], desc_sw128(V + kk * 2048, BK * 128, 1024));
}

// The online softmax of one tile's scores (this thread's rows row[0] and
// row[1], keys k0 ..): -inf where masked (only a tile that reaches past
// the KV length, or under the causal mask past the warp's first row rw,
// tests each entry), the row max over the quad, m and l carried on, sc
// turned into exp(s - m), and corr, the factor that rescales the output
// accumulator.
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int k0,
                                               int kv_len, int causal,
                                               int rw, const int (&row)[2],
                                               int c) {
  if (k0 + BK > kv_len || (causal && k0 + BK - 1 > rw)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * c + (e & 1);
        if (col >= kv_len || (causal && col > row[e >> 1]))
          sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY}, mu[2];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    // a row with every key so far masked keeps m = -inf and l = 0; it
    // subtracts 0 instead, so that exp2 gives 0 and never NaN
    mu[i] = (m_new == -INFINITY ? 0.f : m_new) * LOG2E;
    corr[i] = exp2_approx(m[i] * LOG2E - mu[i]);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(sc[4 * j + e], LOG2E, -mu[e >> 1]));
      sc[4 * j + e] = p;
      l[e >> 1] += p;
    }
}

// One q tile's work: its q rows q0 .., head h, batch b, and the n_kv KV
// tiles it reads. Tile t of the persistent walk: the heaviest causal
// tiles (the last q tiles) of every head first.
struct FwdTile {
  int q0, h, b, kv_len, n_kv;
};

__device__ __forceinline__ FwdTile fwd_tile(int t, int H, int B, int Tq,
                                            int Tk, const int* kv_lens,
                                            int causal) {
  const int n_qt = (Tq + BQ - 1) / BQ, hb = t % (H * B);
  FwdTile f;
  f.q0 = (n_qt - 1 - t / (H * B)) * BQ;
  f.h = hb % H;
  f.b = hb / H;
  f.kv_len = Tk;
  if (kv_lens != nullptr) f.kv_len = max(0, min(kv_lens[f.b], Tk));
  f.n_kv = (f.kv_len + BK - 1) / BK;
  if (causal) f.n_kv = min(f.n_kv, (min(f.q0 + BQ, Tq) - 1) / BK + 1);
  return f;
}

// A persistent grid: block i takes tiles i, i + gridDim.x, ... Two q
// slots, so that the next tile's q lands while this one finishes; the K/V
// ring runs on from tile to tile.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          bf16* __restrict__ out, float* __restrict__ lse,
                          const int* __restrict__ kv_lens, int H, int B,
                          int Tq, int Tk, OutStrides st, int causal) {
  using L = FwdLayout<D>;
  constexpr int S = L::STAGES, NB = D / 64;  // ring slots, boxes of a row
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full[2], q_empty[2], k_full[S], v_full[S], empty[S];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = Qs + 2 * L::Q_BYTES;    // S slots of NB boxes of BK x 64
  uint8_t* Vs = Ks + S * L::KV_BYTES;  // the same
  const int tiles = (Tq + BQ - 1) / BQ * H * B;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 4 * CONSUMERS);  // each consumer warp arrives
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
    // the producer: one thread keeps the q slots and the ring full
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int it = 0, qi = 0;  // K/V tiles and q tiles loaded so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const FwdTile f = fwd_tile(t, H, B, Tq, Tk, kv_lens, causal);
        if (f.n_kv == 0) continue;
        uint8_t* Q = Qs + (qi % 2) * L::Q_BYTES;
        mbar_wait(&q_empty[qi % 2], ((qi / 2) & 1) ^ 1);
        mbar_expect_tx(&q_full[qi % 2], L::Q_BYTES);
        for (int x = 0; x < NB; ++x)
          tma_load_4d(Q + x * BQ * 128, &q_map, &q_full[qi % 2], 64 * x, f.h,
                      f.q0, f.b);
        ++qi;
        for (int kt = 0; kt < f.n_kv; ++kt, ++it) {
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
    float sc[BK / 2], corr[2], acc[D / 2];
    uint32_t pa[BK / 16][4];
    turns_begin(wg);
    int it = 0, qi = 0;  // as the producer counts them
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const FwdTile f = fwd_tile(t, H, B, Tq, Tk, kv_lens, causal);
      const int n_kv = f.n_kv, kv_len = f.kv_len;
      const int r0 = f.q0 + 64 * wg;  // this warpgroup's first row
      const int rw = r0 + 16 * warp;  // this warp's
      const int row[2] = {rw + g, rw + g + 8};
      // the tiles this warpgroup computes, [0, n_mine): none if its rows
      // are all past Tq, under the causal mask none that starts after its
      // last row
      int n_mine = r0 < Tq ? n_kv : 0;
      if (causal) n_mine = min(n_mine, (min(r0 + 64, Tq) - 1) / BK + 1);
      // this thread's rows: running max (natural units), its own part of
      // the running sum, and the output accumulator
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
      const uint8_t* Qw = Qs + (qi % 2) * L::Q_BYTES + wg * 64 * 128;
      if (n_kv > 0) mbar_wait(&q_full[qi % 2], (qi / 2) & 1);

      // Turn kt issues tile kt's S = q K^T, then tile kt - 1's O += P V;
      // tile kt's softmax starts once S is in, while P V still runs and
      // while the other warpgroup's turn holds the tensor cores; then O is
      // rescaled and tile kt - 1's slot freed. The first and the last turn
      // are peeled, so that the steady loop issues the same products every
      // time (ptxas serialises wgmma otherwise). A tile this warpgroup does
      // not compute takes its turn and frees its slot once its K has
      // landed, so that the slot's "empty" phase is the tile's when this
      // warp arrives on it. Each warpgroup takes n_kv + 1 turns a q tile.
      auto wait_k = [&](int kt) {
        mbar_wait(&k_full[(it + kt) % S], ((it + kt) / S) & 1);
      };
      auto wait_v = [&](int kt) {
        mbar_wait(&v_full[(it + kt) % S], ((it + kt) / S) & 1);
      };
      auto scores = [&](int kt) {
        fwd_scores<D>(sc, Qw, Ks + (it + kt) % S * L::KV_BYTES);
        wgmma_commit();
        fence_regs(sc);
      };
      auto pv = [&](int kt) {
        fwd_pv<D>(acc, pa, Vs + (it + kt) % S * L::KV_BYTES);
        wgmma_commit();
        fence_regs(acc);
      };
      auto release = [&](int kt) {
        __syncwarp();
        mbar_arrive_lane0(&empty[(it + kt) % S], lane);
      };
      auto rescale_and_pack = [&]() {
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * n + e] *= corr[e >> 1];
        acc_to_a<BK / 2>(pa, sc);
      };
      if (n_mine > 0) {
        wait_k(0);
        turn_wait(wg);
        scores(0);
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs(sc);
        online_softmax(sc, m, l, corr, 0, kv_len, causal, rw, row, c);
        rescale_and_pack();
        for (int kt = 1; kt < n_mine; ++kt) {
          wait_k(kt);
          wait_v(kt - 1);
          turn_wait(wg);
          scores(kt);
          pv(kt - 1);
          turn_pass(wg);
          wgmma_wait<1>();  // S is in; P V may still run
          fence_regs(sc);
          online_softmax(sc, m, l, corr, kt * BK, kv_len, causal, rw, row,
                         c);
          wgmma_wait<0>();
          fence_regs(acc);
          release(kt - 1);
          rescale_and_pack();
        }
        wait_v(n_mine - 1);
        turn_wait(wg);
        pv(n_mine - 1);
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs(acc);
        release(n_mine - 1);
      } else {
        turn_wait(wg);
        turn_pass(wg);
      }
      for (int kt = n_mine; kt < n_kv; ++kt) {
        wait_k(kt);
        turn_wait(wg);
        turn_pass(wg);
        release(kt);
      }
      it += n_kv;
      if (n_kv > 0) {  // this q slot is free for the tile after next
        __syncwarp();
        mbar_arrive_lane0(&q_empty[qi % 2], lane);
        ++qi;
      }

      bf16* ob = out + f.b * st.o[0] + f.h * st.o[2];
      const long long bh = (long long)f.b * H + f.h;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        if (row[i] >= Tq) continue;
        const bool live = l[i] > 0.f;  // a row with no valid key: zeros
        // out = acc / l, divided as the reference divides, then rounded
        bf16* orow = ob + row[i] * st.o[1];
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * c) =
              live ? pack_bf16(acc[4 * n + 2 * i] / l[i],
                               acc[4 * n + 2 * i + 1] / l[i])
                   : 0u;
        if (c == 0)
          lse[bh * Tq + row[i]] = live ? m[i] + logf(l[i]) : -INFINITY;
      }
    }
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out,
           float* lse, const int* kv_lens, int B, int H, int Tq, int Tk,
           const long long* s, int causal, int device, int sms,
           cudaStream_t stream) {
  using L = FwdLayout<D>;
  CUtensorMap qm, km, vm;
  int err = head_map(&qm, "q", q, D, H, Tq, B, s, BQ);
  // with no keys K and V are never read: their maps then describe q
  if (!err)
    err = Tk > 0 ? head_map(&km, "k", k, D, H, Tk, B, s + 3, BK)
                 : head_map(&km, "k (as q)", q, D, H, Tq, B, s, BK);
  if (!err)
    err = Tk > 0 ? head_map(&vm, "v", v, D, H, Tk, B, s + 6, BK)
                 : head_map(&vm, "v (as q)", q, D, H, Tq, B, s, BK);
  if (err) return err;
  const cudaError_t cerr = allow_smem(
      reinterpret_cast<const void*>(flash_fwd_bf16_kernel<D>), device,
      static_cast<int>(L::BYTES));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const OutStrides st = {{s[9], s[10], s[11]}};
  const int tiles = (Tq + BQ - 1) / BQ * H * B;
  flash_fwd_bf16_kernel<D><<<tiles < sms ? tiles : sms, THREADS, L::BYTES,
                             stream>>>(
      qm, km, vm, out, lse, kv_lens, H, B, Tq, Tk, st, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q is pre-scaled. Strides are in elements, ordered (batch, time, head) for
// q, k, v and out; the head dim must be contiguous, and every stride and
// base pointer a multiple of 8 values (16 bytes, as TMA needs). kv_lens
// (int32, B) may be null. Returns 0 on success, the CUDA error of the
// launch, or a tensor-map error (flash_fwd_bf16_error_string names each).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* out, float* lse, const int* kv_lens,
                              int B, int H, int Tq, int Tk, int D,
                              const long long* strides, int causal,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Tq <= 0 || B <= 0 || H <= 0) return 0;
  const int sms = sm_count(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(out);
  if (D == 128)
    return launch<128>(qq, kk, vv, oo, lse, kv_lens, B, H, Tq, Tk, strides,
                       causal, device, sms, s);
  if (D == 64)
    return launch<64>(qq, kk, vv, oo, lse, kv_lens, B, H, Tq, Tk, strides,
                      causal, device, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_fwd_bf16_error_string(int err) {
  return error_string(err);
}
