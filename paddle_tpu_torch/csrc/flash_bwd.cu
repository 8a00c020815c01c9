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
// So every fp32 operand x is split in registers, as its fragment is
// loaded, into big = x rounded to TF32 and small = x - big, and a product
// is small*big + big*small, then big*big, summed in fp32 (the order of
// CUTLASS's OpMultiplyAddFastF32; small*small is dropped). big is rounded
// to nearest, ties away from zero, by adding 0x1000 to the bits and
// masking the low 13: for finite x that is what cvt.rna.tf32.f32 gives,
// in two integer instructions, where the cvt compiles to a longer
// sequence on sm_90a (it also sorts out NaN and infinity). small is exact
// in fp32 and goes to the tensor core as it is; the tensor core reads its
// top 19 bits (a truncation to TF32), so its error is below 2^-21 of x,
// the order of the small*small term that 3xTF32 drops anyway. Rounding
// small as well costs two more instructions an operand and moves the
// emulated errors only in their last digit (the test checks both).
//
// What the design does about it:
// - mma.sync.m16n8k8 TF32 products (HMMA on sm_90a). Fragments come from
//   shared memory by ldmatrix (a 16x8 A or two 8x8 B fragments per
//   instruction: ldmatrix moves 32-bit words intact) or by 16-byte loads,
//   so any orientation of a tile can feed either operand: three of the five
//   products read a tile transposed. No wgmma: for .tf32 both of its
//   shared-memory operands must be K-major, which would need transposed
//   copies of q and dO (or k) staged again.
// - A block of 4 warps; each warp owns 16 rows of the 64-row resident tile
//   for every product. The dq kernel keeps its q and dO rows resident (and
//   each thread its two rows' lse and delta) and walks the KV tiles up to
//   the diagonal; the dk/dv kernel keeps its 64 keys of k and v resident
//   and walks the q tiles from the first that can see them. Accumulators
//   stay in registers.
// - P and dS never leave registers: an accumulator fragment (rows g, g+8;
//   columns 2c, 2c+1 of an 8-wide slice, g = lane/4, c = lane%4) is the A
//   operand of the next product when the slice's depth is taken in the
//   order 0, 2, 4, 6, 1, 3, 5, 7; the B operand (rows 2c and 2c+1 of the
//   streamed or resident tile) is read in the same order. Its 8-wide
//   column slices are interleaved: column g of slice n is head-dim column
//   g * Dh/8 + n, so a thread reads its B values for all slices with
//   16-byte loads, and writes dq, dk and dv rows as 16-byte stores.
// - Shared-memory rows are padded to Dh + 4 floats: 16-byte aligned for
//   cp.async and ldmatrix, whose 8 row addresses then fall on 8 distinct
//   4-bank groups.
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
//
// chip_smoke.py prints each kernel's registers, local memory and HMMA
// count (cuobjdump).
//
// Not yet used: wgmma, TMA, bf16.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd_strides.cuh"

namespace {

constexpr int TC_THREADS = 128;  // 4 warps, 16 rows of the resident tile each
constexpr int TC_ROWS = 64;      // rows of the resident tile
constexpr int TC_STREAM = 32;    // rows of a streamed tile

// Head dim D: rows of STR floats, shared memory and blocks an SM
template <int D>
struct TcLayout {
  static constexpr int STR = D + 4;
  // two resident tiles and two stages of two streamed tiles; the dk/dv
  // kernel adds two stages of the lse and delta rows
  static constexpr size_t TILE_BYTES =
      sizeof(float) * (2 * TC_ROWS + 4 * TC_STREAM) * STR;
  static constexpr size_t KV_BYTES = TILE_BYTES + sizeof(float) * 4 * TC_STREAM;
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 1;
};

// x = big + small: big rounded to TF32 (nearest, ties away), small exact
template <int N>
struct Frag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    big[i] = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small[i] = __float_as_uint(x - __uint_as_float(big[i]));
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b to fp32 accuracy (3xTF32): the cross terms, then big x big
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// four 8x8 matrices of 32-bit words; lane l gives the address of row l % 8
// of matrix l / 8 and gets word l % 4 of row l / 4 of each
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Lane offsets into a tile of rows of STR floats for ldsm4: an A fragment
// (rows 0-7 and 8-15 of columns 0-3, then of columns 4-7), and the B
// fragments of two 8-wide slices of the tile's rows, B = tile^T (columns
// 0-3 and 4-7 of rows 0-7, then of rows 8-15).
template <int STR>
__device__ __forceinline__ int a_offset(int lane) {
  const int m = lane >> 3, r = lane & 7;
  return (r + 8 * (m & 1)) * STR + 4 * (m >> 1);
}

template <int STR>
__device__ __forceinline__ int bt_offset(int lane) {
  const int m = lane >> 3, r = lane & 7;
  return (r + 8 * (m >> 1)) * STR + 4 * (m & 1);
}

// A (16 rows x 8 deep) at p = tile + r0 * STR + k0 + a_offset
__device__ __forceinline__ void load_a(Frag<4>& a, const float* p) {
  uint32_t x[4];
  ldsm4(x, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) a.set(i, __uint_as_float(x[i]));
}

// B (8 deep x 8 wide) = tile^T for tile rows n0.. and n0 + 8.., depth
// columns k0..; p = tile + n0 * STR + k0 + bt_offset
__device__ __forceinline__ void load_bt2(Frag<2>& b0, Frag<2>& b1,
                                         const float* p) {
  uint32_t x[4];
  ldsm4(x, p);
  b0.set(0, __uint_as_float(x[0]));
  b0.set(1, __uint_as_float(x[1]));
  b1.set(0, __uint_as_float(x[2]));
  b1.set(1, __uint_as_float(x[3]));
}

// An accumulator fragment (16 x 8: rows g, g + 8, columns 2c, 2c + 1) as
// the A operand of a product whose depth is its 8 columns, in the order
// 0, 2, 4, 6, 1, 3, 5, 7
__device__ __forceinline__ void acc_to_a(Frag<4>& a, const float (&x)[4]) {
  a.set(0, x[0]);
  a.set(1, x[2]);
  a.set(2, x[1]);
  a.set(3, x[3]);
}

// acc[n] += A B for the N interleaved head-dim slices n of a tile whose
// rows are the depth: B's depth slots c and c + 4 are rows p and p + STR
// (rows 2c and 2c + 1 of the 8-row step), its column g of slice n is
// column g * N + n, so p = tile + (k0 + 2c) * STR + g * N
template <int N, int STR>
__device__ __forceinline__ void mma_rows(float (&acc)[N][4], const Frag<4>& a,
                                         const float* p) {
  float r0[N], r1[N];
#pragma unroll
  for (int u = 0; u < N / 4; ++u) {
    const float4 x = reinterpret_cast<const float4*>(p)[u];
    const float4 y = reinterpret_cast<const float4*>(p + STR)[u];
    r0[4 * u] = x.x;
    r0[4 * u + 1] = x.y;
    r0[4 * u + 2] = x.z;
    r0[4 * u + 3] = x.w;
    r1[4 * u] = y.x;
    r1[4 * u + 1] = y.y;
    r1[4 * u + 2] = y.z;
    r1[4 * u + 3] = y.w;
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    Frag<2> b;
    b.set(0, r0[n]);
    b.set(1, r1[n]);
    mma3(acc[n], a, b);
  }
}

// Row i (g or g + 8) of interleaved accumulators, times mul, as the 2N
// contiguous head-dim columns 2cN.. that this thread holds: out[n] is
// slice n's column 2c, out[N + n] its column 2c + 1
template <int N>
__device__ __forceinline__ void store_row(float* out, const float (&acc)[N][4],
                                          int i, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < N / 4; ++u)
      reinterpret_cast<float4*>(out + h * N)[u] = make_float4(
          mul * acc[4 * u][2 * i + h], mul * acc[4 * u + 1][2 * i + h],
          mul * acc[4 * u + 2][2 * i + h], mul * acc[4 * u + 3][2 * i + h]);
}

// cp.async of 16 or 4 bytes; with valid false the destination is zeroed
// and nothing is read
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// start copying rows [r0, r0 + ROWS) of a (rows, D) head slice with row
// stride st into a padded tile; rows at or past n are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long st, int r0, int n) {
  constexpr int D4 = D / 4;
  for (int i = threadIdx.x; i < ROWS * D4; i += TC_THREADS) {
    const int r = i / D4, c = (i % D4) * 4;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * TcLayout<D>::STR + c,
               ok ? src + (r0 + r) * st + c : src, ok);
  }
}

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
    copy_tile<D, BQ>(Qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0, Tq);
    copy_tile<D, BQ>(Os, dout + b * st.dout[0] + h * st.dout[2], st.dout[1],
                     q0, Tq);
    copy_tile<D, BK>(Ks, kb, st.k[1], 0, kv_len);
    copy_tile<D, BK>(Vs, vb, st.v[1], 0, kv_len);
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
      copy_tile<D, BK>(Ks + (cur ^ 1) * BK * STR, kb, st.k[1], (kt + 1) * BK,
                       kv_len);
      copy_tile<D, BK>(Vs + (cur ^ 1) * BK * STR, vb, st.v[1], (kt + 1) * BK,
                       kv_len);
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

// One block per (KV tile, head, batch): the block keeps its k and v tiles
// and its dk, dv accumulators for a walk over the q tiles from the first
// that can see its keys; per q tile it recomputes P and dS with keys in
// rows, then dv += P^T dO and dk += dS^T q, queries as the depth.
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
    copy_tile<D, BQ>(Qs + buf * BQ * STR, qbase, st.q[1], r0, Tq);
    copy_tile<D, BQ>(Os + buf * BQ * STR, obase, st.dout[1], r0, Tq);
    for (int i = threadIdx.x; i < 2 * BQ; i += TC_THREADS) {
      const int r = i % BQ;
      const bool ok = r0 + r < Tq;
      const float* src = i < BQ ? lse : delta;
      cp_async4((i < BQ ? Ls : Ds) + buf * BQ + r,
                ok ? src + bh * Tq + r0 + r : src, ok);
    }
  };
  if (q_first < n_q) {
    copy_tile<D, BK>(Ks, k + b * st.k[0] + h * st.k[2], st.k[1], k0, kv_len);
    copy_tile<D, BK>(Vs, v + b * st.v[0] + h * st.v[2], st.v[1], k0, kv_len);
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
