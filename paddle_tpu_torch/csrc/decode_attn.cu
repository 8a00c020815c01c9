// K3: single-query decode attention over a BTHD KV slab for Hopper, fp32.
//
// Replaces paddle_tpu/ops/kv_cache.py:_decode_attn_kernel (the Pallas TPU
// kernel reached through pallas_decode_attention). It computes the same
// function: one query row per (batch, head), pre-scaled, attends its head's
// column of the (B, S, H, Dh) slabs up to lengths[b] rows with an fp32
// online softmax; a slot of length 0 returns zeros.
//
// What bounds it on the H100: bytes. Each live K/V row is read once and
// used for 2*Dh FLOPs, about 0.5 FLOP a byte, far below the card's ~20
// FLOP/byte fp32 balance point; at the serving shape (B=8, H=8, Dh=128,
// 300-1100 live rows a slot) one call reads about 38 MB, 0.0115 ms at
// 3.35 TB/s. What keeps a kernel from that is latency: a chain of
// dependent loads in one warp, too few bytes in flight across the card,
// and a second launch. The rate the card reaches on this read pattern
// keeps rising with the bytes in flight, well past what the unloaded
// latency would ask for, so the design asks for as much as fits at once.
//
// What the design does about it:
// - Short chains sized by the live rows. A block takes SPLIT = 64 keys of
//   one (b, h); the grid is (B*H, S/SPLIT), so a longer slot spreads over
//   more blocks, and a block past its slot's length exits after reading
//   the length (the lengths stay on the device: no host sync). Each of the
//   4 warps owns 16 keys and issues all of its K rows, then all of its V
//   rows (two stages, each a cp.async group), as 16-byte cp.async.cg
//   copies past L1 (L2 fetching whole 128-byte lines and evicting them
//   first) into its own shared memory before it waits for any:
//   one round trip a warp, 64 KB in flight a block at Dh 128 and three
//   blocks an SM. The V rows keep arriving while the K rows are scored.
//   The grid runs split-major, so the live blocks of every slot go first
//   and the empty ones last. (tools/torch_k3_sweep.py times other splits
//   and warp counts. Smaller stages in a deeper ring, a persistent grid
//   walking a list of the live items with two in flight a block, and
//   cp.async.bulk row copies on an mbarrier measured no faster.)
// - One launch. Each warp reduces its keys to a partial (max, sum,
//   accumulator) in log2 units; the block merges its warps' partials in
//   warp order. A slot with one live block writes its output at once.
//   Otherwise the block writes its partial, and the last block of the
//   (b, h) to finish merges the slot's live partials: one thread fences
//   and takes a per-(b, h) counter by atomicAdd, as a grid barrier does.
//   Warp w merges partials w, w + 4, ... in order, then the warps merge
//   in order, so the result is bitwise the same whichever block comes
//   last. That block resets the counter to 0; the wrapper keeps the
//   counters, zeroed once, per device and shape, and the kernel leaves
//   them zeroed (no memset per call; a CUDA graph can capture the launch).
// - CUDA cores. At ~0.5 FLOP a byte the tensor cores would buy nothing;
//   exp2f with log2(e) folded into the query's scale.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"  // cp_async_commit, cp_async_wait

namespace {

// warps a block and keys a block; tools/torch_k3_sweep.py builds other
// values through -D
#ifndef DECODE_ATTN_WARPS
#define DECODE_ATTN_WARPS 4
#endif
#ifndef DECODE_ATTN_SPLIT
#define DECODE_ATTN_SPLIT 64
#endif
constexpr int WARPS = DECODE_ATTN_WARPS;
constexpr int THREADS = WARPS * 32;
constexpr int SPLIT = DECODE_ATTN_SPLIT;  // keys per block
constexpr int KW = SPLIT / WARPS;         // keys per warp
static_assert(SPLIT % WARPS == 0 && KW % 2 == 0,
              "a warp's rows fill its lanes' 16-byte copies at Dh 64");
constexpr int MERGE_BATCH = 8;        // partials a warp loads before merging
constexpr float LOG2E = 1.4426950408889634f;

// a partial is D + PART_PAD floats: the accumulator, then max and sum
// (rows stay 16-byte aligned)
constexpr int PART_PAD = 4;

// cp.async of 16 bytes past L1, with L2 asked to fetch the 128-byte line
// and to evict these lines first (each row is read once); with valid false
// the destination is zeroed and nothing is read
__device__ __forceinline__ void cp_async16_stream(
    float* dst, const float* src, bool valid, unsigned long long policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint.L2::128B [%0], [%1], 16, %2, "
      "%3;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0), "l"(policy)
      : "memory");
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  }
}

// the same from L2 (another block's partial)
template <int V>
__device__ __forceinline__ void load_vec_cg(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
    x[0] = t.x, x[1] = t.y;
  }
}

// (m, l, acc) += (mp, lp, ap), online, in log2 units; an empty partial
// (max -inf) changes nothing
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[N],
                                      float mp, float lp,
                                      const float (&ap)[N]) {
  const float mn = fmaxf(m, mp);
  if (mn == -INFINITY) return;
  const float a = exp2f(m - mn), c = exp2f(mp - mn);
  l = fmaf(lp, c, l * a);
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = fmaf(ap[e], c, acc[e] * a);
  m = mn;
}

template <int D>
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(
    const float* __restrict__ q, const float* __restrict__ kc,
    const float* __restrict__ vc, const int* __restrict__ lens,
    float* __restrict__ out, float* __restrict__ part,
    int* __restrict__ counters, int H, int S, float scale_log2) {
  constexpr int V = D / 32;   // floats per lane
  constexpr int CH = D / 4;   // 16-byte chunks per row
  constexpr int PS = D + PART_PAD;
  static_assert(D <= THREADS, "one thread per output element");
  extern __shared__ float4 stage4[];  // per warp: KW K rows, KW V rows
  __shared__ float comb[WARPS][PS];   // the warps' partials
  __shared__ bool last;

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float qv[V];
  load_vec(q + (long long)bh * D + lane * V, qv);
  const int len = max(0, min(__ldg(lens + b), S));
  const int n_live = (len + SPLIT - 1) / SPLIT;
  float* const o_row = out + (long long)bh * D;
  if (split >= n_live) {  // past the slot's length; an empty slot: zeros
    if (split == 0 && threadIdx.x < D) o_row[threadIdx.x] = 0.f;
    return;
  }

  // this warp's keys [j0, j0 + nk) in two stages, its K rows and its V
  // rows, each a cp.async group; rows past the length are zero-filled and
  // not read
  const int j0 = split * SPLIT + warp * KW;
  const int nk = min(KW, len - j0);
  float* const ks = reinterpret_cast<float*>(stage4) + warp * 2 * KW * D;
  float* const vs = ks + KW * D;
  const long long row = (long long)H * D;  // slab row stride
  const long long base = (long long)b * S * row + (long long)h * D;
  if (nk > 0) {
    unsigned long long evict_first;
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
        : "=l"(evict_first));
#pragma unroll
    for (int it = 0; it < KW * CH / 32; ++it) {
      const int i = it * 32 + lane, r = i / CH, c = i % CH;
      cp_async16_stream(ks + r * D + c * 4,
                        kc + base + min(j0 + r, len - 1) * row + c * 4,
                        r < nk, evict_first);
    }
    cp_async_commit();
#pragma unroll
    for (int it = 0; it < KW * CH / 32; ++it) {
      const int i = it * 32 + lane, r = i / CH, c = i % CH;
      cp_async16_stream(vs + r * D + c * 4,
                        vc + base + min(j0 + r, len - 1) * row + c * 4,
                        r < nk, evict_first);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int e = 0; e < V; ++e) qv[e] *= scale_log2;

  // the warp's partial, in log2 units
  float m = -INFINITY, l = 0.f, acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  if (nk > 0) {
    cp_async_wait<1>();  // the K rows
    __syncwarp();
    float s[KW];
#pragma unroll
    for (int u = 0; u < KW; ++u) {
      float kr[V];
      load_vec(ks + u * D + lane * V, kr);
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) x = fmaf(qv[e], kr[e], x);
      s[u] = x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < KW; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
#pragma unroll
    for (int u = 0; u < KW; ++u) {
      if (u >= nk) s[u] = -INFINITY;
      m = fmaxf(m, s[u]);  // finite: the warp's first key is live
    }
    float p[KW];
#pragma unroll
    for (int u = 0; u < KW; ++u) {
      p[u] = exp2f(s[u] - m);  // 0 past the length
      l += p[u];
    }
    cp_async_wait<0>();  // the V rows, which kept arriving meanwhile
    __syncwarp();
#pragma unroll
    for (int u = 0; u < KW; ++u) {
      float vr[V];
      load_vec(vs + u * D + lane * V, vr);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(p[u], vr[e], acc[e]);
    }
  }

  // the block's partial: its warps' partials merged in warp order, one
  // output element a thread
  const int t = threadIdx.x;
  const auto combine = [&](float& M, float& L, float& o) {
#pragma unroll
    for (int e = 0; e < V; ++e) comb[warp][lane * V + e] = acc[e];
    if (lane == 0) comb[warp][D] = m, comb[warp][D + 1] = l;
    __syncthreads();
    M = -INFINITY, L = 0.f;
    float ov[1] = {0.f};
    if (t < D) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float aw[1] = {comb[w][t]};
        merge(M, L, ov, comb[w][D], comb[w][D + 1], aw);
      }
    }
    o = ov[0];
  };
  float M, L, o;
  combine(M, L, o);
  if (n_live == 1) {
    if (t < D) o_row[t] = o / L;
    return;
  }

  const int n_split = gridDim.y;
  float* const pp = part + (long long)bh * n_split * PS;
  if (t < D) pp[split * PS + t] = o;
  if (t == 0) pp[split * PS + D] = M, pp[split * PS + D + 1] = L;
  __syncthreads();
  if (t == 0) {  // release the block's partial, acquire the others'
    __threadfence();
    last = atomicAdd(counters + bh, 1) == n_live - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;

  // the last block merges the live partials in split order: warp w takes
  // partials w, w + WARPS, ..., then the warps merge in warp order
  m = -INFINITY, l = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  for (int p0 = warp; p0 < n_live; p0 += MERGE_BATCH * WARPS) {
    float mp[MERGE_BATCH], lp[MERGE_BATCH], ap[MERGE_BATCH][V];
#pragma unroll
    for (int i = 0; i < MERGE_BATCH; ++i) {
      const int pi = p0 + i * WARPS;
      const float* src = pp + min(pi, n_live - 1) * PS;
      load_vec_cg(src + lane * V, ap[i]);
      mp[i] = pi < n_live ? __ldcg(src + D) : -INFINITY;
      lp[i] = __ldcg(src + D + 1);
    }
#pragma unroll
    for (int i = 0; i < MERGE_BATCH; ++i)
      merge(m, l, acc, mp[i], lp[i], ap[i]);
  }
  combine(M, L, o);  // comb is free: two barriers since its last read
  if (t < D) o_row[t] = o / L;
  if (t == 0) counters[bh] = 0;  // zero for the next call
}

template <int D>
int launch(const float* q, const float* kc, const float* vc, const int* lens,
           float* out, float* part, int* counters, int B, int H, int S,
           float scale, int device, cudaStream_t stream) {
  constexpr int smem = 2 * SPLIT * D * sizeof(float);
  static bool ready[64];  // the shared-memory opt-in, once a device
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  const int n_split = (S + SPLIT - 1) / SPLIT;
  decode_attn_kernel<D><<<dim3(B * H, n_split), THREADS, smem, stream>>>(
      q, kc, vc, lens, out, part, counters, H, S, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Keys per block, the unit the slab is split into, and warps per block.
extern "C" int decode_attn_split() { return SPLIT; }
extern "C" int decode_attn_warps() { return WARPS; }

// Floats of scratch a call needs: one partial per (b, h, split).
extern "C" long long decode_attn_scratch_floats(int B, int H, int S, int D) {
  const long long n_split = (S + SPLIT - 1) / SPLIT;
  return (long long)B * H * n_split * (D + PART_PAD);
}

// q, out (B, 1, H, D) and the slabs (B, S, H, D) contiguous fp32; lens
// (B,) int32; part, decode_attn_scratch_floats(B, H, S, D) floats;
// counters (B*H,) int32, zero before the call and zero after it. Calls that
// share counters must not overlap in time. Returns the CUDA error of the
// launch (0 on success).
extern "C" int decode_attn_f32(const float* q, const float* kc,
                               const float* vc, const int* lens, float* out,
                               float* part, int* counters, int B, int H,
                               int S, int D, float scale, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if ((S + SPLIT - 1) / SPLIT > 65535)  // the grid's y extent
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, kc, vc, lens, out, part, counters, B, H, S, scale,
                       device, s);
  if (D == 64)
    return launch<64>(q, kc, vc, lens, out, part, counters, B, H, S, scale,
                      device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
