// Launch counters kept on the device, one per kernel of a library.
//
// A kernel adds one to its counter when it starts, from the first thread of
// its first block, so a launch from a replayed CUDA graph is counted like
// one from the host. The wrapper's own count sees only the launches the
// host makes, and a profiler's kernel records are not an exact count (a
// record is now and then missing from a long trace of graph replays).
//
// LAUNCH_COUNTERS(name, n), once at file scope in a source, declares the
// counters `name##_launches[n]` and two C functions of the library:
//   int name_launch_kernels()  -> n
//   int name_launch_counts(int device, unsigned long long* out, int reset)
// which copies the n counters into `out` and, when `reset` is set, zeroes
// them; it returns the CUDA error (0 on success). The copy is ordered after
// the work on the legacy default stream, not after other streams' work:
// the caller synchronizes the device first.

#pragma once

#include <cuda_runtime.h>

#define LAUNCH_COUNTERS(name, n)                                           \
  __device__ unsigned long long name##_launches[n];                        \
  extern "C" int name##_launch_kernels() { return n; }                     \
  extern "C" int name##_launch_counts(int device, unsigned long long* out, \
                                      int reset) {                         \
    cudaError_t err = cudaSetDevice(device);                               \
    if (err == cudaSuccess)                                                \
      err = cudaMemcpyFromSymbol(out, name##_launches,                     \
                                 sizeof(name##_launches));                 \
    if (err == cudaSuccess && reset) {                                     \
      const unsigned long long zeros[n] = {};                              \
      err = cudaMemcpyToSymbol(name##_launches, zeros, sizeof(zeros));     \
    }                                                                      \
    return static_cast<int>(err);                                          \
  }

// One launch of the calling kernel: the first thread of block (0, 0, 0)
// adds one to `counter`.
__device__ __forceinline__ void count_launch(unsigned long long* counter) {
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y |
       threadIdx.z) == 0)
    atomicAdd(counter, 1ull);
}
