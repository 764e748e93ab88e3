// Shared helpers for the port's CUDA kernels (compiled for sm_90a).
//
// Layout contract of every kernel here: panels are TIME-MAJOR [T, B]
// float32, contiguous, so element (t, b) sits at t * B + b.  One thread owns
// one series and walks its time axis; the 32 threads of a warp read 32
// neighbouring series at each step, which makes every panel load coalesced.
// Per-series parameters and outputs are [k, B] for the same reason.
//
// Kernels launch on the caller's stream, allocate nothing, never
// synchronise, and use no atomics: every reduction is a fixed-order sum
// (one thread's sequential sum, or per-thread partials added in thread
// order), so results are bitwise reproducible.  Shared memory, where a
// kernel stages loads in it, is per-thread columns of a block's array: no
// thread reads another's words, so no barriers.  The one exception is the
// autocorrelation's tile (autocorr.cu), whose threads share a block's
// window of the panel; it launches with STS_LAUNCH_COOP and meets at
// __syncthreads.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

// Kernel launch on the caller's stream: STS_LAUNCH(grid, stream, kern)(args)
#ifndef STS_LAUNCH
#define STS_LAUNCH(grid, stream, ...) \
  __VA_ARGS__<<<(grid), ::sts::kThreads, 0, (stream)>>>
#endif

// The same with `smem` bytes of dynamic shared memory a block (above 48 KB
// only after cudaFuncSetAttribute(kern,
// cudaFuncAttributeMaxDynamicSharedMemorySize, smem)).
#ifndef STS_LAUNCH_SMEM
#define STS_LAUNCH_SMEM(grid, smem, stream, ...) \
  __VA_ARGS__<<<(grid), ::sts::kThreads, (smem), (stream)>>>
#endif

// The same with `threads` threads a block (a host emulation runs them one
// after another, as STS_LAUNCH_SMEM's).
#ifndef STS_LAUNCH_BLOCK
#define STS_LAUNCH_BLOCK(grid, threads, smem, stream, ...) \
  __VA_ARGS__<<<(grid), (threads), (smem), (stream)>>>
#endif

// The same, with `threads` threads a block, for a kernel whose threads
// share shared memory across __syncthreads barriers (a host emulation runs
// a block's threads together).
#ifndef STS_LAUNCH_COOP
#define STS_LAUNCH_COOP(grid, threads, smem, stream, ...) \
  __VA_ARGS__<<<(grid), (threads), (smem), (stream)>>>
#endif

// The block's dynamic shared memory as a float array `name` (16-byte
// aligned), declared inside a kernel or device function.
#ifndef STS_SHARED_FLOATS
#define STS_SHARED_FLOATS(name) extern __shared__ __align__(16) float name[]
#endif

namespace sts {

constexpr int kThreads = 256;

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

// Smallest register-ring capacity in {1, 2, 4, 8} that holds n lags.
// Kernels are instantiated per capacity, not per order: loops run to the
// compile-time capacity with a uniform `i < n` guard, so every ring index
// is a compile-time constant and the ring stays in registers.
template <class F>
void with_cap8(int n, F&& f) {
  if (n <= 1) f(std::integral_constant<int, 1>{});
  else if (n <= 2) f(std::integral_constant<int, 2>{});
  else if (n <= 4) f(std::integral_constant<int, 4>{});
  else f(std::integral_constant<int, 8>{});
}

__device__ __forceinline__ size_t at(int t, int B, int b) {
  return static_cast<size_t>(t) * static_cast<size_t>(B) + b;
}

}  // namespace sts
