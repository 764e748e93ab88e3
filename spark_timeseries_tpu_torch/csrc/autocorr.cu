// Multi-lag sample autocorrelation with the valid-sample mean.
//
// Replaces spark_timeseries_tpu/ops/pallas_kernels.py `_autocorr_kernel`
// (launched by `_batch_autocorr_call`).
//
// Per series, over the valid (non-NaN) entries:
//   m   = sum_valid y_t / max(n_valid, 1)
//   d_t = valid ? y_t - m : 0
//   r_k = sum_t d_t d_{t-k} / sum_t d_t^2,   k = 1 .. nl
// A constant or all-NaN row gives 0/0 = NaN, as in the reference.
//
// What bounds it on an H100: bytes.  The function needs one read of the
// [T, B] panel and ~2(nl+1) flops per element (nl = 20: 1.06e10 flops at
// 100k x 2520, 0.16 ms at the float32 rate, under the 0.30 ms of one read).
// One thread per series walks time twice: pass 1 counts the valid entries
// and sums them (the mean must be complete before any product), pass 2
// keeps the last nl centred values in a shift register and nl+1
// accumulators.  Two reads of the panel mean the kernel reaches at most half
// of its one-read bound; the reference makes the same second pass on long
// series (an XLA reduction for the mean before its kernel).  Registers hold
// the ring and the sums for nl <= 32 (kernels are instantiated per capacity
// 1/2/4/8/16/32, so every index is a compile-time constant); longer lag sets
// use a circular ring in local memory.  Each sum is one thread's sequential
// sum in time order: no atomics, bitwise reproducible.
#include "common.cuh"

namespace {

using sts::at;

constexpr int kMaxLag = 1024;  // autocorr_structural_ok: nl < 1024
constexpr int kLagMask = kMaxLag - 1;

__device__ __forceinline__ float valid_mean(const float* __restrict__ y,
                                            int B, int T, int b) {
  float n = 0.f, s = 0.f;
  for (int t = 0; t < T; ++t) {
    const float v = y[at(t, B, b)];
    if (!isnan(v)) {
      n += 1.f;
      s += v;
    }
  }
  return s / fmaxf(n, 1.f);
}

template <int C>
__global__ void __launch_bounds__(sts::kThreads)
autocorr_reg(const float* __restrict__ y, float* __restrict__ out, int B,
             int T, int nl) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float mean = valid_mean(y, B, T, b);
  float dl[C], acc[C];  // dl[k] = d_{t-1-k}; acc[k] = sum d_t d_{t-1-k}
#pragma unroll
  for (int k = 0; k < C; ++k) dl[k] = acc[k] = 0.f;
  float a0 = 0.f;
  for (int t = 0; t < T; ++t) {
    const float v = y[at(t, B, b)];
    const float dt = isnan(v) ? 0.f : v - mean;
    a0 += dt * dt;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (k < nl) acc[k] += dt * dl[k];
#pragma unroll
    for (int k = C - 1; k > 0; --k) dl[k] = dl[k - 1];
    dl[0] = dt;
  }
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (k < nl) out[at(k, B, b)] = acc[k] / a0;
}

// nl > 32: the ring and the sums in local memory; slot (s & kLagMask) holds
// d_s, and slots before the series start read 0, as the reference's halo.
__global__ void __launch_bounds__(sts::kThreads)
autocorr_dyn(const float* __restrict__ y, float* __restrict__ out, int B,
             int T, int nl) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float mean = valid_mean(y, B, T, b);
  float ring[kMaxLag], acc[kMaxLag];
  for (int k = 0; k < kMaxLag; ++k) ring[k] = 0.f;
  for (int k = 0; k < nl; ++k) acc[k] = 0.f;
  float a0 = 0.f;
  for (int t = 0; t < T; ++t) {
    const float v = y[at(t, B, b)];
    const float dt = isnan(v) ? 0.f : v - mean;
    a0 += dt * dt;
    for (int k = 0; k < nl; ++k) acc[k] += dt * ring[(t - 1 - k) & kLagMask];
    ring[t & kLagMask] = dt;
  }
  for (int k = 0; k < nl; ++k) out[at(k, B, b)] = acc[k] / a0;
}

}  // namespace

// y: [T, B]; out: [nl, B] (r_1 .. r_nl); 0 < nl < 1024.
// Returns cudaGetLastError() after the launch.
extern "C" int sts_autocorr(const float* y, float* out, int B, int T, int nl,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = sts::grid_for(B);
  if (nl <= 32) {
    sts::with_cap32(nl, [&](auto c) {
      STS_LAUNCH(grid, s, autocorr_reg<decltype(c)::value>)(y, out, B, T, nl);
    });
  } else {
    STS_LAUNCH(grid, s, autocorr_dyn)(y, out, B, T, nl);
  }
  return static_cast<int>(cudaGetLastError());
}
