// Hannan-Rissanen moment sweep: the weighted lagged moment sums behind the
// ARIMA fit's initial values.
//
// Replaces spark_timeseries_tpu/ops/pallas_kernels.py `_hr_kernel`
// (launched by `_hr_moments`).
//
// Per series, with the column stream at step t
//   c_t = [1 (if intercept), y_{t-1}..y_{t-lag_y}, eh_{t-1}..eh_{t-lag_e}]
// and weight w_t = [zb + woff <= t < t_limit], it accumulates
//   sum_t w_t c_a c_b  (a <= b)   and   sum_t w_t c_a y_t,
// laid out as the upper triangle row by row, then the cross moments.
// Stage 1 is the AR(m) regression (lag_e = 0).  Stage 2 rebuilds the stage-1
// residual eh_t = [zb + beta_m <= t < t_limit] * (y_t - beta_0 -
// sum_i beta_i y_{t-i}) on the fly from beta, so no [T, B] residual panel is
// ever written.  The tiny solves stay in PyTorch (ridge_solve).
//
// What bounds it on an H100: bytes.  Each stage reads the [T, B] panel once
// and does ~ncols^2 flops per element (14 accumulators for the ARIMA(1,1,1)
// init), well under the float32 rate, so its floor is 4*T*B / 3.35 TB/s.
// One thread per series walks time over the time-major panel (coalesced
// loads); the column window shifts through registers (slots are
// compile-time, the segment boundaries are uniform runtime compares), the
// accumulators stay in registers (kernels are instantiated per column
// capacity 2/4/8/16/32) and are written once.  No atomics: each sum is one
// thread's sequential sum.
//
// Loads in flight: a thread that loads one step at a time keeps one line in
// flight a warp, and at B = 1M the rate then follows the threads, not the
// bytes.  So y streams through ring.cuh's per-thread shared-memory ring of
// cp.async copies, 4 stages, D = STS_HR_DEPTH steps deep (32 KB a block at
// D = 32).  Only where y comes from changes: the step, and so every sum's
// order and rounding, is the one-load-a-step loop's, which a build with
// -DSTS_HR_DEPTH=0 keeps (chip_smoke.py holds the ring's sums against it
// bit for bit, and times the depths it builds beside it).
#include "ring.cuh"

#ifndef STS_HR_DEPTH
#define STS_HR_DEPTH 32
#endif

namespace {

using sts::at;

constexpr int kDepth = STS_HR_DEPTH;  // ring depth in steps; 0: no ring
constexpr int kStages = 4;
static_assert(kDepth == 0 || (kDepth % kStages == 0 && kDepth >= kStages),
              "STS_HR_DEPTH must be 0 or a positive multiple of 4");

// index of the pair (a, c) with a <= c in a row-major upper triangle of n
__host__ __device__ constexpr int tri(int n, int a, int c) {
  return a * n - a * (a - 1) / 2 + (c - a);
}

template <int NC>
__global__ void __launch_bounds__(sts::kThreads)
hr_moments_k(const float* __restrict__ y, const float* __restrict__ zb,
             const float* __restrict__ beta, float* __restrict__ acc, int B,
             int T, int lag_y, int lag_e, int intercept, int woff, int beta_m,
             int t_limit) {
  constexpr int YC = NC + 1;  // the residual's AR depth: beta_m <= ncols + 1
  constexpr int NP = NC * (NC + 1) / 2;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int ic = intercept ? 1 : 0;
  const int ncols = ic + lag_y + lag_e;
  float col[NC], yr[YC], bt[YC + 1], s[NP + NC];
#pragma unroll
  for (int a = 0; a < NC; ++a) col[a] = a < ic ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < YC; ++i) yr[i] = 0.f;  // yr[i] = y_{t-1-i}
#pragma unroll
  for (int i = 0; i <= YC; ++i)
    bt[i] = (lag_e > 0 && i <= beta_m) ? beta[at(i, B, b)] : 0.f;
#pragma unroll
  for (int r = 0; r < NP + NC; ++r) s[r] = 0.f;
  const float z = zb[b];
  const float zw = z + static_cast<float>(woff);
  const float z1 = z + static_cast<float>(beta_m);
  const int t_end = t_limit < T ? t_limit : T;
  auto step = [&](int t, float yt) {
    const float tf = static_cast<float>(t);
    const float w = tf >= zw ? 1.f : 0.f;
#pragma unroll
    for (int a = 0; a < NC; ++a) {
      const float wa = w * col[a];
#pragma unroll
      for (int c = a; c < NC; ++c)
        if (c < ncols) s[tri(NC, a, c)] += wa * col[c];
      if (a < ncols) s[NP + a] += wa * yt;
    }
    float eh = 0.f;
    if (lag_e > 0) {
      float pred = bt[0];
#pragma unroll
      for (int i = 0; i < YC; ++i)
        if (i < beta_m) pred += bt[i + 1] * yr[i];
      eh = (tf >= z1 ? 1.f : 0.f) * (yt - pred);
    }
#pragma unroll
    for (int i = YC - 1; i > 0; --i) yr[i] = yr[i - 1];
    yr[0] = yt;
    // slide the column window: y_t enters at slot ic, eh_t at ic + lag_y
#pragma unroll
    for (int a = NC - 1; a >= 0; --a) {
      if (a < ic) continue;  // the intercept column stays 1
      if (lag_e > 0 && a == ic + lag_y) col[a] = eh;
      else if (lag_y > 0 && a == ic) col[a] = yt;
      else if (a > 0) col[a] = col[a - 1];
    }
  };
  if constexpr (kDepth > 0) {
    const float* const pan[1] = {y};
    sts::stream<1, false, kStages, kDepth / kStages>(
        pan, B, t_end, b,
        [&](int t, int, const float (&v)[1]) { step(t, v[0]); });
  } else {
    for (int t = 0; t < t_end; ++t) step(t, y[at(t, B, b)]);
  }
#pragma unroll
  for (int a = 0; a < NC; ++a) {
#pragma unroll
    for (int c = a; c < NC; ++c)
      if (c < ncols) acc[at(tri(ncols, a, c), B, b)] = s[tri(NC, a, c)];
    if (a < ncols) acc[at(ncols * (ncols + 1) / 2 + a, B, b)] = s[NP + a];
  }
}

}  // namespace

// y: [T, B]; zb: [B] (series start); beta: [beta_m + 1, B] (stage 2 only);
// acc: [ncols*(ncols+1)/2 + ncols, B].  Returns the CUDA error of the
// launch (0 on success).
extern "C" int sts_hr_moments(const float* y, const float* zb,
                              const float* beta, float* acc, int B, int T,
                              int lag_y, int lag_e, int intercept, int woff,
                              int beta_m, int t_limit, void* stream) {
  const int ncols = (intercept ? 1 : 0) + lag_y + lag_e;
  if (ncols < 1 || ncols > 32 || beta_m > ncols + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto nc) {
    return sts::launch_ring(hr_moments_k<decltype(nc)::value>,
                            sts::ring_bytes(1, kDepth), B, s, y, zb, beta,
                            acc, B, T, lag_y, lag_e, intercept, woff, beta_m,
                            t_limit);
  };
  if (ncols <= 2) return launch(std::integral_constant<int, 2>{});
  if (ncols <= 4) return launch(std::integral_constant<int, 4>{});
  if (ncols <= 8) return launch(std::integral_constant<int, 8>{});
  if (ncols <= 16) return launch(std::integral_constant<int, 16>{});
  return launch(std::integral_constant<int, 32>{});
}

// The ring's depth in steps, as built (0: one load of y a step).
extern "C" int sts_hr_ring_depth() { return kDepth; }

// Blocks an SM can hold and dynamic shared memory a block, for the
// ARIMA(1,1,1) init's instantiation (4 columns).  Returns the CUDA error.
extern "C" int sts_hr_occupancy(int* blocks, int* smem) {
  *smem = static_cast<int>(sts::ring_bytes(1, kDepth));
  return static_cast<int>(sts::blocks_per_sm(hr_moments_k<4>, *smem, blocks));
}
