// CSS forward and adjoint kernels: the ARMA(p, q) conditional sum of squares.
//
// Replaces spark_timeseries_tpu/ops/pallas_kernels.py `_css_fwd_kernel`
// (launched by `_css_fwd_call_f`) and `_css_bwd_kernel` (launched by
// `_css_errors_bwd_f`).
//
// Forward, per series (m_t = [zb <= t < t_limit]; y and e are 0 before t=0):
//   e_t = m_t * (y_t - c - sum_i phi_i y_{t-i} - sum_j theta_j e_{t-j})
// Adjoint for an upstream cotangent g of e, walking t downward:
//   a_t  = m_t * (g_t - sum_j theta_j a_{t+j})
//   dc   = -sum_t a_t,  dphi_i = -sum_t y_{t-i} a_t,  dtheta_j = -sum_t e_{t-j} a_t
//   dy_t = a_t - sum_i phi_i a_{t+i}                     (only when asked)
// g is either a [T, B] panel or, for the fit objective sum_t e_t^2, the
// per-series cotangent gbar [B] with g_t = 2 e_t gbar formed here, so the
// fit never materialises a [T, B] cotangent.
//
// What bounds it on an H100: bytes.  The `sum` forward reads the panel once
// (4 B per element) for ~2(p+q+1) flops per element, far under the card's
// float32 rate, so its floor is 4*T*B bytes / 3.35 TB/s; the adjoint reads
// y and e once each.  The recursion is serial in t, so all parallelism is
// across series: one thread per series over the time-major panel, so a
// warp's loads at each step are 32 neighbouring floats.  Lag rings for
// p, q <= 8 live in registers (kernels are instantiated per ring capacity
// 1/2/4/8 and every ring index is a compile-time constant); orders up to
// 512 use rings in local memory.  The loads of y_t and e_t do not depend on
// the recursion, so they can be issued ahead of it; enough series (B in the
// hundreds of thousands) keep the memory system busy.
//
// Forward modes (a uniform runtime argument, so ONE code path):
//   0 e: errors out   1 sum: per-series SSE only   2 both: errors and SSE
//   3 tail: only the last q errors, for the forecast carry.
// `sum` and `both` run the same instructions on the same values, so their
// SSEs are bitwise identical: the optimizer compares f across the two.
#include "common.cuh"

namespace {

using sts::at;

constexpr int kMaxLag = 512;  // css_structural_ok: p, q <= 512
constexpr int kLagMask = kMaxLag - 1;

enum : int { kModeE = 0, kModeSum = 1, kModeBoth = 2, kModeTail = 3 };

template <int PC, int QC>
__global__ void __launch_bounds__(sts::kThreads)
css_fwd_reg(const float* __restrict__ y, const float* __restrict__ par,
            const float* __restrict__ zb, float* __restrict__ e,
            float* __restrict__ sse, float* __restrict__ tail, int B, int T,
            int p, int q, int t_limit, int mode) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float c = par[b];
  float phi[PC], yl[PC], th[QC], el[QC];  // yl[i] = y_{t-1-i}, el[j] = e_{t-1-j}
#pragma unroll
  for (int i = 0; i < PC; ++i) {
    phi[i] = i < p ? par[at(1 + i, B, b)] : 0.f;
    yl[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < QC; ++j) {
    th[j] = j < q ? par[at(1 + p + j, B, b)] : 0.f;
    el[j] = 0.f;
  }
  const float z = zb[b];
  const bool emit_e = mode == kModeE || mode == kModeBoth;
  const int t_end = mode == kModeTail ? t_limit : T;
  float acc = 0.f;
  for (int t = 0; t < t_end; ++t) {
    const float yt = y[at(t, B, b)];
    float pred = c;
#pragma unroll
    for (int i = 0; i < PC; ++i)
      if (i < p) pred += phi[i] * yl[i];
#pragma unroll
    for (int j = 0; j < QC; ++j)
      if (j < q) pred += th[j] * el[j];
    const bool live = static_cast<float>(t) >= z && t < t_limit;
    const float et = live ? yt - pred : 0.f;
    if (emit_e) e[at(t, B, b)] = et;
    acc += et * et;
#pragma unroll
    for (int i = PC - 1; i > 0; --i) yl[i] = yl[i - 1];
    yl[0] = yt;
#pragma unroll
    for (int j = QC - 1; j > 0; --j) el[j] = el[j - 1];
    el[0] = et;
  }
  if (mode == kModeSum || mode == kModeBoth) sse[b] = acc;
  if (mode == kModeTail) {
    // el[j] = e_{t_limit-1-j}; the tail is oldest first
#pragma unroll
    for (int j = 0; j < QC; ++j)
      if (j < q) tail[at(q - 1 - j, B, b)] = el[j];
  }
}

// Orders past the register rings: circular rings in local memory, where
// slot (s & kLagMask) holds step s.  A lag of up to kMaxLag reads its slot
// before step t overwrites it.
__global__ void __launch_bounds__(sts::kThreads)
css_fwd_dyn(const float* __restrict__ y, const float* __restrict__ par,
            const float* __restrict__ zb, float* __restrict__ e,
            float* __restrict__ sse, float* __restrict__ tail, int B, int T,
            int p, int q, int t_limit, int mode) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float yl[kMaxLag], el[kMaxLag];
  const float c = par[b];
  const float z = zb[b];
  const bool emit_e = mode == kModeE || mode == kModeBoth;
  const int t_end = mode == kModeTail ? t_limit : T;
  float acc = 0.f;
  for (int t = 0; t < t_end; ++t) {
    const float yt = y[at(t, B, b)];
    float pred = c;
    for (int i = 1; i <= p; ++i)
      if (t - i >= 0) pred += par[at(i, B, b)] * yl[(t - i) & kLagMask];
    for (int j = 1; j <= q; ++j)
      if (t - j >= 0) pred += par[at(p + j, B, b)] * el[(t - j) & kLagMask];
    const bool live = static_cast<float>(t) >= z && t < t_limit;
    const float et = live ? yt - pred : 0.f;
    if (emit_e) e[at(t, B, b)] = et;
    acc += et * et;
    yl[t & kLagMask] = yt;
    el[t & kLagMask] = et;
  }
  if (mode == kModeSum || mode == kModeBoth) sse[b] = acc;
  if (mode == kModeTail)
    for (int j = 0; j < q; ++j)
      tail[at(j, B, b)] = el[(t_limit - q + j) & kLagMask];
}

template <int PC, int QC>
__global__ void __launch_bounds__(sts::kThreads)
css_bwd_reg(const float* __restrict__ y, const float* __restrict__ e,
            const float* __restrict__ par, const float* __restrict__ zb,
            const float* __restrict__ g, float* __restrict__ gpar,
            float* __restrict__ gy, int B, int T, int p, int q, int t_limit,
            int g_is_sse) {
  constexpr int AC = PC > QC ? PC : QC;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float phi[PC], th[QC];
#pragma unroll
  for (int i = 0; i < PC; ++i) phi[i] = i < p ? par[at(1 + i, B, b)] : 0.f;
#pragma unroll
  for (int j = 0; j < QC; ++j) th[j] = j < q ? par[at(1 + p + j, B, b)] : 0.f;
  // windows at step t: al[i] = a_{t+1+i}, yl[i] = y_{t-1-i}, el[j] = e_{t-j}
  float al[AC], yl[PC], el[QC + 1];
  const int t0 = T - 1;
#pragma unroll
  for (int i = 0; i < AC; ++i) al[i] = 0.f;
#pragma unroll
  for (int i = 0; i < PC; ++i)
    yl[i] = (i < p && t0 - 1 - i >= 0) ? y[at(t0 - 1 - i, B, b)] : 0.f;
#pragma unroll
  for (int j = 0; j <= QC; ++j)
    el[j] = (j <= q && t0 - j >= 0) ? e[at(t0 - j, B, b)] : 0.f;
  const float z = zb[b];
  const float gs = g_is_sse ? g[b] : 0.f;
  float gc = 0.f, gphi[PC], gth[QC];
#pragma unroll
  for (int i = 0; i < PC; ++i) gphi[i] = 0.f;
#pragma unroll
  for (int j = 0; j < QC; ++j) gth[j] = 0.f;
  for (int t = t0; t >= 0; --t) {
    const float gt = g_is_sse ? 2.f * el[0] * gs : g[at(t, B, b)];
    float av = gt;
#pragma unroll
    for (int j = 0; j < QC; ++j)
      if (j < q) av -= th[j] * al[j];
    const bool live = static_cast<float>(t) >= z && t < t_limit;
    const float a = live ? av : 0.f;
    if (gy != nullptr) {
      float d = a;
#pragma unroll
      for (int i = 0; i < PC; ++i)
        if (i < p) d -= phi[i] * al[i];
      gy[at(t, B, b)] = d;
    }
    gc -= a;
#pragma unroll
    for (int i = 0; i < PC; ++i)
      if (i < p) gphi[i] -= yl[i] * a;
#pragma unroll
    for (int j = 0; j < QC; ++j)
      if (j < q) gth[j] -= el[j + 1] * a;
    // slide the windows to step t - 1
#pragma unroll
    for (int i = AC - 1; i > 0; --i) al[i] = al[i - 1];
    al[0] = a;
#pragma unroll
    for (int i = 0; i < PC; ++i) {
      if (i + 1 < p) yl[i] = yl[i + 1];
      else if (i + 1 == p) yl[i] = t - 1 - p >= 0 ? y[at(t - 1 - p, B, b)] : 0.f;
    }
#pragma unroll
    for (int j = 0; j <= QC; ++j) {
      if (j < q) el[j] = el[j + 1];
      else if (j == q) el[j] = t - 1 - q >= 0 ? e[at(t - 1 - q, B, b)] : 0.f;
    }
  }
  gpar[b] = gc;
#pragma unroll
  for (int i = 0; i < PC; ++i)
    if (i < p) gpar[at(1 + i, B, b)] = gphi[i];
#pragma unroll
  for (int j = 0; j < QC; ++j)
    if (j < q) gpar[at(1 + p + j, B, b)] = gth[j];
}

// Orders past the register rings: the adjoint ring and the gradient sums
// live in local memory; lagged y and e are read straight from the panels.
__global__ void __launch_bounds__(sts::kThreads)
css_bwd_dyn(const float* __restrict__ y, const float* __restrict__ e,
            const float* __restrict__ par, const float* __restrict__ zb,
            const float* __restrict__ g, float* __restrict__ gpar,
            float* __restrict__ gy, int B, int T, int p, int q, int t_limit,
            int g_is_sse) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float al[kMaxLag], gphi[kMaxLag], gth[kMaxLag];
  for (int i = 0; i < p; ++i) gphi[i] = 0.f;
  for (int j = 0; j < q; ++j) gth[j] = 0.f;
  const float z = zb[b];
  const float gs = g_is_sse ? g[b] : 0.f;
  float gc = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float gt = g_is_sse ? 2.f * e[at(t, B, b)] * gs : g[at(t, B, b)];
    float av = gt;
    for (int j = 1; j <= q; ++j)
      if (t + j < T) av -= par[at(p + j, B, b)] * al[(t + j) & kLagMask];
    const bool live = static_cast<float>(t) >= z && t < t_limit;
    const float a = live ? av : 0.f;
    if (gy != nullptr) {
      float d = a;
      for (int i = 1; i <= p; ++i)
        if (t + i < T) d -= par[at(i, B, b)] * al[(t + i) & kLagMask];
      gy[at(t, B, b)] = d;
    }
    gc -= a;
    for (int i = 1; i <= p; ++i)
      if (t - i >= 0) gphi[i - 1] -= y[at(t - i, B, b)] * a;
    for (int j = 1; j <= q; ++j)
      if (t - j >= 0) gth[j - 1] -= e[at(t - j, B, b)] * a;
    al[t & kLagMask] = a;
  }
  gpar[b] = gc;
  for (int i = 0; i < p; ++i) gpar[at(1 + i, B, b)] = gphi[i];
  for (int j = 0; j < q; ++j) gpar[at(1 + p + j, B, b)] = gth[j];
}

}  // namespace

// y, e: [T, B]; par, gpar: [1+p+q, B]; zb, sse: [B]; tail: [q, B];
// g: [T, B] or [B] (g_is_sse).  Null for outputs a mode does not write.
// Returns cudaGetLastError() after the launch.
extern "C" int sts_css_fwd(const float* y, const float* par, const float* zb,
                           float* e, float* sse, float* tail, int B, int T,
                           int p, int q, int t_limit, int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = sts::grid_for(B);
  if (p <= 8 && q <= 8) {
    sts::with_cap8(p, [&](auto pc) {
      sts::with_cap8(q, [&](auto qc) {
        STS_LAUNCH(grid, s,
                   css_fwd_reg<decltype(pc)::value, decltype(qc)::value>)(
            y, par, zb, e, sse, tail, B, T, p, q, t_limit, mode);
      });
    });
  } else {
    STS_LAUNCH(grid, s, css_fwd_dyn)(y, par, zb, e, sse, tail, B, T, p, q,
                                     t_limit, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sts_css_bwd(const float* y, const float* e, const float* par,
                           const float* zb, const float* g, float* gpar,
                           float* gy, int B, int T, int p, int q, int t_limit,
                           int g_is_sse, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = sts::grid_for(B);
  if (p <= 8 && q <= 8) {
    sts::with_cap8(p, [&](auto pc) {
      sts::with_cap8(q, [&](auto qc) {
        STS_LAUNCH(grid, s,
                   css_bwd_reg<decltype(pc)::value, decltype(qc)::value>)(
            y, e, par, zb, g, gpar, gy, B, T, p, q, t_limit, g_is_sse);
      });
    });
  } else {
    STS_LAUNCH(grid, s, css_bwd_dyn)(y, e, par, zb, g, gpar, gy, B, T, p, q,
                                     t_limit, g_is_sse);
  }
  return static_cast<int>(cudaGetLastError());
}
