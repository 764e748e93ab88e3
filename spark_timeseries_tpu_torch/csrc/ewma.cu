// EWMA smoothing recursion: forward and adjoint kernels.
//
// Replaces spark_timeseries_tpu/ops/pallas_kernels.py `_ewma_fwd_kernel`
// (launched by `_ewma_fwd_call`) and `_ewma_bwd_kernel` (launched by
// `_ewma_bwd_call`).
//
// Forward, per series, with the data x zeroed before its first live step zb:
//   s_t = 0 (t < zb),   x_zb (t = zb),   alpha x_t + (1 - alpha) s_{t-1} (t > zb)
//   sse = sum_{t > zb} (x_t - s_{t-1})^2          (the one-step-ahead error)
// Modes (a uniform runtime argument, so ONE code path):
//   0 e: s out   1 sum: sse only   2 both: s and sse.
// Every operation is an _rn intrinsic, which nvcc never contracts into a
// fused multiply-add: `sum` and `both` give the same sse bit for bit (the
// optimizer compares f across the two), and the plain PyTorch version, which
// rounds each operation the same way, matches the kernel bit for bit.
//
// Adjoint, walking t downward, for a cotangent g of s ([T, B]) or, for the
// sse, its per-series cotangent gbar ([B]).  In the latter case the per-step
// cotangent g_t = -2 gbar err_{t+1} is formed here from x and the saved s
// (err_{t+1} = x_{t+1} - s_t when t+1 > zb, 0 at t = T-1), so the fit never
// writes a [T, B] cotangent:
//   lam_t  = live_t ? g_t + (1 - alpha) lam_{t+1} : 0,  live_t = [t >= zb]
//   dalpha = sum_{t > zb} lam_t (x_t - s_{t-1})
//   dx_t   = live_t ? (t > zb ? alpha lam_t : lam_t) : 0    (s_zb = x_zb)
//            + 2 gbar err_t for the sse (its direct dependence on x_t)
// The seed step reads no s_{zb-1}, so lam does not pass below it.
//
// What bounds it on an H100: bytes.  `sum` reads x once (4 B an element) for
// 6 flops; `e` and `both` add the s write; the adjoint reads x and s once
// each (a one-step window keeps x_{t+1} and s_t in registers), plus the dx
// write when asked.  The recursion is serial in t, so all parallelism is
// across series: one thread per series over the time-major panel, every
// carry in a register, each sum one thread's sequential sum (no atomics).
#include "common.cuh"

namespace {

using sts::at;

enum : int { kModeE = 0, kModeSum = 1, kModeBoth = 2 };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void __launch_bounds__(sts::kThreads)
ewma_fwd_k(const float* __restrict__ x, const float* __restrict__ alpha,
           const float* __restrict__ zbp, float* __restrict__ s,
           float* __restrict__ sse, int B, int T, int mode) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float a = alpha[b];
  const float om = sub(1.f, a);
  const float z = zbp[b];
  const bool emit_s = mode != kModeSum;
  float sp = 0.f, acc = 0.f;
  for (int t = 0; t < T; ++t) {
    const float xt = x[at(t, B, b)];
    const float tf = static_cast<float>(t);
    float sv = tf == z ? xt : add(mul(a, xt), mul(om, sp));
    if (!(tf >= z)) sv = 0.f;
    if (emit_s) s[at(t, B, b)] = sv;
    if (tf > z) {
      const float e = sub(xt, sp);
      acc = add(acc, mul(e, e));
    }
    sp = sv;
  }
  if (mode != kModeE) sse[b] = acc;
}

__global__ void __launch_bounds__(sts::kThreads)
ewma_bwd_k(const float* __restrict__ x, const float* __restrict__ s,
           const float* __restrict__ alpha, const float* __restrict__ zbp,
           const float* __restrict__ g, float* __restrict__ galpha,
           float* __restrict__ gx, int B, int T, int g_is_sse) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float a = alpha[b];
  const float om = sub(1.f, a);
  const float z = zbp[b];
  const float gb = g_is_sse ? g[b] : 0.f;
  float lam_next = 0.f, da = 0.f;
  // window: x_{t+1} and s_t, carried down from the step above
  float x_next = 0.f;
  float st = T > 0 ? s[at(T - 1, B, b)] : 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float xt = x[at(t, B, b)];
    const float sp = t >= 1 ? s[at(t - 1, B, b)] : 0.f;
    const float tf = static_cast<float>(t);
    const bool live = tf >= z;
    const bool past = tf > z;  // past the seed: s_t reads s_{t-1}
    float gt;
    if (g_is_sse) {
      const float en = (t + 1 < T && tf + 1.f > z) ? sub(x_next, st) : 0.f;
      gt = mul(mul(-2.f, en), gb);
    } else {
      gt = g[at(t, B, b)];
    }
    const float lam = live ? add(gt, mul(om, lam_next)) : 0.f;
    const float err = sub(xt, sp);
    if (live && past) da = add(da, mul(lam, err));
    if (gx != nullptr) {
      float v = live ? (past ? mul(a, lam) : lam) : 0.f;
      if (g_is_sse && past) v = add(v, mul(mul(2.f, err), gb));
      gx[at(t, B, b)] = v;
    }
    lam_next = past ? lam : 0.f;
    x_next = xt;
    st = sp;
  }
  galpha[b] = da;
}

}  // namespace

// x, s, gx: [T, B]; alpha, zb, sse, galpha: [B]; g: [T, B] or [B]
// (g_is_sse).  Null for outputs a mode does not write.  Return
// cudaGetLastError() after the launch.
extern "C" int sts_ewma_fwd(const float* x, const float* alpha,
                            const float* zb, float* s, float* sse, int B,
                            int T, int mode, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  STS_LAUNCH(sts::grid_for(B), st, ewma_fwd_k)(x, alpha, zb, s, sse, B, T,
                                               mode);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sts_ewma_bwd(const float* x, const float* s,
                            const float* alpha, const float* zb,
                            const float* g, float* galpha, float* gx, int B,
                            int T, int g_is_sse, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  STS_LAUNCH(sts::grid_for(B), st, ewma_bwd_k)(x, s, alpha, zb, g, galpha, gx,
                                               B, T, g_is_sse);
  return static_cast<int>(cudaGetLastError());
}
