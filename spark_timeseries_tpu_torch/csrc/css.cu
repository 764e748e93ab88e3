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
// fit never materialises a [T, B] cotangent.  The sums over i and j may
// run over a listed subset of the lags (a seasonal expansion's structural
// support): the others are read as zero coefficients and get an exact 0
// gradient.
//
// What bounds it on an H100: bytes.  The `sum` forward reads the panel once
// (4 B per element) for ~2(p+q+1) flops per element, far under the card's
// float32 rate, so its floor is 4*T*B bytes / 3.35 TB/s; the adjoint reads
// e once (and y once where there are AR lags).  The recursion is serial in
// t, so all parallelism is across series: one thread per series over the
// time-major panel, so a warp's loads at each step are 32 neighbouring
// floats.  Three routes, chosen by route_of() (ops/cuda_kernels.css_route
// mirrors it):
//   - register (p, q <= 8, every lag): the rings in registers; kernels are
//     instantiated per ring capacity 1/2/4/8, so every ring index is a
//     compile-time constant;
//   - lag (up to 32 listed lags a side whose rings fit shared memory): the
//     seasonal fits.  The coefficients of the listed lags are loaded once,
//     into registers (the wrapper gathers them into [1 + KA + KM, B]); the
//     lags are a by-value argument; the lag rings are per-thread columns of
//     dynamic shared memory, [L][kLagThreads] floats with slot t & (L - 1)
//     holding step t, so a warp's 32 reads hit 32 banks; the panels stream
//     through ring.cuh's cp.async ring ahead of the recursion.  The adjoint
//     sums its gradients by the index of the panel word, dtheta_j = -sum_u
//     e_u a_{u+j} and dphi_i = -sum_u y_u a_{u+i}: at step u it holds e_u
//     and y_u, just streamed, and reads a_{u+j} from its a ring for the
//     recursion anyway, so it reads each panel once (the same terms, in the
//     same descending order, as the local route's and the plain version's);
//   - local (the rest, up to the reference's 512 lags): circular rings of
//     512 floats a thread in local memory, every slot walked, lagged y and
//     e read from the panels; a lag set is applied by the wrapper (unlisted
//     coefficients and gradients zeroed).
//
// Forward modes (a uniform runtime argument, so ONE code path):
//   0 e: errors out   1 sum: per-series SSE only   2 both: errors and SSE
//   3 tail: only the last q errors, for the forecast carry.
// `sum` and `both` run the same instructions on the same values, so their
// SSEs are bitwise identical: the optimizer compares f across the two.
#include "ring.cuh"

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

// The local route: circular rings in local memory, where slot
// (s & kLagMask) holds step s.  A lag of up to kMaxLag reads its slot
// before step t overwrites it.
__global__ void __launch_bounds__(sts::kThreads)
css_fwd_local(const float* __restrict__ y, const float* __restrict__ par,
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

// The local route: the adjoint ring and the gradient sums live in local
// memory; lagged y and e are read straight from the panels.
__global__ void __launch_bounds__(sts::kThreads)
css_bwd_local(const float* __restrict__ y, const float* __restrict__ e,
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

// ---------------------------------------------------------------------------
// The lag route
// ---------------------------------------------------------------------------

constexpr int kLagThreads = 128;  // threads a block: a ring row is 512 B
constexpr int kLagCap = 32;       // listed lags a side
constexpr int kLagDepth = 32;     // the panel stream: D steps deep, in
constexpr int kLagSteps = 8;      // commit groups of 8 steps
constexpr size_t kRowBytes = sizeof(float) * kLagThreads;
constexpr size_t kSmemLimit = 227 * 1024;  // dynamic shared memory a block

enum : int { kRouteReg = 0, kRouteLag = 1, kRouteLocal = 2 };

// The listed lags, ascending, passed by value (kernel parameter space: a
// launch copies nothing and syncs nothing).
struct LagSet {
  short a[kLagCap];  // AR lags; the first ka are set
  short m[kLagCap];  // MA lags; the first km are set
  int ka, km;
};

// Least power of two above n: a ring of it holds steps t - n .. t.
inline int ring_len(int n) {
  int l = 1;
  while (l <= n) l <<= 1;
  return l;
}

// The lag set of (lags, ka, km), or of every lag 1..p, 1..q for null lags.
inline LagSet lag_set(int p, int q, const int* lags, int ka, int km) {
  LagSet lg{};
  lg.ka = lags ? ka : p;
  lg.km = lags ? km : q;
  for (int k = 0; k < lg.ka && k < kLagCap; ++k)
    lg.a[k] = static_cast<short>(lags ? lags[k] : k + 1);
  for (int k = 0; k < lg.km && k < kLagCap; ++k)
    lg.m[k] = static_cast<short>(lags ? lags[ka + k] : k + 1);
  return lg;
}

inline int deepest(const short* v, int n) { return n ? v[n - 1] : 0; }

// The lag route forward's y ring (only with AR lags) and e ring (with MA
// lags, or for the tail's last q errors): their lengths, 0 for no ring.
struct FwdRings {
  int la, le;
};

inline FwdRings fwd_rings(const LagSet& lg, int q, bool tail) {
  const int dm = deepest(lg.m, lg.km);
  return {lg.ka ? ring_len(deepest(lg.a, lg.ka)) : 0,
          (lg.km || (tail && q)) ? ring_len(tail && q > dm ? q : dm) : 0};
}

// Dynamic shared memory of the lag route's forward and adjoint (np
// streamed panels, one a ring spanning every lag).
inline size_t fwd_smem(const LagSet& lg, int q, bool tail) {
  const FwdRings r = fwd_rings(lg, q, tail);
  return kRowBytes * (kLagDepth + r.la + r.le);
}

inline int bwd_ring(const LagSet& lg) {
  const int da = deepest(lg.a, lg.ka), dm = deepest(lg.m, lg.km);
  return (lg.ka || lg.km) ? ring_len(da > dm ? da : dm) : 0;
}

inline size_t bwd_smem(const LagSet& lg, int np) {
  return kRowBytes * (np * kLagDepth + bwd_ring(lg));
}

// The route of an order (p, q) with listed lags (null: every lag): register
// rings for p, q <= 8 and every lag; the lag route for up to kLagCap lags a
// side whose rings fit kSmemLimit in the largest case of either kernel (the
// tail's e ring, three streamed panels); else the local route.
int route_of(int p, int q, const int* lags, int ka, int km) {
  if (lags == nullptr && p <= 8 && q <= 8) return kRouteReg;
  const LagSet lg = lag_set(p, q, lags, ka, km);
  if (lg.ka > kLagCap || lg.km > kLagCap) return kRouteLocal;
  if (fwd_smem(lg, q, true) > kSmemLimit || bwd_smem(lg, 3) > kSmemLimit)
    return kRouteLocal;
  return kRouteLag;
}

// Ring capacities of the lag kernels: lags a side are loaded into KC
// registers and walked by an unrolled loop guarded by the runtime count.
// Up to 8 lags a side the panel stream walks stages of 8 steps (unrolled);
// wider, stages of one step, which keeps the unrolled code (and nvcc's
// time) small at the same depth D.
template <int AC, int MC>
constexpr int kStreamSteps = AC > 8 || MC > 8 ? 1 : kLagSteps;

// The live steps zb <= t < t_limit of a series as [z0, z0 + n): one
// unsigned compare a step (t < 2^24, where float(t) is exact).
struct LiveWindow {
  int z0;
  unsigned n;
  __device__ __forceinline__ bool operator()(int t) const {
    return static_cast<unsigned>(t - z0) < n;
  }
};

__device__ __forceinline__ LiveWindow live_window(float z, int t_limit) {
  if (!(z < static_cast<float>(t_limit))) return {0, 0u};  // NaN too
  const int z0 = z > 0.f ? static_cast<int>(ceilf(z)) : 0;
  return {z0, static_cast<unsigned>(t_limit - z0)};
}

template <class F>
void with_lag_cap(int n, F&& f) {
  if (n == 0) f(std::integral_constant<int, 0>{});
  else if (n <= 3) f(std::integral_constant<int, 3>{});
  else if (n <= 8) f(std::integral_constant<int, 8>{});
  else f(std::integral_constant<int, kLagCap>{});
}

// par: [1 + ka + km, B] rows [c, the AR lags' phi, the MA lags' theta].
// la, le: the y and e rings' lengths (0: no ring).
template <int AC, int MC>
__global__ void __launch_bounds__(kLagThreads)
css_fwd_lag_k(const float* __restrict__ y, const float* __restrict__ par,
              const float* __restrict__ zb, float* __restrict__ e,
              float* __restrict__ sse, float* __restrict__ tail, int B,
              int T, int q, int t_limit, int mode, int la, int le,
              LagSet lg) {
  constexpr int kSteps = kStreamSteps<AC, MC>;
  const int b = blockIdx.x * kLagThreads + threadIdx.x;
  if (b >= B) return;
  STS_SHARED_FLOATS(smem);
  // this thread's columns of the y and e rings, after the panel stream's
  float* const yr = smem + kLagDepth * kLagThreads + threadIdx.x;
  float* const er = yr + la * kLagThreads;
  const int ma = la - 1, me = le - 1;
  for (int s = 0; s < la; ++s) yr[s * kLagThreads] = 0.f;
  for (int s = 0; s < le; ++s) er[s * kLagThreads] = 0.f;
  const float c = par[b];
  float phi[AC > 0 ? AC : 1], th[MC > 0 ? MC : 1];
#pragma unroll
  for (int k = 0; k < AC; ++k)
    phi[k] = k < lg.ka ? par[at(1 + k, B, b)] : 0.f;
#pragma unroll
  for (int k = 0; k < MC; ++k)
    th[k] = k < lg.km ? par[at(1 + lg.ka + k, B, b)] : 0.f;
  const LiveWindow live = live_window(zb[b], t_limit);
  const bool emit_e = mode == kModeE || mode == kModeBoth;
  const int t_end = mode == kModeTail ? t_limit : T;
  float acc = 0.f;
  const float* const pan[1] = {y};
  sts::stream<1, false, kLagDepth / kSteps, kSteps, false, kLagThreads>(
      pan, B, t_end, b, [&](int t, int, const float (&v)[1]) {
        const float yt = v[0];
        float pred = c;
#pragma unroll
        for (int k = 0; k < AC; ++k)
          if (k < lg.ka)
            pred += phi[k] * yr[((t - lg.a[k]) & ma) * kLagThreads];
#pragma unroll
        for (int k = 0; k < MC; ++k)
          if (k < lg.km)
            pred += th[k] * er[((t - lg.m[k]) & me) * kLagThreads];
        const float et = live(t) ? yt - pred : 0.f;
        if (emit_e) e[at(t, B, b)] = et;
        acc += et * et;
        if (AC > 0) yr[(t & ma) * kLagThreads] = yt;
        if (MC > 0 || le) er[(t & me) * kLagThreads] = et;
      });
  if (mode == kModeSum || mode == kModeBoth) sse[b] = acc;
  if (mode == kModeTail)  // oldest first
    for (int j = 0; j < q; ++j)
      tail[at(j, B, b)] = er[((t_limit - q + j) & me) * kLagThreads];
}

// Panels streamed downward: y with AR lags, e with MA lags or for the
// per-series cotangent, g when it is a panel.  par as the forward's; gpar:
// [1 + p + q, B], zeroed by the caller, of which it writes row 0, the AR
// lags' rows and the MA lags' rows p + j.  la: the a ring's length.
template <int AC, int MC, bool kSse>
__global__ void __launch_bounds__(kLagThreads)
css_bwd_lag_k(const float* __restrict__ y, const float* __restrict__ e,
              const float* __restrict__ par, const float* __restrict__ zb,
              const float* __restrict__ g, float* __restrict__ gpar,
              float* __restrict__ gy, int B, int T, int p, int t_limit,
              int la, LagSet lg) {
  constexpr int kSteps = kStreamSteps<AC, MC>;
  constexpr bool kY = AC > 0, kE = MC > 0 || kSse;
  constexpr int kNP = kY + kE + !kSse, kIe = kY, kIg = kY + kE;
  const int b = blockIdx.x * kLagThreads + threadIdx.x;
  if (b >= B) return;
  STS_SHARED_FLOATS(smem);
  float* const ar = smem + kNP * kLagDepth * kLagThreads + threadIdx.x;
  const int mask = la - 1;
  for (int s = 0; s < la; ++s) ar[s * kLagThreads] = 0.f;
  float phi[AC > 0 ? AC : 1], th[MC > 0 ? MC : 1];
  float gphi[AC > 0 ? AC : 1], gth[MC > 0 ? MC : 1];
#pragma unroll
  for (int k = 0; k < AC; ++k) {
    phi[k] = k < lg.ka ? par[at(1 + k, B, b)] : 0.f;
    gphi[k] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < MC; ++k) {
    th[k] = k < lg.km ? par[at(1 + lg.ka + k, B, b)] : 0.f;
    gth[k] = 0.f;
  }
  const LiveWindow live = live_window(zb[b], t_limit);
  const float gs = kSse ? g[b] : 0.f;
  float gc = 0.f;
  const float* pan[kNP];
  if (kY) pan[0] = y;
  if (kE) pan[kIe] = e;
  if (!kSse) pan[kIg] = g;
  sts::stream<kNP, true, kLagDepth / kSteps, kSteps, false, kLagThreads>(
      pan, B, T, b, [&](int k, int, const float (&v)[kNP]) {
        const int t = T - 1 - k;
        const float et = kE ? v[kIe] : 0.f;
        const float gt = kSse ? 2.f * et * gs : v[kIg];
        // a_{t+j} at the MA lags, a_{t+i} at the AR lags
        float am[MC > 0 ? MC : 1], aa[AC > 0 ? AC : 1];
        float av = gt;
#pragma unroll
        for (int j = 0; j < MC; ++j)
          if (j < lg.km) {
            am[j] = ar[((t + lg.m[j]) & mask) * kLagThreads];
            av -= th[j] * am[j];
          }
        const float a = live(t) ? av : 0.f;
#pragma unroll
        for (int i = 0; i < AC; ++i)
          if (i < lg.ka) aa[i] = ar[((t + lg.a[i]) & mask) * kLagThreads];
        if (gy != nullptr) {
          float d = a;
#pragma unroll
          for (int i = 0; i < AC; ++i)
            if (i < lg.ka) d -= phi[i] * aa[i];
          gy[at(t, B, b)] = d;
        }
        gc -= a;
#pragma unroll
        for (int i = 0; i < AC; ++i)
          if (i < lg.ka) gphi[i] -= v[0] * aa[i];
#pragma unroll
        for (int j = 0; j < MC; ++j)
          if (j < lg.km) gth[j] -= et * am[j];
        if (AC > 0 || MC > 0) ar[(t & mask) * kLagThreads] = a;
      });
  gpar[b] = gc;
#pragma unroll
  for (int i = 0; i < AC; ++i)
    if (i < lg.ka) gpar[at(lg.a[i], B, b)] = gphi[i];
#pragma unroll
  for (int j = 0; j < MC; ++j)
    if (j < lg.km) gpar[at(p + lg.m[j], B, b)] = gth[j];
}

// Launch `kern` in blocks of kLagThreads with `smem` bytes of dynamic
// shared memory; a refusal comes back as its CUDA error.
template <class K, class... A>
int launch_lag(K kern, size_t smem, int B, cudaStream_t s, A... args) {
  const cudaError_t err = sts::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  STS_LAUNCH_BLOCK(dim3((B + kLagThreads - 1) / kLagThreads), kLagThreads,
                   smem, s, kern)(args...);
  return static_cast<int>(cudaGetLastError());
}

int fwd_lag(const float* y, const float* par, const float* zb, float* e,
            float* sse, float* tail, int B, int T, int q, int t_limit,
            int mode, const LagSet& lg, cudaStream_t s) {
  const bool is_tail = mode == kModeTail;
  const FwdRings r = fwd_rings(lg, q, is_tail);
  const size_t smem = fwd_smem(lg, q, is_tail);
  int rc = 0;
  with_lag_cap(lg.ka, [&](auto ac) {
    with_lag_cap(lg.km, [&](auto mc) {
      rc = launch_lag(
          css_fwd_lag_k<decltype(ac)::value, decltype(mc)::value>, smem, B,
          s, y, par, zb, e, sse, tail, B, T, q, t_limit, mode, r.la, r.le,
          lg);
    });
  });
  return rc;
}

int bwd_lag(const float* y, const float* e, const float* par,
            const float* zb, const float* g, float* gpar, float* gy, int B,
            int T, int p, int t_limit, bool g_is_sse, const LagSet& lg,
            cudaStream_t s) {
  const int la = bwd_ring(lg);
  int rc = 0;
  with_lag_cap(lg.ka, [&](auto ac) {
    with_lag_cap(lg.km, [&](auto mc) {
      constexpr int AC = decltype(ac)::value, MC = decltype(mc)::value;
      auto go = [&](auto sse) {
        constexpr bool kSse = decltype(sse)::value;
        constexpr int np = (AC > 0) + (MC > 0 || kSse) + !kSse;
        rc = launch_lag(css_bwd_lag_k<AC, MC, kSse>, bwd_smem(lg, np), B, s,
                        y, e, par, zb, g, gpar, gy, B, T, p, t_limit, la, lg);
      };
      if (g_is_sse) go(std::true_type{});
      else go(std::false_type{});
    });
  });
  return rc;
}

}  // namespace

// y, e: [T, B]; zb, sse: [B]; tail: [q, B]; g: [T, B] or [B] (g_is_sse).
// lags: null (every lag 1..p, 1..q) or ka AR lags then km MA lags, each
// ascending, on the host.  par: [1 + ka + km, B] (with null lags [1+p+q,
// B]) on the lag route, [1+p+q, B] on the others; gpar: [1+p+q, B], zeroed
// by the caller on the lag route.  Null for outputs a mode does not write.
// Returns the CUDA error of the launch (0 on success).
extern "C" int sts_css_fwd(const float* y, const float* par, const float* zb,
                           float* e, float* sse, float* tail, int B, int T,
                           int p, int q, const int* lags, int ka, int km,
                           int t_limit, int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = sts::grid_for(B);
  switch (route_of(p, q, lags, ka, km)) {
    case kRouteReg:
      sts::with_cap8(p, [&](auto pc) {
        sts::with_cap8(q, [&](auto qc) {
          STS_LAUNCH(grid, s,
                     css_fwd_reg<decltype(pc)::value, decltype(qc)::value>)(
              y, par, zb, e, sse, tail, B, T, p, q, t_limit, mode);
        });
      });
      return static_cast<int>(cudaGetLastError());
    case kRouteLag:
      return fwd_lag(y, par, zb, e, sse, tail, B, T, q, t_limit, mode,
                     lag_set(p, q, lags, ka, km), s);
    default:
      STS_LAUNCH(grid, s, css_fwd_local)(y, par, zb, e, sse, tail, B, T, p,
                                         q, t_limit, mode);
      return static_cast<int>(cudaGetLastError());
  }
}

extern "C" int sts_css_bwd(const float* y, const float* e, const float* par,
                           const float* zb, const float* g, float* gpar,
                           float* gy, int B, int T, int p, int q,
                           const int* lags, int ka, int km, int t_limit,
                           int g_is_sse, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = sts::grid_for(B);
  switch (route_of(p, q, lags, ka, km)) {
    case kRouteReg:
      sts::with_cap8(p, [&](auto pc) {
        sts::with_cap8(q, [&](auto qc) {
          STS_LAUNCH(grid, s,
                     css_bwd_reg<decltype(pc)::value, decltype(qc)::value>)(
              y, e, par, zb, g, gpar, gy, B, T, p, q, t_limit, g_is_sse);
        });
      });
      return static_cast<int>(cudaGetLastError());
    case kRouteLag:
      return bwd_lag(y, e, par, zb, g, gpar, gy, B, T, p, t_limit,
                     g_is_sse != 0, lag_set(p, q, lags, ka, km), s);
    default:
      STS_LAUNCH(grid, s, css_bwd_local)(y, e, par, zb, g, gpar, gy, B, T, p,
                                         q, t_limit, g_is_sse);
      return static_cast<int>(cudaGetLastError());
  }
}

// The route sts_css_fwd and sts_css_bwd take for (p, q, lags): 0 register,
// 1 lag, 2 local.
extern "C" int sts_css_route(int p, int q, const int* lags, int ka, int km) {
  return route_of(p, q, lags, ka, km);
}

// Blocks an SM holds, and dynamic shared memory a block, of the airline
// model's lag-route forward (MA lags 1, s, s + 1) and adjoint (per-series
// cotangent).  Returns the CUDA error (0 on success).
extern "C" int sts_css_lag_occupancy(int s, int* blocks, int* smem) {
  const int lags[3] = {1, s, s + 1};
  const LagSet lg = lag_set(0, s + 1, lags, 0, 3);
  const auto fwd = css_fwd_lag_k<0, 3>;
  const auto bwd = css_bwd_lag_k<0, 3, true>;
  const size_t sm[2] = {fwd_smem(lg, s + 1, false), bwd_smem(lg, 1)};
  cudaError_t err = sts::allow_smem(fwd, sm[0]);
  if (err == cudaSuccess) err = sts::allow_smem(bwd, sm[1]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[0], fwd,
                                                        kLagThreads, sm[0]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[1], bwd,
                                                        kLagThreads, sm[1]);
  smem[0] = static_cast<int>(sm[0]);
  smem[1] = static_cast<int>(sm[1]);
  return static_cast<int>(err);
}
