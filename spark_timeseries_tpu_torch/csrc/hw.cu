// Holt-Winters smoothing (additive and multiplicative seasonality): forward
// and adjoint kernels.
//
// Replaces spark_timeseries_tpu/ops/pallas_kernels.py `_hw_fwd_kernel`
// (launched by `_hw_fwd_call`) and `_hw_bwd_kernel` (launched by
// `_hw_e_bwd`, and through it by `_hw_ss_bwd`).
//
// Forward, per series, from the seeds (L, T) = (l0, t0) and the seasonal
// ring, pre-rotated so that slot t mod m holds the seasonal value step t
// reads; live_t = [t >= zb], live_err_t = [t >= zb + m]:
//   additive:        pred = L + T + S,  L' = a (y - S) + (1-a)(L + T),
//                    S'   = g (y - L') + (1-g) S
//   multiplicative:  pred = (L + T) S,  L' = a y / max(S, eps) + (1-a)(L + T),
//                    S'   = g y / max(L', eps) + (1-g) S
//   T' = b (L' - L) + (1-b) T;  the state (L, T, ring slot) moves only on
//   live steps;  e_t = live_err_t ? y_t - pred_t : 0;  sse = sum e_t^2.
// `save` also writes e, L_t, T_t and S_old_t (the slot's value before the
// step), the trajectories the adjoint replays.  Every operation is an _rn
// intrinsic, never contracted, so the sse is the same bits with and without
// `save` (the optimizer compares f across the two), and the plain PyTorch
// version, rounding each operation the same way, matches bit for bit.
//
// Adjoint, walking t downward with (lamL, lamT) and a ring rho of seasonal
// adjoints; gp_t = live_err_t ? -g_t : 0, where g_t is a [T, B] cotangent
// of e or, for the sse, 2 e_t gbar formed here from the saved e and the
// per-series gbar (so the fit never writes a [T, B] cotangent).  Additive:
//   vL = lamL + b lamT - g uS   (uS = rho[slot])
//   da += (y - S - L_{t-1} - T_{t-1}) vL,  db += (L_t - L_{t-1} - T_{t-1}) lamT
//   dg += (y - L_t - S) uS
//   lamL' = -b lamT + (1-a) vL + gp,  lamT' = (1-b) lamT + (1-a) vL + gp
//   rho[slot] = (1-g) uS - a vL + gp
// Multiplicative uses the product and quotient rules (S gp into lamL and
// lamT, (L + T) gp into rho, -a y/S^2 and -g y/L^2 terms), with no flow
// through a clamped denominator; all on live steps only.
//
// What bounds it on an H100: bytes.  The forward reads y once (4 B an
// element, ~14 flops additive, two divides multiplicative); `save` writes 4
// panels.  The adjoint reads y, L, T, S_old and e (or g) once each: L_t is
// carried down from the step above.  One thread per series over the
// time-major panel, every carry in a register, no atomics.  The seasonal
// ring is the hazard: an array indexed by a runtime t mod m lands in local
// memory.  So the kernels are instantiated per period (with_period below): the
// time loop runs in blocks of m steps, the block's inner loop fully
// unrolled, so each slot is a compile-time index and the ring lives in
// registers; the loop range is padded to a multiple of m and the steps past
// T are predicated off, so the backward walk also starts on slot m - 1.  A
// ring of 24 costs registers (about 100 a thread: 16 warps an SM), so the
// forward loads a block's m values of y before it walks them, keeping m
// loads in flight per thread instead of one.  Any
// other period (<= 1024) keeps its ring in a time-major [m, B] global
// scratch the wrapper allocates, where a warp's accesses coalesce.
#include "common.cuh"

namespace {

using sts::at;

constexpr float kEps = 1e-12f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

struct Smoothing {
  float a, b, g, oa, ob, og;  // the parameters and their complements
};

__device__ __forceinline__ Smoothing load_par(const float* par, int B, int b) {
  Smoothing p;
  p.a = par[b];
  p.b = par[at(1, B, b)];
  p.g = par[at(2, B, b)];
  p.oa = sub(1.f, p.a);
  p.ob = sub(1.f, p.b);
  p.og = sub(1.f, p.g);
  return p;
}

// M > 0: the ring in registers (M == m); M == 0: in global scratch.
template <int M, bool kMult>
__global__ void __launch_bounds__(sts::kThreads)
hw_fwd_k(const float* __restrict__ y, const float* __restrict__ par,
         const float* __restrict__ l0p, const float* __restrict__ t0p,
         float* __restrict__ ring, const float* __restrict__ zbp,
         float* __restrict__ e, float* __restrict__ lv,
         float* __restrict__ tr, float* __restrict__ so,
         float* __restrict__ sse, int B, int T, int m, int save) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Smoothing p = load_par(par, B, b);
  const float z = zbp[b];
  const float zm = add(z, static_cast<float>(m));
  float level = l0p[b], trend = t0p[b], acc = 0.f;
  auto step = [&](int t, float yt, float& s) {
    const size_t i = at(t, B, b);
    const float tf = static_cast<float>(t);
    const float lt = add(level, trend);
    float pred, nl, snew;
    if (kMult) {
      pred = mul(lt, s);
      nl = add(dvd(mul(p.a, yt), fmaxf(s, kEps)), mul(p.oa, lt));
      snew = add(dvd(mul(p.g, yt), fmaxf(nl, kEps)), mul(p.og, s));
    } else {
      pred = add(lt, s);
      nl = add(mul(p.a, sub(yt, s)), mul(p.oa, lt));
      snew = add(mul(p.g, sub(yt, nl)), mul(p.og, s));
    }
    const float nt = add(mul(p.b, sub(nl, level)), mul(p.ob, trend));
    const float et = tf >= zm ? sub(yt, pred) : 0.f;
    acc = add(acc, mul(et, et));
    if (save) so[i] = s;
    if (tf >= z) {
      level = nl;
      trend = nt;
      s = snew;
    }
    if (save) {
      e[i] = et;
      lv[i] = level;
      tr[i] = trend;
    }
  };
  if constexpr (M > 0) {
    float r[M];
#pragma unroll
    for (int j = 0; j < M; ++j) r[j] = ring[at(j, B, b)];
    for (int base = 0; base < T; base += M) {
      // the block's loads first: M loads in flight per thread, where one
      // at a time leaves the card idle at this kernel's occupancy
      float yb[M];
#pragma unroll
      for (int j = 0; j < M; ++j)
        yb[j] = base + j < T ? y[at(base + j, B, b)] : 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j)
        if (base + j < T) step(base + j, yb[j], r[j]);
    }
  } else {
    int slot = 0;
    for (int t = 0; t < T; ++t) {
      float s = ring[at(slot, B, b)];
      step(t, y[at(t, B, b)], s);
      ring[at(slot, B, b)] = s;
      if (++slot == m) slot = 0;
    }
  }
  sse[b] = acc;
}

template <int M, bool kMult>
__global__ void __launch_bounds__(sts::kThreads)
hw_bwd_k(const float* __restrict__ y, const float* __restrict__ par,
         const float* __restrict__ l0p, const float* __restrict__ t0p,
         const float* __restrict__ zbp, const float* __restrict__ lv,
         const float* __restrict__ tr, const float* __restrict__ so,
         const float* __restrict__ gpan, const float* __restrict__ gbar,
         float* __restrict__ rho, float* __restrict__ gpar, int B, int T,
         int m) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Smoothing p = load_par(par, B, b);
  const float z = zbp[b];
  const float zm = add(z, static_cast<float>(m));
  const float l0 = l0p[b], t0 = t0p[b];
  const float gb = gbar != nullptr ? gbar[b] : 0.f;
  float lamL = 0.f, lamT = 0.f, da = 0.f, db = 0.f, dg = 0.f;
  float lt = T > 0 ? lv[at(T - 1, B, b)] : 0.f;  // L_t, carried down
  auto step = [&](int t, float& uS) {
    const size_t i = at(t, B, b);
    const float tf = static_cast<float>(t);
    const float gv = gpan[i];
    const float gt = gbar != nullptr ? mul(mul(2.f, gv), gb) : gv;
    const float gp = tf >= zm ? -gt : 0.f;
    const float lp = t >= 1 ? lv[i - B] : l0;
    const float tp = t >= 1 ? tr[i - B] : t0;
    const float s = so[i];
    const float yt = y[i];
    const float uL = lamL, uT = lamT;
    const float lpt = add(lp, tp);
    float vL, da_t, dg_t, nlL, nlT, rn;
    if (kMult) {
      const float sc = fmaxf(s, kEps);
      const float ltc = fmaxf(lt, kEps);
      const float s_pass = s >= kEps ? 1.f : 0.f;
      const float l_pass = lt >= kEps ? 1.f : 0.f;
      vL = sub(add(uL, mul(p.b, uT)),
               mul(mul(mul(p.g, dvd(yt, mul(ltc, ltc))), uS), l_pass));
      da_t = mul(sub(sub(dvd(yt, sc), lp), tp), vL);
      dg_t = mul(sub(dvd(yt, ltc), s), uS);
      const float sgp = mul(s, gp);
      nlL = add(add(mul(-p.b, uT), mul(p.oa, vL)), sgp);
      nlT = add(add(mul(p.ob, uT), mul(p.oa, vL)), sgp);
      rn = add(sub(mul(p.og, uS),
                   mul(mul(mul(p.a, dvd(yt, mul(sc, sc))), vL), s_pass)),
               mul(lpt, gp));
    } else {
      vL = sub(add(uL, mul(p.b, uT)), mul(p.g, uS));
      da_t = mul(sub(sub(sub(yt, s), lp), tp), vL);
      dg_t = mul(sub(sub(yt, lt), s), uS);
      nlL = add(add(mul(-p.b, uT), mul(p.oa, vL)), gp);
      nlT = add(add(mul(p.ob, uT), mul(p.oa, vL)), gp);
      rn = add(sub(mul(p.og, uS), mul(p.a, vL)), gp);
    }
    const float db_t = mul(sub(sub(lt, lp), tp), uT);
    if (tf >= z) {
      da = add(da, da_t);
      db = add(db, db_t);
      dg = add(dg, dg_t);
      lamL = nlL;
      lamT = nlT;
      uS = rn;
    }
    lt = lp;
  };
  if constexpr (M > 0) {
    float r[M];
#pragma unroll
    for (int j = 0; j < M; ++j) r[j] = 0.f;
    for (int base = (T + M - 1) / M * M - M; base >= 0; base -= M) {
#pragma unroll
      for (int j = M - 1; j >= 0; --j)
        if (base + j < T) step(base + j, r[j]);
    }
  } else {
    int slot = T > 0 ? (T - 1) % m : 0;
    for (int t = T - 1; t >= 0; --t) {
      float u = rho[at(slot, B, b)];
      step(t, u);
      rho[at(slot, B, b)] = u;
      slot = slot == 0 ? m - 1 : slot - 1;
    }
  }
  gpar[b] = da;
  gpar[at(1, B, b)] = db;
  gpar[at(2, B, b)] = dg;
}

template <int N>
using Int = std::integral_constant<int, N>;

// f(period constant, multiplicative flag): the register instantiation for
// the periods listed here, the global-ring one (period constant 0) for any
// other.  The one list of register periods; sts_hw_ring_in_registers
// reports it to the wrapper, which allocates the adjoint's scratch by it.
template <class F>
void with_period(int m, int mult, F&& f) {
  auto pick = [&](auto mc) {
    if (mult)
      f(mc, std::true_type{});
    else
      f(mc, std::false_type{});
  };
  switch (m) {
    case 4: pick(Int<4>{}); return;
    case 6: pick(Int<6>{}); return;
    case 7: pick(Int<7>{}); return;
    case 8: pick(Int<8>{}); return;
    case 12: pick(Int<12>{}); return;
    case 24: pick(Int<24>{}); return;
    default: pick(Int<0>{}); return;
  }
}

}  // namespace

// 1 when period m keeps its rings in registers, 0 when in global scratch.
extern "C" int sts_hw_ring_in_registers(int m) {
  int reg = 0;
  with_period(m, 0, [&](auto mc, auto) { reg = decltype(mc)::value > 0; });
  return reg;
}

// y, e, lv, tr, so, gpan: [T, B]; par, gpar: [3, B] (alpha, beta, gamma);
// l0, t0, zb, sse, gbar: [B]; ring, rho: [m, B].  `ring` holds the
// pre-rotated seeds; on the global route it is also the forward's scratch
// and is overwritten.  `rho` is the adjoint's scratch on the global route
// (zeroed by the caller), null otherwise.  Null for outputs the call does
// not write; `gbar` null means `gpan` is a cotangent of e, else gpan is e
// itself.  Return cudaGetLastError() after the launch.
extern "C" int sts_hw_fwd(const float* y, const float* par, const float* l0,
                          const float* t0, float* ring, const float* zb,
                          float* e, float* lv, float* tr, float* so,
                          float* sse, int B, int T, int m, int mult, int save,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_period(m, mult, [&](auto mc, auto mu) {
    STS_LAUNCH(sts::grid_for(B), st,
               hw_fwd_k<decltype(mc)::value, decltype(mu)::value>)(
        y, par, l0, t0, ring, zb, e, lv, tr, so, sse, B, T, m, save);
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sts_hw_bwd(const float* y, const float* par, const float* l0,
                          const float* t0, const float* zb, const float* lv,
                          const float* tr, const float* so, const float* gpan,
                          const float* gbar, float* rho, float* gpar, int B,
                          int T, int m, int mult, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_period(m, mult, [&](auto mc, auto mu) {
    STS_LAUNCH(sts::grid_for(B), st,
               hw_bwd_k<decltype(mc)::value, decltype(mu)::value>)(
        y, par, l0, t0, zb, lv, tr, so, gpan, gbar, rho, gpar, B, T, m);
  });
  return static_cast<int>(cudaGetLastError());
}
