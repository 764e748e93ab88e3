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
// What bounds it on an H100.  The forward reads y once (4 B an element;
// ~14 flops additive, two divides multiplicative); `save` writes 4 panels.
// The adjoint reads y, L, T, S_old and e (or g) once each: L_t is carried
// down from the step above.  One thread per series over the time-major
// panel, every carry in a register, no atomics.
//
// The seasonal ring is the first hazard: an array indexed by a runtime
// t mod m lands in local memory.  So the kernels are instantiated per
// period (with_period below) and walk time in blocks whose inner loop is
// fully unrolled over a multiple of m steps, so each slot is a
// compile-time index and the ring lives in registers; the backward walk
// pads its range to a multiple of m and predicates off the steps past T,
// so it starts on slot m - 1.  Any other period (<= 1024) keeps its ring
// in a time-major [m, B] global scratch the wrapper allocates (the
// forward fills it from the seeds), where a warp's accesses coalesce.
//
// Loads in flight are the second.  The forward streams y through
// ring.cuh's per-thread shared-memory ring of cp.async copies: kStages
// stages of kS = stage_steps(m) steps (24 at the hourly period), a
// multiple of m, so a stage's steps keep their compile-time slots; while
// the thread walks one stage the next kStages - 1 are in flight (24 steps
// at the shipped 2 stages: ~72 KB an SM at 3 blocks, against the ~18 KB
// Little's law asks).  The build may set the stages (-DSTS_HW_STAGES):
// chip_smoke.py builds and times 2 and 3.  `save` is a template argument,
// so `sum` carries no stores and no addressing.
//
// Then instruction issue, in the multiplicative model: `__fdiv_rn` ends in
// a slow-path branch, one a divide, that cuts the unrolled stage into
// one-step pieces.  The forward runs ring.cuh's div_fast, branch-free, and
// walks a series again with __fdiv_rn (from device memory, outside the
// loop) when a step leaves that path's range; its operands are a y and
// g y (zero before zb, of either sign) over max(S, eps) and max(L', eps),
// the range div_fast states.  The live tests are integer compares against
// each series' first live step (first_step), exact for T <= 2^24; a longer
// series takes the exact walk, which keeps the float compares.
//
// Build (-Xptxas=-v, sm_90a): chip_smoke.py prints each instantiation's
// registers, spills, dynamic shared memory and blocks an SM.  The forward
// asks for 3 blocks an SM: at most 80 registers, so the multiplicative fit
// of [960, 100k] runs in one wave (391 blocks, 396 slots); a 64-register
// cap for 4 blocks spilled the additive ring.  The seeds and parameters
// are read in the caller's [B, m] and [B, 3] rows, once a thread, so a
// launch makes no transposing copy.
#include "ring.cuh"

#ifndef STS_HW_STAGES
#define STS_HW_STAGES 2
#endif

namespace {

using sts::at;
using sts::kThreads;

constexpr float kEps = 1e-12f;
constexpr int kStages = STS_HW_STAGES;  // commit groups in the y ring

// Steps a stage of the y ring holds at period m: the least multiple of m
// that is at least 24.
__host__ __device__ constexpr int stage_steps(int m) {
  return m * ((24 + m - 1) / m);
}

// The forward's dynamic shared memory a block at period m: the y ring (0
// on the global route, which streams nothing).
constexpr size_t fwd_smem(int m) {
  return m == 0 ? 0 : sts::ring_bytes(1, kStages * stage_steps(m));
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// The first step t in [0, T] with float(t) >= z (T when there is none, a
// NaN z included).  For T <= 2^24 every t converts to float exactly, so
// t >= first_step(z, T) is the test float(t) >= z.
__device__ __forceinline__ int first_step(float z, int T) {
  return z <= 0.f                        ? 0
         : z < static_cast<float>(T)     ? static_cast<int>(ceilf(z))
                                         : T;
}

struct Smoothing {
  float a, b, g, oa, ob, og;  // the parameters and their complements
};

// par: the caller's [B, 3] rows, read once a thread (no transposing copy
// a launch)
__device__ __forceinline__ Smoothing load_par(const float* par, int b) {
  const float* const q = par + 3 * static_cast<size_t>(b);
  Smoothing p;
  p.a = q[0];
  p.b = q[1];
  p.g = q[2];
  p.oa = sub(1.f, p.a);
  p.ob = sub(1.f, p.b);
  p.og = sub(1.f, p.g);
  return p;
}

// M > 0: the ring in registers and y streamed, M == m; M == 0: the ring in global scratch, y loaded a step at
// a time, every divide __fdiv_rn.  `walked`, when not null, gets 1 for a
// series the exact walk redid, else 0.
template <int M, bool kMult, bool kSave>
__global__ void __launch_bounds__(kThreads, 3)
hw_fwd_k(const float* __restrict__ y, const float* __restrict__ par,
         const float* __restrict__ l0p, const float* __restrict__ t0p,
         const float* __restrict__ s0, float* __restrict__ ring,
         const float* __restrict__ zbp,
         float* __restrict__ e, float* __restrict__ lv,
         float* __restrict__ tr, float* __restrict__ so,
         float* __restrict__ sse, int* __restrict__ walked, int B, int T,
         int m) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Smoothing p = load_par(par, b);
  const float z = zbp[b];
  const float zm = add(z, static_cast<float>(m));
  const float* const s0b = s0 + static_cast<size_t>(b) * m;  // [B, m] rows
  float level = l0p[b], trend = t0p[b], acc = 0.f;
  // step t: live = [t >= zb] moves the state, live_err = [t >= zb + m]
  // counts the error; `divide` is __fdiv_rn or div_fast
  auto step = [&](int t, bool live, bool live_err, float yt, float& s,
                  auto&& divide) {
    const float lt = add(level, trend);
    float pred, nl, snew;
    if constexpr (kMult) {
      pred = mul(lt, s);
      nl = add(divide(mul(p.a, yt), fmaxf(s, kEps)), mul(p.oa, lt));
      snew = add(divide(mul(p.g, yt), fmaxf(nl, kEps)), mul(p.og, s));
    } else {
      pred = add(lt, s);
      nl = add(mul(p.a, sub(yt, s)), mul(p.oa, lt));
      snew = add(mul(p.g, sub(yt, nl)), mul(p.og, s));
    }
    const float nt = add(mul(p.b, sub(nl, level)), mul(p.ob, trend));
    const float et = live_err ? sub(yt, pred) : 0.f;
    acc = add(acc, mul(et, et));
    const size_t i = at(t, B, b);
    if constexpr (kSave) so[i] = s;
    if (live) {
      level = nl;
      trend = nt;
      s = snew;
    }
    if constexpr (kSave) {
      e[i] = et;
      lv[i] = level;
      tr[i] = trend;
    }
  };
  auto exact = [](float x, float d) { return dvd(x, d); };
  if constexpr (M > 0) {
    constexpr int kS = stage_steps(M);
    float rr[M];
    auto seed = [&]() {
      level = l0p[b];
      trend = t0p[b];
      acc = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) rr[j] = s0b[j];
    };
    bool ok = T <= sts::kMaxCountedT;
    if (ok) {
      seed();
      const int tz = first_step(z, T), tzm = first_step(zm, T);
      const float* const pan[1] = {y};
      sts::stream<1, false, kStages, kS, true>(
          pan, B, T, b, [&](int t, int j, const float (&v)[1]) {
            const int base = t - j;  // the stage's first step, a multiple of M
            step(t, j >= tz - base, j >= tzm - base, v[0], rr[j % M],
                 [&](float x, float d) { return sts::div_fast(x, d, ok); });
          });
    }
    if (!ok) {  // a step left the fast divide's range, or T > 2^24
      seed();
      for (int base = 0; base < T; base += M) {
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const int t = base + j;
          if (t < T) {
            const float tf = static_cast<float>(t);
            step(t, tf >= z, tf >= zm, y[at(t, B, b)], rr[j], exact);
          }
        }
      }
    }
    if (walked != nullptr) walked[b] = ok ? 0 : 1;
  } else {
    for (int j = 0; j < m; ++j) ring[at(j, B, b)] = s0b[j];
    int slot = 0;
    for (int t = 0; t < T; ++t) {
      const float tf = static_cast<float>(t);
      float s = ring[at(slot, B, b)];
      step(t, tf >= z, tf >= zm, y[at(t, B, b)], s, exact);
      ring[at(slot, B, b)] = s;
      if (++slot == m) slot = 0;
    }
    if (walked != nullptr) walked[b] = 0;
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
  const Smoothing p = load_par(par, b);
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

// y, e, lv, tr, so, gpan: [T, B]; par: [B, 3] (alpha, beta, gamma); gpar:
// [3, B]; l0, t0, zb, sse, gbar, walked: [B]; s0: [B, m], the pre-rotated
// seeds; ring, rho: [m, B], the forward's and the adjoint's scratch on the
// global route (rho zeroed by the caller), null otherwise.  Null for outputs the call does
// not write (`walked`: int32, 1 where the forward redid a series with
// __fdiv_rn); `gbar` null means `gpan` is a cotangent of e, else gpan is e
// itself.  Return the CUDA error of the launch (0 on success): a ring whose
// shared memory the card refuses launches nothing.
extern "C" int sts_hw_fwd(const float* y, const float* par, const float* l0,
                          const float* t0, const float* s0, float* ring,
                          const float* zb,
                          float* e, float* lv, float* tr, float* so,
                          float* sse, int* walked, int B, int T, int m,
                          int mult, int save, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  with_period(m, mult, [&](auto mc, auto mu) {
    constexpr int M = decltype(mc)::value;
    constexpr bool kMult = decltype(mu)::value;
    auto go = [&](auto kern) {
      rc = sts::launch_ring(kern, fwd_smem(M), B, st, y, par, l0, t0, s0,
                            ring, zb, e, lv, tr, so, sse, walked, B, T, m);
    };
    if (save)
      go(hw_fwd_k<M, kMult, true>);
    else
      go(hw_fwd_k<M, kMult, false>);
  });
  return rc;
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

// The forward's y ring at period m, as built: stages and steps a stage;
// both 0 on the global route.
extern "C" int sts_hw_ring_layout(int m, int* stages, int* steps) {
  *stages = *steps = 0;
  with_period(m, 0, [&](auto mc, auto) {
    constexpr int M = decltype(mc)::value;
    if (M > 0) {
      *stages = kStages;
      *steps = stage_steps(M);
    }
  });
  return 0;
}

// Blocks an SM can hold and dynamic shared memory a block of the forward
// at period m, model `mult`, mode `save`.  Returns the CUDA error.
extern "C" int sts_hw_occupancy(int m, int mult, int save, int* blocks,
                                int* smem) {
  int rc = 0;
  with_period(m, mult, [&](auto mc, auto mu) {
    constexpr int M = decltype(mc)::value;
    constexpr bool kMult = decltype(mu)::value;
    *smem = static_cast<int>(fwd_smem(M));
    rc = static_cast<int>(
        save ? sts::blocks_per_sm(hw_fwd_k<M, kMult, true>, *smem, blocks)
             : sts::blocks_per_sm(hw_fwd_k<M, kMult, false>, *smem, blocks));
  });
  return rc;
}

// The forward's fast divide against __fdiv_rn, for numerators of either
// sign: tried, differ are device counters (zeroed by the caller) for n
// pairs.
extern "C" int sts_hw_check_divide(unsigned long long n,
                                   unsigned long long seed,
                                   unsigned long long* tried,
                                   unsigned long long* differ, void* stream) {
  STS_LAUNCH(dim3(132 * 8), static_cast<cudaStream_t>(stream),
             sts::check_divide_k<true>)(n, seed, tried, differ);
  return static_cast<int>(cudaGetLastError());
}
