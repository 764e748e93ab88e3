// Batched L-BFGS arithmetic: the two-loop direction, one line-search trial
// and the history update, one thread a row.
//
// Replaces no Pallas kernel.  The reference's optimizer
// (spark_timeseries_tpu/utils/optim.py, `minimize_lbfgs_batched`) is jitted
// XLA, which fuses each iteration's small per-row operations into a few
// programs.  The port runs eagerly, so the same arithmetic was ~200 small
// PyTorch operations an iteration over [B, d] and [B, m, d] tensors, each
// costing more host time to issue than device time to run; a compacted
// straggler stage of a few thousand rows was paced by the host alone.
// These three kernels carry that arithmetic; utils/optim.py keeps the loop,
// the objective, the compaction and the counted host reads.
//
// Layout: the optimizer's own, row-major: x, g, direction [B, d]; the
// history ring s, y [B, m, d] and rho [B, m] (slot k % m holds iteration
// k's pair; a slot is valid where rho > 0); scalars a row [B]; the bool
// flags one byte a row.  `flags` is the call's own int32[2]: [0] the last
// trial in which some row still backtracked, [1] the rows still live after
// the update.  The direction kernel zeroes both (stream order puts it
// before this iteration's trials and update), so no launch clears them.
//
// Arithmetic: every operation of the plain versions (ops/lbfgs_kernels.py,
// the optimizer's step off this route), each rounded once (_rn
// intrinsics: nvcc never contracts them into a fused multiply-add), with
// the same guards (non-finite values, the `where`s, the 1e-30 clamp) and
// each clamp's NaN kept as torch.clamp keeps it.  Dot products and norms
// sum their d rounded products in two lanes by index parity, each lane in
// index order, then the even lane plus the odd one: the order of
// PyTorch's CUDA row sums and norms for d <= 4 (measured: the same bits as
// `(a * b).sum(-1)` and `linalg.vector_norm` on the H100), so both routes
// step alike on the card.  The plain versions sum in this order when
// asked (`lanes=True`), which is how the kernels are checked.
//
// What bounds it on an H100: bytes.  At [1M, 3] with m = 8 the direction
// kernel reads the ring (2 x 96 B + 32 B a row), g, x, f, tprev and the
// flags and writes the direction, the trial point, three scalars and a
// flag: 295 B a row, 295 MB, 88 us at 3.35 TB/s.  A trial touches only the
// rows still backtracking (61 B a row); the update reads the old and new
// iterates, writes the new state and one ring slot in place (193 B a row).
// At a compacted straggler stage's 13,312 rows each launch is latency, not
// bytes: the point is one launch where the eager step issued dozens.
//
// d and m are compile-time capacities (d in {4, 16}, m in {8, 16}) with a
// uniform `j < d` guard, so every per-row vector stays in registers; two of
// each keep the build short, as it counts in a first run's set-up (every
// fit of the port has d <= 4 but AR-GARCH and wider ARIMA orders).
#include "common.cuh"

namespace {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(v, min=lo) and torch.clamp(v, max=hi): NaN stays NaN
__device__ __forceinline__ float at_least(float v, float lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ float at_most(float v, float hi) {
  return v > hi ? hi : v;
}

// Python's (k - 1 - j) % m: the ring slot of the j-th newest pair
__device__ __forceinline__ int ring_slot(int k, int j, int m) {
  const int i = (k - 1 - j) % m;
  return i < 0 ? i + m : i;
}

template <int D>
__device__ __forceinline__ void load(float (&v)[D], const float* p, int d) {
#pragma unroll
  for (int j = 0; j < D; ++j) v[j] = j < d ? p[j] : 0.f;
}

template <int D>
__device__ __forceinline__ void store(float* p, const float (&v)[D], int d) {
#pragma unroll
  for (int j = 0; j < D; ++j)
    if (j < d) p[j] = v[j];
}

// sum_j a_j b_j, each product and sum rounded: the even-index terms and
// the odd-index terms each summed in index order, then added
template <int D, class A>
__device__ __forceinline__ float dot_of(const A& a, const float (&b)[D],
                                        int d) {
  float even = 0.f, odd = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < d) {
      if (j & 1)
        odd = add(odd, mul(a[j], b[j]));
      else
        even = add(even, mul(a[j], b[j]));
    }
  }
  return add(even, odd);
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float (&b)[D],
                                     int d) {
  return dot_of<D>(a, b, d);
}

template <int D>
__device__ __forceinline__ float dot_mem(const float* a, const float (&b)[D],
                                         int d) {
  return dot_of<D>(a, b, d);
}

template <int D>
__device__ __forceinline__ float norm(const float (&a)[D], int d) {
  return __fsqrt_rn(dot(a, a, d));
}

template <int D>
__device__ __forceinline__ bool all_finite(const float (&a)[D], int d) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < D; ++j)
    if (j < d) ok = ok && isfinite(a[j]);
  return ok;
}

// x + t * direction, each rounded (the trial point)
template <int D>
__device__ __forceinline__ void trial_point(float* out, const float* x,
                                            const float (&dir)[D], float t,
                                            int d) {
#pragma unroll
  for (int j = 0; j < D; ++j)
    if (j < d) out[j] = add(x[j], mul(t, dir[j]));
}

// Two-loop recursion, steepest-descent fallback, first step and trial
// point (utils/optim.py `_step`'s direction and `_linesearch`'s set-up).
template <int D, int M>
__global__ void __launch_bounds__(sts::kThreads)
lbfgs_direction_k(const float* __restrict__ x, const float* __restrict__ f,
                  const float* __restrict__ g, const float* __restrict__ sh,
                  const float* __restrict__ yh, const float* __restrict__ rho,
                  const float* __restrict__ tprev,
                  const unsigned char* __restrict__ conv,
                  const unsigned char* __restrict__ failed,
                  float* __restrict__ dir, float* __restrict__ t,
                  unsigned char* __restrict__ ok, float* __restrict__ gd,
                  float* __restrict__ eps, float* __restrict__ xt,
                  int* __restrict__ flags, int B, int d, int m, int k,
                  float ftol) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b == 0) {
    flags[0] = 0;
    flags[1] = 0;
  }
  if (b >= B) return;
  const size_t row = static_cast<size_t>(b);
  const float* s = sh + row * m * d;
  const float* y = yh + row * m * d;
  const float* r = rho + row * m;
  float gv[D], q[D];
  load(gv, g + row * d, d);
#pragma unroll
  for (int j = 0; j < D; ++j) q[j] = gv[j];
  // newest to oldest: q -= alpha_i y_i over the valid slots
  float alpha[M];
#pragma unroll
  for (int jj = 0; jj < M; ++jj) {
    alpha[jj] = 0.f;
    if (jj < m) {
      const int i = ring_slot(k, jj, m);
      const float ri = r[i];
      if (ri > 0.f) {
        const float a = mul(ri, dot_mem(s + i * d, q, d));
        alpha[jj] = a;
#pragma unroll
        for (int j = 0; j < D; ++j)
          if (j < d) q[j] = sub(q[j], mul(a, y[i * d + j]));
      }
    }
  }
  const int nw = ring_slot(k, 0, m);
  float sn[D], yn[D];
  load(sn, s + nw * d, d);
  load(yn, y + nw * d, d);
  const float sy = dot(sn, yn, d);
  const float yy = dot(yn, yn, d);
  const float gamma = r[nw] > 0.f && yy > 0.f ? dvd(sy, yy) : 1.f;
  float hv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) hv[j] = mul(gamma, q[j]);
  // oldest to newest: h += (alpha_i - beta_i) s_i over the valid slots
#pragma unroll
  for (int jj = M - 1; jj >= 0; --jj) {
    if (jj < m) {
      const int i = ring_slot(k, jj, m);
      const float ri = r[i];
      if (ri > 0.f) {
        const float c = sub(alpha[jj], mul(ri, dot_mem(y + i * d, hv, d)));
#pragma unroll
        for (int j = 0; j < D; ++j)
          if (j < d) hv[j] = add(hv[j], mul(c, s[i * d + j]));
      }
    }
  }
  float dv[D];
#pragma unroll
  for (int j = 0; j < D; ++j) dv[j] = -hv[j];
  float gdv = dot(gv, dv, d);
  const bool descent = gdv < 0.f;
  if (!descent) {
#pragma unroll
    for (int j = 0; j < D; ++j) dv[j] = -gv[j];
    gdv = dot(gv, dv, d);
  }
  bool has_hist = false;
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (i < m) has_hist = has_hist || r[i] > 0.f;
  // rows without curvature history step along raw steepest descent,
  // bounded by 1; with history, warm start from the last accepted step
  const float t0 = has_hist && descent
                       ? at_most(mul(4.f, tprev[b]), 1.f)
                       : dvd(1.f, at_least(norm(dv, d), 1.f));
  store(dir + row * d, dv, d);
  trial_point(xt + row * d, x + row * d, dv, t0, d);
  t[b] = t0;
  ok[b] = conv[b] || failed[b];
  gd[b] = gdv;
  eps[b] = mul(ftol, at_least(fabsf(f[b]), 1.f));
}

// One backtracking trial on the objective's values `fnew` at the trial
// points: the Armijo test with its noise floor, the quadratic step clamped
// to [0.1 t, 0.5 t], and the next trial point.  Rows already satisfied are
// left as they are (their t and trial point do not change).
template <int D>
__global__ void __launch_bounds__(sts::kThreads)
lbfgs_trial_k(const float* __restrict__ x, const float* __restrict__ dir,
              const float* __restrict__ f, const float* __restrict__ gd,
              const float* __restrict__ eps, const float* __restrict__ fnew,
              float* __restrict__ t, unsigned char* __restrict__ ok,
              float* __restrict__ xt, int* __restrict__ flags, int B, int d,
              int trial, float c1) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || ok[b]) return;
  float fn = fnew[b];
  if (!isfinite(fn)) fn = INFINITY;
  const float tb = t[b], fb = f[b], g = gd[b];
  if (fn <= add(add(fb, mul(mul(c1, tb), g)), eps[b])) {
    ok[b] = 1;
    return;
  }
  float tq = dvd(mul(mul(-g, tb), tb),
                 mul(2.f, sub(sub(fn, fb), mul(g, tb))));
  if (!isfinite(tq)) tq = 0.f;
  // torch.minimum(torch.maximum(tq, 0.1 t), 0.5 t); tq is finite, so a NaN
  // can only come from t, and then both bounds carry it
  const float lo = mul(0.1f, tb), hi = mul(0.5f, tb);
  tq = tq > lo ? tq : lo;
  tq = tq < hi ? tq : hi;
  t[b] = tq;
  flags[0] = trial;  // every writer writes the same value
  const size_t row = static_cast<size_t>(b);
  float dv[D];
  load(dv, dir + row * d, d);
  trial_point(xt + row * d, x + row * d, dv, tq, d);
}

// The history update after the value-and-gradient evaluation at the
// accepted trial point: the non-finite guard, the curvature pair into ring
// slot k % m (in place), the accepted iterate, the convergence tests, the
// best-seen iterate, and the count of rows still live.
template <int D>
__global__ void __launch_bounds__(sts::kThreads)
lbfgs_update_k(const float* __restrict__ x, const float* __restrict__ f,
               const float* __restrict__ g, const float* __restrict__ xn,
               const float* __restrict__ fn_raw,
               const float* __restrict__ gn_raw, const float* __restrict__ t,
               const unsigned char* __restrict__ ok,
               const unsigned char* __restrict__ conv,
               const unsigned char* __restrict__ failed,
               const float* __restrict__ tprev, const float* __restrict__ bx,
               const float* __restrict__ bf, const float* __restrict__ bg,
               const int* __restrict__ iters, float* __restrict__ sh,
               float* __restrict__ yh, float* __restrict__ rho,
               float* __restrict__ x_out, float* __restrict__ f_out,
               float* __restrict__ g_out, unsigned char* __restrict__ conv_out,
               unsigned char* __restrict__ failed_out,
               float* __restrict__ tprev_out, float* __restrict__ bx_out,
               float* __restrict__ bf_out, float* __restrict__ bg_out,
               int* __restrict__ iters_out, int* __restrict__ flags, int B,
               int d, int m, int k, float tol, float ftol) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  if (b < B) {
    const size_t row = static_cast<size_t>(b);
    float xv[D], gv[D], xnv[D], gnv[D];
    load(xv, x + row * d, d);
    load(gv, g + row * d, d);
    load(xnv, xn + row * d, d);
    load(gnv, gn_raw + row * d, d);
    float fnv = fn_raw[b];
    if (!isfinite(fnv) || !all_finite(gnv, d)) {
      fnv = INFINITY;
#pragma unroll
      for (int j = 0; j < D; ++j) gnv[j] = 0.f;
    }
    float sv[D], yv[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      sv[j] = sub(xnv[j], xv[j]);
      yv[j] = sub(gnv[j], gv[j]);
    }
    const float sy = dot(sv, yv, d);
    const float fo = f[b];
    const bool done = conv[b] || failed[b];
    const bool okb = ok[b];
    const bool accept =
        okb && fnv <= add(fo, mul(ftol, at_least(fabsf(fo), 1.f))) && !done;
    // history is gated on accept: a step rejected at the re-evaluation must
    // not poison the curvature history
    if (sy > 1e-10f && accept) {
      const int slot = k % m;
      store(sh + (row * m + slot) * d, sv, d);
      store(yh + (row * m + slot) * d, yv, d);
      rho[row * m + slot] = dvd(1.f, at_least(sy, 1e-30f));
    }
    float xov[D], gov[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      xov[j] = accept ? xnv[j] : xv[j];
      gov[j] = accept ? gnv[j] : gv[j];
    }
    const float fov = accept ? fnv : fo;
    bool c = conv[b] ||
             norm(gov, d) < mul(tol, at_least(norm(xov, d), 1.f));
    c = c || (accept &&
              sub(fo, fnv) <= mul(ftol, at_least(fabsf(fnv), 1.f)));
    const bool fl = failed[b] || (!okb && !c && !done);
    const bool better = fov < bf[b];
    store(x_out + row * d, xov, d);
    store(g_out + row * d, gov, d);
    f_out[b] = fov;
    conv_out[b] = c;
    failed_out[b] = fl;
    tprev_out[b] = accept ? t[b] : tprev[b];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j < d) {
        bx_out[row * d + j] = better ? xov[j] : bx[row * d + j];
        bg_out[row * d + j] = better ? gov[j] : bg[row * d + j];
      }
    }
    bf_out[b] = better ? fov : bf[b];
    iters_out[b] = done ? iters[b] : k + 1;
    live = !(c || fl);
  }
  // the live rows into flags[1]: one atomic a warp (integer sums are exact
  // in any order); every lane of the warp reaches the ballot
#ifdef __CUDA_ARCH__
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if ((threadIdx.x & 31) == 0 && mask != 0)
    atomicAdd(flags + 1, __popc(mask));
#else
  if (live) atomicAdd(flags + 1, 1);
#endif
}

// The capacities a (d, m) runs at: d in {4, 16}, m in {8, 16}
template <class F>
int with_caps(int d, int m, F&& f) {
  auto by_m = [&](auto dc) {
    if (m <= 8) return f(dc, std::integral_constant<int, 8>{});
    return f(dc, std::integral_constant<int, 16>{});
  };
  if (d <= 4) return by_m(std::integral_constant<int, 4>{});
  return by_m(std::integral_constant<int, 16>{});
}

bool shape_ok(int B, int d, int m) {
  return B > 0 && d >= 1 && d <= 16 && m >= 1 && m <= 16;
}

}  // namespace

// Every pointer a device pointer of the layout above, bool flags one byte.
// Return cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape outside the capacities, which the wrappers never pass).
extern "C" int sts_lbfgs_direction(
    const float* x, const float* f, const float* g, const float* sh,
    const float* yh, const float* rho, const float* tprev,
    const unsigned char* conv, const unsigned char* failed, float* dir,
    float* t, unsigned char* ok, float* gd, float* eps, float* xt,
    int* flags, int B, int d, int m, int k, float ftol, void* stream) {
  if (!shape_ok(B, d, m)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_caps(d, m, [&](auto dc, auto mc) {
    STS_LAUNCH(sts::grid_for(B), st,
               lbfgs_direction_k<decltype(dc)::value, decltype(mc)::value>)(
        x, f, g, sh, yh, rho, tprev, conv, failed, dir, t, ok, gd, eps, xt,
        flags, B, d, m, k, ftol);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int sts_lbfgs_trial(const float* x, const float* dir,
                               const float* f, const float* gd,
                               const float* eps, const float* fnew, float* t,
                               unsigned char* ok, float* xt, int* flags,
                               int B, int d, int trial, float c1,
                               void* stream) {
  if (!shape_ok(B, d, 8)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_caps(d, 8, [&](auto dc, auto) {
    STS_LAUNCH(sts::grid_for(B), st, lbfgs_trial_k<decltype(dc)::value>)(
        x, dir, f, gd, eps, fnew, t, ok, xt, flags, B, d, trial, c1);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int sts_lbfgs_update(
    const float* x, const float* f, const float* g, const float* xn,
    const float* fn, const float* gn, const float* t, const unsigned char* ok,
    const unsigned char* conv, const unsigned char* failed,
    const float* tprev, const float* bx, const float* bf, const float* bg,
    const int* iters, float* sh, float* yh, float* rho, float* x_out,
    float* f_out, float* g_out, unsigned char* conv_out,
    unsigned char* failed_out, float* tprev_out, float* bx_out,
    float* bf_out, float* bg_out, int* iters_out, int* flags, int B, int d,
    int m, int k, float tol, float ftol, void* stream) {
  if (!shape_ok(B, d, m)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_caps(d, 8, [&](auto dc, auto) {
    STS_LAUNCH(sts::grid_for(B), st, lbfgs_update_k<decltype(dc)::value>)(
        x, f, g, xn, fn, gn, t, ok, conv, failed, tprev, bx, bf, bg, iters,
        sh, yh, rho, x_out, f_out, g_out, conv_out, failed_out, tprev_out,
        bx_out, bf_out, bg_out, iters_out, flags, B, d, m, k, tol, ftol);
    return static_cast<int>(cudaGetLastError());
  });
}
