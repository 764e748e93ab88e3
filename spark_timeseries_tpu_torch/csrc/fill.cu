// Fill-linear chain: linear interpolation across interior NaN gaps, with the
// lag-1 difference and the lag-1 shift of the filled series.
//
// Replaces spark_timeseries_tpu/ops/pallas_kernels.py
// `_fillchain_fused_kernel` (launched by `_fill_linear_call_folded`).
//
// Per series, with pv / pi the last valid value and its index and nv / ni
// the next valid value and its index:
//   fill_t = y_t                                   (y_t valid)
//          = pv (1 - w) + nv w,  w = (t - pi) / max(ni - pi, 1)
//                                                  (an interior gap)
//          = NaN                                   (leading or trailing run)
//   diff_t = fill_t - fill_{t-1},  lag_t = fill_{t-1}  (fill_{-1} = NaN)
// in float32 with float indices, as the reference computes it.  The
// arithmetic uses the _rn intrinsics, which the compiler never contracts into
// fused multiply-adds, so the kernel gives the plain version's bits.
//
// What bounds it on an H100: bytes.  It reads the [T, B] panel once and
// writes each requested output once, with a few flops per element, so its
// floor is 4*T*B*(1 + outputs) bytes / 3.35 TB/s.  The TPU kernel needs two
// phases (a backward next-valid sweep into VMEM scratch, then the forward
// fill).  Here one thread per series walks forward once, holding the last
// valid (value, index) in registers.  A leading NaN run is written as it is
// read (it is NaN throughout); an interior run is only remembered by its
// first position, and when the next valid value closes it the run's outputs
// are written then (a trailing run at the end).  Each element is read once
// and each output written once.  The time-major layout makes a warp's loads
// and in-step stores at one step 32 neighbouring floats.  Lanes whose
// interior gaps differ in length diverge inside the write-back loop and
// store uncoalesced there; with ~2 % of positions in gaps that costs little.
// (Deferring the leading runs too made the kernel 2.1x slower on an H100,
// at 100k x 2,520 with half of the series listing late.)
#include "common.cuh"

namespace {

using sts::at;

struct Outs {
  float* f;
  float* d;
  float* l;
  int B;
  int b;

  // one position's outputs, given its filled value and the previous one
  __device__ __forceinline__ void emit(int t, float fill, float prev) const {
    const size_t i = at(t, B, b);
    if (f != nullptr) f[i] = fill;
    if (d != nullptr) d[i] = __fsub_rn(fill, prev);
    if (l != nullptr) l[i] = prev;
  }
};

__global__ void __launch_bounds__(sts::kThreads)
fill_chain_k(const float* __restrict__ y, float* __restrict__ f,
             float* __restrict__ d, float* __restrict__ l, int B, int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Outs out{f, d, l, B, b};
  const float nan = __int_as_float(0x7fc00000);
  float pv = 0.f;      // last valid value
  float pi = -1e30f;   // its index (none yet)
  float fprev = nan;   // fill_{t-1}
  int gap = -1;        // first position of the open NaN run, or -1
  for (int t = 0; t < T; ++t) {
    const float yt = y[at(t, B, b)];
    if (isnan(yt)) {
      if (pi < 0.f) {  // a leading run is NaN throughout: write it now
        out.emit(t, nan, fprev);
        fprev = nan;
      } else if (gap < 0) {
        gap = t;
      }
      continue;
    }
    if (gap >= 0) {  // y_t closes the run gap .. t-1
      const float span = fmaxf(__fsub_rn(static_cast<float>(t), pi), 1.f);
      for (int g = gap; g < t; ++g) {
        const float w = __fdiv_rn(__fsub_rn(static_cast<float>(g), pi), span);
        const float fill =
            __fadd_rn(__fmul_rn(pv, __fsub_rn(1.f, w)), __fmul_rn(yt, w));
        out.emit(g, fill, fprev);
        fprev = fill;
      }
      gap = -1;
    }
    out.emit(t, yt, fprev);
    fprev = yt;
    pv = yt;
    pi = static_cast<float>(t);
  }
  if (gap >= 0) {  // a trailing run has no next valid value: NaN
    for (int g = gap; g < T; ++g) {
      out.emit(g, nan, fprev);
      fprev = nan;
    }
  }
}

}  // namespace

// y, f, d, l: [T, B]; an output pointer is null when it is not requested.
// Returns cudaGetLastError() after the launch.
extern "C" int sts_fill_chain(const float* y, float* f, float* d, float* l,
                              int B, int T, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  STS_LAUNCH(sts::grid_for(B), s, fill_chain_k)(y, f, d, l, B, T);
  return static_cast<int>(cudaGetLastError());
}
