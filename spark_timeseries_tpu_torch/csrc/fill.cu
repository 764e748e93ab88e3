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
// valid (value, index) in registers, and the time-major layout makes a
// warp's loads and stores at one step 32 neighbouring floats.
//
// Loads in flight.  At the volatility pipeline's B = 100k a thread that
// loads one step at a time keeps about one line in flight a warp, and the
// first version moved ~0.65 TB/s.  So y streams through ring.cuh's
// per-thread ring of cp.async copies (4 stages, D = STS_FILL_DEPTH = 8
// steps, 6 of them ahead of the walk); each thread owns its ring column,
// so the kernel needs no barrier.  The build may set the depth
// (-DSTS_FILL_DEPTH=8/16/32): chip_smoke.py times the three in turns.
//
// Stores in order.  Every step's outputs are written at that step, so each
// warp fills whole lines, row after row.  A NaN after a valid value opens
// a run whose fill is not known until the next valid value: the run is
// written as NaN as it is read (what a trailing run keeps), and when a
// valid value closes it, close_gap writes the run's interpolated outputs
// over it, from the carried (pv, pi) and the closing value, with no second
// read of y.  The first versions left an open run's outputs unwritten
// until it closed (or the walk ended): each then wrote single floats into
// lines the warp had finished before, and on an H100 the 1.7 % of
// positions in interior gaps and 0.25 % in trailing runs of the
// pipeline's panel made the kernel far slower than on the same panel
// without NaN.  With the writes in order the runs cost nothing measurable
// (chip_smoke.py also times the panel with its NaN replaced), so the
// gap's weight (g - pi) / span keeps __fdiv_rn, whose slow-path branch
// runs out of line, at a gap's close only.
#include "ring.cuh"

#ifndef STS_FILL_DEPTH
#define STS_FILL_DEPTH 8
#endif

namespace {

using sts::at;

constexpr int kDepth = STS_FILL_DEPTH;    // ring depth D in time steps
constexpr int kStages = 4;                // commit groups in the ring
constexpr int kSteps = kDepth / kStages;  // time steps a group
static_assert(kDepth % kStages == 0 && kSteps >= 1,
              "STS_FILL_DEPTH must be a positive multiple of 4");

// The requested outputs of one series; kWhich: bit 0 filled, bit 1 diff,
// bit 2 lag.
template <int kWhich>
struct Outs {
  float* f;
  float* d;
  float* l;
  int B;
  int b;

  // one position's outputs, given its filled value and the previous one
  __device__ __forceinline__ void emit(int t, float fill, float prev) const {
    const size_t i = at(t, B, b);
    if (kWhich & 1) f[i] = fill;
    if (kWhich & 2) d[i] = __fsub_rn(fill, prev);
    if (kWhich & 4) l[i] = prev;
  }
};

// The outputs of the interior gap g0 .. t-1 that the valid y_t closes,
// from the last valid value before it (pv at pi, which is also fill_{g0-1}),
// written over the NaN the walk wrote there -> fill_{t-1}.  Out of line: a
// gap closes at under 1 % of a series' steps, and inlined into each step
// of the walk's unrolled stage it would make the hot loop several times
// longer.
template <int kWhich>
__device__ __noinline__ float close_gap(Outs<kWhich> out, int g0, int t,
                                        float pv, float pi, float yt) {
  const float span = fmaxf(__fsub_rn(static_cast<float>(t), pi), 1.f);
  float fprev = pv;
  for (int g = g0; g < t; ++g) {
    const float w = __fdiv_rn(__fsub_rn(static_cast<float>(g), pi), span);
    const float fill =
        __fadd_rn(__fmul_rn(pv, __fsub_rn(1.f, w)), __fmul_rn(yt, w));
    out.emit(g, fill, fprev);
    fprev = fill;
  }
  return fprev;
}

template <int kWhich>
__global__ void __launch_bounds__(sts::kThreads)
fill_chain_k(const float* __restrict__ y, float* __restrict__ f,
             float* __restrict__ d, float* __restrict__ l, int B, int T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Outs<kWhich> out{f, d, l, B, b};
  const float nan = __int_as_float(0x7fc00000);
  float pv = 0.f;      // last valid value
  float pi = -1e30f;   // its index (none yet)
  float fprev = nan;   // fill_{t-1}
  int gap = -1;        // first position of the open NaN run, or -1
  const float* const pan[1] = {y};
  sts::stream<1, false, kStages, kSteps>(
      pan, B, T, b, [&](int t, int, const float (&v)[1]) {
        const float yt = v[0];
        const bool valid = !isnan(yt);
        if (valid && gap >= 0) {  // y_t closes the run gap .. t-1
          fprev = close_gap(out, gap, t, pv, pi, yt);
          gap = -1;
        }
        // every step is written in order: a NaN after a valid value as NaN
        // too (what a trailing run keeps), overwritten by close_gap if a
        // valid value closes its run
        gap = !valid && pi >= 0.f && gap < 0 ? t : gap;
        const float fill = valid ? yt : nan;
        out.emit(t, fill, fprev);
        fprev = fill;
        pv = valid ? yt : pv;
        pi = valid ? static_cast<float>(t) : pi;
      });
}

template <int kWhich>
int launch(const float* y, float* f, float* d, float* l, int B, int T,
           cudaStream_t s) {
  return sts::launch_ring(fill_chain_k<kWhich>, sts::ring_bytes(1, kDepth),
                          B, s, y, f, d, l, B, T);
}

}  // namespace

// y, f, d, l: [T, B]; an output pointer is null when it is not requested.
// Returns cudaGetLastError() after the launch (or a refusal of the ring's
// shared memory).
extern "C" int sts_fill_chain(const float* y, float* f, float* d, float* l,
                              int B, int T, void* stream) {
  using Launch = int (*)(const float*, float*, float*, float*, int, int,
                         cudaStream_t);
  // by the outputs asked for: bit 0 filled, bit 1 diff, bit 2 lag
  static constexpr Launch kLaunch[8] = {nullptr,   launch<1>, launch<2>,
                                        launch<3>, launch<4>, launch<5>,
                                        launch<6>, launch<7>};
  const int which = (f != nullptr) | (d != nullptr) << 1 | (l != nullptr) << 2;
  if (which == 0) return static_cast<int>(cudaErrorInvalidValue);
  return kLaunch[which](y, f, d, l, B, T, static_cast<cudaStream_t>(stream));
}

// The ring's depth D in time steps, as built.
extern "C" int sts_fill_ring_depth() { return kDepth; }

// Blocks an SM holds and dynamic shared memory a block of the kernel the
// volatility pipeline runs (the difference only).  Returns the CUDA error
// (0 on success).
extern "C" int sts_fill_occupancy(int* blocks, int* smem) {
  *smem = static_cast<int>(sts::ring_bytes(1, kDepth));
  return sts::blocks_per_sm(fill_chain_k<2>, *smem, blocks);
}
