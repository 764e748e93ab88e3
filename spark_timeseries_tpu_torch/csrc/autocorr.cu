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
// The mean must be complete before the first lag product, so a thread that
// walks its series in device memory reads it twice, and the first version
// (one thread a series, one load in flight) reached 20 % of the one-read
// bound.  The reference reads twice at long T too (its mean is fused only
// when the series fits one 1024-step tile).
//
// The tile route reads y from device memory once.  A block of 256 threads
// owns kTile series (STS_ACF_TILE, 8 as shipped) and stages their whole
// [T, kTile] window in dynamic shared memory (80.6 KB at T = 2,520, two
// blocks an SM).  Thread (s, c) = (tid % kTile, tid / kTile) owns chunk c
// of series s: L consecutive steps, L = ceil(T / chunks) made odd, so the
// chunks a warp reads at once sit in different banks.
//   1. It copies its own chunk with 4-byte cp.async copies (a warp's
//      instruction moves kTile-float rows, whole 32-byte sectors), in four
//      commit groups, and sums each group's valid values and count as it
//      lands: no barrier, a thread reads only what it copied.
//   2. Barrier; each thread adds the chunks' partials of its series in
//      chunk order and forms the mean.
//   3. It walks its chunk again in shared memory with a register window of
//      the last C centred values (C = 1, 2, 4, 8, 16, 20, 24 or 32 >= nl,
//      every index a compile-time constant: the walk is unrolled C steps
//      at a time and the window rotates instead of shifting), seeded from
//      the C rows before the chunk, and forms C + 1 partial sums (all C
//      lags, so no lag needs a guard; the ones past nl are not written).
//   4. Barrier; the partials go where the tile was; barrier; each output
//      (lag, series) adds its chunks' partials in chunk order and divides.
// Every sum has one fixed order whatever the batch: no atomics, the same
// bits for a series in any batch.  The products are fused multiply-adds
// (__fmaf_rn); autocorr_plain follows the chunk order and rounds the
// products apart, so the two agree to a few units in the last place.
//
// What holds it at about half of its bound on an H100 (PERF.md): a
// block's load and its walks run one after the other, and the two blocks
// an SM holds start together, so the memory idles while they compute; a
// block's 32-byte row pieces also move more slowly than whole lines.
// Tiles of 16 series (64-byte rows, one block an SM) ran slower, and so
// did a persistent block that streams the next tile in while it walks
// this one, and clusters of neighbouring blocks.
//
// The stream route, for a T whose tile does not fit the 227 KB a block may
// have (T > 7,200), or nl > 32: one thread a series walks y twice,
// streamed through ring.cuh's per-thread ring of cp.async copies (4
// stages, 32 steps): pass 1 counts and sums, pass 2 keeps the last nl
// centred values in a shift register (nl <= 32) or a circular ring in
// local memory (longer lag sets) with one accumulator a lag.  It reads y
// twice, so at most half of the one-read bound.  The route is structural
// (T and nl), never a retry.  A build with -DSTS_ACF_TILE=0 takes it for
// every T, and one with -DSTS_ACF_TILE=16 tiles 16 series a block:
// chip_smoke.py times the three in turns.
#include "ring.cuh"

#ifndef STS_ACF_TILE
#define STS_ACF_TILE 8
#endif

namespace {

using sts::at;
using sts::kThreads;

constexpr int kMaxLag = 1024;  // autocorr_structural_ok: nl < 1024
constexpr int kLagMask = kMaxLag - 1;
constexpr int kMaxCap = 32;    // the largest register window

// the tile: series a block (0: no tile route) and chunks a series
constexpr int kTile = STS_ACF_TILE;
static_assert(kTile == 0 || (kTile <= kThreads && kThreads % kTile == 0),
              "STS_ACF_TILE must divide the block's threads");
// the kernel's indexing, also in a build without the tile route
constexpr int kTileS = kTile > 0 ? kTile : 1;
constexpr int kChunks = kThreads / kTileS;
constexpr size_t kSmemMax = 227 * 1024;  // dynamic shared memory a block
constexpr int kGroups = 4;  // commit groups of a chunk's copies

// the stream route's ring: 4 stages of 8 steps
constexpr int kStages = 4;
constexpr int kSteps = 8;

// Smallest register window in {1, 2, 4, 8, 16, 20, 24, 32} that holds n
// lags; the caller takes n <= 32.
template <class F>
void with_cap(int n, F&& f) {
  if (n <= 8) sts::with_cap8(n, f);
  else if (n <= 16) f(std::integral_constant<int, 16>{});
  else if (n <= 20) f(std::integral_constant<int, 20>{});
  else if (n <= 24) f(std::integral_constant<int, 24>{});
  else f(std::integral_constant<int, 32>{});
}

// Floats of the tile route's shared memory at T: the tile (later the
// partial sums of pass 3, C + 1 a thread), then pass 1's two partials a
// thread.
__host__ __device__ __forceinline__ size_t tile_floats(int T) {
  const size_t tile = static_cast<size_t>(T) * kTileS;
  const size_t sums = static_cast<size_t>(kMaxCap + 1) * kThreads;
  return (tile > sums ? tile : sums) + 2 * kThreads;
}

// The tile route's chunk length at T (odd), or 0 when it takes the stream
// route.
int tile_chunk(int T, int nl) {
  if (kTile == 0 || nl > kMaxCap ||
      sizeof(float) * tile_floats(T) > kSmemMax)
    return 0;
  const int L = (T + kChunks - 1) / kChunks;
  return L | 1;
}

__device__ __forceinline__ float centre(float v, float mean) {
  return isnan(v) ? 0.f : __fsub_rn(v, mean);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
autocorr_tile_k(const float* __restrict__ y, float* __restrict__ out, int B,
                int T, int nl, int L) {
  STS_SHARED_FLOATS(sm);
  const int tid = threadIdx.x;
  const int s = tid % kTileS, c = tid / kTileS;
  const int b = blockIdx.x * kTileS + s;
  // threads past the batch's edge run every step on rows nobody copied
  // and write nothing: every thread reaches every barrier
  const bool live = b < B;
  const size_t region = tile_floats(T) - 2 * kThreads;
  float* const tile = sm;             // [T][kTileS]
  float* const part = sm + region;    // pass 1: [2][kThreads]
  const int t0 = min(c * L, T);
  const int n = min(t0 + L, T) - t0;  // this chunk's steps (may be 0)
  const float* const col = tile + t0 * kTileS + s;
  float cnt = 0.f, sum = 0.f;
  // pass 1 over steps j0 .. j1-1 of the chunk: the valid count and sum
  auto add = [&](int j0, int j1) {
    for (int j = j0; j < j1; ++j) {
      const float v = col[j * kTileS];
      const bool valid = !isnan(v);
      cnt = __fadd_rn(cnt, valid ? 1.f : 0.f);
      sum = __fadd_rn(sum, valid ? v : 0.f);
    }
  };
  // 1. copy the chunk in kGroups groups; sum each as it lands
  const int per = (n + kGroups - 1) / kGroups;
  {
    const float* src = y + at(t0, B, live ? b : 0);
    sts::SharedAddr dst = sts::shared_addr(tile + t0 * kTileS + s);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j1 = min((g + 1) * per, n);
      for (int j = g * per; live && j < j1; ++j) {
        sts::copy4(dst, src);
        src += B;
        dst += sizeof(float) * kTileS;
      }
      __pipeline_commit();
    }
  }
  __pipeline_wait_prior(kGroups - 1);
  add(0, min(per, n));
  __pipeline_wait_prior(kGroups - 2);
  add(min(per, n), min(2 * per, n));
  __pipeline_wait_prior(kGroups - 3);
  add(min(2 * per, n), min(3 * per, n));
  __pipeline_wait_prior(0);
  add(min(3 * per, n), n);
  part[tid] = cnt;
  part[kThreads + tid] = sum;
  __syncthreads();  // every copy has landed, every partial is written

  // 2. the series' mean from its chunks' partials, in chunk order
  float n_all = 0.f, s_all = 0.f;
  for (int k = 0; k < kChunks; ++k) {
    n_all = __fadd_rn(n_all, part[k * kTileS + s]);
    s_all = __fadd_rn(s_all, part[kThreads + k * kTileS + s]);
  }
  const float mean = __fdiv_rn(s_all, fmaxf(n_all, 1.f));

  // 3. the chunk's lag products; w[i] holds d_{t0 - C + i} at the start
  float w[C], acc[C + 1];  // acc[0] = sum d^2, acc[k + 1]: lag k + 1
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int r = t0 - C + i;
    w[i] = r >= 0 ? centre(tile[r * kTileS + s], mean) : 0.f;
  }
#pragma unroll
  for (int k = 0; k <= C; ++k) acc[k] = 0.f;
  // step j of a C-step block: w[(j - 1 - k) mod C] = d_{t-1-k}; d_t then
  // takes the slot of d_{t-C}
  auto step = [&](int j, float v) {
    const float d = centre(v, mean);
    acc[0] = __fmaf_rn(d, d, acc[0]);
#pragma unroll
    for (int k = 0; k < C; ++k)
      acc[k + 1] = __fmaf_rn(d, w[(j - 1 - k + C) % C], acc[k + 1]);
    w[j] = d;
  };
  int j0 = 0;
  for (; j0 + C <= n; j0 += C) {
#pragma unroll
    for (int j = 0; j < C; ++j) step(j, col[(j0 + j) * kTileS]);
  }
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (j0 + j < n) step(j, col[(j0 + j) * kTileS]);
  __syncthreads();  // the tile is read: its space takes the partials
#pragma unroll
  for (int k = 0; k <= C; ++k) sm[k * kThreads + tid] = acc[k];
  __syncthreads();

  // 4. each (lag, series) output adds its chunks' partials in chunk order
  for (int o = tid; o < kTileS * nl; o += kThreads) {
    const int k = o / kTileS, so = o % kTileS;
    const int bo = blockIdx.x * kTileS + so;
    if (bo >= B) continue;
    float num = 0.f, den = 0.f;
    for (int q = 0; q < kChunks; ++q) {
      num = __fadd_rn(num, sm[(k + 1) * kThreads + q * kTileS + so]);
      den = __fadd_rn(den, sm[q * kTileS + so]);
    }
    out[at(k, B, bo)] = __fdiv_rn(num, den);
  }
}

// Stream route, pass 1: the valid-sample mean.
__device__ __forceinline__ float stream_mean(const float* y, int B, int T,
                                             int b) {
  const float* const pan[1] = {y};
  float n = 0.f, s = 0.f;
  sts::stream<1, false, kStages, kSteps>(
      pan, B, T, b, [&](int, int, const float (&v)[1]) {
        const bool valid = !isnan(v[0]);
        n = __fadd_rn(n, valid ? 1.f : 0.f);
        s = __fadd_rn(s, valid ? v[0] : 0.f);
      });
  return __fdiv_rn(s, fmaxf(n, 1.f));
}

// Stream route, nl <= C <= 32: the window in registers, shifted a step.
template <int C>
__global__ void __launch_bounds__(kThreads)
autocorr_stream_k(const float* __restrict__ y, float* __restrict__ out, int B,
                int T, int nl) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float mean = stream_mean(y, B, T, b);
  float dl[C], acc[C];  // dl[k] = d_{t-1-k}; acc[k] = sum d_t d_{t-1-k}
#pragma unroll
  for (int k = 0; k < C; ++k) dl[k] = acc[k] = 0.f;
  float a0 = 0.f;
  const float* const pan[1] = {y};
  sts::stream<1, false, kStages, kSteps>(
      pan, B, T, b, [&](int, int, const float (&v)[1]) {
        const float d = centre(v[0], mean);
        a0 = __fmaf_rn(d, d, a0);
#pragma unroll
        for (int k = 0; k < C; ++k)
          if (k < nl) acc[k] = __fmaf_rn(d, dl[k], acc[k]);
#pragma unroll
        for (int k = C - 1; k > 0; --k) dl[k] = dl[k - 1];
        dl[0] = d;
      });
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (k < nl) out[at(k, B, b)] = __fdiv_rn(acc[k], a0);
}

// Stream route, nl > 32: the ring and the sums in local memory; slot
// (s & kLagMask) holds d_s, and slots before the series start read 0, as
// the reference's halo.
__global__ void __launch_bounds__(kThreads)
autocorr_stream_dyn_k(const float* __restrict__ y, float* __restrict__ out,
                    int B, int T, int nl) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float mean = stream_mean(y, B, T, b);
  float ring[kMaxLag], acc[kMaxLag];
  for (int k = 0; k < kMaxLag; ++k) ring[k] = 0.f;
  for (int k = 0; k < nl; ++k) acc[k] = 0.f;
  float a0 = 0.f;
  const float* const pan[1] = {y};
  sts::stream<1, false, kStages, kSteps>(
      pan, B, T, b, [&](int t, int, const float (&v)[1]) {
        const float d = centre(v[0], mean);
        a0 = __fmaf_rn(d, d, a0);
        for (int k = 0; k < nl; ++k)
          acc[k] = __fmaf_rn(d, ring[(t - 1 - k) & kLagMask], acc[k]);
        ring[t & kLagMask] = d;
      });
  for (int k = 0; k < nl; ++k) out[at(k, B, b)] = __fdiv_rn(acc[k], a0);
}

}  // namespace

// y: [T, B]; out: [nl, B] (r_1 .. r_nl); 0 < nl < 1024.
// Returns cudaGetLastError() after the launch (or a refusal of the shared
// memory a route asks for).
extern "C" int sts_autocorr(const float* y, float* out, int B, int T, int nl,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = tile_chunk(T, nl);
  int rc = 0;
  if (L > 0) {
    const size_t smem = sizeof(float) * tile_floats(T);
    with_cap(nl, [&](auto c) {
      auto kern = autocorr_tile_k<decltype(c)::value>;
      const cudaError_t e = sts::allow_smem(kern, smem);
      if (e != cudaSuccess) {
        rc = static_cast<int>(e);
        return;
      }
      STS_LAUNCH_COOP(dim3((B + kTileS - 1) / kTileS), kThreads, smem, s,
                      kern)(y, out, B, T, nl, L);
      rc = static_cast<int>(cudaGetLastError());
    });
  } else if (nl <= kMaxCap) {
    with_cap(nl, [&](auto c) {
      rc = sts::launch_ring(autocorr_stream_k<decltype(c)::value>,
                            sts::ring_bytes(1, kStages * kSteps), B, s, y,
                            out, B, T, nl);
    });
  } else {
    rc = sts::launch_ring(autocorr_stream_dyn_k,
                          sts::ring_bytes(1, kStages * kSteps), B, s, y, out,
                          B, T, nl);
  }
  return rc;
}

// The route sts_autocorr takes at (T, nl): the tile route's chunk length,
// or 0 for the stream route.
extern "C" int sts_autocorr_route(int T, int nl) { return tile_chunk(T, nl); }

// Series a block of the tile route, as built (0: no tile route).
extern "C" int sts_autocorr_tile() { return kTile; }

// Blocks an SM holds and dynamic shared memory a block for the route at
// (T, nl) (the tile route at capacity 20 or the stream route).  Returns the
// CUDA error (0 on success).
extern "C" int sts_autocorr_occupancy(int T, int nl, int* blocks,
                                      int* smem) {
  if (tile_chunk(T, nl) > 0) {
    *smem = static_cast<int>(sizeof(float) * tile_floats(T));
    return sts::blocks_per_sm(autocorr_tile_k<20>, *smem, blocks);
  }
  *smem = static_cast<int>(sts::ring_bytes(1, kStages * kSteps));
  return sts::blocks_per_sm(autocorr_stream_k<20>, *smem, blocks);
}
