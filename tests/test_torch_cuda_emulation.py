"""The CUDA kernels' own source, run on the CPU against the plain versions.

A host without ``nvcc`` cannot build ``spark_timeseries_tpu_torch/csrc``
for the card, but g++ compiles the same source against a small header
that defines the CUDA names it uses.  A kernel that keeps shared memory in
per-thread columns (``STS_LAUNCH``, ``STS_LAUNCH_SMEM``) runs as a loop
over blocks and threads, one thread after another, with dynamic shared
memory set to NaN before each thread (a thread that read a word it did not
copy would see NaN).  A cooperative kernel (``STS_LAUNCH_COOP``: the
autocorrelation's tile) runs each block's threads as fibers
(``ucontext``), in rounds from one ``__syncthreads`` to the next, with
shared memory set to NaN once a block; a thread that left the kernel with
fewer barriers than the others makes the launch return an error.
``cp.async`` is a plain copy whose commit and wait do nothing.  Each
kernel, loaded with ctypes through the wrappers of ``ops.cuda_kernels``,
is then held against its plain PyTorch version on the same inputs.  This
checks the kernels' logic (indexing, masks, modes, ring capacities);
``chip_smoke.py`` checks the code ``nvcc`` builds on the card.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spark_timeseries_tpu_torch.ops import _build
from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
from spark_timeseries_tpu_torch.ops import lbfgs_kernels as lk
from spark_timeseries_tpu_torch.utils import optim

_HEADER = r"""
#pragma once
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <vector>
using std::isfinite;
using std::isnan;
using std::min;
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a) : x(a) {}
};
inline dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchFailure = 4
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
namespace emu {
inline int error = 0;  // a launch's fault, reported by cudaGetLastError
// a cooperative launch's threads: one fiber each, and the running one
inline ucontext_t fiber_main;
inline std::vector<ucontext_t> fiber_ctx;
inline std::vector<int> fiber_barriers, fiber_done;
inline int fiber_cur = -1;  // -1: outside a cooperative launch
inline std::function<void()> fiber_body;
inline void fiber_entry() {
  fiber_body();
  fiber_done[fiber_cur] = 1;  // then back to fiber_main (uc_link)
}
}  // namespace emu
inline int cudaGetLastError() {
  const int e = emu::error;
  emu::error = 0;
  return e;
}
// a barrier: the thread yields; its block resumes it once every thread has
// reached the barrier or left the kernel
inline void __syncthreads() {
  if (emu::fiber_cur < 0) {  // in a one-thread-at-a-time launch
    emu::error = cudaErrorLaunchFailure;
    return;
  }
  ++emu::fiber_barriers[emu::fiber_cur];
  swapcontext(&emu::fiber_ctx[emu::fiber_cur], &emu::fiber_main);
}
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
#ifndef EMU_SMEM_LIMIT
#define EMU_SMEM_LIMIT (227 * 1024)  // the dynamic shared memory a card grants
#endif
namespace emu {
// each kernel's raised dynamic shared memory; above the default 48 KB a
// launch may use only as much as its kernel's attribute grants
inline std::map<const void*, size_t> smem_attr;
template <class K> bool smem_granted(K k, size_t smem) {
  const auto it = smem_attr.find(reinterpret_cast<const void*>(k));
  return smem <= 48 * 1024 || (it != smem_attr.end() && it->second >= smem);
}
}  // namespace emu
template <class T> int cudaFuncSetAttribute(T* k, cudaFuncAttribute, int v) {
  if (v > EMU_SMEM_LIMIT) return cudaErrorInvalidValue;
  emu::smem_attr[reinterpret_cast<const void*>(k)] = v;
  return cudaSuccess;
}
template <class T>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T*, int, size_t) {
  *n = 1;
  return 0;
}
#define __global__
#define __device__
#define __host__
#define __shared__
#define __align__(n) alignas(n)
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { volatile float r = std::sqrt(a); return r; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
template <class T> T atomicAdd(T* p, T v) { T old = *p; *p += v; return old; }
namespace emu {
inline std::vector<float> shared;  // the launch's dynamic shared memory
template <class K> struct Launcher {
  dim3 g;
  unsigned threads;
  size_t smem;
  K k;
  template <class... A> void operator()(A... a) const {
    if (!smem_granted(k, smem)) {  // the card refuses the launch
      error = cudaErrorInvalidValue;
      return;
    }
    blockDim = dim3(threads);
    gridDim = g;
    shared.resize(smem / sizeof(float));
    for (unsigned bx = 0; bx < g.x; ++bx)
      for (unsigned tx = 0; tx < threads; ++tx) {
        blockIdx = dim3(bx);
        threadIdx = dim3(tx);
        std::fill(shared.begin(), shared.end(), std::nanf(""));
        k(a...);
      }
  }
};
template <class K>
Launcher<K> launcher(dim3 g, unsigned threads, size_t smem, K k) {
  return {g, threads, smem, k};
}
// a block's threads run as fibers, in rounds from barrier to barrier;
// shared memory is set to NaN once a block; a thread that left the kernel
// with fewer barriers than another makes the launch fail
template <class K> struct CoopLauncher {
  dim3 g;
  unsigned threads;
  size_t smem;
  K k;
  template <class... A> void operator()(A... a) const {
    constexpr size_t kStack = 1 << 17;
    if (!smem_granted(k, smem)) {
      error = cudaErrorInvalidValue;
      return;
    }
    blockDim = dim3(threads);
    gridDim = g;
    shared.resize(smem / sizeof(float));
    std::vector<std::unique_ptr<char[]>> stacks(threads);
    for (auto& st : stacks) st.reset(new char[kStack]);
    fiber_ctx.assign(threads, ucontext_t{});
    fiber_body = [&] { k(a...); };
    for (unsigned bx = 0; bx < g.x; ++bx) {
      std::fill(shared.begin(), shared.end(), std::nanf(""));
      blockIdx = dim3(bx);
      fiber_barriers.assign(threads, 0);
      fiber_done.assign(threads, 0);
      for (unsigned tx = 0; tx < threads; ++tx) {
        ucontext_t& c = fiber_ctx[tx];
        getcontext(&c);
        c.uc_stack.ss_sp = stacks[tx].get();
        c.uc_stack.ss_size = kStack;
        c.uc_link = &fiber_main;
        makecontext(&c, fiber_entry, 0);
      }
      for (unsigned left = threads; left > 0;)
        for (unsigned tx = 0; tx < threads; ++tx) {
          if (fiber_done[tx]) continue;
          fiber_cur = static_cast<int>(tx);
          threadIdx = dim3(tx);
          swapcontext(&fiber_main, &fiber_ctx[tx]);
          left -= fiber_done[tx];
        }
      fiber_cur = -1;
      for (int c : fiber_barriers)
        if (c != fiber_barriers[0]) error = cudaErrorLaunchFailure;
    }
  }
};
template <class K>
CoopLauncher<K> coop_launcher(dim3 g, unsigned threads, size_t smem, K k) {
  return {g, threads, smem, k};
}
}  // namespace emu
#define STS_LAUNCH(grid, stream, ...) \
  ::emu::launcher((grid), ::sts::kThreads, 0, __VA_ARGS__)
#define STS_LAUNCH_SMEM(grid, smem, stream, ...) \
  ::emu::launcher((grid), ::sts::kThreads, (smem), __VA_ARGS__)
#define STS_LAUNCH_BLOCK(grid, threads, smem, stream, ...) \
  ::emu::launcher((grid), (threads), (smem), __VA_ARGS__)
#define STS_LAUNCH_COOP(grid, threads, smem, stream, ...) \
  ::emu::coop_launcher((grid), (threads), (smem), __VA_ARGS__)
#define STS_SHARED_FLOATS(name) float* const name = ::emu::shared.data()
"""

# <cuda_pipeline.h>: cp.async as a copy that has landed when it returns
_PIPELINE = r"""
#pragma once
#include <cstddef>
#include <cstring>
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t zfill = 0) {
  std::memcpy(dst, src, n - zfill);
  std::memset(static_cast<char*>(dst) + n - zfill, 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
"""

# the GARCH ring depths garch.cu builds at (-DSTS_GARCH_DEPTH); it ships
# one of them
GARCH_DEPTHS = (8, 16, 32)
# the Holt-Winters forward's builds (y ring stages) and the moment sweep's
# ring depths (0: one load of y a step, the design before the ring); csrc
# ships one of each
HW_VARIANTS = {"S2": ["-DSTS_HW_STAGES=2"], "S3": ["-DSTS_HW_STAGES=3"]}
HR_DEPTHS = (0, 8, 16, 32)
# the fill chain's ring depths and the autocorrelation's tiles (series a
# block; 0: the two-pass stream for every T) the sources build at; csrc
# ships one of each
FILL_DEPTHS = (8, 16, 32)
ACF_TILES = (0, 8, 16)


def _acf_tile_fits(tile, t):
    """csrc/autocorr.cu's rule: the tile route's shared memory (the tile,
    or 33 partials a thread of 256, and two pass-1 partials a thread)
    within the 227 KB a block may have."""
    return tile > 0 and 4 * (max(tile * t, 33 * 256) + 2 * 256) <= 227 * 1024


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``{source: ctypes library}`` built by g++ from ``csrc``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the emulated kernels cannot be "
                    "built")
    d = tmp_path_factory.mktemp("cuda_emu")
    (d / "cuda_runtime.h").write_text(_HEADER)
    (d / "cuda_pipeline.h").write_text(_PIPELINE)
    builds = {name: (name, []) for name in _build.SOURCES}
    builds.update({f"garch-D{k}": ("garch", [f"-DSTS_GARCH_DEPTH={k}"])
                   for k in GARCH_DEPTHS})
    builds["garch-48K"] = ("garch", ["-DEMU_SMEM_LIMIT=49152",
                                     "-DSTS_GARCH_DEPTH=32"])
    builds.update({f"hw-{k}": ("hw", defs) for k, defs in HW_VARIANTS.items()})
    builds["hw-48K"] = ("hw", ["-DEMU_SMEM_LIMIT=49152", "-DSTS_HW_STAGES=3"])
    builds["css-48K"] = ("css", ["-DEMU_SMEM_LIMIT=49152"])
    builds.update({f"hr-D{k}": ("hr", [f"-DSTS_HR_DEPTH={k}"])
                   for k in HR_DEPTHS})
    builds.update({f"fill-D{k}": ("fill", [f"-DSTS_FILL_DEPTH={k}"])
                   for k in FILL_DEPTHS})
    builds.update({f"autocorr-S{k}": ("autocorr", [f"-DSTS_ACF_TILE={k}"])
                   for k in ACF_TILES})
    builds["autocorr-fresh"] = ("autocorr", [])  # no launch before its test
    jobs = {key: subprocess.Popen(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{d}", *defs, "-x", "c++", str(_build.CSRC / f"{name}.cu"),
         "-o", str(d / f"lib{key}.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for key, (name, defs) in builds.items()}
    libs = {}
    for key, proc in jobs.items():
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out
        lib = ctypes.CDLL(str(d / f"lib{key}.so"))
        name = builds[key][0]
        for fn, argtypes in _build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


@pytest.fixture
def kernels(emulated, monkeypatch):
    """Route the wrappers of ``ops.cuda_kernels`` to the emulated kernels
    for CPU tensors; returns the launch counter."""
    def launch(lib_name, counter, device, call):
        assert call(emulated[lib_name], None) == 0
        ck._count_launch(counter)

    monkeypatch.setattr(ck, "_on_cuda", lambda device: True)
    monkeypatch.setattr(ck, "_launch_call", launch)
    monkeypatch.setattr(ck, "hw_ring_in_registers", lambda m: bool(
        emulated["hw"].sts_hw_ring_in_registers(m)))
    ck.reset_launch_counts()
    yield ck.LAUNCHES
    ck.reset_launch_counts()


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    scale = max(1.0, float(np.abs(ref[ok]).max()) if ok.any() else 0.0)
    err = float(np.abs(got[ok] - ref[ok]).max()) if ok.any() else 0.0
    assert err <= rtol * scale, (err, scale)


def _ragged(t, b, seed, gap=0.1):
    """Time-major random walks with NaN gaps and the edge rows: a leading
    run, a trailing run, all-NaN, constant, one valid value."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(t, b, generator=g).cumsum(0)
    y[torch.rand(t, b, generator=g) < gap] = float("nan")
    y[:7, 0] = float("nan")
    y[-5:, 1] = float("nan")
    y[:, 2] = float("nan")
    y[:, 3] = 4.0
    y[:, 4] = float("nan")
    y[t // 2, 4] = 1.0
    return y.contiguous()


@pytest.mark.parametrize("t,b", [(1, 9), (2, 9), (37, 300), (513, 70)])
@pytest.mark.parametrize("which", [(True, True, True), (False, True, False),
                                   (True, False, True), (False, False, True)])
def test_fill_chain_source(kernels, t, b, which):
    y = _ragged(t, b, seed=t)
    ref = ck.fill_chain_plain(y, which)
    got = ck.fill_chain(y, which)
    assert kernels["fill_chain"] == 1
    for g, r in zip(got, ref):  # the same bits: _rn intrinsics throughout
        np.testing.assert_array_equal(g.numpy(), r.numpy())


@pytest.mark.parametrize("nl", [1, 2, 7, 20, 32, 33, 40])
def test_autocorr_source(kernels, nl):
    y = _ragged(300, 130, seed=nl)
    got = ck.autocorr(y, nl)
    assert kernels["autocorr"] == 1
    _close(got, ck.autocorr_plain(y, nl))


def _fill_lib(lib, yt, which):
    """One fill chain straight through ``lib`` (a build of ``fill.cu``) ->
    the outputs ``which`` asks for, each started as 7.0."""
    outs = [torch.full_like(yt, 7.0) if w else None for w in which]
    T, B = yt.shape
    assert lib.sts_fill_chain(yt.data_ptr(), *(
        None if o is None else o.data_ptr() for o in outs), B, T, None) == 0
    return [o for o in outs if o is not None]


@pytest.fixture(params=FILL_DEPTHS, ids="D{}".format)
def fill_depth(request, emulated):
    """``(D, library)`` of ``fill.cu`` built with ring depth D."""
    lib = emulated[f"fill-D{request.param}"]
    assert lib.sts_fill_ring_depth() == request.param
    return request.param, lib


def test_fill_shipped_depth_is_timed(emulated):
    assert emulated["fill"].sts_fill_ring_depth() in FILL_DEPTHS


# time lengths (k, a) -> k D + a around the ring's edges: one and two
# steps, a ring short of full, full, one over, three rings and part of a
# stage
FILL_T = {"1": (0, 1), "2": (0, 2), "D-1": (1, -1), "D": (1, 0),
          "D+1": (1, 1), "3D+5": (3, 5)}


@pytest.mark.parametrize("t_of_d", FILL_T)
@pytest.mark.parametrize("b", [9, 300])
@pytest.mark.parametrize("gap", [0.1, 0.6])
def test_fill_chain_ring_source(fill_depth, t_of_d, b, gap):
    # every output set through each depth's ring, T around its edges, B not
    # a multiple of the block, leading / interior / trailing gaps (long
    # ones across stages at gap = 0.6), all-NaN and constant rows: the
    # plain version's bits
    d, lib = fill_depth
    k, a = FILL_T[t_of_d]
    t = k * d + a
    y = _ragged(t, b, seed=t + b, gap=gap)
    for which in ((True, True, True), (False, True, False),
                  (True, False, True), (False, False, True)):
        for g, r in zip(_fill_lib(lib, y, which),
                        ck.fill_chain_plain(y, which)):
            np.testing.assert_array_equal(g.numpy(), r.numpy())


def _acf_lib(lib, yt, nl):
    """One autocorrelation straight through ``lib`` (a build of
    ``autocorr.cu``) -> ``[B, nl]``; the output starts as 7.0."""
    T, B = yt.shape
    out = torch.full((nl, B), 7.0)
    assert lib.sts_autocorr(yt.data_ptr(), out.data_ptr(), B, T, nl,
                            None) == 0
    return out.t()


def test_acf_route_rule_matches_the_plain_version(emulated):
    # the plain version follows the shipped build's chunks: its tile, its
    # rule for the route and the chunk length at every (T, nl)
    lib = emulated["autocorr"]
    assert lib.sts_autocorr_tile() == ck._ACF_TILE
    assert ck._ACF_TILE in ACF_TILES
    for t in [*range(1, 200), 2520, 3600, 3601, 7200, 7201, 30000]:
        for nl in (1, 20, 32, 33, 100):
            assert lib.sts_autocorr_route(t, nl) == ck._acf_chunk(t, nl)
    assert ck._acf_chunk(2520, 20) == 79  # the pipeline's: 32 chunks


@pytest.fixture(params=ACF_TILES, ids="S{}".format)
def acf_tile(request, emulated):
    """``(S, library)`` of ``autocorr.cu`` built with a tile of S series
    a block (0: the two-pass stream)."""
    lib = emulated[f"autocorr-S{request.param}"]
    assert lib.sts_autocorr_tile() == request.param
    return request.param, lib


# (nl, T): every register window (1, 2, 4, 8, 16, 24, 32 lags) and the
# local ring, each at T = 2, nl + 1, 33 and 300 where T > nl
ACF_CASES = sorted({(nl, t) for nl in (1, 2, 3, 8, 13, 20, 32, 40)
                    for t in (2, nl + 1, 33, 300) if t > nl})


@pytest.mark.parametrize("nl,t", ACF_CASES)
@pytest.mark.parametrize("b", [9, 257])
def test_autocorr_tile_source(acf_tile, nl, t, b):
    # each build at T not a multiple of the chunk or the ring's stage, B
    # not a multiple of the tile or the block, with leading / interior /
    # trailing gaps, all-NaN and constant rows (NaN out, 0/0): the shipped
    # build follows the plain version's order (only its fused products
    # round differently), the others sum in their own order
    tile, lib = acf_tile
    y = _ragged(t, b, seed=nl * t + b)
    want = ck.autocorr_plain(y, nl)
    _close(_acf_lib(lib, y, nl), want,
           rtol=1e-6 if tile == ck._ACF_TILE else 1e-5)


def test_autocorr_tile_raises_its_shared_memory_as_t_grows_source(emulated):
    # the tile's shared memory grows with T: a launch above an earlier,
    # smaller one of the same kernel raises the attribute again (a launch
    # above it is refused, on the card and here)
    lib = emulated["autocorr-fresh"]
    for t in (1000, 2520, 3000, 7200, 2520):
        y = _ragged(t, 9, seed=t, gap=0.05)
        _close(_acf_lib(lib, y, 20), ck.autocorr_plain(y, 20), rtol=1e-6)


@pytest.mark.parametrize("t", [3600, 3601, 7200, 7201])
@pytest.mark.parametrize("nl", [5, 20, 40])
def test_autocorr_routes_at_the_tile_edge_source(acf_tile, t, nl):
    # both routes of the T dispatch: each build's last tile T and first
    # stream T (3,600 / 3,601 for 16 series a block, 7,200 / 7,201 for 8)
    tile, lib = acf_tile
    y = _ragged(t, 11, seed=t + nl, gap=0.05)
    route = lib.sts_autocorr_route(t, nl)
    assert (route > 0) == (nl <= 32 and _acf_tile_fits(tile, t))
    _close(_acf_lib(lib, y, nl), ck.autocorr_plain(y, nl),
           rtol=1e-6 if tile == ck._ACF_TILE else 1e-5)


@pytest.fixture(params=GARCH_DEPTHS, ids="D{}".format)
def garch_depth(request, emulated, kernels, monkeypatch):
    """Route the GARCH wrappers to ``garch.cu`` built with ring depth D;
    returns D."""
    lib = emulated[f"garch-D{request.param}"]
    assert lib.sts_garch_ring_depth() == request.param
    inner = ck._launch_call

    def launch(lib_name, counter, device, call):
        if lib_name != "garch":
            return inner(lib_name, counter, device, call)
        assert call(lib, None) == 0
        ck.LAUNCHES[counter] += 1

    monkeypatch.setattr(ck, "_launch_call", launch)
    return request.param


def test_garch_shipped_depth_is_timed(emulated):
    assert emulated["garch"].sts_garch_ring_depth() in GARCH_DEPTHS


def test_garch_fast_divide_source(emulated):
    # the forward's divide without its slow-path branch, seeded here with a
    # correctly rounded reciprocal (the card seeds it with its hardware
    # one): the quotient is __fdiv_rn's, bit for bit, over its whole range
    tried, differ = ctypes.c_ulonglong(0), ctypes.c_ulonglong(0)
    assert emulated["garch"].sts_garch_check_divide(
        1 << 17, 7, ctypes.byref(tried), ctypes.byref(differ), None) == 0
    assert tried.value > 1 << 15 and differ.value == 0


def test_garch_refused_launch_returns_its_error(emulated):
    # a card that grants 48 KB a block refuses the adjoint's 64 KB ring: the
    # entry point returns the error (the wrapper raises on it) and runs
    # nothing; the forward's 32 KB ring needs no attribute
    lib = emulated["garch-48K"]
    assert lib.sts_garch_ring_depth() == 32
    r, par, h0, zb = _garch_inputs(40, 9, seed=3)
    par_t = par.t().contiguous()
    gpar = torch.full((3, 9), 7.0)
    p = lambda x: x.data_ptr()  # noqa: E731
    assert lib.sts_garch_bwd(p(r), p(par_t), p(h0), p(zb), p(r), p(h0),
                             p(gpar), p(h0.clone()), None, 9, 40, 1,
                             None) != 0
    assert bool((gpar == 7.0).all())
    ll = torch.empty(9)
    assert lib.sts_garch_fwd(p(r), p(par_t), p(h0), p(zb), None, p(ll), None,
                             9, 40, 1, None) == 0
    _close(ll, ck.garch_fwd_plain(r, par, h0, zb, "sum"))


# time lengths (k, a) -> k D + a around the ring's edges: one step, a ring
# short of full, full, one over, two rings and part of a stage, a long walk
GARCH_T = {"1": (0, 1), "D-1": (1, -1), "D": (1, 0), "D+1": (1, 1),
           "2D+3": (2, 3), "300": (0, 300)}


def _garch_inputs(t, b, seed):
    g = torch.Generator().manual_seed(seed)
    r = torch.randn(t, b, generator=g)
    zb = torch.randint(0, max(t // 2, 1), (b,), generator=g).float()
    zb[0] = 0.0
    if b > 1:
        zb[1] = t + 1.0
    r[torch.arange(t)[:, None] < zb[None, :]] = 0.0
    par = torch.stack([torch.rand(b, generator=g) * 0.2 + 0.01,
                       torch.rand(b, generator=g) * 0.2,
                       torch.rand(b, generator=g) * 0.7], 1).contiguous()
    return r, par, torch.rand(b, generator=g) + 0.5, zb


@pytest.mark.parametrize("b", [1, 270])
@pytest.mark.parametrize("t_of_d", GARCH_T)
def test_garch_fwd_source(kernels, garch_depth, t_of_d, b):
    k, a = GARCH_T[t_of_d]
    t = k * garch_depth + a
    r, par, h0, zb = _garch_inputs(t, b, seed=t)
    for mode in ("e", "sum", "last"):
        _close(ck.garch_fwd(r, par, h0, zb, mode),
               ck.garch_fwd_plain(r, par, h0, zb, mode))
    h, s = ck.garch_fwd(r, par, h0, zb, "both")
    assert torch.equal(s, ck.garch_fwd(r, par, h0, zb, "sum"))
    assert torch.equal(h, ck.garch_fwd(r, par, h0, zb, "e"))
    assert kernels["garch_fwd"] == 6


@pytest.mark.parametrize("t_of_d", GARCH_T)
def test_garch_fwd_exact_walk_source(kernels, garch_depth, t_of_d):
    # rows whose r^2 or h leave the fast divide's range are walked again
    # with __fdiv_rn; each row is held on its own scale
    k, a = GARCH_T[t_of_d]
    t = k * garch_depth + a
    r, par, h0, zb = _garch_inputs(t, 6, seed=t + 2)
    zb[2:] = 0.0
    r[:, 2] = 1e-20  # r^2 subnormal
    r[t // 2, 3] = 1e16  # r^2 and the next h above 2^60
    r[:, 4] = 1e-30  # r^2 rounds to 0: inside the range
    r[:, 5] *= 1e-12  # r^2 about 2^-80
    s = ck.garch_fwd(r, par, h0, zb, "sum")
    ref = ck.garch_fwd_plain(r, par, h0, zb, "sum")
    for i in range(6):
        _close(s[i:i + 1], ref[i:i + 1])
    assert torch.equal(ck.garch_fwd(r, par, h0, zb, "both")[1], s)


@pytest.mark.parametrize("b", [1, 270])
@pytest.mark.parametrize("t_of_d", GARCH_T)
@pytest.mark.parametrize("cotangent", ["per-series", "panel"])
@pytest.mark.parametrize("want_gr", [False, True])
def test_garch_bwd_source(kernels, garch_depth, t_of_d, b, cotangent,
                          want_gr):
    k, a = GARCH_T[t_of_d]
    t = k * garch_depth + a
    r, par, h0, zb = _garch_inputs(t, b, seed=t + 1)
    h = ck.garch_fwd_plain(r, par, h0, zb, "e")
    g = torch.Generator().manual_seed(t)
    cot = (torch.rand(b, generator=g) if cotangent == "per-series"
           else torch.randn(t, b, generator=g))
    got = ck.garch_bwd(r, par, h0, zb, h, cot, want_gr)
    ref = ck.garch_bwd_plain(r, par, h0, zb, h, cot, want_gr)
    assert kernels["garch_bwd"] == 1
    assert (got[2] is None) == (not want_gr)
    for a, e in zip(got, ref):
        if e is not None:
            _close(a, e)


def _seasonal_rows(b, p, q, g):
    """Kernel rows ``[c, phi, theta]`` of seasonal expansions at period 24:
    (0,0,1)(0,0,1,24) (the airline model's MA side, q = 25) and, with
    p = 25, (1,0,1)(1,0,1,24): non-zeros at lags 1, 24 and 25 only."""
    u = lambda: 1.6 * torch.rand(b, generator=g) - 0.8  # noqa: E731
    params = torch.zeros(b, 1 + p + q)
    params[:, 0] = 0.2 * torch.randn(b, generator=g)
    for off, cross, n in ((1, -1.0, p), (1 + p, 1.0, q)):
        if n:
            a, s = u(), u()
            params[:, off], params[:, off + 23] = a, s
            params[:, off + 24] = cross * a * s
    return params.contiguous()


@pytest.mark.parametrize("p,q", [(1, 1), (3, 2), (0, 2), (10, 3), (0, 25),
                                 (25, 25)])
def test_css_sources(kernels, p, q):
    # the slice-1 kernels through the same emulation: register rings and
    # the local-memory rings past 8 lags, with the seasonal fits' expanded
    # coefficients on the latter
    b, t = 130, 90
    g = torch.Generator().manual_seed(p * 10 + q)
    yt = torch.randn(t, b, generator=g)
    zb = torch.randint(p, t // 2, (b,), generator=g).float()
    if q >= 24:
        params = _seasonal_rows(b, p, q, g)
    else:
        params = (0.2 * torch.randn(b, 1 + p + q, generator=g)).contiguous()
    for mode in ("e", "sum", "tail"):
        _close(ck.css_fwd(yt, params, zb, p, q, mode),
               ck.css_fwd_plain(yt, params, zb, p, q, mode))
    e = ck.css_fwd_plain(yt, params, zb, p, q, "e")
    for cot in (torch.rand(b, generator=g), torch.randn(t, b, generator=g)):
        got = ck.css_bwd(yt, e, params, zb, cot, p, q, True)
        ref = ck.css_bwd_plain(yt, e, params, zb, cot, p, q, True)
        for a, r in zip(got, ref):
            _close(a, r)
    m = 3
    _close(ck.hr_moments(yt, zb, m, 0, True, m),
           ck.hr_moments_plain(yt, zb, m, 0, True, m))
    if p <= 8:
        beta = (0.2 * torch.randn(b, m + 1, generator=g)).contiguous()
        _close(ck.hr_moments(yt, zb, p, q, True, m + q, m, beta),
               ck.hr_moments_plain(yt, zb, p, q, True, m + q, m, beta))
    assert kernels["css_fwd"] == 3 and kernels["css_bwd"] == 2


@pytest.mark.parametrize("order,seasonal", [((0, 1, 1), (0, 1, 1, 24)),
                                            ((1, 0, 1), (1, 1, 1, 24))])
def test_sarima_objective_through_the_kernels(kernels, order, seasonal):
    # the seasonal fit's cuda objective (expanded rows through css_fwd and,
    # for the gradient, css_bwd) against the eager objective, 1e-5
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import layout

    b, t = 70, 110
    g = torch.Generator().manual_seed(sum(order) + seasonal[0])
    yd = torch.randn(b, t, generator=g)
    nv = torch.randint(t // 2, t + 1, (b,), generator=g).to(torch.int32)
    k = arima._n_params_seasonal(order, seasonal, True)
    pr = 0.6 * torch.rand(b, k, generator=g) - 0.3
    p_full, q_full, _ = arima.seasonal_lag_span(order, seasonal)
    yt, zb = layout.css_prefold(yd, (p_full, 0, q_full), nv)
    pk = pr.clone().requires_grad_(True)
    got = ck.css_neg_loglik_folded(
        arima._sarima_kernel_params(pk, order, seasonal, True), yt, zb, t,
        (p_full, 0, q_full), True, nv)
    (g_k,) = torch.autograd.grad(got.sum(), pk)
    assert kernels["css_fwd"] == 1 and kernels["css_bwd"] == 1
    pe = pr.clone().requires_grad_(True)
    ref = arima.sarima_neg_loglik(pe, yd, order, seasonal, True, nv)
    (g_e,) = torch.autograd.grad(ref.sum(), pe)
    _close(got.detach(), ref.detach())
    _close(g_k, g_e)


# css.cu's lag route: (label, order, seasonal, lags or None, T).  Seasonal
# cases run the expanded rows with their structural support
# (``arima._lag_support``) and, with lags None, with every lag; the rest
# list lags by hand.  L is the ring length, the least power of two above
# the deepest lag.
LAG_CASES = {
    "airline": ((0, 0, 1), (0, 0, 1, 24), 90),
    "(1,0,1)(1,1,1,24)": ((1, 0, 1), (1, 0, 1, 24), 90),
    "AR only, s=12": ((1, 0, 0), (1, 0, 0, 12), 60),
    "(2,0,2)(2,0,2,4)": ((2, 0, 2), (2, 0, 2, 4), 50),
    "(2,0,2)(2,0,2,7)": ((2, 0, 2), (2, 0, 2, 7), 60),
    "(1,0,1)(1,0,1,12)": ((1, 0, 1), (1, 0, 1, 12), 70),
    "(2,0,2)(2,0,2,52)": ((2, 0, 2), (2, 0, 2, 52), 130),
    "T under the deepest lag": ((0, 0, 1), (0, 0, 1, 24), 20),
}


def _lag_rows(b, order, seasonal, g):
    """Expanded kernel rows ``[c, phi_full, theta_full]`` of random
    parameters in (-0.3, 0.3), and the order's structural support."""
    from spark_timeseries_tpu_torch.models import arima

    k = arima._n_params_seasonal(order, seasonal, True)
    pr = 0.6 * torch.rand(b, k, generator=g) - 0.3
    return (arima._sarima_kernel_params(pr, order, seasonal, True),
            arima._lag_support(order, seasonal))


def _lag_inputs(b, t, seed):
    """Panel, conditioning starts (row 0 never live, row 1 live from 0)."""
    g = torch.Generator().manual_seed(seed)
    yt = torch.randn(t, b, generator=g)
    zb = torch.randint(0, max(t // 2, 1), (b,), generator=g).float()
    zb[0], zb[1] = t + 1.0, 0.0
    return yt, zb, g


def _hold_lag_route(kernels, yt, params, zb, p, q, lags, route):
    """Every forward mode and the adjoint (both cotangents, with gy) of the
    kernels against the plain versions with the same lags; sum == both
    bitwise; unlisted gradient columns exactly 0; each launch on
    ``route``."""
    t, b = yt.shape
    modes = ("e", "sum", "tail") if t >= q else ("e", "sum")
    for mode in modes:
        _close(ck.css_fwd(yt, params, zb, p, q, mode, lags=lags),
               ck.css_fwd_plain(yt, params, zb, p, q, mode, lags=lags))
    e_both, s_both = ck.css_fwd(yt, params, zb, p, q, "both", lags=lags)
    assert torch.equal(s_both, ck.css_fwd(yt, params, zb, p, q, "sum",
                                          lags=lags))
    e = ck.css_fwd_plain(yt, params, zb, p, q, "e", lags=lags)
    _close(e_both, e)
    g = torch.Generator().manual_seed(t + b)
    norm = ck._css_lags(p, q, lags)
    unlisted = list(ck._unlisted(p, q, norm))
    for cot in (torch.rand(b, generator=g), torch.randn(t, b, generator=g)):
        for want_gy in (False, True):
            got = ck.css_bwd(yt, e, params, zb, cot, p, q, want_gy,
                             lags=lags)
            ref = ck.css_bwd_plain(yt, e, params, zb, cot, p, q, want_gy,
                                   lags=lags)
            assert (got[1] is None) == (not want_gy)
            for a, r in zip(got, ref):
                if r is not None:
                    _close(a, r)
            assert not got[0][:, unlisted].any()
    n_fwd = len(modes) + 2
    assert kernels["css_fwd"] == n_fwd and kernels["css_bwd"] == 4
    assert ck.ROUTE_LAUNCHES == {
        "css_fwd": {r: n_fwd * (r == route) for r in ck.CSS_ROUTES},
        "css_bwd": {r: 4 * (r == route) for r in ck.CSS_ROUTES}}


@pytest.mark.parametrize("listed", ["support", "every lag"])
@pytest.mark.parametrize("case", LAG_CASES)
def test_css_lag_route_source(kernels, case, listed):
    # the seasonal expansions on the lag route, with their structural
    # support and with every lag listed (past 32 lags a side, at s = 52,
    # every lag takes the local route)
    from spark_timeseries_tpu_torch.models import arima

    order, seasonal, t = LAG_CASES[case]
    p, q, _ = arima.seasonal_lag_span(order, seasonal)
    b = 140  # two blocks of 128, the second partial
    yt, zb, g = _lag_inputs(b, t, seed=p * 100 + q + t)
    params, support = _lag_rows(b, order, seasonal, g)
    lags = support if listed == "support" else None
    route = "lag" if lags is not None or max(p, q) <= 32 else "local"
    assert ck.css_route(p, q, lags) == route
    _hold_lag_route(kernels, yt, params, zb, p, q, lags, route)


# lags listed by hand: (p, q, lags, T); deepest lags at L - 1, L and L + 1
HAND_LAGS = {
    "deepest L-1": (15, 31, ((2, 15), (1, 31)), 80),
    "deepest L": (16, 32, ((16,), (1, 2, 32)), 80),
    "deepest L+1": (17, 9, ((1, 17), (9,)), 80),
    "dense (10,3)": (10, 3, None, 60),
    "dense (25,25)": (25, 25, None, 70),
    "every lag listed": (12, 2, (tuple(range(1, 13)), (1, 2)), 40),
    "no lag listed": (9, 9, ((), ()), 30),
}


@pytest.mark.parametrize("case", HAND_LAGS)
def test_css_lag_route_hand_lags_source(kernels, case):
    p, q, lags, t = HAND_LAGS[case]
    b = 130
    yt, zb, g = _lag_inputs(b, t, seed=p + 7 * q)
    params = (0.1 * torch.randn(b, 1 + p + q, generator=g)).contiguous()
    assert ck.css_route(p, q, lags) == "lag"
    _hold_lag_route(kernels, yt, params, zb, p, q, lags, "lag")


# past the lag route: rings that do not fit a block's shared memory (both
# sides at s = 168) and more than 32 lags a side
@pytest.mark.parametrize("order,seasonal,lagged", [
    ((1, 0, 1), (1, 0, 1, 168), "support"),
    ((1, 0, 1), (1, 0, 1, 168), "every lag"),
    ((40, 0, 0), None, "every lag")])
def test_css_local_route_source(kernels, order, seasonal, lagged):
    from spark_timeseries_tpu_torch.models import arima

    p, q, _ = arima.seasonal_lag_span(order, seasonal)
    b, t = 9, p + 30
    yt, zb, g = _lag_inputs(b, t, seed=p)
    if seasonal is None:
        params = (0.02 * torch.randn(b, 1 + p + q, generator=g)).contiguous()
        support = None
    else:
        params, support = _lag_rows(b, order, seasonal, g)
    lags = support if lagged == "support" else None
    assert ck.css_route(p, q, lags) == "local"
    _hold_lag_route(kernels, yt, params, zb, p, q, lags, "local")


def test_css_register_route_stays_for_every_lag_up_to_8(kernels):
    # every lag of a small order, listed or not, takes the register route
    yt, zb, g = _lag_inputs(40, 30, seed=3)
    params = (0.2 * torch.randn(40, 4, generator=g)).contiguous()
    for lags in (None, ((1, 2), (1,))):
        assert ck.css_route(2, 1, lags) == "register"
        ck.reset_launch_counts()
        _hold_lag_route(kernels, yt, params, zb, 2, 1, lags, "register")


def test_css_route_rule_matches_the_plain_version(emulated):
    # csrc/css.cu's route_of against ck.css_route, around the register
    # bound, the lag caps and the shared-memory edge
    from spark_timeseries_tpu_torch.models import arima

    lib = emulated["css"]
    names = dict(enumerate(ck.CSS_ROUTES))
    cases = [(p, q, None) for p in (0, 1, 8, 9, 32, 33, 100)
             for q in (0, 8, 9, 25, 32, 33)]
    for s in (4, 7, 12, 24, 52, 104, 168):
        for P in (0, 1, 2):
            for Q in (0, 1, 2):
                for pq in ((0, 0), (1, 1), (2, 2), (3, 0)):
                    order, sea = (pq[0], 0, pq[1]), (P, 0, Q, s)
                    p, q, _ = arima.seasonal_lag_span(order, sea)
                    if p <= 512 and q <= 512:
                        cases.append((p, q, arima._lag_support(order, sea)))
    cases += [(15, 31, ((2, 15), (1, 31))), (40, 2, (tuple(range(1, 34)),
                                                     (1,)))]
    seen = set()
    for p, q, lags in cases:
        norm = ck._css_lags(p, q, lags)
        c_lags, ka, km = ck._c_lags(norm)
        got = names[lib.sts_css_route(p, q, c_lags, ka, km)]
        assert got == ck.css_route(p, q, lags), (p, q, lags)
        seen.add(got)
    assert seen == set(ck.CSS_ROUTES)
    # the lag route's reach: s in {4, 7, 12, 24, 52} with P, Q <= 2, and
    # dense (10, 3)
    for s in (4, 7, 12, 24, 52):
        for order in ((0, 0, 1), (1, 0, 1), (2, 0, 2)):
            sea = (2, 0, 2, s)
            p, q, _ = arima.seasonal_lag_span(order, sea)
            assert ck.css_route(p, q, arima._lag_support(order, sea)) == "lag"
    assert ck.css_route(10, 3) == "lag"


def test_css_lag_refused_launch_returns_its_error(emulated):
    # a card that grants 48 KB a block refuses a lag-route ring above it
    # ((1,0,1)(1,0,1,52): y and e rings of 64 slots and the panel stream,
    # 80 KB): the entry point returns the error and writes nothing; the
    # airline model's (32 KB) runs
    from spark_timeseries_tpu_torch.models import arima

    lib = emulated["css-48K"]
    b, t = 9, 120
    yt, zb, g = _lag_inputs(b, t, seed=5)
    p = lambda x: x.data_ptr()  # noqa: E731
    for order, sea, refused in (((1, 0, 1), (1, 0, 1, 52), True),
                                ((0, 0, 1), (0, 0, 1, 24), False)):
        params, lags = _lag_rows(b, order, sea, g)
        pf, qf, _ = arima.seasonal_lag_span(order, sea)
        norm = ck._css_lags(pf, qf, lags)
        par_c = ck._css_rows(params, pf, qf, norm, "lag")
        sse = torch.full((b,), 7.0)
        rc = lib.sts_css_fwd(p(yt), p(par_c), p(zb), None, p(sse), None, b,
                             t, pf, qf, *ck._c_lags(norm), t, 1, None)
        gpar = torch.full((1 + pf + qf, b), 7.0)
        rc_b = lib.sts_css_bwd(p(yt), p(yt), p(par_c), p(zb), p(sse),
                               p(gpar), None, b, t, pf, qf,
                               *ck._c_lags(norm), t, 1, None)
        if refused:
            assert rc != 0 and bool((sse == 7.0).all())
            assert rc_b != 0 and bool((gpar == 7.0).all())
        else:
            assert rc == 0 and rc_b == 0
            _close(sse, ck.css_fwd_plain(yt, params, zb, pf, qf, "sum",
                                         lags=lags))


def test_css_lag_route_launch_error_raises(emulated, monkeypatch):
    # the wrapper raises on the refusal, as on the card; nothing runs on
    # the plain version instead
    def launch(lib_name, counter, device, call):
        rc = call(emulated["css-48K"], None)
        if rc != 0:
            raise RuntimeError(f"{counter} launch failed with CUDA error {rc}")
        ck.LAUNCHES[counter] += 1

    from spark_timeseries_tpu_torch.models import arima

    monkeypatch.setattr(ck, "_on_cuda", lambda device: True)
    monkeypatch.setattr(ck, "_launch_call", launch)
    ck.reset_launch_counts()
    order, sea = (1, 0, 1), (1, 0, 1, 52)
    pf, qf, _ = arima.seasonal_lag_span(order, sea)
    yt, zb, g = _lag_inputs(9, 120, seed=6)
    params, lags = _lag_rows(9, order, sea, g)
    with pytest.raises(RuntimeError, match="css_fwd launch failed"):
        ck.css_fwd(yt, params, zb, pf, qf, "sum", lags=lags)
    assert ck.LAUNCHES["css_fwd"] == 0
    assert ck.ROUTE_LAUNCHES["css_fwd"]["lag"] == 0
    ck.reset_launch_counts()


@pytest.mark.parametrize("order,seasonal", [((0, 1, 1), (0, 1, 1, 24)),
                                            ((1, 0, 1), (1, 1, 1, 12)),
                                            ((2, 1, 0), (1, 1, 0, 7))])
def test_sarima_objective_with_support_through_the_kernels(kernels, order,
                                                           seasonal):
    # the seasonal fit's cuda objective as _fit_sarima runs it (the
    # structural support, css_sse_folded, then the concentration) against
    # the eager objective, value and gradient, 1e-5, on the lag route
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import layout

    b, t = 70, 110
    g = torch.Generator().manual_seed(sum(order) + seasonal[3])
    yd = torch.randn(b, t, generator=g)
    nv = torch.randint(t // 2, t + 1, (b,), generator=g).to(torch.int32)
    k = arima._n_params_seasonal(order, seasonal, True)
    pr = 0.6 * torch.rand(b, k, generator=g) - 0.3
    p_full, q_full, _ = arima.seasonal_lag_span(order, seasonal)
    yt, zb = layout.css_prefold(yd, (p_full, 0, q_full), nv)
    pk = pr.clone().requires_grad_(True)
    css = ck.css_sse_folded(
        arima._sarima_kernel_params(pk, order, seasonal, True), yt, zb,
        p_full, q_full, lags=arima._lag_support(order, seasonal))
    got = arima._concentrated(css, nv.float() - p_full)
    (g_k,) = torch.autograd.grad(got.sum(), pk)
    assert ck.ROUTE_LAUNCHES["css_fwd"] == {"register": 0, "lag": 1,
                                            "local": 0}
    assert ck.ROUTE_LAUNCHES["css_bwd"]["lag"] == 1
    pe = pr.clone().requires_grad_(True)
    ref = arima.sarima_neg_loglik(pe, yd, order, seasonal, True, nv)
    (g_e,) = torch.autograd.grad(ref.sum(), pe)
    _close(got.detach(), ref.detach())
    _close(g_k, g_e)


def test_css_work_counters_of_the_airline_fit(kernels, monkeypatch):
    # the airline fit on the cuda backend, through the emulated kernels:
    # every CSS launch on the lag route; with the plane on the work.css_*
    # counters are a hand count from the launches (each adjoint follows a
    # "both" forward, every other forward is a "sum"); plane off and on
    # give the same bits and the same launches
    from spark_timeseries_tpu_torch import entry, obs
    from spark_timeseries_tpu_torch.models import arima

    monkeypatch.setattr(arima, "resolve_backend",
                        lambda backend, y, structural_ok=True: "cuda")
    b, t = 40, 24 * 6
    y = entry.gen_hourly_panel(b, t, seed=13, device="cpu")

    def run():
        ck.reset_launch_counts()
        res = arima.fit(y, (0, 1, 1), seasonal=(0, 1, 1, 24),
                        include_intercept=False, max_iters=8, device="cpu")
        return res, dict(ck.LAUNCHES), {k: dict(v) for k, v in
                                        ck.ROUTE_LAUNCHES.items()}

    off, launches, routes = run()
    obs.enable()
    try:
        on, launches_on, routes_on = run()
        work = obs.snapshot()["counters"]
    finally:
        obs.disable()
    for a, c in zip(off, on):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(c))
    assert launches_on == launches and routes_on == routes
    n_f, n_b = launches["css_fwd"], launches["css_bwd"]
    assert routes["css_fwd"]["lag"] == n_f > n_b == routes["css_bwd"]["lag"]
    steps = b * (t - 25)  # rows x the doubly differenced steps
    assert work["work.css_launches"] == work["work.css_lag_launches"] \
        == n_f + n_b
    assert work["work.css_lag_row_steps.sum"] == (n_f - n_b) * steps
    assert work["work.css_lag_row_steps.both"] == n_b * steps
    assert work["work.css_lag_row_steps.bwd"] == n_b * steps
    assert work["work.css_lag_row_steps.bwd_e"] == n_b * steps
    assert not {"work.css_lag_row_steps.bwd_y", "work.css_lag_row_steps.e",
                "work.css_lag_row_steps.bwd_g"} & set(work)
    # zb and the SSE (zb and the row's cotangent) a row; c and the three
    # MA lags' rows read, and written again as gradients by the adjoint
    assert work["work.css_lag_row_floats"] == 2 * b * (n_f + n_b)
    assert work["work.css_lag_coef_floats"] == 4 * b * (n_f + 2 * n_b)


def _ewma_inputs(t, b, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, b, generator=g).cumsum(0)
    zb = torch.randint(0, max(t // 2, 1), (b,), generator=g).float()
    zb[0], zb[1] = 0.0, t + 1.0  # a full row and a row never live
    zb[2] = max(t - 1, 0)  # live at the last step only
    x[torch.arange(t)[:, None] < zb[None, :]] = 0.0
    return x, torch.rand(b, generator=g) * 0.9 + 0.05, zb


@pytest.mark.parametrize("t", [1, 2, 45, 300])
def test_ewma_fwd_source(kernels, t):
    x, alpha, zb = _ewma_inputs(t, 270, seed=t)
    for mode in ("e", "sum"):  # every operation rounded as PyTorch rounds it
        np.testing.assert_array_equal(
            ck.ewma_fwd(x, alpha, zb, mode).numpy(),
            ck.ewma_fwd_plain(x, alpha, zb, mode).numpy())
    s, sse = ck.ewma_fwd(x, alpha, zb, "both")
    assert torch.equal(sse, ck.ewma_fwd(x, alpha, zb, "sum"))
    assert torch.equal(s, ck.ewma_fwd(x, alpha, zb, "e"))
    assert kernels["ewma_fwd"] == 5


@pytest.mark.parametrize("t", [1, 45, 300])
@pytest.mark.parametrize("cotangent", ["per-series", "panel"])
@pytest.mark.parametrize("want_gx", [False, True])
def test_ewma_bwd_source(kernels, t, cotangent, want_gx):
    x, alpha, zb = _ewma_inputs(t, 270, seed=t + 1)
    s = ck.ewma_fwd_plain(x, alpha, zb, "e")
    g = torch.Generator().manual_seed(t)
    cot = (torch.rand(270, generator=g) if cotangent == "per-series"
           else torch.randn(t, 270, generator=g))
    got = ck.ewma_bwd(x, s, alpha, zb, cot, want_gx)
    ref = ck.ewma_bwd_plain(x, s, alpha, zb, cot, want_gx)
    assert kernels["ewma_bwd"] == 1
    assert (got[1] is None) == (not want_gx)
    for a, e in zip(got, ref):
        if e is not None:
            _close(a, e)


def _hw_inputs(t, b, m, mult, seed):
    """Time-major seasonal panel (positive for the multiplicative model),
    zeroed before ragged starts, with the kernels' seeds: some rows with
    fewer than two valid seasons (clamped seed windows), one never live."""
    g = torch.Generator().manual_seed(seed)
    tt = torch.arange(t, dtype=torch.float32)[None, :]
    y = (20.0 + 0.05 * tt + 3.0 * torch.sin(2 * np.pi * tt / m)
         + 0.5 * torch.randn(b, t, generator=g))
    nv = torch.randint(1, t + 1, (b,), generator=g)
    nv[0], nv[1] = t, 0
    y[tt.expand(b, t) < (t - nv)[:, None]] = 0.0
    l0, t0, s0r, zb = ck.hw_seeds(y, m, mult, nv)
    par = torch.rand(b, 3, generator=g) * 0.8 + 0.05
    return y.t().contiguous(), par, l0, t0, s0r, zb


# (period, T, ring route): every register-ring instantiation (T not a
# multiple of the period in most, and one that is), and the global-scratch
# ring, which every period without an instantiation takes
HW_CASES = [(4, 45, "registers"), (6, 45, "registers"), (7, 101, "registers"),
            (8, 50, "registers"), (12, 101, "registers"),
            (24, 101, "registers"), (24, 48, "registers"), (5, 45, "global"),
            (10, 101, "global"), (25, 60, "global")]


def test_hw_cases_cover_every_ring_instantiation(kernels):
    # the periods csrc/hw.cu instantiates with register rings, as it
    # reports them, are the cases' register periods
    assert {m for m in range(1, 1025) if ck.hw_ring_in_registers(m)} \
        == {m for m, _, r in HW_CASES if r == "registers"}


@pytest.mark.parametrize("m,t,route", HW_CASES)
@pytest.mark.parametrize("mult", [False, True])
def test_hw_fwd_source(kernels, m, t, route, mult):
    assert ck.hw_ring_in_registers(m) == (route == "registers")
    yt, par, l0, t0, s0r, zb = _hw_inputs(t, 130, m, mult, seed=m + t)
    s0_before = s0r.clone()
    got = ck.hw_fwd(yt, par, l0, t0, s0r, zb, m, mult, True)
    ref = ck.hw_fwd_plain(yt, par, l0, t0, s0r, zb, m, mult, True)
    for a, e in zip(got, ref):  # the same bits: _rn intrinsics throughout
        np.testing.assert_array_equal(a.numpy(), e.numpy())
    assert torch.equal(got[-1], ck.hw_fwd(yt, par, l0, t0, s0r, zb, m, mult))
    assert torch.equal(s0r, s0_before)  # the caller's seeds stay untouched
    assert kernels["hw_fwd"] == 2


@pytest.mark.parametrize("m,t,route", HW_CASES)
@pytest.mark.parametrize("mult", [False, True])
@pytest.mark.parametrize("cotangent", ["per-series", "panel"])
def test_hw_bwd_source(kernels, m, t, route, mult, cotangent):
    assert ck.hw_ring_in_registers(m) == (route == "registers")
    yt, par, l0, t0, s0r, zb = _hw_inputs(t, 130, m, mult, seed=m * t)
    e, lv, tr, so, _ = ck.hw_fwd_plain(yt, par, l0, t0, s0r, zb, m, mult,
                                       True)
    g = torch.Generator().manual_seed(t)
    cot = (torch.rand(130, generator=g) if cotangent == "per-series"
           else torch.randn(t, 130, generator=g))
    got = ck.hw_bwd(yt, par, l0, t0, zb, lv, tr, so, e, cot, m, mult)
    ref = ck.hw_bwd_plain(yt, par, l0, t0, zb, lv, tr, so, e, cot, m, mult)
    assert kernels["hw_bwd"] == 1
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _hw_lib_fwd(lib, yt, par, l0, t0, s0r, zb, m, mult, save):
    """One Holt-Winters forward straight through ``lib`` (a build of
    ``hw.cu``) -> ``(return code, outputs as hw_fwd gives them, walked)``;
    the outputs start as 7.0 and ``walked`` (1 where the exact walk redid a
    series) as -1."""
    T, B = yt.shape
    sse = torch.full((B,), 7.0)
    walked = torch.full((B,), -1, dtype=torch.int32)
    outs = [torch.full((T, B), 7.0) for _ in range(4)] if save else None
    rc = ck._hw_fwd_call(lib, None, yt, par.contiguous(), l0, t0,
                         s0r.contiguous(), zb, m, mult, sse, outs, walked)
    return rc, ((*outs, sse) if save else sse), walked


def _hw_layout(lib, m):
    """(stages, steps a stage) of ``lib``'s forward's y ring at period
    ``m``."""
    vals = [ctypes.c_int(-1) for _ in range(2)]
    assert lib.sts_hw_ring_layout(m, *(ctypes.byref(v) for v in vals)) == 0
    return tuple(v.value for v in vals)


@pytest.fixture(params=sorted(HW_VARIANTS))
def hw_variant(request, emulated):
    """``(name, library)`` of each Holt-Winters build of ``HW_VARIANTS``."""
    return request.param, emulated[f"hw-{request.param}"]


def test_hw_shipped_variant_is_timed(emulated):
    # the shipped build is one of the timed ones, and every register
    # period's stage holds a whole number of periods, at least 24 steps
    shipped = _hw_layout(emulated["hw"], 24)
    assert shipped in {_hw_layout(emulated[f"hw-{k}"], 24)
                       for k in HW_VARIANTS}
    for m, _, route in HW_CASES:
        stages, steps = _hw_layout(emulated["hw"], m)
        if route == "registers":
            assert stages >= 2 and steps % m == 0 and 24 <= steps < 24 + m
        else:
            assert (stages, steps) == (0, 0)


# time lengths (k, a) -> k S + a around the y ring's stage S: one step, a
# stage short of full, full, one over, and past the whole ring (k = None:
# stages + 1)
HW_T = {"1": (0, 1), "S-1": (1, -1), "S": (1, 0), "S+1": (1, 1),
        "ring+3": (None, 3)}


@pytest.mark.parametrize("t_of_s", HW_T)
@pytest.mark.parametrize("m", [4, 6, 7, 8, 12, 24])
@pytest.mark.parametrize("mult", [False, True])
def test_hw_fwd_ring_source(hw_variant, m, t_of_s, mult):
    # every register period through each build's y ring, T around the
    # ring's edges: the plain version's bits in both modes, sum ==
    # save_resid, and no series off the fast divide
    name, lib = hw_variant
    stages, steps = _hw_layout(lib, m)
    assert stages == (3 if name == "S3" else 2)
    k, a = HW_T[t_of_s]
    t = (stages + 1 if k is None else k) * steps + a
    # seeds need two seasons: a short panel is the tail of a longer one,
    # its starts moved with it (some now before step 0)
    tl = max(t, 2 * m)
    yt, par, l0, t0, s0r, zb = _hw_inputs(tl, 70, m, mult, seed=7 * m + t)
    yt, zb = yt[tl - t:].contiguous(), zb - (tl - t)
    ref = ck.hw_fwd_plain(yt, par, l0, t0, s0r, zb, m, mult, True)
    rc, got, walked = _hw_lib_fwd(lib, yt, par, l0, t0, s0r, zb, m, mult,
                                  True)
    assert rc == 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    rc, sse, walked_sum = _hw_lib_fwd(lib, yt, par, l0, t0, s0r, zb, m, mult,
                                      False)
    assert rc == 0 and torch.equal(sse, got[-1])
    assert not walked.any() and not walked_sum.any()


@pytest.mark.parametrize("save", [False, True])
def test_hw_fwd_exact_walk_source(hw_variant, save):
    # multiplicative rows whose divides leave the fast path's range are
    # walked again with __fdiv_rn: numerators below 2^-60 (row 2), above
    # 2^60 (row 3), a -0 numerator (row 4), denominators above 2^60 (row
    # 6); a negative numerator inside the range stays fast (row 5).  Every
    # row keeps the plain version's bits; the additive model never walks.
    _, lib = hw_variant
    m, t = 24, 101
    yt, par, l0, t0, s0r, zb = _hw_inputs(t, 8, m, True, seed=11)
    yt[:, 2] *= 1e-27
    par[3, 0] = 0.5
    yt[t - 1, 3] = 2.4e18
    yt[t - 1, 4] = -0.0
    yt[t - 2, 5] = -3.0
    s0r[6] = 1e19
    for mult in (True, False):
        ref = ck.hw_fwd_plain(yt, par, l0, t0, s0r, zb, m, mult, save)
        rc, got, walked = _hw_lib_fwd(lib, yt, par, l0, t0, s0r, zb, m,
                                      mult, save)
        assert rc == 0
        for g, r in zip(got if save else [got], ref if save else [ref]):
            np.testing.assert_array_equal(g.numpy(), r.numpy())
        want = [0, 0, 1, 1, 1, 0, 1, 0] if mult else [0] * 8
        assert walked.tolist() == want


def test_hw_fast_divide_source(emulated):
    # the forward's fast divide for numerators of either sign, against
    # __fdiv_rn (seeded here with a correctly rounded reciprocal): the same
    # bits over its whole range
    tried, differ = ctypes.c_ulonglong(0), ctypes.c_ulonglong(0)
    assert emulated["hw"].sts_hw_check_divide(
        1 << 17, 7, ctypes.byref(tried), ctypes.byref(differ), None) == 0
    assert tried.value > 1 << 15 and differ.value == 0


def test_hw_refused_launch_returns_its_error(emulated):
    # a card that grants 48 KB a block refuses the 3-stage ring (72 KB at
    # period 24): the entry point returns the error and writes nothing; the
    # global route, which streams nothing, still runs
    lib = emulated["hw-48K"]
    yt, par, l0, t0, s0r, zb = _hw_inputs(60, 9, 24, False, seed=2)
    rc, sse, walked = _hw_lib_fwd(lib, yt, par, l0, t0, s0r, zb, 24, False,
                                  False)
    assert rc != 0 and bool((sse == 7.0).all()) and bool((walked == -1).all())
    yt, par, l0, t0, s0r, zb = _hw_inputs(60, 9, 25, False, seed=2)
    rc, sse, _ = _hw_lib_fwd(lib, yt, par, l0, t0, s0r, zb, 25, False, False)
    assert rc == 0
    np.testing.assert_array_equal(
        sse.numpy(), ck.hw_fwd_plain(yt, par, l0, t0, s0r, zb, 25,
                                     False).numpy())


def _hr_lib(lib, yt, zb, lag_y, lag_e, woff, beta_m=0, beta=None):
    """One moment sweep (with intercept) straight through ``lib`` (a build
    of ``hr.cu``) -> the accumulators ``[nacc, B]``."""
    ncols = 1 + lag_y + lag_e
    acc = torch.full((ncols * (ncols + 1) // 2 + ncols, yt.shape[1]), 7.0)
    assert ck._hr_moments_call(lib, None, yt, zb, acc, lag_y, lag_e, True,
                               woff, beta_m, beta) == 0
    return acc


def _hr_sweeps(lib, yt, zb, beta):
    """The ARIMA(1,1,1) init's two sweeps: AR(3) with intercept, then
    [1, y_{t-1}, eh_{t-1}] with the AR(3) residual rebuilt from beta."""
    return (_hr_lib(lib, yt, zb, 3, 0, 3),
            _hr_lib(lib, yt, zb, 1, 1, 4, 3, beta))


def _hr_digest_inputs(t=77, b=300):
    rs = np.random.RandomState(5)
    yt = torch.from_numpy(rs.standard_normal((t, b)).cumsum(0)
                          .astype(np.float32))
    zb = torch.from_numpy(rs.randint(0, t // 2, b).astype(np.float32))
    beta = torch.from_numpy((0.2 * rs.standard_normal((b, 4)))
                            .astype(np.float32))
    return yt, zb, beta


# sha256 of the two sweeps' accumulators on _hr_digest_inputs(), from
# csrc/hr.cu as it was before its y ring (one load of y a step), built as
# the `emulated` fixture builds
HR_PARENT_DIGEST = ("32dc4189c5afa7e855fab7b02bac59d6"
                    "c63c8630df4468be21ab964efa39aa50")


@pytest.fixture(params=HR_DEPTHS, ids="D{}".format)
def hr_depth(request, emulated):
    """``(D, library)`` of ``hr.cu`` built with ring depth D."""
    lib = emulated[f"hr-D{request.param}"]
    assert lib.sts_hr_ring_depth() == request.param
    return request.param, lib


def test_hr_shipped_depth_is_timed(emulated):
    assert emulated["hr"].sts_hr_ring_depth() in HR_DEPTHS[1:]


def test_hr_moments_match_the_parent_kernel(hr_depth):
    import hashlib

    _, lib = hr_depth
    h = hashlib.sha256()
    for acc in _hr_sweeps(lib, *_hr_digest_inputs()):
        h.update(acc.numpy().tobytes())
    assert h.hexdigest() == HR_PARENT_DIGEST


# time lengths (k, a) -> k D + a around the ring's edges (D = 8 for the
# build without a ring)
HR_T = {"1": (0, 1), "D-1": (1, -1), "D": (1, 0), "D+1": (1, 1),
        "3D+5": (3, 5), "200": (0, 200)}


@pytest.mark.parametrize("t_of_d", HR_T)
def test_hr_moments_ring_source(emulated, hr_depth, t_of_d):
    # both sweeps through the ring: the bits of the one-load-a-step loop,
    # and the plain version within its tolerance
    d, lib = hr_depth
    k, a = HR_T[t_of_d]
    t = k * max(d, 8) + a
    g = torch.Generator().manual_seed(t)
    b = 270
    yt = torch.randn(t, b, generator=g).cumsum(0).contiguous()
    zb = torch.randint(0, max(t // 2, 1), (b,), generator=g).float()
    zb[0], zb[1] = 0.0, t + 1.0
    beta = (0.2 * torch.randn(b, 4, generator=g)).contiguous()
    ref = _hr_sweeps(emulated["hr-D0"], yt, zb, beta)
    for got, want in zip(_hr_sweeps(lib, yt, zb, beta), ref):
        assert torch.equal(got, want)
    _close(ref[0].t(), ck.hr_moments_plain(yt, zb, 3, 0, True, 3))
    _close(ref[1].t(), ck.hr_moments_plain(yt, zb, 1, 1, True, 4, 3, beta))


# (lag_y, lag_e, intercept, beta_m): a layout for each column capacity the
# sweep is instantiated at (2, 4, 8, 16 and 32 columns)
HR_COLS = {"NC2": (1, 0, True, 0), "NC4": (2, 1, False, 3),
           "NC8": (4, 3, True, 5), "NC16": (10, 4, True, 6),
           "NC32": (20, 8, False, 10)}


@pytest.mark.parametrize("cols", HR_COLS)
@pytest.mark.parametrize("t_limit", ["T", "T-5", "0"])
def test_hr_moments_ring_instantiations_source(emulated, hr_depth, cols,
                                               t_limit):
    # every column capacity through the ring, with and without an
    # intercept, the sweep cut short by t_limit (or empty): the bits of the
    # one-load-a-step build, and the plain version within its tolerance
    d, lib = hr_depth
    lag_y, lag_e, ic, beta_m = HR_COLS[cols]
    t, b = 3 * max(d, 8) + 5, 70
    tl = {"T": t, "T-5": t - 5, "0": 0}[t_limit]
    g = torch.Generator().manual_seed(len(cols) + t)
    yt = torch.randn(t, b, generator=g).cumsum(0).contiguous()
    zb = torch.randint(0, t // 2, (b,), generator=g).float()
    beta = (0.1 * torch.randn(b, beta_m + 1, generator=g)).contiguous()
    ncols = int(ic) + lag_y + lag_e
    woff = beta_m + lag_e

    def sweep(build):
        acc = torch.full((ncols * (ncols + 1) // 2 + ncols, b), 7.0)
        assert ck._hr_moments_call(build, None, yt, zb, acc, lag_y, lag_e, ic,
                                   woff, beta_m, beta, tl) == 0
        return acc

    got = sweep(lib)
    assert torch.equal(got, sweep(emulated["hr-D0"]))
    _close(got.t(), ck.hr_moments_plain(yt, zb, lag_y, lag_e, ic, woff,
                                        beta_m, beta, tl))


def _lbfgs_state(b, d, m, k, seed):
    """A random optimizer state: rings partly valid (row 0 without history,
    some slots with rho <= 0), rows 1 and 2 done, row 3's f infinite."""
    g = torch.Generator().manual_seed(seed)
    x, grad = torch.randn(b, d, generator=g), torch.randn(b, d, generator=g)
    s = 0.2 * torch.randn(b, m, d, generator=g)
    y = s * (0.5 + torch.rand(b, m, 1, generator=g)) + 0.05 * torch.randn(
        b, m, d, generator=g)
    rho = 1.0 / (s * y).sum(-1)
    rho = torch.where(torch.rand(b, m, generator=g) < 0.3, -rho.abs(), rho)
    rho[0] = 0.0
    f = torch.randn(b, generator=g).abs() * 3
    f[3] = torch.inf
    conv, failed = torch.zeros(b, dtype=torch.bool), torch.zeros(
        b, dtype=torch.bool)
    conv[1], failed[2] = True, True
    return optim._State(x, f, grad, s, y, rho, conv, failed,
                        0.05 + torch.rand(b, generator=g), x.clone(), f + 0.01,
                        grad.clone(), torch.full((b,), k, dtype=torch.int32))


@pytest.mark.parametrize("d", [1, 3, 5, 11, 16])
@pytest.mark.parametrize("m", [3, 8, 16])
def test_lbfgs_kernels_source(kernels, d, m, monkeypatch):
    # the direction, two trials and the update, each capacity of d and m,
    # B not a multiple of the block, k wrapping the ring: the bits of the
    # plain versions summing in the kernels' order (both round every
    # operation once)
    monkeypatch.setattr(lk, "fused_ok", lambda x, m: True)
    b, k = 300, 2 * m + 1
    st = _lbfgs_state(b, d, m, k, seed=d * 31 + m)
    outs = {}
    for route in ("kernel", "plain"):
        flags = torch.tensor([5, 5], dtype=torch.int32)
        ring = [a.clone() for a in (st.s_hist, st.y_hist, st.rho_hist)]
        fn = (lk.lbfgs_direction if route == "kernel"
              else functools.partial(lk.lbfgs_direction_plain, lanes=True))
        dr = fn(st.x, st.f, st.g, *ring, st.tprev, st.converged, st.failed,
                k, 1e-6, flags)
        got = [*dr, flags.clone()]
        g = torch.Generator().manual_seed(d + m)
        for trial in (1, 2):
            fnew = st.f - 0.3 * torch.randn(b, generator=g)
            fnew[5] = torch.nan
            fn = lk.lbfgs_trial if route == "kernel" else lk.lbfgs_trial_plain
            fn(st.x, dr.direction, st.f, dr.gd, dr.eps, fnew, dr.t, dr.ok,
               dr.xt, flags, trial, 1e-4)
            got += [dr.t.clone(), dr.ok.clone(), dr.xt.clone(), flags.clone()]
        gn = st.g + 1.5 * (dr.xt - st.x)
        gn[6, 0] = torch.nan
        fn = (lk.lbfgs_update if route == "kernel"
              else functools.partial(lk.lbfgs_update_plain, lanes=True))
        got += [*fn(st.x, st.f, st.g, dr.xt, st.f - 0.2, gn, dr.t, dr.ok,
                    st.converged, st.failed, st.tprev, st.bx, st.bf, st.bg,
                    st.iters, *ring, k, 1e-4, 1e-6, flags), *ring, flags]
        outs[route] = got
    for a, e in zip(outs["kernel"], outs["plain"]):
        assert torch.equal(a, e)
    assert ck.OPTIM_LAUNCHES == {"lbfgs_direction": 1, "lbfgs_trial": 2,
                                 "lbfgs_update": 1}
    assert sum(ck.LAUNCHES.values()) == 0


def test_lbfgs_minimize_through_the_kernels_source(kernels, monkeypatch):
    # a whole run with compaction through the emulated kernels: the bits,
    # reads and trials of the plain route summing in the kernels' order
    g = torch.Generator().manual_seed(3)
    a = torch.randn(200, 3, 3, generator=g)
    a = a @ a.transpose(1, 2) + 0.5 * torch.eye(3)
    c = torch.randn(200, 3, generator=g)

    def f(x, idx=slice(None)):
        return 0.5 * torch.einsum("bi,bij,bj->b", x, a[idx], x) \
            - (c[idx] * x).sum(-1) + 0.1 * (x ** 4).sum(-1)

    x0 = torch.randn(200, 3, generator=g)
    monkeypatch.setattr(lk, "fused_ok", lambda x, m: True)
    runs = []
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(lk, "fused_ok", lambda x, m: False)
            for name in ("lbfgs_direction_plain", "lbfgs_update_plain"):
                monkeypatch.setattr(lk, name, functools.partial(
                    getattr(lk, name), lanes=True))
        reads = optim.host_reads.count
        res, info = optim.minimize_lbfgs_batched(
            f, x0, max_iters=60, count_evals=True, straggler_cap=64,
            straggler_fun=lambda idx: (lambda x: f(x, idx)))
        runs.append((res, info, optim.host_reads.count - reads))
    (rk, ik, nk), (rp, ip, np_) = runs
    assert ik["compact_at"] < 60 and nk == np_
    assert torch.equal(ik["ls_evals"], ip["ls_evals"])
    for a_, e in zip(rk, rp):
        assert torch.equal(a_, e)
    # one update a lockstep or straggler iteration, each with its trials
    assert ck.OPTIM_LAUNCHES["lbfgs_update"] == int((ik["ls_evals"] > 0).sum())

