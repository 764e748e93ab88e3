"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, a shared
library with a plain C interface (no PyTorch headers, so a source builds in
seconds).  The hash covers the source, the shared headers and the flags, so
an edited source is rebuilt at its next use and an unchanged one is loaded
as built.  :func:`build_all` starts one ``nvcc`` per source at once.  A
variant of a source built with extra ``-D`` macros (the ring depths of
``garch.cu``, ``hw.cu``, ``hr.cu`` and ``fill.cu``, the tile of
``autocorr.cu``) is a library of its own, keyed by them too; the wrappers
load the plain build.

Each library counts once a process in ``utils.compile_cache`` (which can
also move :data:`BUILD_DIR` to a persistent cache directory): a miss when
this process runs ``nvcc`` for it, a hit when :func:`load` first finds it
built on disk by an earlier run.  Later loads of a loaded library are not
lookups and count nothing.

A failed build raises: nothing here falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils import compile_cache

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("css", "hr", "fill", "autocorr", "garch", "ewma", "hw")
# -Xptxas=-v: the build log reports each kernel's registers and spills
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures: every device pointer and the stream are void*, sizes int,
# host arrays int*
SIGNATURES = {
    "css": {
        "sts_css_fwd": [_P] * 6 + [_I] * 4 + [_IP, _I, _I, _I, _I, _P],
        "sts_css_bwd": [_P] * 7 + [_I] * 4 + [_IP, _I, _I, _I, _I, _P],
        "sts_css_route": [_I, _I, _IP, _I, _I],
        "sts_css_lag_occupancy": [_I, _P, _P],
    },
    "hr": {
        "sts_hr_moments": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
        "sts_hr_ring_depth": [],
        "sts_hr_occupancy": [_P, _P],
    },
    "fill": {
        "sts_fill_chain": [_P, _P, _P, _P, _I, _I, _P],
        "sts_fill_ring_depth": [],
        "sts_fill_occupancy": [_P, _P],
    },
    "autocorr": {
        "sts_autocorr": [_P, _P, _I, _I, _I, _P],
        "sts_autocorr_route": [_I, _I],
        "sts_autocorr_tile": [],
        "sts_autocorr_occupancy": [_I, _I, _P, _P],
    },
    "garch": {
        "sts_garch_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "sts_garch_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _P],
        "sts_garch_ring_depth": [],
        "sts_garch_check_divide": [ctypes.c_ulonglong, ctypes.c_ulonglong,
                                   _P, _P, _P],
        "sts_garch_occupancy": [_I, _P, _P],
    },
    "ewma": {
        "sts_ewma_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        "sts_ewma_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
    "hw": {
        "sts_hw_fwd": [_P] * 13 + [_I] * 5 + [_P],
        "sts_hw_bwd": [_P] * 12 + [_I] * 4 + [_P],
        "sts_hw_ring_in_registers": [_I],
        "sts_hw_ring_layout": [_I, _P, _P],
        "sts_hw_occupancy": [_I, _I, _I, _P, _P],
        "sts_hw_check_divide": [ctypes.c_ulonglong, ctypes.c_ulonglong, _P,
                                _P, _P],
    },
}

_lock = threading.Lock()
_libs: dict = {}
# library files already counted in utils.compile_cache by this process
_counted: set = set()


def nvcc() -> str:
    """Path of ``nvcc`` (``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH)."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(name: str, defines=()) -> str:
    h = hashlib.sha256(" ".join(FLAGS + _dflags(defines)).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _dflags(defines) -> tuple:
    return tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines=()) -> Path:
    """Where the library of ``csrc/<name>.cu`` built with ``defines`` is
    (or will be)."""
    tag = "".join(f"-{d}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{_digest(name, defines)}.so"


def _start(name: str, defines, out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, *_dflags(defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=SOURCES, variants=()) -> dict:
    """Build every stale library at once (one ``nvcc`` per source, and one
    per ``(name, defines)`` of ``variants``) -> ``{library file: compiler
    log}`` for the libraries it built."""
    logs = {}
    wanted = [(n, ()) for n in names] + [(n, tuple(d)) for n, d in variants]
    jobs = [_start(n, d, t) for n, d in wanted
            if not (t := library_path(n, d)).is_file()]
    for _, _, out in jobs:
        _counted.add(out)
        compile_cache.note_miss()
    try:
        for proc, tmp, out in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, out)  # atomic: never a half-written library
            logs[out.name] = log
    finally:
        for proc, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return logs


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built with ``-D`` of each
    of ``defines``), built on first use, with every function's
    ``argtypes`` / ``restype`` declared."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            out = library_path(*key)
            if not out.is_file():
                build_all((), (key,))  # counts the miss
            elif out not in _counted:  # built on disk by an earlier run
                _counted.add(out)
                compile_cache.note_hit()
            lib = ctypes.CDLL(str(out))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[key] = lib
        return lib
