"""One run of one benchmark cell of spark_timeseries_tpu_torch.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with the card(s) the cell
asks for.  Prints each number that decides ``correct`` beside its limit
as the last lines of standard error, and one JSON object as the last line
of standard output.  Exits non-zero, with no result, without the cards,
or if the JAX package (or JAX) was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
CACHE = BENCH / ".cache"


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library may load JAX on its own."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(CHECKOUT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def _time_builds(build_module) -> list:
    """Wrap the program's library build (``nvcc``) with a clock: the
    returned one-item list sums the seconds it took in this process
    (``None`` where the program has no such function)."""
    real = getattr(build_module, "build_all", None)
    if real is None:
        return None
    spent = [0.0]

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            spent[0] += time.perf_counter() - t0

    build_module.build_all = timed
    return spent


def _fmt(v) -> str:
    return repr(v) if isinstance(v, float) and math.isfinite(v) else str(v)


def _clean(x):
    """JSON-safe: a non-finite float becomes the string "inf" / "nan"."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_clean(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from benchlib import spec
    cell = spec.Cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda:0")
    torch.cuda.synchronize()
    print(f"imports and CUDA context {time.perf_counter() - T_PROCESS:.3f} s",
          file=sys.stderr, flush=True)
    from spark_timeseries_tpu_torch.utils import compile_cache
    compile_cache.enable_compile_cache(str(CACHE / "kernels"))
    from spark_timeseries_tpu_torch.ops import _build
    built = _time_builds(_build)

    from benchlib import runner
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", T_PROCESS)
    found = runner.forbidden_modules()
    if found:
        print(f"run.py: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    out["card"] = _card_line()
    out["kernel_cache"] = compile_cache.program_cache_stats()
    # the first run in a checkout builds the kernel libraries inside its
    # set-up: setup_s counts that, and build_s says how much of it it was
    out["build_s"] = built[0] if built is not None else None
    print(f"kernel library builds {out['build_s']} s inside the set-up "
          f"({out['kernel_cache']})", file=sys.stderr)
    checks = out.pop("checks")
    out["checks"] = checks  # the last key of the line
    print(f"correct = {out['correct']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {_fmt(c['value'])} limit {_fmt(c['limit'])}",
              file=sys.stderr)
    print(json.dumps(_clean(out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
