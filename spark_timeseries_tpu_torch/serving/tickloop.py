"""Tick-to-forecast streaming loop (port of ``serving/tickloop.py``).

Everything below this module already knows how to do its step of the
market-data story durably: shard dirs append new time columns
idempotently (``write_npz_shards(append_time=..., expect_time=...)``),
``fit_chunked(delta_from=...)`` warm-refits a grown panel from the
previous fit's journal, and ``forecast_chunked(sink=...)`` streams the
packed forecasts straight into durable output shards without ever
holding the panel's results in RAM.  :class:`TickLoop` is the daemon
that strings them into ONE journaled cycle::

    tick batch -> record -> append -> delta-warm refit -> forecast
               -> publish (write-back sink)

Each cycle lives under ``<root>/cycle_%05d/`` with a durable
``tick_manifest.json`` recording the stage progression
(``ticked -> appended -> fitted -> published``), per-stage walls, and
the delta adoption counts.  The tick batch itself is recorded durably
(``ticks.npz``) BEFORE anything mutates the data dir, so a SIGKILL at
ANY point — mid-append (some shards grown, some not), mid-fit,
mid-publish — resumes from the recorded ticks and finishes the cycle
bitwise-identical to an uninterrupted run: the append is
width-gated idempotent, the fit and forecast walks replay their chunk
journals, and the write-back sink re-emits committed spans through
``durable_replace`` with the same bytes.

The loop is the serving layer's ingestion twin: ``FitServer`` answers
"fit this panel now"; ``TickLoop`` answers "the panel grew again" —
forever, at O(chunk) incremental cost per cycle.  The refit and the
forecast run on ``device`` (default ``"cuda"``): each chunk is staged
there from the shard directory, and the fits and forecasts launch the
CUDA kernels.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import List, NamedTuple, Optional

import numpy as np

from .. import obs
from ..forecasting import walk as walk_mod
from ..reliability import journal as journal_mod
from ..reliability import sink as sink_mod
from ..reliability import source as source_mod

__all__ = ["TickLoop", "TickLoopError", "CycleResult",
           "TICKLOOP_MANIFEST", "CYCLE_MANIFEST", "TICKLOOP_VERSION"]

TICKLOOP_MANIFEST = "tickloop.json"
CYCLE_MANIFEST = "tick_manifest.json"
TICKLOOP_VERSION = 1

_CYCLE_DIR_RE = re.compile(r"^cycle_(\d{5})$")


class TickLoopError(RuntimeError):
    """The tick-loop root is torn, stale, or fed inconsistent ticks."""


class CycleResult(NamedTuple):
    """One completed cycle: where its forecasts landed + accounting."""

    cycle: int
    published_dir: str
    manifest_path: str
    meta: dict


def _write_json_atomic(path: str, payload: dict) -> None:
    journal_mod._atomic_write_bytes(
        path, (json.dumps(payload, indent=1, sort_keys=True)
               + "\n").encode())


def _load_json(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise TickLoopError(
            f"{path} does not parse ({e}); a crash tore the write — "
            "inspect/remove it explicitly.") from e


class TickLoop:
    """Durable append -> delta-refit -> forecast -> publish cycles.

    ``data_dir`` is an npz or parquet shard directory holding the
    panel; it is the ONLY mutable input state, and only grows (columns
    appended, never revised).  ``root`` holds the loop's own durable
    record: ``tickloop.json`` (loop identity — reopened loops must
    match it) and one ``cycle_%05d/`` per tick batch.

    Each :meth:`run_cycle` call first finishes any incomplete prior
    cycle from its recorded ticks (:meth:`resume`), then runs the new
    batch end to end.  Publishing streams through a write-back sink:
    the packed forecasts land as durable ``out_*.npz`` shards under
    ``cycle_%05d/published`` and are readable back with
    ``NpzShardSource(published_dir, key="params")`` — the loop never
    materializes a full forecast panel on the host.  ``device`` is where
    the refit and the forecast run.
    """

    def __init__(self, root: str, data_dir: str, *,
                 model: str = "arima",
                 model_kwargs: Optional[dict] = None,
                 fit_kwargs: Optional[dict] = None,
                 horizon: int = 8,
                 intervals: bool = False,
                 level: float = 0.9,
                 n_samples: int = 256,
                 seed: Optional[int] = None,
                 chunk_rows: Optional[int] = None,
                 pipeline: bool = True,
                 delta: bool = True,
                 device="cuda"):
        from ..forecasting import backtest as backtest_mod
        from ..forecasting import kernels

        self.root = os.path.abspath(root)
        self.data_dir = os.path.abspath(data_dir)
        os.makedirs(self.root, exist_ok=True)
        src = source_mod.as_source(self.data_dir)
        b, t0 = int(src.shape[0]), int(src.shape[1])
        self._layout = ("parquet" if src.kind.startswith("parquet")
                        else "npz")
        cfg = dict(kernels.normalize_model_kwargs(model,
                                                  model_kwargs or {}))
        self.model = model
        self.model_kwargs = dict(cfg)
        self.fit_kwargs = dict(fit_kwargs or {})
        self.horizon = int(horizon)
        self.intervals = bool(intervals)
        self.level = float(level)
        self.n_samples = int(n_samples)
        self.seed = seed
        self.chunk_rows = chunk_rows
        self.pipeline = bool(pipeline)
        self.delta = bool(delta)
        self.device = str(device)
        self._fit_fn = backtest_mod._model_fit_fn(model, cfg,
                                                  dict(self.fit_kwargs))
        config = {
            "model": model, "model_kwargs": repr(sorted(cfg.items())),
            "fit_kwargs": repr(sorted(self.fit_kwargs.items())),
            "horizon": self.horizon, "intervals": self.intervals,
            "level": self.level if self.intervals else None,
            "n_samples": self.n_samples if self.intervals else None,
            "seed": seed,
            "chunk_rows": (int(chunk_rows) if chunk_rows else None),
        }
        mp = os.path.join(self.root, TICKLOOP_MANIFEST)
        prior = _load_json(mp)
        if prior is not None:
            bad = []
            if prior.get("kind") != "tickloop":
                bad.append("kind")
            if int(prior.get("n_rows", -1)) != b:
                bad.append("n_rows")
            if prior.get("config") != config:
                bad.append("config")
            if bad:
                raise TickLoopError(
                    f"{mp} was written by a different loop "
                    f"({', '.join(bad)} mismatch); resuming would splice "
                    "foreign cycles — use a fresh root or remove the "
                    "stale one explicitly.")
            self._manifest = prior
        else:
            self._manifest = {
                "kind": "tickloop",
                "tickloop_version": TICKLOOP_VERSION,
                "created_at": time.time(),
                "data_dir": self.data_dir,
                "layout": self._layout,
                "n_rows": b,
                "n_time0": t0,
                "config": config,
            }
            _write_json_atomic(mp, self._manifest)

    # -- cycle bookkeeping ---------------------------------------------------

    def _cycles(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            m = _CYCLE_DIR_RE.match(name)
            if m is not None:
                out.append(int(m.group(1)))
        return sorted(out)

    def _cycle_dir(self, i: int) -> str:
        return os.path.join(self.root, f"cycle_{i:05d}")

    def _cycle_manifest(self, i: int) -> Optional[dict]:
        return _load_json(os.path.join(self._cycle_dir(i), CYCLE_MANIFEST))

    def _t_before(self, i: int) -> int:
        """Panel width when cycle ``i`` started: the initial width plus
        every earlier cycle's recorded tick count — derived from the
        durable chain, never from the (possibly torn mid-append) data
        dir."""
        t = int(self._manifest["n_time0"])
        for j in self._cycles():
            if j >= i:
                break
            m = self._cycle_manifest(j)
            if m is None:
                raise TickLoopError(
                    f"cycle {j} has no {CYCLE_MANIFEST}; the cycle chain "
                    "is torn — resume cycles in order.")
            t += int(m["n_ticks"])
        return t

    # -- the cycle ----------------------------------------------------------

    def resume(self) -> Optional[CycleResult]:
        """Finish the last cycle if a crash left it incomplete.

        A cycle dir without a durable ``ticks.npz`` recorded nothing —
        the batch never happened, the dir is swept, and the feed's
        redelivery becomes a fresh cycle.  With the record present, the
        cycle re-executes from the recorded ticks; every stage is
        idempotent, so the result is bitwise what an uninterrupted run
        would have published.
        """
        cycles = self._cycles()
        if not cycles:
            return None
        i = cycles[-1]
        tick_path = os.path.join(self._cycle_dir(i), "ticks.npz")
        if not os.path.exists(tick_path):
            shutil.rmtree(self._cycle_dir(i), ignore_errors=True)
            return None
        m = self._cycle_manifest(i)
        if m is not None and m.get("stage") == "published":
            return None
        with np.load(tick_path, allow_pickle=False) as z:
            ticks = np.array(z["ticks"])
        obs.event("tickloop.resume", cycle=i)
        return self._execute(i, ticks)

    def run_cycle(self, ticks) -> CycleResult:
        """Ingest one tick batch ``[B, n_ticks]`` end to end."""
        self.resume()
        ticks = np.asarray(ticks)
        if ticks.ndim != 2 or ticks.shape[0] != int(
                self._manifest["n_rows"]):
            raise TickLoopError(
                f"tick batch must be [n_rows={self._manifest['n_rows']}, "
                f"n_ticks], got {ticks.shape}")
        cycles = self._cycles()
        i = (cycles[-1] + 1) if cycles else 0
        return self._execute(i, ticks)

    def serve(self, feed, max_cycles: Optional[int] = None
              ) -> List[CycleResult]:
        """Drain an iterable of tick batches through :meth:`run_cycle`."""
        out = []
        for ticks in feed:
            out.append(self.run_cycle(ticks))
            if max_cycles is not None and len(out) >= max_cycles:
                break
        return out

    def _execute(self, i: int, ticks: np.ndarray) -> CycleResult:
        from ..reliability import fit_chunked

        cdir = self._cycle_dir(i)
        os.makedirs(cdir, exist_ok=True)
        mp = os.path.join(cdir, CYCLE_MANIFEST)
        t_before = self._t_before(i)
        digest = journal_mod.panel_fingerprint(ticks)
        manifest = self._cycle_manifest(i)

        # stage 1 — record the batch durably BEFORE touching the data
        # dir: the recorded ticks are what every later stage (and every
        # resume) consumes, so the cycle's bytes are pinned here
        tick_path = os.path.join(cdir, "ticks.npz")
        if not os.path.exists(tick_path):
            self._write_ticks(tick_path, ticks)
        if manifest is None:
            manifest = {
                "kind": "tickloop_cycle",
                "tickloop_version": TICKLOOP_VERSION,
                "cycle": i,
                "t_before": t_before,
                "n_ticks": int(ticks.shape[1]),
                "ticks_digest": digest,
                "stage": "ticked",
                "walls": {},
            }
            _write_json_atomic(mp, manifest)
        elif manifest.get("ticks_digest") != digest:
            raise TickLoopError(
                f"cycle {i} already recorded a different tick batch "
                f"({manifest.get('ticks_digest')} != {digest}); a feed "
                "must redeliver the SAME batch to an incomplete cycle.")

        # stage 2 — width-gated idempotent append: shards already at
        # t_before + n_ticks are skipped, shards still at t_before are
        # grown, anything else (a foreign writer) is rejected
        if manifest.get("stage") == "ticked":
            t0 = time.perf_counter()
            writer = (source_mod.write_parquet_shards
                      if self._layout == "parquet"
                      else source_mod.write_npz_shards)
            writer(self.data_dir, ticks, append_time=True,
                   expect_time=t_before)
            manifest["stage"] = "appended"
            manifest["walls"]["append_s"] = round(
                time.perf_counter() - t0, 4)
            _write_json_atomic(mp, manifest)

        # stage 3 — delta-warm refit of the grown panel: every chunk's
        # content changed (new columns), so the previous cycle's journal
        # warm-starts all of them; the fit's own chunk journal makes
        # this stage resumable mid-walk
        src = source_mod.as_source(self.data_dir)
        fit_dir = os.path.join(cdir, "fit")
        if manifest.get("stage") in ("appended", "ticked"):
            t0 = time.perf_counter()
            prev_fit = (os.path.join(self._cycle_dir(i - 1), "fit")
                        if i > 0 else None)
            delta_from = (prev_fit if self.delta and prev_fit
                          and os.path.exists(
                              os.path.join(prev_fit, "manifest.json"))
                          else None)
            fit_res = fit_chunked(
                self._fit_fn, src, resilient=False,
                checkpoint_dir=fit_dir, delta_from=delta_from,
                chunk_rows=self.chunk_rows, pipeline=self.pipeline,
                journal_extra={"tickloop": {"cycle": i,
                                            "t_before": t_before}},
                device=self.device)
            manifest["stage"] = "fitted"
            manifest["walls"]["fit_s"] = round(
                time.perf_counter() - t0, 4)
            if "delta" in fit_res.meta:
                manifest["delta_counts"] = fit_res.meta["delta"]["counts"]
            manifest["fit_status_counts"] = fit_res.meta.get(
                "status_counts")
            _write_json_atomic(mp, manifest)

        # stage 4 — forecast the grown panel and publish through the
        # write-back sink: packed forecasts stream to durable out_*.npz
        # shards, O(chunk) host footprint, torn writes invisible
        pub_dir = os.path.join(cdir, "published")
        if manifest.get("stage") == "fitted":
            t0 = time.perf_counter()
            fres = walk_mod.forecast_chunked(
                self.model, fit_dir, src, self.horizon,
                model_kwargs=self.model_kwargs,
                intervals=self.intervals, level=self.level,
                n_samples=self.n_samples, seed=self.seed,
                chunk_rows=self.chunk_rows,
                checkpoint_dir=os.path.join(cdir, "forecast"),
                pipeline=self.pipeline,
                sink=sink_mod.WritableChunkSource(pub_dir),
                device=self.device)
            manifest["stage"] = "published"
            manifest["walls"]["publish_s"] = round(
                time.perf_counter() - t0, 4)
            manifest["published"] = {
                "rows": int(self._manifest["n_rows"]),
                "pack_width": self.horizon * (3 if self.intervals
                                              else 1),
                "status_counts": fres.meta["forecast"]["status_counts"],
                "sink": {key: fres.meta["sink"][key]
                         for key in ("writes", "spans", "bytes_written",
                                     "peak_in_flight_bytes")},
            }
            _write_json_atomic(mp, manifest)
            obs.counter("tickloop.cycles").inc()
            obs.event("tickloop.published", cycle=i,
                      n_ticks=int(ticks.shape[1]),
                      t_after=t_before + int(ticks.shape[1]))
        return CycleResult(i, pub_dir, mp, dict(manifest))

    # -- reads ---------------------------------------------------------------

    def published_forecast(self, cycle: Optional[int] = None):
        """Load one cycle's published forecasts: ``(point, lo, hi)``.

        Reads the sink's output shards back through the ordinary source
        layer — the published artifact is just another shard dir."""
        if cycle is None:
            done = [j for j in self._cycles()
                    if (self._cycle_manifest(j) or {}).get("stage")
                    == "published"]
            if not done:
                raise TickLoopError("no published cycle yet")
            cycle = done[-1]
        src = source_mod.NpzShardSource(
            os.path.join(self._cycle_dir(cycle), "published"),
            key="params")
        b, w = int(src.shape[0]), int(src.shape[1])
        pack = np.empty((b, w), src.dtype)
        step = max(1, int(src.default_chunk_rows or 4096))
        for lo in range(0, b, step):
            hi = min(lo + step, b)
            src.read_rows(lo, hi, pack[lo:hi])
        return walk_mod.split_forecast(pack, self.horizon, self.intervals)

    def _write_ticks(self, path: str, ticks: np.ndarray) -> None:
        import tempfile

        d = os.path.dirname(path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=".npz")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, ticks=np.ascontiguousarray(ticks))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
