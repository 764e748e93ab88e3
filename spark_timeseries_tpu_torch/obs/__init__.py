"""Runtime telemetry plane: spans, metrics, flight recorder (port of
``obs/``).

Zero-dependency and **off by default** — when disabled every call returns a
shared no-op object, adds no events, and leaves fit results bitwise
identical to the uninstrumented code:

- :mod:`.core` — nested wall/process-time **spans**
  (``obs.span("fit.primary", rows=...)``), first-dispatch tagging, run
  summaries and failure dumps; ``profile=True`` mirrors spans into
  ``torch.profiler.record_function`` ranges.  Spans read the host clock
  and never synchronize the device.
- :mod:`.metrics` — the **registry** of counters / gauges / histograms
  the instrumented paths feed: ladder-rung counts, sanitizer actions,
  watchdog timeouts, straggler compactions, alignment probes, kernel
  library builds and loads.
- :mod:`.recorder` — the bounded ring-buffer **flight recorder**: every
  span/event lands in a ring (and, when enabled with a path, a flushed
  JSONL stream, schema v2, that ``tools/obs_report.py`` renders and
  checks), and a fit failure dumps the tail for post-mortems.
- :mod:`.memory` — peak-memory probe: the CUDA caching allocator's peak,
  with a host peak-RSS fallback labelled as such.
- :mod:`.tracing` — deterministic trace contexts (sha256 of the request
  id, never random), carried on a thread-local and stamped onto every
  recorder line as a top-level ``trace`` object; the ids are the
  reference package's bit for bit.
- :mod:`.promsink` — Prometheus-textfile sink: the registry snapshot
  rendered to the node-exporter textfile format with atomic replace;
  ``validate_textfile`` is the ``obs_report --check --prom`` gate.

Usage::

    from spark_timeseries_tpu_torch import obs
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.reliability import resilient_fit

    obs.enable("run.jsonl")           # or STSTPU_OBS=1 in the environment
    res = resilient_fit(arima.fit, y, order=(1, 1, 1))
    obs.disable()                     # final metrics snapshot -> JSONL

Instrumented surfaces: ``reliability.resilient_fit`` / ``sanitize`` /
``watchdog``, ``models.base.align_mode_on_host``, ``models.arima.fit_grid``;
the fits of ``models.arima`` (plain and seasonal), ``models.garch``
(``fit``, ``fit_argarch``) and ``models.holtwinters`` (``fit.<model>``
spans, with ``fit.prep`` and ``fit.finalize`` inside, and the
``work.objective_row_steps`` counter in each objective); ``utils.optim``'s
L-BFGS loop (``optim.*`` spans, ``optim.host_read`` around each counted
device read, the ``work.row_evals`` / ``work.live_row_evals`` counters,
the straggler compaction); ``ops.univariate``'s fill chain and batched
autocorrelation (``transforms.*`` spans); and the kernel library loader
(``ops._build``: ``kernels.build`` spans and the build clock, through
``utils.compile_cache``).
"""

from . import core, memory, metrics, promsink, recorder, tracing
from .core import (NULL_SPAN, Span, counter, disable, dump_failure,
                   dump_on_failure, emit_metrics, enable, enable_from_env,
                   enabled, event, first_dispatch, gauge, histogram,
                   last_crash_dump, snapshot, span, stream_path, summary)
from .memory import PeakMemory, peak_memory, register_staging_pool
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .promsink import PromTextfileSink
from .recorder import SCHEMA_VERSION, FlightRecorder
from .tracing import (TraceContext, trace_for_request, trace_from_wire,
                      trace_scope, trace_to_wire)
from .tracing import current as current_trace

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "PeakMemory",
    "PromTextfileSink",
    "SCHEMA_VERSION",
    "Span",
    "TraceContext",
    "core",
    "counter",
    "current_trace",
    "disable",
    "dump_failure",
    "dump_on_failure",
    "emit_metrics",
    "enable",
    "enable_from_env",
    "enabled",
    "event",
    "first_dispatch",
    "gauge",
    "histogram",
    "last_crash_dump",
    "memory",
    "metrics",
    "peak_memory",
    "promsink",
    "recorder",
    "register_staging_pool",
    "snapshot",
    "span",
    "stream_path",
    "summary",
    "trace_for_request",
    "trace_from_wire",
    "trace_scope",
    "trace_to_wire",
    "tracing",
]

# opt-in without code changes (no-op unless STSTPU_OBS=1)
enable_from_env()
