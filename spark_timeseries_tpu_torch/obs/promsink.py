"""Streaming Prometheus-textfile sink for the obs plane.

The flight recorder's JSONL stream is a post-mortem artifact; a RESIDENT
server needs its metrics scrapeable WHILE it runs.  The standard
zero-dependency bridge is the node-exporter *textfile collector*: a
process writes ``<name>.prom`` files in the text exposition format, the
exporter scrapes the directory.  :class:`PromTextfileSink` renders the
obs registry snapshot (counters / gauges / histograms) plus any
caller-supplied gauge map into that format and replaces the target file
ATOMICALLY (tmp + ``os.replace``), so a scraper never reads a torn file
— the journal's manifest discipline applied to metrics.

Name mapping (the contract ``validate_textfile`` enforces so a renamed
counter cannot silently vanish from dashboards):

- every metric name is prefixed ``ststpu_`` and sanitized to the
  Prometheus grammar (``[a-zA-Z_:][a-zA-Z0-9_:]*``; dots and dashes
  become underscores);
- counters keep their name (``# TYPE ... counter``);
- numeric gauges keep their name (``# TYPE ... gauge``); string-valued
  gauges (e.g. ``memory.source``) become ``<name>_info{value="..."} 1``;
- histograms emit ``<name>_count`` / ``<name>_sum`` (counter-style) and
  ``<name>_min`` / ``<name>_max`` / ``<name>_last`` gauges.

``tools/obs_report.py --check --prom FILE`` runs :func:`validate_textfile`
against the event stream's final metrics snapshot: the file must parse,
every family must be well-formed, and every registry metric must be
present under its mapped name.
"""

from __future__ import annotations

import math
import os
import re
import threading
from typing import Dict, Iterable, Optional

__all__ = ["PromTextfileSink", "expected_families", "prom_name",
           "render_textfile", "validate_textfile"]

PREFIX = "ststpu"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?\s+(?P<value>\S+)(\s+\d+)?$")
_LABELS = re.compile(r'^\{\s*([a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
                     r'(\s*,\s*[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*'
                     r'\s*,?\s*)?\}$')


def prom_name(name: str, prefix: str = PREFIX) -> str:
    """Map an obs metric name onto the Prometheus grammar."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", str(name))
    if prefix:
        out = f"{prefix}_{out}"
    if not _NAME_OK.match(out):
        out = "_" + out
    return out


def _fmt(v) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _esc(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def expected_families(snapshot: Optional[dict],
                      extra: Optional[Dict[str, float]] = None,
                      prefix: str = PREFIX) -> Dict[str, str]:
    """``{family_name: type}`` the sink MUST emit for this registry
    snapshot (+ caller gauges) — the checkable contract between the
    registry and the dashboards."""
    fams: Dict[str, str] = {}
    snap = snapshot or {}
    for name in (snap.get("counters") or {}):
        fams[prom_name(name, prefix)] = "counter"
    for name, v in (snap.get("gauges") or {}).items():
        base = prom_name(name, prefix)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            fams[base] = "gauge"
        elif v is not None:
            fams[base + "_info"] = "gauge"
    for name in (snap.get("histograms") or {}):
        base = prom_name(name, prefix)
        # _min/_max/_last are deliberately NOT required: an empty
        # histogram (count 0) has no extrema to export
        fams[base + "_count"] = "counter"
        fams[base + "_sum"] = "counter"
    for name in (extra or {}):
        fams[prom_name(name, prefix)] = "gauge"
    return fams


def render_textfile(snapshot: Optional[dict],
                    extra: Optional[Dict[str, float]] = None,
                    prefix: str = PREFIX) -> str:
    """The exposition text for a registry snapshot (+ extra gauges)."""
    lines = []
    emitted: set = set()

    def family(name: str, kind: str, samples: Iterable[tuple]) -> None:
        # one declaration per family: a caller gauge that shadows a
        # registry metric of the same mapped name is skipped (the obs
        # plane is authoritative; the server refreshes its registry
        # gauges before each sink write)
        if name in emitted:
            return
        emitted.add(name)
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in samples:
            lines.append(f"{name}{labels} {value}")

    snap = snapshot or {}
    for name, v in sorted((snap.get("counters") or {}).items()):
        family(prom_name(name, prefix), "counter", [("", _fmt(v))])
    for name, v in sorted((snap.get("gauges") or {}).items()):
        base = prom_name(name, prefix)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            family(base, "gauge", [("", _fmt(v))])
        elif v is not None:
            family(base + "_info", "gauge",
                   [('{value="%s"}' % _esc(v), "1")])
    for name, h in sorted((snap.get("histograms") or {}).items()):
        base = prom_name(name, prefix)
        h = h or {}
        family(base + "_count", "counter", [("", _fmt(h.get("count", 0)))])
        family(base + "_sum", "counter", [("", _fmt(h.get("sum", 0.0)))])
        for suffix, key in (("_min", "min"), ("_max", "max"),
                            ("_last", "last")):
            if h.get(key) is not None:
                family(base + suffix, "gauge", [("", _fmt(h[key]))])
    for name, v in sorted((extra or {}).items()):
        family(prom_name(name, prefix), "gauge", [("", _fmt(v))])
    return "\n".join(lines) + ("\n" if lines else "")


class PromTextfileSink:
    """Write the current metrics to ``path`` atomically on every
    :meth:`write` — the resident server calls it after each batch (and on
    idle ticks), so the textfile always reflects a recent state and never
    a torn one."""

    # lock-discipline contract (tools/lint lock-map): the serve loop and
    # forced final writes (stop()) may overlap; one writer at a time.
    _protected_by_ = {"writes": "_lock"}

    def __init__(self, path: str, prefix: str = PREFIX):
        self.path = os.path.abspath(path)
        self.prefix = prefix
        self.writes = 0
        self._lock = threading.Lock()
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    def write(self, snapshot: Optional[dict] = None,
              extra: Optional[Dict[str, float]] = None) -> str:
        """Render and atomically replace the textfile.  ``snapshot``
        defaults to the live obs registry (None when the plane is
        disabled — the caller's ``extra`` gauges still export, so a
        server without the obs plane on remains scrapeable)."""
        if snapshot is None:
            from . import core

            snapshot = core.snapshot()
        extra = dict(extra or {})
        with self._lock:
            self.writes += 1
            extra.setdefault("sink_writes_total", float(self.writes))
            text = render_textfile(snapshot, extra, self.prefix)
            tmp = f"{self.path}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(text)
            os.replace(tmp, self.path)
        return self.path


def validate_textfile(path: str, snapshot: Optional[dict] = None,
                      prefix: str = PREFIX) -> list:
    """Validate a sink textfile; returns a list of error strings (empty =
    valid).

    Checks (the ``obs_report --check --prom`` gate):

    - the file parses line-by-line as text exposition format (``# TYPE``
      headers, samples ``name{labels} value``, valid names/labels/values);
    - every sample belongs to a declared ``# TYPE`` family;
    - with ``snapshot`` (a registry dump — ``obs.snapshot()`` or the
      event stream's final ``metrics`` line): every registry metric's
      mapped family is PRESENT in the file, so a renamed or dropped
      counter fails the gate instead of silently vanishing from
      dashboards.
    """
    errors: list = []
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError as e:
        return [f"cannot read {path}: {e}"]
    declared: Dict[str, str] = {}
    seen: set = set()
    for i, line in enumerate(lines, 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) != 4:
                    errors.append(f"line {i}: malformed TYPE line: {line!r}")
                    continue
                _, _, fam, kind = parts
                if not _NAME_OK.match(fam):
                    errors.append(f"line {i}: invalid family name {fam!r}")
                if kind not in ("counter", "gauge", "histogram", "summary",
                                "untyped"):
                    errors.append(f"line {i}: invalid family type {kind!r}")
                if fam in declared:
                    errors.append(f"line {i}: family {fam!r} declared twice")
                declared[fam] = kind
            continue  # HELP/comments pass through
        m = _SAMPLE.match(line.strip())
        if not m:
            errors.append(f"line {i}: not a valid sample: {line!r}")
            continue
        name, labels, value = (m.group("name"), m.group("labels"),
                               m.group("value"))
        if labels and not _LABELS.match(labels):
            errors.append(f"line {i}: malformed labels {labels!r}")
        try:
            float(value.replace("+Inf", "inf").replace("-Inf", "-inf"))
        except ValueError:
            errors.append(f"line {i}: non-numeric sample value {value!r}")
        fam = name
        for suffix in ("_bucket", "_count", "_sum"):
            if name.endswith(suffix) and name[: -len(suffix)] in declared:
                fam = name[: -len(suffix)]
                break
        if fam not in declared:
            errors.append(f"line {i}: sample {name!r} has no TYPE "
                          "declaration")
        seen.add(name)
    if snapshot is not None:
        for fam, kind in expected_families(snapshot,
                                           prefix=prefix).items():
            if fam not in seen and fam not in declared:
                errors.append(
                    f"registry metric missing from textfile: {fam} "
                    f"({kind}) — a renamed/dropped metric would silently "
                    "vanish from dashboards")
            elif declared.get(fam) not in (kind, None):
                errors.append(f"family {fam}: textfile type "
                              f"{declared.get(fam)!r} != registry-derived "
                              f"type {kind!r}")
    return errors
