"""Chrome-trace / Perfetto JSON export of a :class:`~repro_torch.obs.Telemetry`.

Emits the Chrome Trace Event Format (the JSON flavour Perfetto's
https://ui.perfetto.dev loads directly, as does ``chrome://tracing``):

  * every finished span is one complete event (``"ph": "X"``) with its
    category, thread id, microsecond start/duration, and attributes under
    ``args`` (plus the span's computed ``self_us``, so consumers never have
    to re-derive nesting);
  * every counter increment and gauge sample is one counter event
    (``"ph": "C"``) -- Perfetto renders them as stepped value tracks, and
    ``tools/trace_report.py`` rebuilds rate timelines (snapshots/sec) from
    the deltas.

Timestamps are microseconds relative to the telemetry epoch (process
collection start), kept as floats with nanosecond precision so strictly
nested spans never tie with their parents after conversion.
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .telemetry import Telemetry

__all__ = ["chrome_trace", "export"]


def _json_safe(value):
    """Coerce an attribute value to something ``json.dump`` accepts
    (numpy scalars and tuples show up from the engines)."""
    if isinstance(value, (str, bool, int, float)) or value is None:
        return value
    for attr in ("item",):                  # numpy scalar -> python scalar
        fn = getattr(value, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                break
    if isinstance(value, (list, tuple)):
        return [_json_safe(v) for v in value]
    return str(value)


def chrome_trace(tel: "Telemetry") -> dict:
    """Render ``tel``'s buffers as a Chrome-trace JSON object."""
    pid = os.getpid()
    epoch = tel.epoch_ns
    events = []
    tel._settle()
    with tel._lock:
        spans = list(tel.spans)
        counter_events = {k: list(v) for k, v in tel.counter_events.items()}
        gauges = {k: list(v) for k, v in tel.gauges.items()}
    for rec in spans:
        args = {k: _json_safe(v) for k, v in (rec.attrs or {}).items()}
        args["self_us"] = round(rec.self_ns / 1e3, 3)
        events.append({
            "name": rec.name, "cat": rec.cat, "ph": "X", "pid": pid,
            "tid": rec.tid, "ts": round((rec.start_ns - epoch) / 1e3, 3),
            "dur": round(rec.dur_ns / 1e3, 3), "args": args,
        })
    for name, series in counter_events.items():
        leaf = name.rsplit(".", 1)[-1]
        for t_ns, value in series:
            events.append({
                "name": name, "cat": "counter", "ph": "C", "pid": pid,
                "ts": round((t_ns - epoch) / 1e3, 3),
                "args": {leaf: value},
            })
    for name, series in gauges.items():
        leaf = name.rsplit(".", 1)[-1]
        for t_ns, value in series:
            events.append({
                "name": name, "cat": "gauge", "ph": "C", "pid": pid,
                "ts": round((t_ns - epoch) / 1e3, 3),
                "args": {leaf: value},
            })
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "repro_torch.obs",
                      "summary": tel.summary()},
    }


def export(tel: "Telemetry", path: str) -> str:
    """Serialize :func:`chrome_trace` to ``path``; returns ``path``."""
    trace = chrome_trace(tel)
    with open(path, "w") as f:
        json.dump(trace, f, separators=(",", ":"))
    return path
