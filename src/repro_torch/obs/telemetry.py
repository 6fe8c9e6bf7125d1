"""Zero-dependency telemetry core: spans, counters, and gauges.

One process-global :class:`Telemetry` handle (module-level ``TELEMETRY``,
re-exported as ``repro_torch.obs``'s function API) collects three primitives from
the engines' hot paths:

  * **spans** -- hierarchical timed regions (``with obs.span("sim.run_sweep",
    backend="jax"):``).  Nesting is tracked per thread, so every finished
    span knows its depth and its *self time* (duration minus the time spent
    in child spans) -- the quantity the trace report ranks by;
  * **counters** -- monotonic event counts (``obs.count("prng.masks", n)``);
    every increment is timestamped, so a counter is also a rate timeline;
    ``count_held`` keeps a device tensor's running sum on the device until
    the summary or an export reads it;
  * **gauges** -- point-in-time samples (``obs.gauge("prng.rss_mb", v)``),
    e.g. RSS during a million-snapshot stream.

The disabled path is a true no-op: ``span()`` returns one preallocated
``NULL_SPAN`` singleton after a single attribute check, and ``count`` /
``gauge`` return immediately -- no allocation, no locking, no timestamps.
Enabled-path overhead stays negligible because every instrumented site
operates at *block* granularity (one counter bump per engine step), never
per token.

Enabling: programmatic (``obs.enable()`` / ``obs.disable()``) or via the
``REPRO_TRACE`` environment variable (any value but ``0``/``false``/``off``
enables collection at import and registers an atexit export to
``REPRO_TRACE_PATH``, default ``repro.trace.json``) -- so
``REPRO_TRACE=1 python -m repro_torch.launch.serve`` drops a
Perfetto-loadable trace with zero code changes.  Export lives in
:mod:`repro_torch.obs.export`; ``tools/trace_report.py`` summarizes the file.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "NULL_SPAN", "Span", "SpanRecord", "Telemetry", "TELEMETRY",
    "configure_from_env", "rss_mb",
]


class _NullSpan:
    """The disabled-path span: a reusable, stateless no-op context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


#: The singleton every disabled ``span()`` call returns (identity-pinned by
#: the tests -- the no-op path must never allocate).
NULL_SPAN = _NullSpan()


class SpanRecord:
    """One finished span: the unit the exporter and summary consume."""

    __slots__ = ("name", "cat", "tid", "start_ns", "dur_ns", "self_ns",
                 "depth", "attrs")

    def __init__(self, name: str, cat: str, tid: int, start_ns: int,
                 dur_ns: int, self_ns: int, depth: int,
                 attrs: Optional[dict]):
        self.name = name
        self.cat = cat
        self.tid = tid
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.self_ns = self_ns
        self.depth = depth
        self.attrs = attrs


class Span:
    """A live (open) span; finished spans become :class:`SpanRecord`.

    Context-manager protocol only -- ``set(**attrs)`` attaches attributes
    any time before exit (the churn replay stamps each reconfiguration's
    latency and GPU delta after the replan runs).
    """

    __slots__ = ("_tel", "name", "cat", "attrs", "start_ns", "child_ns")

    def __init__(self, tel: "Telemetry", name: str, cat: str,
                 attrs: Optional[dict]):
        self._tel = tel
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.start_ns = 0
        self.child_ns = 0

    def set(self, **attrs) -> "Span":
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = self._tel._stack()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dur_ns = time.perf_counter_ns() - self.start_ns
        stack = self._tel._stack()
        # tolerate a disable() between enter and exit: only pop ourselves
        if stack and stack[-1] is self:
            stack.pop()
        depth = len(stack)
        if stack:
            stack[-1].child_ns += dur_ns
        self._tel._record(SpanRecord(
            self.name, self.cat, threading.get_ident(), self.start_ns,
            dur_ns, dur_ns - self.child_ns, depth, self.attrs))
        return False


def rss_mb() -> float:
    """Current peak RSS in MB (``ru_maxrss``); NaN where unavailable."""
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    except Exception:  # pragma: no cover - non-POSIX
        return float("nan")


class Telemetry:
    """Process-global telemetry collector.

    Thread-safe: finished spans, counter bumps and gauge samples append
    under one lock; the open-span stack is thread-local (each thread nests
    independently, all land in the same buffers with their ``tid``).
    """

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self.epoch_ns = time.perf_counter_ns()
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, float] = {}
        #: per-counter increment timeline: (t_ns, cumulative value)
        self.counter_events: Dict[str, List[Tuple[int, float]]] = {}
        self.gauges: Dict[str, List[Tuple[int, float]]] = {}
        #: counters whose running sums stay on a device until read
        self._held: Dict[str, Any] = {}

    # ------------------------------------------------------------ control

    def enable(self) -> "Telemetry":
        self.enabled = True
        return self

    def disable(self) -> "Telemetry":
        self.enabled = False
        return self

    def reset(self) -> "Telemetry":
        """Drop all collected data (state of ``enabled`` is unchanged)."""
        with self._lock:
            self.spans = []
            self.counters = {}
            self.counter_events = {}
            self.gauges = {}
            self._held = {}
            self.epoch_ns = time.perf_counter_ns()
        self._local = threading.local()
        return self

    # ---------------------------------------------------------- recording

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            self.spans.append(rec)

    def span(self, name: str, cat: str = "repro", **attrs):
        """Open a timed span (context manager).

        Disabled: returns the shared :data:`NULL_SPAN` singleton -- one
        attribute check, no allocation.
        """
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, attrs or None)

    def count(self, name: str, n: float = 1) -> None:
        """Bump monotonic counter ``name`` by ``n`` (timestamped)."""
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        with self._lock:
            total = self.counters.get(name, 0) + n
            self.counters[name] = total
            self.counter_events.setdefault(name, []).append((now, total))

    def count_held(self, name: str, n) -> None:
        """Bump counter ``name`` by ``n``, a 0-d tensor, without reading it:
        the running sum stays where ``n`` lives (added in place, no host
        sync) until :meth:`summary` or an export reads every held counter
        at once, as one increment each."""
        if not self.enabled:
            return
        with self._lock:
            held = self._held.get(name)
            if held is None:
                self._held[name] = n.detach().clone()
            else:
                held.add_(n)

    def _settle(self) -> None:
        """Read the held counters into the host counters."""
        with self._lock:
            held, self._held = self._held, {}
        now = time.perf_counter_ns()
        for name, n in held.items():
            with self._lock:
                total = self.counters.get(name, 0) + n.item()
                self.counters[name] = total
                self.counter_events.setdefault(name, []).append((now, total))

    def gauge(self, name: str, value: float) -> None:
        """Record one point-in-time sample of gauge ``name``."""
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        with self._lock:
            self.gauges.setdefault(name, []).append((now, float(value)))

    # ------------------------------------------------------------ summary

    def summary(self) -> dict:
        """Aggregate view: per-span-name totals, counter totals, gauge last.

        The same shape as the JAX package's ``repro.obs`` summary::

            {"enabled": bool,
             "spans": {name: {"count", "total_s", "self_s"}},
             "counters": {name: total},
             "gauges": {name: {"last", "max", "samples"}}}
        """
        self._settle()
        with self._lock:
            spans = list(self.spans)
            counters = dict(self.counters)
            gauges = {k: list(v) for k, v in self.gauges.items()}
        agg: Dict[str, List[float]] = {}
        for rec in spans:
            row = agg.setdefault(rec.name, [0, 0, 0])
            row[0] += 1
            row[1] += rec.dur_ns
            row[2] += rec.self_ns
        return {
            "enabled": self.enabled,
            "spans": {name: {"count": int(c),
                             "total_s": round(t / 1e9, 6),
                             "self_s": round(s / 1e9, 6)}
                      for name, (c, t, s) in sorted(agg.items())},
            "counters": {name: counters[name] for name in sorted(counters)},
            "gauges": {name: {"last": vals[-1][1],
                              "max": max(v for _, v in vals),
                              "samples": len(vals)}
                       for name, vals in sorted(gauges.items()) if vals},
        }

    # ------------------------------------------------------------- export

    def chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON object (see :mod:`repro_torch.obs.export`)."""
        from .export import chrome_trace
        return chrome_trace(self)

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path``; returns the path."""
        from .export import export
        return export(self, path)


#: The process-global handle every ``repro_torch.obs`` function delegates to.
TELEMETRY = Telemetry()


def _env_truthy(value: str) -> bool:
    return value.strip().lower() not in ("", "0", "false", "off", "no")


def configure_from_env(tel: Telemetry = TELEMETRY) -> bool:
    """Enable collection when ``REPRO_TRACE`` is set (and register an
    atexit export to ``REPRO_TRACE_PATH``, default ``repro.trace.json``).

    Called once at ``repro_torch.obs`` import; idempotent and cheap when the
    variable is unset.  Returns whether tracing was enabled.
    """
    if not _env_truthy(os.environ.get("REPRO_TRACE", "")):
        return False
    tel.enable()
    if not getattr(tel, "_atexit_registered", False):
        import atexit
        path = os.environ.get("REPRO_TRACE_PATH", "repro.trace.json")
        atexit.register(lambda: tel.spans and tel.export(path))
        tel._atexit_registered = True
    return True
