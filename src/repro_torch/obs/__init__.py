"""``repro_torch.obs``: zero-dependency telemetry, a copy of ``repro.obs``.

Spans (hierarchical timed regions), monotonic counters and gauges behind
one process-global :class:`Telemetry` handle, with Chrome-trace/Perfetto
JSON export that ``tools/trace_report.py`` reads.  Disabled -- the
default -- every call is a true no-op, so instrumentation stays in the hot
paths permanently.  The port keeps its own copy so that it imports nothing
of the JAX package.

Typical use::

    from repro_torch import obs

    with obs.span("serve.step", slots=n):
        ...
        obs.count("serve.requests_completed", done)

Enable collection with ``obs.enable()`` or ``REPRO_TRACE=1`` (atexit
export to ``REPRO_TRACE_PATH``, default ``repro.trace.json``), then
``obs.export(path)`` / ``obs.summary()``.
"""

# import the .export submodule eagerly: a first lazy import (inside
# Telemetry.export) would set the submodule as this package's ``export``
# attribute, clobbering the bound-function API below
from . import export as _export_module  # noqa: F401
from .telemetry import (NULL_SPAN, Span, SpanRecord, TELEMETRY, Telemetry,
                        configure_from_env, rss_mb)
from .progress import Progress, StreamProgress

#: Function API bound to the process-global handle -- ``obs.span(...)``
#: etc. read ``TELEMETRY.enabled`` per call, so enable/disable at any time.
span = TELEMETRY.span
count = TELEMETRY.count
count_held = TELEMETRY.count_held
gauge = TELEMETRY.gauge
summary = TELEMETRY.summary
export = TELEMETRY.export
chrome_trace = TELEMETRY.chrome_trace
reset = TELEMETRY.reset


def enable() -> Telemetry:
    return TELEMETRY.enable()


def disable() -> Telemetry:
    return TELEMETRY.disable()


def enabled() -> bool:
    return TELEMETRY.enabled


# REPRO_TRACE=1 in the environment turns collection on at first import.
configure_from_env()

__all__ = [
    "NULL_SPAN", "Progress", "Span", "SpanRecord", "StreamProgress",
    "TELEMETRY", "Telemetry", "chrome_trace", "configure_from_env", "count", "count_held",
    "disable", "enable", "enabled", "export", "gauge", "reset", "rss_mb",
    "span", "summary",
]
