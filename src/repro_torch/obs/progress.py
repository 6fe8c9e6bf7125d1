"""Streaming progress reporting for the long-running engines.

A copy of ``repro.obs.progress``.

A :class:`StreamProgress` tracks one bounded stream (total units known up
front, e.g. snapshots) and produces :class:`Progress` updates carrying
blocks done, units/sec throughput, and an ETA.  The streaming engines
(``repro_torch.sim.engine.evaluate_mask_stream``, ``monte_carlo_replay``
``engine="streamed"``) drive one per run and hand each update to a
``progress`` callback -- by default :func:`telemetry_progress`, which
publishes the update as telemetry gauges (``<prefix>.blocks_done``,
``<prefix>.units_per_sec``, ``<prefix>.eta_s``), so a multi-minute
million-snapshot sweep is observable from the trace instead of silent.

Custom callbacks receive the :class:`Progress` dataclass directly::

    def progress(p):
        print(f"{p.units_done}/{p.total_units} ({p.units_per_sec:.0f}/s, "
              f"eta {p.eta_s:.0f}s)")

    evaluate_mask_stream(models, tps, chunks, total, progress=progress)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from .telemetry import TELEMETRY, Telemetry

__all__ = ["Progress", "StreamProgress", "telemetry_progress"]


@dataclasses.dataclass(frozen=True)
class Progress:
    """One progress update of a bounded stream."""

    blocks_done: int
    units_done: int
    total_units: int
    elapsed_s: float
    units_per_sec: float       # cumulative throughput since stream start
    eta_s: Optional[float]     # None until throughput is measurable

    @property
    def fraction(self) -> float:
        return self.units_done / self.total_units if self.total_units else 1.0


def telemetry_progress(prefix: str = "stream",
                       tel: Telemetry = TELEMETRY) -> Callable[[Progress], None]:
    """Default ``progress`` sink: publish updates as telemetry gauges."""

    def report(p: Progress) -> None:
        tel.gauge(f"{prefix}.blocks_done", p.blocks_done)
        tel.gauge(f"{prefix}.units_per_sec", p.units_per_sec)
        if p.eta_s is not None:
            tel.gauge(f"{prefix}.eta_s", p.eta_s)

    return report


class StreamProgress:
    """Progress tracker of one bounded stream; emits to a callback.

    ``callback=None`` defaults to :func:`telemetry_progress` (gauges under
    ``prefix``) -- a no-op when telemetry is disabled, so engines can
    always drive one of these without checking.
    """

    def __init__(self, total_units: int,
                 callback: Optional[Callable[[Progress], None]] = None,
                 prefix: str = "stream"):
        self.total_units = int(total_units)
        self.callback = (telemetry_progress(prefix) if callback is None
                         else callback)
        self.blocks_done = 0
        self.units_done = 0
        self.start_s = time.perf_counter()

    def update(self, units: int) -> Progress:
        """Record one finished block of ``units`` and emit an update."""
        self.blocks_done += 1
        self.units_done += int(units)
        elapsed = time.perf_counter() - self.start_s
        rate = self.units_done / elapsed if elapsed > 0 else 0.0
        remaining = max(self.total_units - self.units_done, 0)
        eta = remaining / rate if rate > 0 else None
        p = Progress(self.blocks_done, self.units_done, self.total_units,
                     elapsed, rate, eta)
        self.callback(p)
        return p
