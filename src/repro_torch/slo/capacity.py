"""Per-interval serving capacity from a churn timeline.

The bridge between the churn machinery and the serving simulator: each
:class:`~repro_torch.churn.timeline.ChurnTimeline` interval contributes an
*integer* request budget per architecture --

    cap[a, b] = floor(placed_gpus[a, b, tp] * req_per_gpu_hour
                      * usable_hours[b])

where ``usable_hours`` is the interval duration minus the control plane's
reconfiguration stall (``ChurnTimeline.reconfig_stall_h``): faults shrink
the usable ring (smaller ``placed_gpus``), elastic reconfiguration pauses
slots (stall), and recovered nodes restore them (the next interval's
grid).  Budgets are computed host-side in float64 and floored to int64
once, then fed verbatim to every engine, so backend equality never hinges
on device float semantics.  A copy of ``repro.slo.capacity``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:   # annotation-only: a runtime import would cycle back
    from ..churn.timeline import ChurnTimeline   # churn -> sim -> slo


def interval_capacity(timeline: ChurnTimeline, *,
                      tp: Optional[int] = None,
                      req_per_gpu_hour: float = 1.0,
                      reconfig_pause: bool = True) -> np.ndarray:
    """Request budget per ``(architecture, interval)`` cell, int64.

    ``tp`` selects the timeline's TP column (default: its first); the TP
    size fixes which ``placed_gpus`` grid the serving fleet runs at.
    ``reconfig_pause=False`` ignores the control-plane stall (an idealized
    fleet that reconfigures instantly).
    """
    if req_per_gpu_hour < 0:
        raise ValueError(f"req_per_gpu_hour must be >= 0, "
                         f"got {req_per_gpu_hour}")
    ti = timeline.tp_index(int(tp) if tp is not None
                           else int(timeline.tp_sizes[0]))
    usable_h = timeline.durations_h.astype(np.float64)
    if reconfig_pause:
        usable_h = np.maximum(usable_h - timeline.reconfig_stall_h(), 0.0)
    placed = timeline.placed_gpus[:, :, ti].astype(np.float64)   # (A, B)
    return np.floor(placed * req_per_gpu_hour
                    * usable_h[None, :]).astype(np.int64)


__all__ = ["interval_capacity"]
