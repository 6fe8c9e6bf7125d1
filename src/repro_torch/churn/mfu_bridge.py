"""Bridge from churn timelines to end-to-end training throughput (§6.3).

Waste ratios say how many GPUs an architecture strands; what a training
team buys is *time-integrated MFU*.  This bridge feeds each interval's
surviving placeable capacity into the analytic MFU simulator
(``repro_torch.core.mfu_sim``): the job runs at the swept TP size with an
elastic power-of-two DP degree (exactly the control plane's ``dp //= 2``
scaling), so interval ``b`` contributes

    mfu(TP, dp(b)) * scheduled_gpus(b) / total_gpus

-- achieved model FLOPs per cluster-wide peak FLOP, idle (wasted + faulty
+ unscheduled) GPUs included.  Integrating over interval durations and
dividing by the fault-free figure yields the per-architecture throughput
retention the paper's resiliency argument is really about.

A copy of ``repro.churn.mfu_bridge``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.mfu_sim import Cluster, LLAMA31_405B, SimModel, SimResult, search
from .timeline import ChurnTimeline


def pow2_floor(x) -> np.ndarray:
    """Elementwise largest power of two <= x (0 where x < 1)."""
    arr = np.asarray(x, dtype=np.int64)
    scalar = arr.ndim == 0
    arr = np.atleast_1d(arr)
    out = np.zeros_like(arr)
    nz = arr > 0
    out[nz] = np.int64(1) << np.floor(np.log2(arr[nz])).astype(np.int64)
    return int(out[0]) if scalar else out


def elastic_mfu(sim_model: SimModel, tp: int, dp: int, *,
                global_batch: int = 2048,
                cluster_kwargs: Optional[Dict] = None) -> Optional[SimResult]:
    """Best plan for a TP=``tp`` job elastically scaled to DP=``dp``.

    The search keeps TP fixed and folds pipeline stages into the DP budget
    (``pp * d == dp``), mirroring how the control plane shrinks a job
    without re-sharding the model axis.  Returns None when no plan fits
    (e.g. the model no longer fits in memory at this scale).
    """
    if dp < 1:
        return None
    cluster = Cluster(gpus=tp * dp, **(cluster_kwargs or {}))
    return search(sim_model, cluster, global_batch=global_batch, tps=(tp,),
                  max_dp=dp)


def timeline_mfu_table(timeline: ChurnTimeline,
                       sim_model: SimModel = LLAMA31_405B, *,
                       tp: Optional[int] = None, global_batch: int = 2048,
                       max_dp: int = 1024,
                       cluster_kwargs: Optional[Dict] = None) -> List[Dict]:
    """Per architecture: time-integrated effective MFU over the timeline.

    ``integrated_mfu`` is the duration-weighted cluster-level MFU defined
    above; ``ideal_mfu`` is the same quantity on a fault-free cluster, so
    ``retention = integrated / ideal`` is the architecture's end-to-end
    throughput delta under churn.  ``unschedulable_share`` is the fraction
    of the horizon during which no feasible job existed at all.
    """
    ti = timeline.tp_index(int(tp) if tp is not None
                           else int(timeline.tp_sizes[0]))
    tp = int(timeline.tp_sizes[ti])
    w = timeline.durations_h / timeline.horizon_h
    # distinct elastic DP degrees are few (powers of two); one search each,
    # shared across architectures (the job model doesn't depend on the HBD)
    cache: Dict[int, Optional[SimResult]] = {}

    def util(dp: int, total: int) -> float:
        if dp < 1 or total <= 0:
            return 0.0
        if dp not in cache:
            cache[dp] = elastic_mfu(sim_model, tp, dp,
                                    global_batch=global_batch,
                                    cluster_kwargs=cluster_kwargs)
        res = cache[dp]
        return res.mfu * (tp * dp) / total if res else 0.0

    rows = []
    for ai, name in enumerate(timeline.names):
        total = int(timeline.total_gpus[ai, ti])
        dps = np.minimum(pow2_floor(timeline.placed_gpus[ai, :, ti] // tp),
                         max_dp)
        eff = np.array([util(int(d), total) for d in dps])
        ideal_dp = min(pow2_floor(total // tp), max_dp) if total else 0
        ideal = util(ideal_dp, total)
        integrated = float(np.dot(eff, w))
        rows.append({
            "architecture": name, "tp_size": tp,
            "integrated_mfu": integrated,
            "ideal_mfu": float(ideal),
            "retention": integrated / ideal if ideal > 0 else 0.0,
            "unschedulable_share": float(w[eff == 0.0].sum()),
        })
    return rows


__all__ = ["elastic_mfu", "pow2_floor", "timeline_mfu_table"]
