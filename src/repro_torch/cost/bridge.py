"""Cost over cluster lifetimes: churn timelines -> dollars per delivered MFU.

The §6.5 snapshot formula prices one instant; a training team's bill is
temporal.  This bridge applies the shared dollar map
(:func:`repro_torch.cost.engine.cost_grid`) to a :class:`~repro_torch.churn.timeline.
ChurnTimeline`'s piecewise-constant ``(architecture x interval x TP)``
waste grids -- duration-weighted aggregate cost over the trace -- and
combines it with the MFU bridge (``repro_torch.churn.timeline_mfu_table``) into
the paper's real cost-effectiveness metric: **dollars (capex) and watts
per delivered MFU-GPU-hour** per architecture.  "Delivered MFU-GPU-hours"
is ``integrated_mfu * total_gpus * horizon_h``: cluster-level achieved
model-FLOPs utilization integrated over the trace, idle GPUs included, so
an architecture that strands healthy GPUs under churn pays for them here.

The counterpart of ``repro.cost.bridge``, over the port's
:class:`~repro_torch.churn.timeline.ChurnTimeline`: host float64 code,
the time mean the same ``einsum`` as ``repro``'s.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..churn.mfu_bridge import timeline_mfu_table
from ..churn.timeline import ChurnTimeline
from ..core.cost_model import (BOM_REGISTRY, GPU_UNIT_COST, GPU_UNIT_POWER_W,
                               bom_for)
from ..core.mfu_sim import LLAMA31_405B, SimModel
from .engine import cost_grid


def timeline_cost_grid(timeline: ChurnTimeline, *,
                       gpu_unit_cost: float = GPU_UNIT_COST) -> np.ndarray:
    """§6.5 aggregate cost per ``(architecture, interval, TP)`` cell, float64.

    The same affine dollar map as the snapshot engine, applied to the
    timeline's interval grids; every architecture in the timeline must have
    a BOM (``repro_torch.core.cost_model.BOM_REGISTRY``).  Reduce with the
    timeline's own ``time_mean`` for the duration-weighted §6.5 figure.
    """
    boms = [bom_for(name) for name in timeline.names]
    return cost_grid(timeline.total_gpus, timeline.placed_gpus, boms,
                     gpu_unit_cost=gpu_unit_cost)


def timeline_cost_table(timeline: ChurnTimeline,
                        sim_model: SimModel = LLAMA31_405B, *,
                        tp: Optional[int] = None,
                        gpu_unit_cost: float = GPU_UNIT_COST,
                        gpu_unit_power_w: float = GPU_UNIT_POWER_W,
                        global_batch: int = 2048, max_dp: int = 1024,
                        cluster_kwargs: Optional[Dict] = None) -> List[Dict]:
    """Per architecture: cost-effectiveness under churn (§6.5 x §6.3).

    Rows combine three quantities at the selected TP size (default: the
    timeline's first):

      * ``time_mean_cost_usd``      -- duration-weighted §6.5 aggregate cost
        over the trace (stranded GPUs priced interval by interval);
      * ``usd_per_mfu_gpu_h``       -- cluster capex (GPU + interconnect,
        ``(gpu_unit_cost + per_gpu_cost) * total_gpus``) over delivered
        MFU-GPU-hours;
      * ``watts_per_mfu_gpu``       -- cluster power draw (GPU + per-GPU
        interconnect power) over the delivered MFU-GPU rate.

    Architectures without a BOM (big-switch, sip-ring) are skipped -- they
    cannot be priced; the MFU integration itself is delegated to
    ``repro_torch.churn.timeline_mfu_table`` so the throughput leg stays
    bit-identical to the §6.3 tables.  A row whose job never fits
    (``integrated_mfu == 0``) reports ``None`` unit costs instead of
    infinity.
    """
    mfu_rows = {r["architecture"]: r
                for r in timeline_mfu_table(timeline, sim_model, tp=tp,
                                            global_batch=global_batch,
                                            max_dp=max_dp,
                                            cluster_kwargs=cluster_kwargs)}
    ti = timeline.tp_index(int(tp) if tp is not None
                           else int(timeline.tp_sizes[0]))
    priced = [n for n in timeline.names if n in BOM_REGISTRY]
    if not priced:
        return []
    boms = [bom_for(n) for n in priced]
    idx = [timeline.index(n) for n in priced]
    cost = cost_grid(timeline.total_gpus[idx], timeline.placed_gpus[idx],
                     boms, gpu_unit_cost=gpu_unit_cost)
    time_mean = np.einsum("abt,b->at", cost,
                          timeline.durations_h / timeline.horizon_h)
    rows = []
    for pi, name in enumerate(priced):
        bom = boms[pi]
        total = int(timeline.total_gpus[idx[pi], ti])
        m = mfu_rows[name]
        delivered_h = m["integrated_mfu"] * total * timeline.horizon_h
        capex = (gpu_unit_cost + bom.per_gpu_cost) * total
        watts = (gpu_unit_power_w + bom.per_gpu_power) * total
        rows.append({
            "architecture": name, "tp_size": int(timeline.tp_sizes[ti]),
            "total_gpus": total,
            "time_mean_cost_usd": float(time_mean[pi, ti]),
            "integrated_mfu": m["integrated_mfu"],
            "retention": m["retention"],
            "capex_usd": capex,
            "usd_per_mfu_gpu_h": capex / delivered_h if delivered_h > 0
                else None,
            "watts_per_mfu_gpu":
                watts / (m["integrated_mfu"] * total)
                if m["integrated_mfu"] > 0 and total else None,
        })
    return rows


__all__ = ["timeline_cost_grid", "timeline_cost_table"]
