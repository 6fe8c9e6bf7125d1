"""Reductions from a SweepResult grid to the paper's figure tables.

The counterpart of ``repro.sim.tables``.  Its ``comparison_matrix`` needs
the churn, DCN and cost engines and comes with their slices.

Each helper returns a list of plain dict rows (one per architecture x TP
combination) so callers can print CSV, assert on values, or feed plotting.
The actual reductions live in :mod:`repro_torch.core.reductions`, a copy
of the JAX package's, matching the scalar definitions bit-for-bit: waste statistics
(Fig. 13/14), P5 placeable capacity (Fig. 15), and fault-waiting share
(Fig. 16/23).
"""

from __future__ import annotations

import io
from typing import Dict, List, Sequence

from ..core.reductions import (percentile_capacity, waiting_share,
                               waste_stats)
from .engine import SweepResult


def waste_table(result: SweepResult) -> List[Dict]:
    """Per (architecture, TP): mean/P50/P99 waste ratio over snapshots."""
    waste = result.waste_ratio
    rows = []
    for ai, name in enumerate(result.names):
        for ti, tp in enumerate(result.tp_sizes):
            mean, p50, p99 = waste_stats(waste[ai, :, ti])
            rows.append({
                "architecture": name, "tp_size": int(tp),
                "mean_waste": mean, "p50_waste": p50, "p99_waste": p99,
            })
    return rows


def max_job_table(result: SweepResult, percentile: float = 5.0) -> List[Dict]:
    """Per (architecture, TP): P5 of placeable GPUs -- the job scale a long
    run could hold through ~95% of the trace (Fig. 15)."""
    rows = []
    for ai, name in enumerate(result.names):
        for ti, tp in enumerate(result.tp_sizes):
            gpus = percentile_capacity(result.placed_gpus[ai, :, ti],
                                       percentile)
            total = int(result.total_gpus[ai, ti])
            rows.append({
                "architecture": name, "tp_size": int(tp),
                "max_job_gpus": gpus,
                "fraction": gpus / total if total else 0.0,
            })
    return rows


def fault_waiting_table(result: SweepResult,
                        job_gpus: Sequence[int]) -> List[Dict]:
    """Per (architecture, TP, job size): share of snapshots during which the
    job cannot run because placeable capacity < requirement (Fig. 16/23)."""
    rows = []
    for ai, name in enumerate(result.names):
        for ti, tp in enumerate(result.tp_sizes):
            placed = result.placed_gpus[ai, :, ti]
            for jg in job_gpus:
                rows.append({
                    "architecture": name, "tp_size": int(tp),
                    "job_gpus": int(jg),
                    "waiting_share": waiting_share(placed, jg),
                })
    return rows


def to_csv(rows: List[Dict]) -> str:
    """Render table rows as CSV (stable column order from the first row)."""
    if not rows:
        return ""
    cols = list(rows[0])
    buf = io.StringIO()
    buf.write(",".join(cols) + "\n")
    for r in rows:
        buf.write(",".join(_fmt(r.get(c)) for c in cols) + "\n")
    return buf.getvalue()


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)
