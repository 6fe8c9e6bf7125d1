"""Reductions of a serving sweep: SLO, latency, goodput, and dollars.

A copy of ``repro.slo.tables``.

The batched engines never materialize per-request state, so the latency
leg starts with :func:`request_outcomes`: the three monotone cumulative
grids of a :class:`~repro_torch.slo.engine.ServeResult` are inverted into
``(cohort, interval, served)`` segments -- every request index ``j`` maps
to its arrival cohort via the arrival cumsum and to its resolution
interval via ``gone_cum``, and all three drivers are nondecreasing, so the
map is piecewise constant with O(intervals) segments.  The scalar
reference's directly observed request log is bit-identical
(``tests/test_torch_slo.py``), which is what licenses computing exact p50/p99
waits from batched grids.

  * :func:`slo_table`          -- per (stream, architecture): SLO
    attainment, p50/p99 wait, goodput, abandoned/leftover counts;
  * :func:`timeline_slo_table` -- the ``repro_torch.cost`` join: amortized
    cluster capex over SLO-met requests, dollars per SLO-met request.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.cost_model import BOM_REGISTRY, GPU_UNIT_COST, bom_for
from .engine import ServeResult

#: Default capex amortization window: 5 years, in hours.
AMORTIZE_H = 5 * 8760.0


def request_outcomes(result: ServeResult, stream: int,
                     arch: int) -> Dict[Tuple[int, int, bool], int]:
    """Per-request fates of one cell, aggregated:
    ``{(cohort b, interval s, served): count}``.

    Requests are indexed in arrival order; request ``j`` resolves at the
    first interval where ``gone_cum > j`` (served if ``j`` is below that
    interval's ``served_cum``, abandoned otherwise) and belongs to the
    first cohort whose arrival cumsum exceeds ``j``.  All three arrays are
    monotone, so the fate is constant between consecutive values of any of
    them -- one segment walk instead of a per-request loop.  Requests the
    horizon never resolves (``leftover``) carry no pair.
    """
    ca = np.cumsum(result.arrivals[stream])
    sc = result.served_cum[stream, arch]
    gone = result.gone_cum[stream, arch]
    n_total = int(ca[-1]) if ca.size else 0
    if n_total == 0:
        return {}
    pts = np.unique(np.concatenate([[0], ca, sc, gone]))
    pts = pts[(pts >= 0) & (pts < n_total)]
    ends = np.append(pts[1:], n_total)
    B = gone.size
    pairs: Dict[Tuple[int, int, bool], int] = {}
    for j0, j1 in zip(pts, ends):
        s = int(np.searchsorted(gone, j0, side="right"))
        if s == B:                       # unresolved at the horizon
            continue
        b = int(np.searchsorted(ca, j0, side="right"))
        key = (b, s, bool(j0 < sc[s]))
        pairs[key] = pairs.get(key, 0) + int(j1 - j0)
    return pairs


def _weighted_percentile(values: np.ndarray, counts: np.ndarray,
                         q: float) -> float:
    """Smallest value whose cumulative count reaches ``q`` percent."""
    order = np.argsort(values, kind="stable")
    v = values[order]
    cum = np.cumsum(counts[order])
    target = q / 100.0 * cum[-1]
    return float(v[np.searchsorted(cum, target, side="left")])


def _cell_stats(result: ServeResult, r: int, a: int) -> Dict:
    edges = result.edges_h
    ends = result.ends_h
    pairs = request_outcomes(result, r, a)
    waits, counts, slo_met = [], [], 0
    for (b, s, served), n in pairs.items():
        if not served:
            continue
        w = float(ends[s] - edges[b])
        waits.append(w)
        counts.append(n)
        if w <= result.slo_h:
            slo_met += n
    stats = {"slo_met": slo_met}
    if waits:
        v = np.asarray(waits)
        c = np.asarray(counts, dtype=np.int64)
        stats["p50_wait_h"] = _weighted_percentile(v, c, 50.0)
        stats["p99_wait_h"] = _weighted_percentile(v, c, 99.0)
    else:
        stats["p50_wait_h"] = None
        stats["p99_wait_h"] = None
    return stats


def slo_table(result: ServeResult) -> List[Dict]:
    """Per (arrival stream, architecture): the serving scoreboard.

    ``slo_attainment`` is SLO-met requests over *all* arrivals (abandoned
    and leftover requests count against it); ``goodput_per_h`` is SLO-met
    requests per horizon hour -- the serving analogue of the paper's
    goodput-retention claim.
    """
    w = result.durations_h / result.horizon_h
    rows = []
    for r, label in enumerate(result.arrival_labels):
        n_arr = int(result.total_arrivals[r])
        for a, name in enumerate(result.names):
            stats = _cell_stats(result, r, a)
            served = int(result.served[r, a].sum())
            rows.append({
                "arrival": label, "architecture": name,
                "tp_size": result.tp_size,
                "arrivals": n_arr, "served": served,
                "abandoned": int(result.abandoned[r, a].sum()),
                "leftover": int(result.leftover[r, a]),
                "slo_met": stats["slo_met"],
                "slo_attainment": stats["slo_met"] / n_arr if n_arr else 0.0,
                "goodput_per_h": stats["slo_met"] / result.horizon_h,
                "p50_wait_h": stats["p50_wait_h"],
                "p99_wait_h": stats["p99_wait_h"],
                "mean_queue_depth":
                    float(result.queue_depth[r, a] @ w),
            })
    return rows


def timeline_slo_table(result: ServeResult, *,
                       gpu_unit_cost: float = GPU_UNIT_COST,
                       amortize_h: float = AMORTIZE_H) -> List[Dict]:
    """The ``repro_torch.cost`` join: dollars per SLO-met request.

    Cluster capex is ``(gpu_unit_cost + bom.per_gpu_cost) * total_gpus``
    (the same affine map as ``repro_torch.cost.bridge``), amortized linearly
    over ``amortize_h`` and charged for the sweep horizon; dividing by the
    SLO-met request count prices each architecture's goodput retention
    under churn.  Architectures without a BOM are skipped (they cannot be
    priced); a cell that never meets SLO reports ``None`` instead of
    infinity.
    """
    priced = [n for n in result.names if n in BOM_REGISTRY]
    rows = []
    for r, label in enumerate(result.arrival_labels):
        for name in priced:
            a = result.index(name)
            bom = bom_for(name)
            total = int(result.total_gpus[a])
            slo_met = _cell_stats(result, r, a)["slo_met"]
            capex = (gpu_unit_cost + bom.per_gpu_cost) * total
            horizon_capex = capex * result.horizon_h / amortize_h
            rows.append({
                "arrival": label, "architecture": name,
                "tp_size": result.tp_size, "total_gpus": total,
                "slo_met": slo_met,
                "capex_usd": capex,
                "horizon_capex_usd": horizon_capex,
                "usd_per_slo_met_request":
                    horizon_capex / slo_met if slo_met else None,
            })
    return rows


__all__ = ["AMORTIZE_H", "request_outcomes", "slo_table",
           "timeline_slo_table"]
