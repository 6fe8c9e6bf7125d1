"""Reductions from a DcnSweepResult grid to the paper's Fig. 17 tables.

A copy of ``repro.dcn.tables``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .engine import DcnSweepResult
from .traffic import LLAMA3_70B, dp_tp_bytes


def traffic_tables(result: DcnSweepResult, *, dp_bytes: Optional[float] = None,
                   tp_bytes: Optional[float] = None,
                   dp_size: int = 64) -> List[Dict]:
    """Cross-ToR-traffic rows per (variant, fault_ratio, TP) -- Fig. 17c.

    The byte weighting defaults to the Megatron-style volumes of a
    Llama-3-70B-class model at the row's TP size and ``dp_size``
    (:func:`repro_torch.dcn.traffic.dp_tp_bytes`); pass explicit ``dp_bytes`` /
    ``tp_bytes`` to pin a ratio (e.g. the historical 1:9).  Shares average
    over the feasible snapshots of each cell; a cell with no feasible
    snapshot reports ``None`` shares instead of a fake zero.
    """
    from ..core.orchestrator import traffic_volume_shares
    rows = []
    for ti, tp in enumerate(result.tp_sizes):
        if dp_bytes is None or tp_bytes is None:
            db, tb = dp_tp_bytes(LLAMA3_70B, int(tp), dp_size)
        else:
            db, tb = dp_bytes, tp_bytes
        # slice this TP's column before the float share arithmetic (the
        # full (V, R, S, T) grids would be recomputed once per TP)
        shares = traffic_volume_shares(
            result.dp_pairs[..., ti], result.crossing_pairs[..., ti],
            result.crossing_pod_pairs[..., ti],
            result.groups[..., ti] * int(result.group_nodes[ti]), db, tb)
        for vi, variant in enumerate(result.variants):
            for ri, ratio in enumerate(result.spec.fault_ratios):
                feas = result.feasible[vi, ri, :, ti]
                row = {
                    "variant": variant, "fault_ratio": float(ratio),
                    "tp_size": int(tp),
                    "feasible_share": float(feas.mean()) if feas.size else 0.0,
                }
                for key in ("cross_tor_share", "cross_pod_share",
                            "dp_cross_share"):
                    cell = shares[key][vi, ri][feas]
                    row[f"mean_{key}"] = (float(cell.mean()) if cell.size
                                          else None)
                if variant == "orchestrated":
                    nc = result.n_constraints[ri, :, ti]
                    nc = nc[nc >= 0]
                    row["mean_constraints"] = (float(nc.mean()) if nc.size
                                               else None)
                rows.append(row)
    return rows


def cross_tor_curve(result: DcnSweepResult, variant: str = "orchestrated",
                    tp: Optional[int] = None, **kw) -> Dict[float, float]:
    """``{fault_ratio: mean cross-ToR share}`` of one variant -- the Fig. 17c
    curve (the 7% point is ``curve[0.07]`` when swept)."""
    tp = int(result.tp_sizes[0]) if tp is None else tp
    return {r["fault_ratio"]: r["mean_cross_tor_share"]
            for r in traffic_tables(result, **kw)
            if r["variant"] == variant and r["tp_size"] == tp}


__all__ = ["cross_tor_curve", "traffic_tables"]
