"""Reductions from a CostResult grid to the paper's §6.5 tables/figures.

A copy of ``repro.cost.tables``.

Each helper returns plain dict rows (CSV-able, assertable) mirroring
:mod:`repro_torch.sim.tables`:

  * :func:`per_gpu_cost_table`      -- Table 6 (validated to the cent);
  * :func:`headline_ratio_rows`     -- the 30.86%-of-NVL-72 / 62.84%-of-
    TPUv4 per-GPU-per-GBps interconnect ratios;
  * :func:`cost_table`              -- mean/P50/P99 aggregate cost per
    ``(fault_ratio, architecture, TP)`` cell (statistics via the shared
    :mod:`repro_torch.core.reductions` implementation);
  * :func:`cost_effectiveness_table` -- Fig. 17d: aggregate cost vs fault
    ratio, normalized against a baseline architecture's curve.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..core.cost_model import (INFINITEHBD_K2, NVL72, TPUV4, cost_ratio,
                               table6)
from ..core.reductions import waste_stats
from .engine import CostResult


def per_gpu_cost_table(include_hpn: bool = False) -> List[Dict]:
    """Table 6 rows (per-GPU / per-GPU-per-GBps cost & power, cent-rounded
    USD exactly as printed in the paper)."""
    return table6(include_hpn=include_hpn)


def headline_ratio_rows() -> List[Dict]:
    """The paper's §6.5 headline interconnect-cost ratios with our values."""
    return [
        {"pair": "infinitehbd-k2/nvl-72",
         "ours": round(cost_ratio(INFINITEHBD_K2, NVL72), 4),
         "paper": 0.3086},
        {"pair": "infinitehbd-k2/tpuv4",
         "ours": round(cost_ratio(INFINITEHBD_K2, TPUV4), 4),
         "paper": 0.6284},
    ]


def cost_table(result: CostResult) -> List[Dict]:
    """Per ``(fault_ratio, architecture, TP)``: aggregate-cost statistics.

    ``mean/p50/p99_cost_usd`` reduce the snapshot axis with the shared
    :func:`repro_torch.core.reductions.waste_stats`; ``mean_stranded_gpus`` is
    the §6.5 ``N_wasted + N_faulty`` count behind the dollar figure.
    """
    stranded = result.stranded_gpus
    rows = []
    for ri, ratio in enumerate(result.fault_ratios):
        for ai, name in enumerate(result.names):
            for ti, tp in enumerate(result.tp_sizes):
                mean, p50, p99 = waste_stats(result.cost_usd[ri, ai, :, ti])
                rows.append({
                    "fault_ratio": float(ratio),
                    "architecture": name, "tp_size": int(tp),
                    "mean_cost_usd": mean, "p50_cost_usd": p50,
                    "p99_cost_usd": p99,
                    "mean_stranded_gpus":
                        float(stranded[ri, ai, :, ti].mean()),
                })
    return rows


def hosting_architectures(result: CostResult, tp: int) -> List[str]:
    """Architectures with non-zero placeable capacity somewhere on the
    grid at TP size ``tp``.

    An architecture that can never host a TP (dgx-h100's 8-GPU islands at
    TP-32) contributes a degenerate whole-cluster-stranded constant to the
    Fig. 17d curves; the benchmark and example report each TP's rows for
    these architectures only.
    """
    ti = result.tp_index(tp)
    return [name for ai, name in enumerate(result.names)
            if result.placed_gpus[:, ai, :, ti].max(initial=0) > 0]


def cost_effectiveness_table(result: CostResult, *,
                             baseline: str = "nvl-72",
                             tp: Optional[int] = None) -> List[Dict]:
    """Fig. 17d rows: mean aggregate cost vs fault ratio, per architecture.

    One row per ``(fault_ratio, architecture)`` at the selected TP size
    (default: the grid's first), with ``vs_baseline`` = the architecture's
    mean cost over the baseline architecture's at the same fault ratio --
    the curve the paper plots to argue cost-effectiveness under faults.
    """
    ti = result.tp_index(int(tp) if tp is not None
                         else int(result.tp_sizes[0]))
    bi = result.index(baseline)
    mean = result.mean_cost_usd                         # (R, A, T)
    rows = []
    for ri, ratio in enumerate(result.fault_ratios):
        base = mean[ri, bi, ti]
        for ai, name in enumerate(result.names):
            rows.append({
                "fault_ratio": float(ratio), "architecture": name,
                "tp_size": int(result.tp_sizes[ti]),
                "mean_cost_usd": float(mean[ri, ai, ti]),
                "vs_baseline": float(mean[ri, ai, ti] / base) if base else
                    None,
            })
    return rows


__all__ = ["cost_effectiveness_table", "cost_table", "headline_ratio_rows",
           "hosting_architectures", "per_gpu_cost_table"]
