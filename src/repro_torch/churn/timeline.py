"""Time-stamped cluster-lifetime results and their reductions.

A :class:`ChurnTimeline` is the churn replay's output for ONE fault trace:
the piecewise-constant `(architectures x intervals x TP sizes)` grid of
faulty/placed GPU counts (same semantics as :class:`repro_torch.sim.SweepResult`,
but with interval *durations* attached, so every reduction can be
time-weighted), plus the control plane's :class:`ReconfigRecord` log.

Reductions:

  * :func:`latency_table`          -- Fig. 18-style reconfiguration-latency
    distribution rows (one per labelled record set, e.g. per cluster size);
  * :func:`integrated_waste_table` -- time-integrated waste / goodput per
    (architecture, TP): GPU-hours, not snapshot counts.

A copy of ``repro.churn.timeline``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ReconfigRecord:
    """One control-plane reconfiguration during a trace replay."""

    time_h: float
    kind: str                      # "fault" | "repair"
    nodes: Tuple[int, ...]
    latency_us: Optional[float]    # settle - event time; None: no feasible plan
    dp_degree: int                 # elastic DP degree the replan settled on
    placed_gpus: int               # GPUs in the surviving job


@dataclasses.dataclass
class ChurnTimeline:
    """Piecewise-constant cluster state over one trace's lifetime.

    Interval ``b`` spans ``[edges_h[b], edges_h[b+1])`` (the last one ends
    at ``horizon_h``); the grids hold that interval's counts exactly as the
    scenario engine computes them for the interval's fault snapshot.
    """

    horizon_h: float
    edges_h: np.ndarray        # (B,) interval left edges, hours
    names: List[str]           # architecture names, grid axis 0
    tp_sizes: np.ndarray       # (T,), grid axis 2
    total_gpus: np.ndarray     # (A, T)
    faulty_gpus: np.ndarray    # (A, B, T)
    placed_gpus: np.ndarray    # (A, B, T)
    backend: str = "numpy"     # engine that produced the grids
    reconfigs: List[ReconfigRecord] = dataclasses.field(default_factory=list)

    @property
    def num_intervals(self) -> int:
        return self.placed_gpus.shape[1]

    @property
    def durations_h(self) -> np.ndarray:
        return np.diff(np.append(self.edges_h, self.horizon_h))

    @property
    def healthy_gpus(self) -> np.ndarray:
        return self.total_gpus[:, None, :] - self.faulty_gpus

    @property
    def wasted_gpus(self) -> np.ndarray:
        return self.healthy_gpus - self.placed_gpus

    @property
    def waste_ratio(self) -> np.ndarray:
        total = np.broadcast_to(self.total_gpus[:, None, :],
                                self.placed_gpus.shape)
        return np.divide(self.wasted_gpus, total,
                         out=np.zeros(self.placed_gpus.shape),
                         where=total != 0)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def tp_index(self, tp: int) -> int:
        return int(np.nonzero(self.tp_sizes == tp)[0][0])

    # -------------------------------------------------- time integration

    def time_mean(self, series: np.ndarray) -> np.ndarray:
        """Duration-weighted mean of an ``(A, B, T)`` series over intervals."""
        w = self.durations_h / self.horizon_h
        return np.einsum("abt,b->at", np.asarray(series, dtype=float), w)

    def gpu_hours(self, series: np.ndarray) -> np.ndarray:
        """Time integral of an ``(A, B, T)`` GPU-count series, in GPU-hours."""
        return np.einsum("abt,b->at", np.asarray(series, dtype=float),
                         self.durations_h)

    def integrated_waste_ratio(self) -> np.ndarray:
        """Time-weighted mean waste ratio, shape ``(A, T)``."""
        return self.time_mean(self.waste_ratio)

    def goodput_gpu_hours(self) -> np.ndarray:
        """Placed (training-capable) GPU-hours over the horizon, ``(A, T)``."""
        return self.gpu_hours(self.placed_gpus)

    def wasted_gpu_hours(self) -> np.ndarray:
        return self.gpu_hours(self.wasted_gpus)

    def placed_share(self) -> np.ndarray:
        """Goodput as a share of total GPU-hours, ``(A, T)``."""
        denom = self.total_gpus.astype(float) * self.horizon_h
        return np.divide(self.goodput_gpu_hours(), denom,
                         out=np.zeros_like(denom), where=denom != 0)

    # --------------------------------------------------- interval export

    def reconfig_stall_h(self) -> np.ndarray:
        """Per-interval control-plane stall, shape ``(B,)``, in hours.

        Each feasible :class:`ReconfigRecord` charges its settle latency to
        the interval containing its event time (clipped to the interval's
        duration -- a replan can not stall longer than the interval it
        happened in).  Records with ``latency_us=None`` (no feasible plan)
        contribute nothing here: their capacity loss already lives in the
        shrunken ``placed_gpus`` grid.  This is the serving bridge's
        capacity hook: the SLO engine (``repro_torch.slo.capacity``)
        subtracts the stall from every interval's usable serving time.
        """
        stall = np.zeros(self.num_intervals, dtype=float)
        if not self.reconfigs:
            return stall
        durations = self.durations_h
        for rec in self.reconfigs:
            if rec.latency_us is None:
                continue
            b = int(np.searchsorted(self.edges_h, rec.time_h,
                                    side="right")) - 1
            if 0 <= b < stall.size:
                stall[b] += rec.latency_us / 3.6e9
        return np.minimum(stall, durations)


# ------------------------------------------------------------- reductions

def integrated_waste_table(timeline: ChurnTimeline) -> List[Dict]:
    """Per (architecture, TP): time-integrated waste/goodput over the trace."""
    waste = timeline.integrated_waste_ratio()
    good = timeline.goodput_gpu_hours()
    wasted = timeline.wasted_gpu_hours()
    share = timeline.placed_share()
    rows = []
    for ai, name in enumerate(timeline.names):
        for ti, tp in enumerate(timeline.tp_sizes):
            rows.append({
                "architecture": name, "tp_size": int(tp),
                "time_mean_waste": float(waste[ai, ti]),
                "wasted_gpu_h": float(wasted[ai, ti]),
                "goodput_gpu_h": float(good[ai, ti]),
                "placed_share": float(share[ai, ti]),
            })
    return rows


def latency_table(records_by_label: Mapping[str, Sequence[ReconfigRecord]],
                  ) -> List[Dict]:
    """Fig. 18-style reconfiguration-latency distribution rows.

    One row per label (e.g. per cluster size, per ControlPlaneConfig);
    records whose replan found no feasible plan carry no latency and are
    reported via ``infeasible`` instead of polluting the distribution (a
    label with no feasible replans at all gets ``None`` stats, so it can
    never rank as "fastest").
    """
    rows = []
    for label, records in records_by_label.items():
        lats = np.array([r.latency_us for r in records
                         if r.latency_us is not None], dtype=float)
        row = {"label": label, "reconfigs": len(records),
               "infeasible": sum(1 for r in records if r.latency_us is None)}
        if lats.size:
            row.update({
                "mean_us": float(lats.mean()),
                "p50_us": float(np.percentile(lats, 50)),
                "p90_us": float(np.percentile(lats, 90)),
                "p99_us": float(np.percentile(lats, 99)),
                "max_us": float(lats.max()),
            })
        else:
            row.update({"mean_us": None, "p50_us": None, "p90_us": None,
                        "p99_us": None, "max_us": None})
        rows.append(row)
    return rows


__all__ = ["ChurnTimeline", "ReconfigRecord", "integrated_waste_table",
           "latency_table"]
