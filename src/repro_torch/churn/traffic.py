"""Time-integrated DCN traffic over a fault trace (churn x Fig. 17).

The snapshot engine answers "what does a placement cost the DCN at one
instant"; this module integrates that cost over a cluster lifetime: every
fault interval of a :class:`~repro_torch.core.trace.FaultTrace` is evaluated
through the batched placement kernels (``repro_torch.dcn``), and the resulting
piecewise-constant pair-count series is reduced to duration-weighted
cross-ToR shares and **cross-ToR GPU-hours** -- how much gradient traffic
actually transited ToR uplinks while the job ran, per placement variant.

The counterpart of ``repro.churn.traffic``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.orchestrator import traffic_volume_shares
from ..core.trace import FaultTrace
from ..dcn.engine import VARIANTS, evaluate_placements, resolve_backend
from ..dcn.kernel import FatTreeConfig, batched_pair_counts
from ..dcn.traffic import LLAMA3_70B, dp_tp_bytes

_COUNT_KEYS = ("groups", "dp_pairs", "crossing_pairs", "crossing_pod_pairs")


@dataclasses.dataclass
class TrafficTimeline:
    """Piecewise-constant DP-ring pair counts over one trace's lifetime.

    Interval ``b`` spans ``[edges_h[b], edges_h[b+1])`` (the last one ends
    at ``horizon_h``); infeasible intervals -- the job cannot be placed --
    hold zero counts, so every time integral naturally excludes them.
    """

    horizon_h: float
    edges_h: np.ndarray            # (B,) interval left edges, hours
    variants: List[str]            # grid axis 0
    tp_sizes: np.ndarray           # (T,), grid axis 2
    gpus_per_node: int
    groups: np.ndarray             # (V, B, T) int64
    dp_pairs: np.ndarray           # (V, B, T) int64
    crossing_pairs: np.ndarray     # (V, B, T) int64
    crossing_pod_pairs: np.ndarray  # (V, B, T) int64
    feasible: np.ndarray           # (V, B, T) bool
    backend: str = "numpy"

    @property
    def durations_h(self) -> np.ndarray:
        return np.diff(np.append(self.edges_h, self.horizon_h))

    def shares(self, dp_bytes: float = 1.0,
               tp_bytes: float = 9.0) -> Dict[str, np.ndarray]:
        """Per-interval volume-share grids, each ``(V, B, T)``."""
        m = (self.tp_sizes // self.gpus_per_node)[None, None, :]
        return traffic_volume_shares(self.dp_pairs, self.crossing_pairs,
                                     self.crossing_pod_pairs,
                                     self.groups * m, dp_bytes, tp_bytes)

    def _hours(self, series: np.ndarray) -> np.ndarray:
        return np.einsum("vbt,b->vt", np.asarray(series, dtype=float),
                         self.durations_h)

    def time_mean_shares(self, dp_bytes: float = 1.0,
                         tp_bytes: float = 9.0) -> Dict[str, np.ndarray]:
        """Duration-weighted mean shares, ``(V, T)`` (infeasible time = 0)."""
        w = self.durations_h / self.horizon_h
        return {key: np.einsum("vbt,b->vt", val, w)
                for key, val in self.shares(dp_bytes, tp_bytes).items()}

    def crossing_gpu_hours(self) -> np.ndarray:
        """Time-integrated cross-ToR GPU-hours, ``(V, T)``.

        Each crossing DP pair keeps ``2 x gpus_per_node`` GPU endpoints
        exchanging gradients across a ToR uplink for the interval.
        """
        return self._hours(self.crossing_pairs * 2 * self.gpus_per_node)

    def dp_gpu_hours(self) -> np.ndarray:
        """Time-integrated DP-ring GPU-hours (all pairs), ``(V, T)``."""
        return self._hours(self.dp_pairs * 2 * self.gpus_per_node)

    def feasible_time_share(self) -> np.ndarray:
        """Share of the horizon during which the job was placeable."""
        return self._hours(self.feasible) / self.horizon_h

    def index(self, variant: str) -> int:
        return self.variants.index(variant)


def traffic_replay(trace: FaultTrace, *, tp_sizes: Sequence[int] = (32,),
                   variants: Sequence[str] = VARIANTS,
                   job_scale: float = 0.85, gpus_per_node: int = 4,
                   nodes_per_tor: int = 8, agg_domain: int = 64, k: int = 3,
                   greedy_seed: int = 0, backend: str = "auto",
                   chunk_snapshots: int = 4096,
                   device="cuda") -> TrafficTimeline:
    """Evaluate every fault interval's placement traffic in one batched pass.

    Returns a :class:`TrafficTimeline` with ``(variants V, fault-intervals
    B, TP sizes T)`` pair-count grids.  The interval occupancy masks
    (``trace.fault_masks(interval_edges())``) stream through
    :func:`repro_torch.dcn.evaluate_placements` exactly like the churn waste
    replay streams through the scenario engine -- ``backend`` selects the
    NumPy or torch placement kernel (identical grids; torch on
    ``device``) -- so a whole 348-day trace reduces to a handful of
    vectorized kernel calls.
    """
    cfg = FatTreeConfig(trace.num_nodes, gpus_per_node, nodes_per_tor,
                        agg_domain, k)
    edges = trace.interval_edges()
    masks = trace.fault_masks(edges)
    total = trace.num_nodes * gpus_per_node
    tps = np.asarray(list(tp_sizes), dtype=np.int64)
    shape = (len(variants), len(edges), len(tps))
    grids = {key: np.zeros(shape, dtype=np.int64) for key in _COUNT_KEYS}
    feasible = np.zeros(shape, dtype=bool)
    for ti, tp in enumerate(tps):
        job = max(int(total * job_scale) // int(tp) * int(tp), int(tp))
        for vi, variant in enumerate(variants):
            bp = evaluate_placements(masks, cfg, variant, int(tp), job,
                                     backend=backend, greedy_seed=greedy_seed,
                                     chunk_snapshots=chunk_snapshots,
                                     device=device)
            counts = batched_pair_counts(bp, nodes_per_tor, agg_domain)
            for key in _COUNT_KEYS:
                grids[key][vi, :, ti] = counts[key]
            feasible[vi, :, ti] = bp.feasible
    chosen = resolve_backend(backend)
    return TrafficTimeline(trace.horizon_h, edges, list(variants), tps,
                           gpus_per_node, grids["groups"], grids["dp_pairs"],
                           grids["crossing_pairs"],
                           grids["crossing_pod_pairs"], feasible,
                           backend=chosen)


def integrated_traffic_table(timeline: TrafficTimeline, *,
                             dp_bytes: Optional[float] = None,
                             tp_bytes: Optional[float] = None,
                             dp_size: int = 64) -> List[Dict]:
    """Per (variant, TP): time-integrated DCN traffic over the trace.

    Byte weighting defaults to the Llama-3-70B Megatron volumes at the
    row's TP (:func:`repro_torch.dcn.traffic.dp_tp_bytes`), like the snapshot
    traffic tables.
    """
    cross_h = timeline.crossing_gpu_hours()
    dp_h = timeline.dp_gpu_hours()
    feas = timeline.feasible_time_share()
    rows = []
    for ti, tp in enumerate(timeline.tp_sizes):
        if dp_bytes is None or tp_bytes is None:
            db, tb = dp_tp_bytes(LLAMA3_70B, int(tp), dp_size)
        else:
            db, tb = dp_bytes, tp_bytes
        means = timeline.time_mean_shares(db, tb)
        for vi, variant in enumerate(timeline.variants):
            rows.append({
                "variant": variant, "tp_size": int(tp),
                "time_mean_cross_tor_share":
                    float(means["cross_tor_share"][vi, ti]),
                "time_mean_cross_pod_share":
                    float(means["cross_pod_share"][vi, ti]),
                "cross_tor_gpu_h": float(cross_h[vi, ti]),
                "dp_gpu_h": float(dp_h[vi, ti]),
                "feasible_time_share": float(feas[vi, ti]),
            })
    return rows


__all__ = ["TrafficTimeline", "integrated_traffic_table", "traffic_replay"]
