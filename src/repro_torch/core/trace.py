"""Production-like fault traces (paper Appendix A).

A copy of ``repro.core.trace``: it keeps NumPy's ``default_rng``, so trace
and i.i.d. masks are bit-equal to the JAX package's.

The paper's trace comes from a 3K-GPU cluster of 8-GPU nodes over 348 days:
mean faulty-node ratio 2.33%, P99 7.22%.  The raw trace is open-sourced but
not available offline, so we generate statistically matching traces: a
baseline Poisson failure process with exponential repair, plus rare correlated
burst events that produce the heavy P99 tail, then calibrate rates so the
stationary mean matches 2.33%.

Also implements the Appendix-A Bayes conversion from 8-GPU-node traces to
4-GPU-node traces (each half-node fails with probability 50.21% given the
8-GPU node fault).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

# Appendix A constants.
MEAN_FAULT_RATIO_8GPU = 0.0233
P99_FAULT_RATIO_8GPU = 0.0722
PER_GPU_FAULT_P = 1.0 - (1.0 - MEAN_FAULT_RATIO_8GPU) ** (1.0 / 8.0)  # ~0.29%
FAULT_RATIO_4GPU = 1.0 - (1.0 - PER_GPU_FAULT_P) ** 4                 # ~1.17%
BAYES_SPLIT_P = FAULT_RATIO_4GPU / MEAN_FAULT_RATIO_8GPU              # ~50.21%


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    node: int
    start_h: float
    end_h: float


@dataclasses.dataclass
class FaultTrace:
    """A set of fault events over ``num_nodes`` nodes and ``horizon_h`` hours."""

    num_nodes: int
    horizon_h: float
    events: List[FaultEvent]

    def faulty_at(self, t_h: float) -> Set[int]:
        return {e.node for e in self.events if e.start_h <= t_h < e.end_h}

    def sample_times(self, num: int) -> np.ndarray:
        return np.linspace(0.0, self.horizon_h, num, endpoint=False)

    def fault_masks(self, ts: Sequence[float]) -> np.ndarray:
        """Boolean fault matrix of shape ``(len(ts), num_nodes)``.

        Row ``i`` is exactly ``faulty_at(ts[i])`` as a mask (same ``start <=
        t < end`` comparisons, evaluated with searchsorted on the sorted
        sample times), so the batched scenario engine sees bit-identical
        snapshots to the scalar path -- in one vectorized sweep instead of
        O(samples * events) Python.
        """
        ts = np.asarray(ts, dtype=np.float64)
        if len(ts) > 1 and np.any(np.diff(ts) < 0):
            raise ValueError("fault_masks requires ascending sample times "
                             "(searchsorted semantics)")
        masks = np.zeros((len(ts), self.num_nodes), dtype=bool)
        if not self.events or not len(ts):
            return masks
        starts = np.array([e.start_h for e in self.events])
        ends = np.array([e.end_h for e in self.events])
        nodes = np.array([e.node for e in self.events])
        # event active at ts[i] iff i >= searchsorted(start) and i < searchsorted(end)
        i0 = np.searchsorted(ts, starts, side="left")
        i1 = np.searchsorted(ts, ends, side="left")
        # int16 + in-place cumsum keeps the peak footprint at ~2x the bool
        # mask even for 100k-node x multi-thousand-snapshot grids (the count
        # is concurrently-active events per node, far below the int16 range);
        # the (node, time) layout makes the cumsum contiguous (~4x faster
        # than accumulating down the snapshot axis)
        delta = np.zeros((self.num_nodes, len(ts) + 1), dtype=np.int16)
        np.add.at(delta, (nodes, i0), 1)
        np.add.at(delta, (nodes, i1), -1)
        np.cumsum(delta[:, :-1], axis=1, out=delta[:, :-1])
        out = np.empty((len(ts), self.num_nodes), dtype=bool)
        np.greater(delta[:, :-1].T, 0, out=out)    # one C-ordered allocation
        return out

    def interval_edges(self) -> np.ndarray:
        """Left edges of the piecewise-constant fault-set intervals.

        ``edges[0] == 0.0`` and every event start/end inside ``(0,
        horizon_h)`` contributes an edge, so ``faulty_at`` is constant on
        ``[edges[i], edges[i+1])`` and on the final ``[edges[-1],
        horizon_h)``.  ``fault_masks(interval_edges())`` is therefore the
        exact per-interval occupancy matrix of the trace -- the snapshot
        axis of the churn replay (``repro_torch.churn``).
        """
        ts = {0.0}
        for e in self.events:
            if 0.0 < e.start_h < self.horizon_h:
                ts.add(e.start_h)
            if 0.0 < e.end_h < self.horizon_h:
                ts.add(e.end_h)
        return np.array(sorted(ts), dtype=np.float64)

    def interval_durations(self, edges: Optional[np.ndarray] = None) -> np.ndarray:
        """Durations (hours) of the intervals whose left edges are ``edges``."""
        edges = self.interval_edges() if edges is None else np.asarray(edges)
        return np.diff(np.append(edges, self.horizon_h))

    def event_deltas(self) -> List[Tuple[float, int, int]]:
        """Time-sorted ``(time_h, node, +1/-1)`` occupancy deltas.

        Fault events may overlap on one node (background + burst), so the
        event-by-event replay tracks a per-node active-event *count*; a node
        is faulty at ``t`` iff its count is positive once every delta with
        ``time <= t`` has been applied -- identical to ``faulty_at(t)``.
        Ends clipped at the horizon emit no delta (they never fire inside
        the trace window).
        """
        deltas: List[Tuple[float, int, int]] = []
        for e in self.events:
            deltas.append((e.start_h, e.node, +1))
            if e.end_h < self.horizon_h:
                deltas.append((e.end_h, e.node, -1))
        deltas.sort(key=lambda d: d[0])
        return deltas

    def fault_ratio_series(self, num: int = 500) -> np.ndarray:
        ts = self.sample_times(num)
        return np.array([len(self.faulty_at(t)) / self.num_nodes for t in ts])

    def mean_fault_ratio(self, num: int = 500) -> float:
        return float(self.fault_ratio_series(num).mean())

    def p99_fault_ratio(self, num: int = 500) -> float:
        return float(np.percentile(self.fault_ratio_series(num), 99))

    def mean_repair_h(self) -> float:
        if not self.events:
            return 0.0
        return float(np.mean([e.end_h - e.start_h for e in self.events]))


def generate_trace(num_nodes: int, horizon_h: float = 348 * 24.0,
                   mean_ratio: float = MEAN_FAULT_RATIO_8GPU,
                   p99_ratio: float = P99_FAULT_RATIO_8GPU,
                   mean_repair_h: float = 8.0, seed: int = 0) -> FaultTrace:
    """Generate a trace matching the target stationary mean and a heavy tail.

    Two superposed processes:
      * background: per-node Poisson failures, exponential repair with mean
        ``mean_repair_h``; rate solved so its stationary ratio hits the bulk
        of ``mean_ratio``.
      * bursts: cluster-wide incidents (power/network) that take out a random
        ~(p99 - mean) fraction simultaneously for a short window -- these
        create the P99 spikes seen in Fig. 18a.
    """
    rng = np.random.default_rng(seed)
    events: List[FaultEvent] = []

    # Background process: stationary faulty fraction = rate*repair/(1+rate*repair)
    burst_share = 0.25  # fraction of steady-state downtime owed to bursts
    bg_ratio = mean_ratio * (1.0 - burst_share)
    lam = bg_ratio / ((1.0 - bg_ratio) * mean_repair_h)  # failures per node-hour
    for node in range(num_nodes):
        t = float(rng.exponential(1.0 / lam))
        while t < horizon_h:
            dur = float(rng.exponential(mean_repair_h))
            events.append(FaultEvent(node, t, min(t + dur, horizon_h)))
            t += dur + float(rng.exponential(1.0 / lam))

    # Burst incidents: sized so the overall mean lands on target and the P99
    # reaches the requested spike level.
    burst_budget = mean_ratio * burst_share * horizon_h * num_nodes  # node-hours
    spent = 0.0
    while spent < burst_budget:
        frac = float(rng.uniform(0.5, 1.0)) * max(p99_ratio - bg_ratio, 0.01)
        count = max(1, int(frac * num_nodes))
        start = float(rng.uniform(0.0, horizon_h))
        dur = float(rng.exponential(mean_repair_h))
        nodes = rng.choice(num_nodes, size=count, replace=False)
        for node in nodes:
            events.append(FaultEvent(int(node), start, min(start + dur, horizon_h)))
        spent += count * dur
    return FaultTrace(num_nodes, horizon_h, events)


def to_4gpu_trace(trace: FaultTrace, seed: int = 0) -> FaultTrace:
    """Appendix-A Bayes conversion: each 8-GPU node splits into two 4-GPU
    nodes; on every 8-GPU fault event each half fails independently w.p.
    ``BAYES_SPLIT_P`` (at least one must fail; resampled accordingly)."""
    rng = np.random.default_rng(seed)
    events: List[FaultEvent] = []
    # Consistent conditional: given the 8-GPU node fault, at least one half
    # contains the failing GPU (marginal per half = BAYES_SPLIT_P, so both
    # fail with probability 2p - 1).
    p_both = max(0.0, 2.0 * BAYES_SPLIT_P - 1.0)
    for e in trace.events:
        a, b = 2 * e.node, 2 * e.node + 1
        if rng.random() < p_both:
            fa = fb = True
        else:
            fa = bool(rng.integers(0, 2))
            fb = not fa
        if fa:
            events.append(FaultEvent(a, e.start_h, e.end_h))
        if fb:
            events.append(FaultEvent(b, e.start_h, e.end_h))
    return FaultTrace(trace.num_nodes * 2, trace.horizon_h, events)


def iid_fault_sets(num_nodes: int, node_fault_ratio: float, samples: int,
                   seed: int = 0) -> Iterator[Set[int]]:
    """I.i.d. snapshots at a fixed node fault ratio (for Fig. 14-style sweeps)."""
    for mask in iid_fault_masks(num_nodes, node_fault_ratio, samples, seed):
        yield set(np.nonzero(mask)[0].tolist())


def iid_fault_masks(num_nodes: int, node_fault_ratio: float, samples: int,
                    seed: int = 0) -> np.ndarray:
    """Batched form of :func:`iid_fault_sets`: a ``(samples, num_nodes)`` bool
    matrix drawn from the identical RNG stream (row ``i`` == snapshot ``i``)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.random(num_nodes) < node_fault_ratio
                     for _ in range(samples)]) if samples else \
        np.zeros((0, num_nodes), dtype=bool)
