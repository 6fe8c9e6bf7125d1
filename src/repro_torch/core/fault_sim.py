"""Fault-resilience simulation driver (paper §6.2, Figs 13-16, 20-23).

Runs fault traces / i.i.d. fault snapshots through the comparative HBD models
and reports:

  * GPU waste ratio statistics over a trace (Fig. 13 CDF / Fig. 20 series),
  * waste ratio vs node fault ratio (Fig. 14 sweep),
  * maximum supported job scale (Fig. 15),
  * job fault-waiting time (Fig. 16): a job of ``job_gpus`` pauses whenever
    placeable capacity drops below its requirement; waiting time accumulates
    until repairs restore capacity.

A copy of ``repro.core.fault_sim``, on the port's copies of ``hbd_models``,
``reductions`` and ``trace``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set

import numpy as np

from .hbd_models import BatchedWasteResult, HBDModel, WasteResult
from .reductions import percentile_capacity, waiting_share, waste_stats
from .trace import FaultTrace, iid_fault_masks, iid_fault_sets


@dataclasses.dataclass
class TraceStats:
    name: str
    tp_size: int
    mean_waste: float
    p50_waste: float
    p99_waste: float
    series: np.ndarray


def _stats_from_series(name: str, tp_size: int,
                       series: np.ndarray) -> TraceStats:
    return TraceStats(name, tp_size, *waste_stats(series), series)


def waste_over_trace(model: HBDModel, trace: FaultTrace, tp_size: int,
                     samples: int = 400) -> TraceStats:
    ts = trace.sample_times(samples)
    series = np.empty(len(ts))
    for i, t in enumerate(ts):
        faults = {u for u in trace.faulty_at(t) if u < model.num_nodes}
        series[i] = model.evaluate(faults, tp_size).waste_ratio
    return _stats_from_series(model.name, tp_size, series)


# --------------------------------------------------------------------------
# Batched path: same metrics, one vectorized grid evaluation per model.
# Each wrapper reproduces its scalar sibling bit-for-bit (identical snapshot
# sets, identical integer placement, identical float reductions).
# --------------------------------------------------------------------------

def trace_grid(model: HBDModel, trace: FaultTrace, tp_sizes: Sequence[int],
               samples: int = 400) -> BatchedWasteResult:
    """Evaluate ``model`` on every (trace snapshot, TP size) pair at once."""
    masks = trace.fault_masks(trace.sample_times(samples))
    return model.evaluate_batch(masks, tp_sizes)


def waste_over_trace_batched(model: HBDModel, trace: FaultTrace,
                             tp_sizes: Sequence[int],
                             samples: int = 400) -> List[TraceStats]:
    grid = trace_grid(model, trace, tp_sizes, samples)
    waste = grid.waste_ratio
    return [_stats_from_series(model.name, int(tp), waste[:, ti])
            for ti, tp in enumerate(grid.tp_sizes)]


def waste_vs_fault_ratio_batched(model: HBDModel, tp_size: int,
                                 fault_ratios: Sequence[float],
                                 samples: int = 20,
                                 seed: int = 0) -> List[float]:
    out = []
    for fr in fault_ratios:
        masks = iid_fault_masks(model.num_nodes, fr, samples, seed)
        grid = model.evaluate_batch(masks, [tp_size])
        out.append(float(np.mean(grid.waste_ratio[:, 0])))
    return out


def max_job_scale_batched(model: HBDModel, trace: FaultTrace,
                          tp_sizes: Sequence[int],
                          samples: int = 200) -> List[float]:
    grid = trace_grid(model, trace, tp_sizes, samples)
    return [percentile_capacity(grid.placed_gpus[:, ti])
            for ti in range(len(grid.tp_sizes))]


def fault_waiting_time_batched(model: HBDModel, trace: FaultTrace,
                               tp_size: int, job_gpus: Sequence[int],
                               samples: int = 400) -> List[float]:
    """Waiting-time share for several job sizes from one grid evaluation."""
    grid = trace_grid(model, trace, [tp_size], samples)
    placed = grid.placed_gpus[:, 0]
    return [waiting_share(placed, jg) for jg in job_gpus]


def waste_vs_fault_ratio(model: HBDModel, tp_size: int,
                         fault_ratios: Sequence[float], samples: int = 20,
                         seed: int = 0) -> List[float]:
    """Mean waste ratio at fixed i.i.d. node-fault ratios (Fig. 14)."""
    out = []
    for fr in fault_ratios:
        vals = [model.evaluate(f, tp_size).waste_ratio
                for f in iid_fault_sets(model.num_nodes, fr, samples, seed)]
        out.append(float(np.mean(vals)))
    return out


def max_job_scale(model: HBDModel, trace: FaultTrace, tp_size: int,
                  samples: int = 200) -> float:
    """Largest job (in GPUs) supportable at every sampled instant (Fig. 15:
    we report the P5 of placeable capacity -- the scale a long job could hold
    through ~95% of the trace)."""
    ts = trace.sample_times(samples)
    cap = np.empty(len(ts))
    for i, t in enumerate(ts):
        faults = {u for u in trace.faulty_at(t) if u < model.num_nodes}
        cap[i] = model.evaluate(faults, tp_size).placed_gpus
    return percentile_capacity(cap)


def fault_waiting_time(model: HBDModel, trace: FaultTrace, tp_size: int,
                       job_gpus: int, samples: int = 400) -> float:
    """Fraction of the trace horizon during which a ``job_gpus`` job cannot
    run because placeable capacity < requirement (Fig. 16/23)."""
    ts = trace.sample_times(samples)
    waiting = 0
    for t in ts:
        faults = {u for u in trace.faulty_at(t) if u < model.num_nodes}
        if model.evaluate(faults, tp_size).placed_gpus < job_gpus:
            waiting += 1
    return waiting / len(ts)


def theoretical_waste_bound(tp_size: int, gpus_per_node: int, k: int,
                            node_fault_p: float) -> float:
    """Appendix C, Eq. (1): E[waste ratio] <= 2 (N_t - R) P_s^K."""
    return 2.0 * (tp_size - gpus_per_node) * (node_fault_p ** k)
