"""Discrete-event replay of one fault trace through the cluster models.

Two replay engines produce the :class:`~repro_torch.churn.timeline.ChurnTimeline`
waste grids **bit-for-bit identically** (pinned by ``tests/test_torch_churn.py``):

  * ``engine="scalar"``  -- true event-by-event replay: walk the trace's
    ``event_deltas`` stream, maintain per-node active-event counts, and run
    every architecture's scalar ``evaluate`` at each interval edge.  The
    reference semantics, O(events x architectures) Python.
  * ``engine="batched"`` -- the trace's per-interval occupancy matrix
    (``fault_masks(interval_edges())``) evaluated in one pass through the
    batched scenario engine (``repro_torch.sim.evaluate_masks``), on the NumPy
    or the torch backend (on ``device``).

The control-plane leg (:func:`control_plane_replay`) streams the same
fault/repair transitions through ``ClusterManager`` (which delta-updates
placements via ``IncrementalOrchestrator``), recording per-event
reconfiguration latencies -- hardware ``reconfig_latency_us`` samples plus
the protocol delay from :class:`~repro_torch.core.control_plane.ControlPlaneConfig`
-- and the elastic DP degree each replan settled on (Fig. 18's inputs).

The counterpart of ``repro.churn.replay``; the control-plane leg is host
code.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .. import obs
from ..core.control_plane import ClusterManager, ControlPlaneConfig
from ..core.placement import InsufficientCapacityError
from ..core.trace import FaultTrace
from ..sim.engine import evaluate_masks
from ..sim.scenario import DEFAULT_ARCHITECTURES, make_model
from .timeline import ChurnTimeline, ReconfigRecord


@dataclasses.dataclass(frozen=True)
class ChurnJob:
    """The training job the control plane keeps alive during a replay."""

    tp_size: int = 32
    dp_size: int = 8
    pod_size: int = 1
    k: int = 3
    nodes_per_tor: int = 8
    agg_domain: int = 64
    seed: int = 0


def _occupancy_transitions(trace: FaultTrace):
    """Yield ``(edge_h, newly_faulted, newly_repaired)`` per interval edge.

    Walks the delta stream with per-node active-event counts; only 0
    crossings are topology transitions (overlapping events on an
    already-faulty node reconfigure nothing).
    """
    counts = np.zeros(trace.num_nodes, dtype=np.int32)
    deltas = trace.event_deltas()
    di = 0
    for t in trace.interval_edges():
        was = counts > 0
        while di < len(deltas) and deltas[di][0] <= t:
            _, node, d = deltas[di]
            counts[node] += d
            di += 1
        now = counts > 0
        yield t, now, np.nonzero(now & ~was)[0], np.nonzero(was & ~now)[0]


def replay_trace(trace: FaultTrace, *, tp_sizes: Sequence[int] = (32,),
                 architectures: Sequence[str] = DEFAULT_ARCHITECTURES,
                 gpus_per_node: int = 4, engine: str = "batched",
                 backend: str = "auto", chunk_snapshots: int = 4096,
                 job: Optional[ChurnJob] = None,
                 config: Optional[ControlPlaneConfig] = None,
                 max_events: Optional[int] = None,
                 device="cuda") -> ChurnTimeline:
    """Replay one trace into a :class:`ChurnTimeline`.

    The timeline's grids are ``(architectures A, fault-intervals B, TP
    sizes T)``: one row per interval of ``trace.interval_edges()``,
    evaluated through ``engine="batched"`` (one pass of the scenario
    engine's ``evaluate_masks`` on the NumPy or torch ``backend``, the
    latter on ``device``) or ``engine="scalar"`` (event-by-event
    reference) --
    bit-for-bit identical either way.  With ``job`` set, the
    control-plane replay runs too and its :class:`ReconfigRecord` log
    (Fig. 18's inputs) is attached to the timeline.
    """
    models = [make_model(a, trace.num_nodes, gpus_per_node)
              for a in architectures]
    edges = trace.interval_edges()
    tps = np.asarray(list(tp_sizes), dtype=np.int64)

    with obs.span("churn.replay_trace", engine=engine,
                  intervals=len(edges), models=len(models)):
        return _replay_trace(trace, models, edges, tps, tp_sizes, engine,
                             backend, chunk_snapshots, job, config,
                             max_events, gpus_per_node, device)


def _replay_trace(trace, models, edges, tps, tp_sizes, engine, backend,
                  chunk_snapshots, job, config, max_events,
                  gpus_per_node, device) -> ChurnTimeline:
    if engine == "batched":
        masks = trace.fault_masks(edges)
        total, faulty, placed, chosen = evaluate_masks(
            models, tp_sizes, masks, chunk_snapshots=chunk_snapshots,
            backend=backend, device=device)
    elif engine == "scalar":
        snaps = len(edges)
        total = np.zeros((len(models), len(tps)), dtype=np.int64)
        faulty = np.zeros((len(models), snaps, len(tps)), dtype=np.int64)
        placed = np.zeros((len(models), snaps, len(tps)), dtype=np.int64)
        for bi, (_, now, _, _) in enumerate(_occupancy_transitions(trace)):
            faults = set(np.nonzero(now)[0].tolist())
            for ai, model in enumerate(models):
                mf = {u for u in faults if u < model.num_nodes}
                for ti, tp in enumerate(tps):
                    r = model.evaluate(mf, int(tp))
                    total[ai, ti] = r.total_gpus
                    faulty[ai, bi, ti] = r.faulty_gpus
                    placed[ai, bi, ti] = r.placed_gpus
        chosen = "scalar"
    else:
        raise ValueError(f"unknown engine {engine!r} (batched|scalar)")

    timeline = ChurnTimeline(trace.horizon_h, edges,
                             [m.name for m in models], tps,
                             total, faulty, placed, backend=chosen)
    if job is not None:
        timeline.reconfigs = control_plane_replay(
            trace, job, gpus_per_node=gpus_per_node, config=config,
            max_events=max_events)
    return timeline


def control_plane_replay(trace: FaultTrace, job: ChurnJob = ChurnJob(), *,
                         gpus_per_node: int = 4,
                         config: Optional[ControlPlaneConfig] = None,
                         max_events: Optional[int] = None,
                         ) -> List[ReconfigRecord]:
    """Stream the trace's fault/repair transitions through ``ClusterManager``.

    Every 0-crossing edge triggers ``on_repair``/``on_fault`` (repairs
    first: freed capacity is visible before the same edge's new faults);
    each replan's settle latency and surviving elastic DP degree become one
    :class:`ReconfigRecord`.  A replan that cannot place even TP x DP=1 is
    recorded with ``latency_us=None`` (the job waits) and the replay
    continues -- the next transition replans from the updated fault state.
    """
    cm = ClusterManager(trace.num_nodes, gpus_per_node, k=job.k,
                        nodes_per_tor=job.nodes_per_tor,
                        agg_domain=job.agg_domain, seed=job.seed,
                        incremental=True, config=config)
    records: List[ReconfigRecord] = []
    prev_gpus = job.tp_size * job.dp_size
    with obs.span("churn.control_plane_replay", nodes=trace.num_nodes,
                  horizon_h=trace.horizon_h):
        for t, _, faulted, repaired in _occupancy_transitions(trace):
            now_s = t * 3600.0
            for kind, nodes in (("repair", repaired), ("fault", faulted)):
                if not len(nodes):
                    continue
                node_set = {int(u) for u in nodes}
                fn = cm.on_repair if kind == "repair" else cm.on_fault
                # one span per reconfiguration event: its attributes carry
                # everything Fig. 18's latency table needs (kind, simulated
                # time, settle latency, surviving DP degree, GPU delta), so
                # the table is derivable from the trace file alone
                with obs.span("churn.reconfig", cat="churn", kind=kind,
                              sim_time_h=round(t, 4),
                              nodes=len(node_set)) as sp:
                    obs.count("churn.reconfig_events")
                    try:
                        ev = fn(now_s, node_set, job.tp_size, job.dp_size,
                                job.pod_size)
                        groups = len(ev.plan.placement)
                        latency_us = (ev.settle_s - ev.time_s) * 1e6
                        placed_gpus = groups * job.tp_size
                        records.append(ReconfigRecord(
                            t, kind, tuple(sorted(node_set)), latency_us,
                            groups // job.pod_size, placed_gpus))
                        sp.set(latency_us=round(latency_us, 3),
                               dp_degree=groups // job.pod_size,
                               placed_gpus=placed_gpus,
                               gpu_delta=placed_gpus - prev_gpus)
                        prev_gpus = placed_gpus
                    except InsufficientCapacityError:
                        records.append(ReconfigRecord(
                            t, kind, tuple(sorted(node_set)), None, 0, 0))
                        obs.count("churn.infeasible_replans")
                        sp.set(infeasible=True, gpu_delta=0 - prev_gpus)
                        prev_gpus = 0
            if max_events is not None and len(records) >= max_events:
                break
    return records


__all__ = ["ChurnJob", "control_plane_replay", "replay_trace"]
