"""Trace-driven cluster-lifetime simulation: fault events -> MFU.

The layer between the snapshot scenario engine (``repro_torch.sim``) and the
training runtime: replay whole :class:`~repro_torch.core.trace.FaultTrace` event
streams -- not i.i.d. snapshots -- through the HBD models and the control
plane, and reduce the resulting timelines to the paper's *temporal*
resiliency claims (Fig. 18 reconfiguration-latency distributions,
time-integrated waste, and end-to-end MFU deltas per architecture).

The counterpart of ``repro.churn``, with the same exports; what ``repro``
runs with ``backend="jax"`` runs here with ``backend="torch"`` on
``device`` (``cuda`` by default).

Typical use::

    from repro_torch.churn import ChurnSpec, monte_carlo_replay, replay_trace

    spec = ChurnSpec(trace_nodes=400, tp_sizes=(32,))
    timeline = replay_trace(spec.trace(0), tp_sizes=spec.tp_sizes)
    ensemble = monte_carlo_replay(spec, traces=1000, backend="torch")
    ensemble = monte_carlo_replay(spec, traces=8, device="cpu")
"""

from .mfu_bridge import elastic_mfu, pow2_floor, timeline_mfu_table
from .monte_carlo import ChurnEnsemble, ChurnSpec, monte_carlo_replay
from .replay import ChurnJob, control_plane_replay, replay_trace
from .timeline import (ChurnTimeline, ReconfigRecord, integrated_waste_table,
                       latency_table)
from .traffic import (TrafficTimeline, integrated_traffic_table,
                      traffic_replay)

__all__ = [
    "ChurnEnsemble", "ChurnJob", "ChurnSpec", "ChurnTimeline",
    "ReconfigRecord", "TrafficTimeline",
    "control_plane_replay", "monte_carlo_replay", "replay_trace",
    "integrated_waste_table", "integrated_traffic_table", "latency_table",
    "traffic_replay",
    "elastic_mfu", "pow2_floor", "timeline_mfu_table",
]
