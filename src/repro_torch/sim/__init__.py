"""Batched scenario engine of the port: declarative fault sweeps over HBD
architectures, on the card.

The counterpart of ``repro.sim`` (the paper's §6.2 resiliency evaluation,
Figs. 13-16, as ``(architectures x snapshots x TP)`` grids), with the
cross-paper ``comparison_matrix`` (``repro_torch.sim.tables``), the DCN
traffic axis (Fig. 17, ``repro_torch.dcn``) and the serving-SLO axis
(``repro_torch.slo``) re-exported beside it as ``repro.sim`` does.

Typical use::

    from repro_torch.sim import (ScenarioSpec, TraceSnapshots, run_sweep,
                                 waste_table)

    spec = ScenarioSpec(num_nodes=720,
                        snapshots=TraceSnapshots(trace_nodes=400, samples=400),
                        tp_sizes=(16, 32, 64))
    result = run_sweep(spec)                   # torch on cuda
    result = run_sweep(spec, device="cpu")     # the same kernels on the CPU
    for row in waste_table(result):
        print(row)
"""

from .engine import (BACKENDS, SweepResult, evaluate_masks, resolve_backend,
                     run_sweep, run_sweep_scalar)
from .scenario import (CounterIIDSnapshots, DEFAULT_ARCHITECTURES,
                       IIDSnapshots, MODEL_REGISTRY, ScenarioSpec,
                       TraceSnapshots, make_model)
from .tables import (comparison_matrix, fault_waiting_table, max_job_table,
                     to_csv, waste_table)
# DCN traffic axis of the sweep engine (Fig. 17): the batched fat-tree
# placement kernels live in repro_torch.dcn; the spec/sweep/reduction trio
# is re-exported here so traffic sweeps sit next to the waste sweeps.
from ..dcn.engine import DcnSpec, run_dcn_sweep, variant_for
from ..dcn.tables import traffic_tables
# Serving axis: production traffic against the churn timeline
# (repro_torch.slo) -- same spec/sweep/reduction contract.
from ..slo.engine import ServeSpec, run_serve_scalar, run_serve_sweep
from ..slo.tables import slo_table, timeline_slo_table

__all__ = [
    "SweepResult", "run_sweep", "run_sweep_scalar", "evaluate_masks",
    "BACKENDS", "resolve_backend",
    "ScenarioSpec", "TraceSnapshots", "IIDSnapshots", "CounterIIDSnapshots",
    "MODEL_REGISTRY", "DEFAULT_ARCHITECTURES", "make_model",
    "waste_table", "max_job_table", "fault_waiting_table", "to_csv",
    "comparison_matrix",
    "DcnSpec", "run_dcn_sweep", "traffic_tables", "variant_for",
    "ServeSpec", "run_serve_sweep", "run_serve_scalar", "slo_table",
    "timeline_slo_table",
]
