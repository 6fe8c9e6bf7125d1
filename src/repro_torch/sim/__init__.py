"""Batched scenario engine of the port: declarative fault sweeps over HBD
architectures, on the card.

The counterpart of ``repro.sim`` (the paper's §6.2 resiliency evaluation,
Figs. 13-16, as ``(architectures x snapshots x TP)`` grids).  The DCN
traffic and serving-SLO axes that ``repro.sim`` re-exports come with their
slices, as does ``comparison_matrix``.

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
from .tables import fault_waiting_table, max_job_table, to_csv, waste_table

__all__ = [
    "SweepResult", "run_sweep", "run_sweep_scalar", "evaluate_masks",
    "BACKENDS", "resolve_backend",
    "ScenarioSpec", "TraceSnapshots", "IIDSnapshots", "CounterIIDSnapshots",
    "MODEL_REGISTRY", "DEFAULT_ARCHITECTURES", "make_model",
    "waste_table", "max_job_table", "fault_waiting_table", "to_csv",
]
