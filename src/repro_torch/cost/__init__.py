"""Batched cost-effectiveness engine: the paper's §6.5 claims at grid scale.

Prices fault-scenario grids with the §6.5 aggregate-cost formula (Table 8
BOMs, Table 6 per-GPU costs reproduced to the cent, the 31%-of-NVL-72
headline ratio), over i.i.d. snapshot sweeps (Fig. 17d curves) and over
trace-driven churn timelines (dollars / watts per delivered MFU-GPU-hour).

The counterpart of ``repro.cost``, with the same exports; the waste
sweeps underneath run on ``device`` (``cuda`` by default).

Typical use::

    from repro_torch.cost import (CostSpec, cost_effectiveness_table,
                                  run_cost_sweep)

    spec = CostSpec(num_nodes=768, fault_ratios=(0.0, 0.05, 0.10),
                    samples=200, tp_sizes=(8, 32))
    result = run_cost_sweep(spec)                  # torch on cuda
    result = run_cost_sweep(spec, device="cpu")    # the same kernels on the CPU
    for row in cost_effectiveness_table(result, tp=32):
        print(row)
"""

from .bridge import timeline_cost_grid, timeline_cost_table
from .engine import (CostResult, CostSpec, DEFAULT_COST_ARCHITECTURES,
                     cost_grid, run_cost_sweep, run_cost_sweep_scalar)
from .tables import (cost_effectiveness_table, cost_table,
                     headline_ratio_rows, hosting_architectures,
                     per_gpu_cost_table)

__all__ = [
    "CostResult", "CostSpec", "DEFAULT_COST_ARCHITECTURES",
    "cost_grid", "run_cost_sweep", "run_cost_sweep_scalar",
    "cost_effectiveness_table", "cost_table", "headline_ratio_rows",
    "hosting_architectures", "per_gpu_cost_table",
    "timeline_cost_grid", "timeline_cost_table",
]
