"""Batched fat-tree DCN traffic engine with incremental tiered placement.

The scale-out counterpart of ``repro_torch.sim``: where the scenario engine
asks "how many GPUs can still be *placed*", this subsystem asks "what does
the surviving placement cost the *DCN*" -- the paper's Fig. 17 cross-ToR
traffic claims, including near-zero cross-ToR share under 7% node faults.
The counterpart of ``repro.dcn``, with the same exports.

Typical use::

    from repro_torch.dcn import DcnSpec, run_dcn_sweep, traffic_tables

    spec = DcnSpec(num_nodes=2048, fault_ratios=(0.0, 0.03, 0.07),
                   tp_sizes=(32,), job_scale=0.85)
    result = run_dcn_sweep(spec)                  # torch on cuda
    result = run_dcn_sweep(spec, device="cpu")    # the same kernel on the CPU
    for row in traffic_tables(result):
        print(row)

Single fault/repair events go through
:class:`~repro_torch.dcn.incremental.IncrementalFatTreeOrchestrator`, which
delta-updates Algorithm 4/5's tiered placement (equal to full
re-orchestration); ``ClusterManager`` uses it when the cluster geometry is
regular.
"""

from .engine import (DcnSpec, DcnSweepResult, VARIANTS, evaluate_placements,
                     resolve_backend, run_dcn_sweep, run_dcn_sweep_scalar,
                     variant_for)
from .incremental import IncrementalFatTreeOrchestrator
from .kernel import (BatchedPlacement, FatTreeConfig, batched_dgx_island,
                     batched_fat_tree, batched_greedy, batched_pair_counts,
                     dgx_island_placement, line_carve)
from .tables import cross_tor_curve, traffic_tables
from .traffic import LLAMA3_70B, dp_tp_bytes, dp_tp_ratio

__all__ = [
    "BatchedPlacement", "DcnSpec", "DcnSweepResult", "FatTreeConfig",
    "IncrementalFatTreeOrchestrator", "LLAMA3_70B", "VARIANTS",
    "batched_dgx_island", "batched_fat_tree", "batched_greedy",
    "batched_pair_counts", "cross_tor_curve", "dgx_island_placement",
    "dp_tp_bytes", "dp_tp_ratio", "evaluate_placements", "line_carve",
    "resolve_backend", "run_dcn_sweep", "run_dcn_sweep_scalar",
    "traffic_tables", "variant_for",
]
