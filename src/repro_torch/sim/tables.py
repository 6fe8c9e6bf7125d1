"""Reductions from a SweepResult grid to the paper's figure tables.

The counterpart of ``repro.sim.tables``; ``comparison_matrix`` runs its
waste and DCN sweeps on ``device`` and its MFU economics on the host.

Each helper returns a list of plain dict rows (one per architecture x TP
combination) so callers can print CSV, assert on values, or feed plotting.
The actual reductions live in :mod:`repro_torch.core.reductions`, a copy
of the JAX package's, matching the scalar definitions bit-for-bit: waste statistics
(Fig. 13/14), P5 placeable capacity (Fig. 15), and fault-waiting share
(Fig. 16/23).
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Sequence, Tuple

from .. import obs
from ..core.reductions import (percentile_capacity, waiting_share,
                               waste_stats)
from .engine import SweepResult


def waste_table(result: SweepResult) -> List[Dict]:
    """Per (architecture, TP): mean/P50/P99 waste ratio over snapshots."""
    waste = result.waste_ratio
    rows = []
    for ai, name in enumerate(result.names):
        for ti, tp in enumerate(result.tp_sizes):
            mean, p50, p99 = waste_stats(waste[ai, :, ti])
            rows.append({
                "architecture": name, "tp_size": int(tp),
                "mean_waste": mean, "p50_waste": p50, "p99_waste": p99,
            })
    return rows


def max_job_table(result: SweepResult, percentile: float = 5.0) -> List[Dict]:
    """Per (architecture, TP): P5 of placeable GPUs -- the job scale a long
    run could hold through ~95% of the trace (Fig. 15)."""
    rows = []
    for ai, name in enumerate(result.names):
        for ti, tp in enumerate(result.tp_sizes):
            gpus = percentile_capacity(result.placed_gpus[ai, :, ti],
                                       percentile)
            total = int(result.total_gpus[ai, ti])
            rows.append({
                "architecture": name, "tp_size": int(tp),
                "max_job_gpus": gpus,
                "fraction": gpus / total if total else 0.0,
            })
    return rows


def fault_waiting_table(result: SweepResult,
                        job_gpus: Sequence[int]) -> List[Dict]:
    """Per (architecture, TP, job size): share of snapshots during which the
    job cannot run because placeable capacity < requirement (Fig. 16/23)."""
    rows = []
    for ai, name in enumerate(result.names):
        for ti, tp in enumerate(result.tp_sizes):
            placed = result.placed_gpus[ai, :, ti]
            for jg in job_gpus:
                rows.append({
                    "architecture": name, "tp_size": int(tp),
                    "job_gpus": int(jg),
                    "waiting_share": waiting_share(placed, jg),
                })
    return rows


def comparison_matrix(num_nodes: int = 512, *,
                      fault_ratios: Sequence[float] = (0.0, 0.02, 0.05, 0.10),
                      samples: int = 25, tp: int = 32, seed: int = 0,
                      architectures: Optional[Sequence[str]] = None,
                      backend: str = "auto", sim_model=None,
                      global_batch: int = 2048, max_dp: int = 1024,
                      amortize_h: float = 3 * 8760.0,
                      gpus_per_node: int = 4,
                      dp_bytes: float = 1.0, tp_bytes: float = 9.0,
                      cluster_kwargs: Optional[Dict] = None,
                      dcn_kwargs: Optional[Dict] = None,
                      device="cuda") -> List[Dict]:
    """Cross-paper comparison matrix: one row per (architecture, fault
    ratio) with the three headline axes side by side --

      * ``waste_ratio``        -- snapshot-mean GPU waste ratio (§2.1)
        from the batched scenario engine;
      * ``cross_tor_share``    -- mean volume-weighted cross-ToR traffic
        share of the architecture's registered placement variant
        (``ArchSpec.placement_variant`` via ``repro_torch.dcn``); ``None`` for
        architectures without a DCN topology model;
      * ``usd_per_mfu_gpu_h``  -- interconnect+GPU capex amortized over
        ``amortize_h`` hours, divided by the cluster-level MFU actually
        delivered under the faults (elastic power-of-two DP via
        ``repro_torch.churn.mfu_bridge``); ``None`` for unpriceable
        architectures (``ArchSpec.unpriceable``).

    Every architecture is evaluated under *identical fault grids*: ratio
    row ``i`` draws its snapshot masks from the counter-based threefry
    stream at ``seed + i`` in both the scenario sweep and the DCN sweep
    (``CounterIIDSnapshots`` and ``DcnSpec.masks`` share
    ``repro_torch.core.prng.counter_fault_masks``).  All reductions are host
    float64 over the engines' backend-bit-identical int64 grids, so the
    matrix is reproducible bit-for-bit across the numpy and torch backends
    and equal to ``repro``'s (``tests/test_torch_cost.py``).  ``device``
    is where the torch backend of both sweeps runs (``cuda`` unless the
    caller passes ``"cpu"``; it raises without a card).

    ``architectures`` defaults to every registered architecture -- the
    full rival zoo (``repro_torch.core.arch.names()``).  Traffic shares pin the
    historical DP:TP byte weighting (``dp_bytes``/``tp_bytes``) so rows
    stay comparable across TP sizes.
    """
    from ..core import arch
    from ..core.cost_model import GPU_UNIT_COST
    from ..churn.mfu_bridge import elastic_mfu, pow2_floor
    from ..dcn.engine import DcnSpec, run_dcn_sweep, variant_for
    from ..dcn.tables import traffic_tables
    from .engine import run_sweep
    from .scenario import CounterIIDSnapshots, ScenarioSpec

    arches = tuple(architectures) if architectures is not None \
        else arch.names()
    specs = [arch.get(a) for a in arches]
    fault_ratios = tuple(float(r) for r in fault_ratios)

    matrix_span = obs.span("sim.comparison_matrix",
                           architectures=len(arches),
                           ratios=len(fault_ratios))
    with matrix_span:
        # 1. waste grids, one scenario sweep per fault-ratio row
        with obs.span("matrix.waste_sweeps", ratios=len(fault_ratios)):
            sweeps = [run_sweep(ScenarioSpec(
                num_nodes=num_nodes,
                snapshots=CounterIIDSnapshots(ratio, samples=samples,
                                              seed=seed + ri),
                tp_sizes=(tp,), architectures=arches,
                gpus_per_node=gpus_per_node),
                backend=backend, device=device)
                for ri, ratio in enumerate(fault_ratios)]

        # 2. cross-ToR shares of every placement variant the suite maps
        #    to, over the same counter-threefry mask rows
        variants: List[str] = []
        for a in arches:
            v = variant_for(a)
            if v is not None and v not in variants:
                variants.append(v)
        shares: Dict[Tuple[str, float], Optional[float]] = {}
        if variants:
            with obs.span("matrix.dcn_shares", variants=len(variants)):
                dres = run_dcn_sweep(DcnSpec(
                    num_nodes=num_nodes, fault_ratios=fault_ratios,
                    samples=samples, seed=seed, tp_sizes=(tp,),
                    variants=tuple(variants), gpus_per_node=gpus_per_node,
                    **(dcn_kwargs or {})),
                    backend=backend, device=device)
                for r in traffic_tables(dres, dp_bytes=dp_bytes,
                                        tp_bytes=tp_bytes):
                    shares[(r["variant"], r["fault_ratio"])] = \
                        r["mean_cross_tor_share"]

        # 3. delivered-MFU economics: elastic power-of-two DP per
        #    snapshot, one MFU search per distinct DP degree (shared
        #    across the suite)
        if sim_model is None:
            from ..core.mfu_sim import LLAMA31_405B
            sim_model = LLAMA31_405B
        mfu_cache: Dict[int, Optional[object]] = {}

        def cluster_mfu(dp: int, total: int) -> float:
            if dp < 1 or total <= 0:
                return 0.0
            if dp not in mfu_cache:
                mfu_cache[dp] = elastic_mfu(sim_model, tp, dp,
                                            global_batch=global_batch,
                                            cluster_kwargs=cluster_kwargs)
            res = mfu_cache[dp]
            return res.mfu * (tp * dp) / total if res else 0.0

        rows = []
        with obs.span("matrix.mfu_economics", architectures=len(arches)):
            for ai, (name, spec) in enumerate(zip(arches, specs)):
                variant = variant_for(name)
                for ri, ratio in enumerate(fault_ratios):
                    res = sweeps[ri]
                    total = int(res.total_gpus[ai, 0])
                    waste = float(res.waste_ratio[ai, :, 0].mean())
                    placed = res.placed_gpus[ai, :, 0]
                    dps = [min(int(d), max_dp)
                           for d in pow2_floor(placed // tp)]
                    mean_mfu = float(sum(cluster_mfu(d, total)
                                         for d in dps) / max(len(dps), 1))
                    if spec.bom is not None and mean_mfu > 0 and total > 0:
                        capex = (GPU_UNIT_COST
                                 + spec.bom.per_gpu_cost) * total
                        usd_per_mfu_gpu_h = capex / (mean_mfu * total
                                                     * amortize_h)
                    else:
                        usd_per_mfu_gpu_h = None
                    rows.append({
                        "architecture": name, "paper": spec.paper,
                        "fault_ratio": ratio, "tp_size": int(tp),
                        "waste_ratio": waste,
                        "cross_tor_share": (shares.get((variant, ratio))
                                            if variant is not None
                                            else None),
                        "mean_mfu": mean_mfu,
                        "usd_per_mfu_gpu_h": usd_per_mfu_gpu_h,
                        "priced": spec.bom is not None,
                    })
    return rows


def to_csv(rows: List[Dict]) -> str:
    """Render table rows as CSV (stable column order from the first row)."""
    if not rows:
        return ""
    cols = list(rows[0])
    buf = io.StringIO()
    buf.write(",".join(cols) + "\n")
    for r in rows:
        buf.write(",".join(_fmt(r.get(c)) for c in cols) + "\n")
    return buf.getvalue()


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)
