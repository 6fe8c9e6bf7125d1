"""Batched DCN traffic sweeps: (variant x fault_ratio x snapshot x TP) grids.

A :class:`DcnSpec` declares one cross-ToR traffic experiment -- the paper's
Fig. 17 axes -- and :func:`run_dcn_sweep` evaluates it through the batched
placement kernels (NumPy, or torch on ``device`` for the Algorithm-4/5
variant), producing dense integer pair-count grids that
:mod:`repro_torch.dcn.tables` reduces to the cross-ToR-vs-fault-ratio curve.

Placement variants:

  * ``orchestrated`` -- Algorithm 4/5 (``orchestrate_fat_tree``);
  * ``greedy``       -- the paper's §6.4 random baseline;
  * ``dgx-island``   -- static contiguous islands (DGX-class scheduling,
    no optical re-splicing), the §6.3 comparison point.

``run_dcn_sweep_scalar`` is the per-snapshot Python reference; the batched
grids match it bit-for-bit (``tests/test_torch_dcn.py``), and both backends of
the batched engine match each other.  Snapshot masks come from the
counter-based threefry stream (``repro_torch.core.prng``) so the grid is
reproducible from the spec alone on every backend.

The counterpart of ``repro.dcn.engine``: its ``backend="jax"`` is
``backend="torch"`` here (``repro_torch.dcn.torch_backend``), which runs
on ``device`` -- ``cuda`` by default, raising without a card; it never
falls back to NumPy or to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..core.orchestrator import (deployment_strategy, greedy_baseline,
                                 orchestrate_fat_tree, traffic_pair_counts,
                                 traffic_volume_shares)
from ..core.prng import counter_fault_masks
from .kernel import (BatchedPlacement, FatTreeConfig, batched_dgx_island,
                     batched_fat_tree, batched_greedy, batched_pair_counts,
                     dgx_island_placement)

VARIANTS: Tuple[str, ...] = ("orchestrated", "greedy", "dgx-island")
BACKENDS: Tuple[str, ...] = ("numpy", "torch")

_COUNT_KEYS = ("groups", "dp_pairs", "crossing_pairs", "crossing_pod_pairs")


def variant_for(architecture: str) -> Optional[str]:
    """Placement variant of a registered architecture -- the registry's
    traffic-model hook (``repro_torch.core.arch.ArchSpec.placement_variant``).

    ``None`` means the architecture has no DCN topology model (the
    idealized ``big-switch``); an unknown architecture raises the
    registry's instructive KeyError, and a spec declaring a variant this
    engine does not implement raises ``ValueError``.
    """
    from ..core import arch
    variant = arch.get(architecture).placement_variant
    if variant is not None and variant not in VARIANTS:
        raise ValueError(
            f"architecture {architecture!r} declares placement variant "
            f"{variant!r}; this engine implements {VARIANTS}")
    return variant


def resolve_backend(backend: Optional[str]) -> str:
    """Resolve ``backend`` ("auto"/None reads ``REPRO_SWEEP_BACKEND``).

    ``auto`` is ``torch``: the placement kernel has a torch version for
    every regular geometry.  Which device it runs on is the caller's
    ``device`` argument, never chosen here.  Only the ``orchestrated``
    variant runs on the device -- the baselines are cheap host kernels
    either way.
    """
    if backend in (None, "auto"):
        backend = os.environ.get("REPRO_SWEEP_BACKEND", "auto").strip().lower() \
            or "auto"
        if backend not in ("auto",) + BACKENDS:
            raise ValueError(
                f"REPRO_SWEEP_BACKEND={backend!r} (want numpy|torch|auto)")
        return "torch" if backend == "auto" else backend
    if backend in BACKENDS:
        return backend
    raise ValueError(f"unknown backend {backend!r} (numpy|torch|auto)")


@dataclasses.dataclass(frozen=True)
class DcnSpec:
    """One traffic sweep: ``variants x fault_ratios x snapshots x tp_sizes``."""

    num_nodes: int
    fault_ratios: Tuple[float, ...] = (0.0, 0.03, 0.05, 0.07, 0.10)
    samples: int = 20
    seed: int = 0
    tp_sizes: Tuple[int, ...] = (32,)
    job_scale: float = 0.85
    variants: Tuple[str, ...] = VARIANTS
    gpus_per_node: int = 4
    nodes_per_tor: int = 8
    agg_domain: int = 64
    k: int = 3
    greedy_seed: int = 0

    @property
    def config(self) -> FatTreeConfig:
        return FatTreeConfig(self.num_nodes, self.gpus_per_node,
                             self.nodes_per_tor, self.agg_domain, self.k)

    def job_gpus(self, tp: int) -> int:
        total = self.num_nodes * self.gpus_per_node
        return max(int(total * self.job_scale) // tp * tp, tp)

    def masks(self, ratio_index: int) -> np.ndarray:
        """Snapshot masks of one fault-ratio row (counter threefry stream)."""
        return counter_fault_masks(self.num_nodes,
                                   self.fault_ratios[ratio_index],
                                   self.samples, self.seed + ratio_index)


@dataclasses.dataclass
class DcnSweepResult:
    """Dense integer pair-count grids of one traffic sweep."""

    spec: DcnSpec
    variants: List[str]            # grid axis 0
    tp_sizes: np.ndarray           # (T,), grid axis 3
    groups: np.ndarray             # (V, R, S, T) int64
    dp_pairs: np.ndarray           # (V, R, S, T) int64
    crossing_pairs: np.ndarray     # (V, R, S, T) int64
    crossing_pod_pairs: np.ndarray  # (V, R, S, T) int64
    feasible: np.ndarray           # (V, R, S, T) bool
    n_constraints: np.ndarray      # (R, S, T) int64 (orchestrated; -1 n/a)
    backend: str = "numpy"

    @property
    def group_nodes(self) -> np.ndarray:
        """Nodes per TP group, (T,)."""
        return self.tp_sizes // self.spec.gpus_per_node

    def shares(self, dp_bytes: float = 1.0,
               tp_bytes: float = 9.0) -> Dict[str, np.ndarray]:
        """Volume-weighted share grids, each ``(V, R, S, T)`` float64.

        Identical float expressions to the scalar ``cross_tor_traffic``
        path (shared ``traffic_volume_shares``), so shares agree
        bit-for-bit wherever the counts do.
        """
        tp_members = self.groups * self.group_nodes[None, None, None, :]
        return traffic_volume_shares(self.dp_pairs, self.crossing_pairs,
                                     self.crossing_pod_pairs, tp_members,
                                     dp_bytes, tp_bytes)

    def index(self, variant: str) -> int:
        return self.variants.index(variant)

    def ratio_index(self, ratio: float) -> int:
        return int(np.nonzero(
            np.isclose(np.asarray(self.spec.fault_ratios), ratio))[0][0])


# ------------------------------------------------------------ batched path

def evaluate_placements(masks: np.ndarray, cfg: FatTreeConfig, variant: str,
                        tp_size: int, job_gpus: int, *,
                        backend: str = "auto", greedy_seed: int = 0,
                        chunk_snapshots: int = 1024,
                        device="cuda") -> BatchedPlacement:
    """Batched placements of one variant on one mask matrix (shared core).

    The sweep grid, the churn traffic timeline and ``chip_smoke.py`` call
    this; ``backend`` only affects the ``orchestrated`` variant (the
    baselines are host kernels) and ``device`` is where the torch backend
    runs.  Falls back to the scalar loop for irregular geometry so the
    result is always bit-for-bit the scalar reference.
    """
    chosen = resolve_backend(backend)
    with obs.span("dcn.evaluate_placements", variant=variant,
                  tp=tp_size, snapshots=len(masks), backend=chosen):
        if variant == "orchestrated":
            if not cfg.regular():
                return _scalar_fat_tree(masks, cfg, tp_size, job_gpus)
            if chosen == "torch":
                from . import torch_backend
                return torch_backend.fat_tree_placements(
                    masks, cfg, [tp_size], [job_gpus],
                    chunk_snapshots=chunk_snapshots, device=device)[0]
            return batched_fat_tree(masks, cfg, tp_size, job_gpus)
        if variant == "greedy":
            order = np.asarray(deployment_strategy(
                cfg.num_nodes, cfg.nodes_per_tor).order, dtype=np.int64)
            return batched_greedy(masks, cfg, tp_size, job_gpus,
                                  seed=greedy_seed, order=order)
        if variant == "dgx-island":
            return batched_dgx_island(masks, cfg, tp_size, job_gpus)
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")


def _scalar_fat_tree(masks: np.ndarray, cfg: FatTreeConfig, tp_size: int,
                     job_gpus: int) -> BatchedPlacement:
    """Scalar-loop fallback with the batched output contract."""
    masks = np.asarray(masks, dtype=bool)
    m = cfg.group_nodes(tp_size)
    need = cfg.need_groups(tp_size, job_gpus)
    s = masks.shape[0]
    out = BatchedPlacement(np.full((s, need, m), -1, np.int32),
                           np.zeros(s, bool), np.full(s, -1, np.int64),
                           need, m)
    for si in range(s):
        faults = set(np.nonzero(masks[si])[0].tolist())
        pl = orchestrate_fat_tree(cfg.num_nodes, cfg.gpus_per_node,
                                  cfg.nodes_per_tor, faults, tp_size,
                                  job_gpus, cfg.agg_domain, cfg.k)
        if pl is not None:
            out.members[si] = np.asarray(pl, dtype=np.int32)
            out.feasible[si] = True
    return out


def run_dcn_sweep(spec: DcnSpec, *, backend: str = "auto",
                  masks: Optional[Sequence[np.ndarray]] = None,
                  chunk_snapshots: int = 1024,
                  device="cuda") -> DcnSweepResult:
    """Evaluate the full traffic grid through the batched kernels.

    Grid axes are ``(variants V, fault_ratios R, snapshots S, TP sizes
    T)``; ``backend`` selects the NumPy or torch placement kernel for the
    ``orchestrated`` variant (bit-identical grids either way), and
    ``device`` is where the torch kernel runs.  ``masks`` may supply one
    pre-materialized ``(samples, nodes)`` matrix per fault ratio
    (``chip_smoke.py`` does, so timing isolates the kernels).
    """
    chosen = resolve_backend(backend)
    cfg = spec.config
    v_count, r_count = len(spec.variants), len(spec.fault_ratios)
    t_count = len(spec.tp_sizes)
    shape = (v_count, r_count, spec.samples, t_count)
    grids = {key: np.zeros(shape, dtype=np.int64) for key in _COUNT_KEYS}
    feasible = np.zeros(shape, dtype=bool)
    n_constraints = np.full((r_count, spec.samples, t_count), -1,
                            dtype=np.int64)
    # one kernel invocation per (variant, TP) over ALL fault-ratio rows --
    # the fault_ratio axis rides the batched snapshot axis
    with obs.span("dcn.run_dcn_sweep", backend=chosen,
                  variants=v_count, ratios=r_count, tps=t_count):
        row_masks = [spec.masks(ri) if masks is None
                     else np.asarray(masks[ri], dtype=bool)
                     for ri in range(r_count)]
        stacked = (np.concatenate(row_masks) if row_masks
                   else np.zeros((0, spec.num_nodes), dtype=bool))
        for ti, tp in enumerate(spec.tp_sizes):
            job = spec.job_gpus(int(tp))
            for vi, variant in enumerate(spec.variants):
                bp = evaluate_placements(
                    stacked, cfg, variant, int(tp), job, backend=chosen,
                    greedy_seed=spec.greedy_seed,
                    chunk_snapshots=chunk_snapshots, device=device)
                counts = batched_pair_counts(bp, cfg.nodes_per_tor,
                                             cfg.agg_domain)
                grid_shape = (r_count, spec.samples)
                for key in _COUNT_KEYS:
                    grids[key][vi, :, :, ti] = counts[key].reshape(
                        grid_shape)
                feasible[vi, :, :, ti] = bp.feasible.reshape(grid_shape)
                if variant == "orchestrated":
                    n_constraints[:, :, ti] = bp.n_constraints.reshape(
                        grid_shape)
    return DcnSweepResult(spec, list(spec.variants),
                          np.asarray(spec.tp_sizes, dtype=np.int64),
                          grids["groups"], grids["dp_pairs"],
                          grids["crossing_pairs"],
                          grids["crossing_pod_pairs"], feasible,
                          n_constraints, backend=chosen)


# ------------------------------------------------------------- scalar path

def run_dcn_sweep_scalar(spec: DcnSpec, *,
                         masks: Optional[Sequence[np.ndarray]] = None
                         ) -> DcnSweepResult:
    """Reference implementation: per-snapshot Python orchestration.

    Count and feasibility grids match :func:`run_dcn_sweep` bit-for-bit;
    ``n_constraints`` stays ``-1`` (Algorithm 5 does not report the level
    it settled on, only the batched kernel does).
    """
    cfg = spec.config
    order = list(deployment_strategy(cfg.num_nodes, cfg.nodes_per_tor).order)
    v_count, r_count = len(spec.variants), len(spec.fault_ratios)
    t_count = len(spec.tp_sizes)
    shape = (v_count, r_count, spec.samples, t_count)
    grids = {key: np.zeros(shape, dtype=np.int64) for key in _COUNT_KEYS}
    feasible = np.zeros(shape, dtype=bool)
    n_constraints = np.full((r_count, spec.samples, t_count), -1,
                            dtype=np.int64)
    for ri in range(r_count):
        row_masks = (spec.masks(ri) if masks is None
                     else np.asarray(masks[ri], dtype=bool))
        for si in range(row_masks.shape[0]):
            faults = set(np.nonzero(row_masks[si])[0].tolist())
            for ti, tp in enumerate(spec.tp_sizes):
                tp = int(tp)
                job = spec.job_gpus(tp)
                m = cfg.group_nodes(tp)
                need = cfg.need_groups(tp, job)
                for vi, variant in enumerate(spec.variants):
                    if variant == "orchestrated":
                        pl = orchestrate_fat_tree(
                            cfg.num_nodes, cfg.gpus_per_node,
                            cfg.nodes_per_tor, faults, tp, job,
                            cfg.agg_domain, cfg.k)
                    elif variant == "greedy":
                        pl = greedy_baseline(cfg.num_nodes, cfg.gpus_per_node,
                                             faults, tp, job, cfg.k,
                                             spec.greedy_seed, order=order)
                    elif variant == "dgx-island":
                        pl = dgx_island_placement(cfg.num_nodes, faults, m,
                                                  need)
                    else:
                        raise ValueError(f"unknown variant {variant!r}")
                    if pl is None:
                        continue
                    counts = traffic_pair_counts(pl, cfg.nodes_per_tor,
                                                 cfg.agg_domain)
                    for key in _COUNT_KEYS:
                        grids[key][vi, ri, si, ti] = counts[key]
                    feasible[vi, ri, si, ti] = True
    return DcnSweepResult(spec, list(spec.variants),
                          np.asarray(spec.tp_sizes, dtype=np.int64),
                          grids["groups"], grids["dp_pairs"],
                          grids["crossing_pairs"],
                          grids["crossing_pod_pairs"], feasible,
                          n_constraints, backend="scalar")
