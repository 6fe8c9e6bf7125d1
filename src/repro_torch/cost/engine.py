"""Batched cost-effectiveness engine (paper §6.5, Fig. 17d, Tables 6/8).

Vectorizes the §6.5 aggregate-cost formula

    Cost = Cost_GPU * (N_wasted + N_faulty) + Cost_interconnect

over the scenario engine's batched fault-snapshot grids.  On the engine's
int64 grids ``N_wasted + N_faulty`` is exactly ``total - placed``, so one
float64 affine map per architecture turns any ``(fault_ratio x
architecture x snapshot x TP)`` sweep into a dollar grid -- no per-snapshot
Python, no re-evaluation of the waste kernels.

The counterpart of ``repro.cost.engine``.  The waste grids underneath come
from :func:`repro_torch.sim.run_sweep` on either compute backend
(``"numpy"`` | ``"torch"``, the latter on ``device`` with the counter-based
masks drawn there); the dollar map itself is ONE shared float64 host
implementation applied to those bit-identical int64 grids, so the cost
grids are bit-for-bit equal across backends and to the scalar §6.5
reference (:func:`repro_torch.core.cost_model.aggregate_cost` per
snapshot).  ``tests/test_torch_cost.py`` holds them to ``repro``'s.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..core.cost_model import (ArchBOM, GPU_UNIT_COST, aggregate_cost,
                               bom_for)
from ..sim.engine import run_sweep
from ..sim.scenario import CounterIIDSnapshots, ScenarioSpec, make_model

#: The §6.5 comparison set: every registry architecture with a BOM that the
#: paper's Fig. 17d / §6.3 comparisons price (big-switch and sip-ring have
#: no published BOM and cannot be priced).
DEFAULT_COST_ARCHITECTURES: Tuple[str, ...] = (
    "infinitehbd-k2", "infinitehbd-k3", "nvl-72", "tpuv4", "dgx-h100")


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """One cost sweep: ``fault_ratios x architectures x snapshots x TP``.

    Snapshot masks come from the counter-based threefry stream (ratio row
    ``i`` uses ``seed + i``, matching :class:`repro_torch.dcn.DcnSpec`), so
    the grid is reproducible from the spec alone on every backend and the
    torch path can draw masks on the device.
    """

    num_nodes: int
    fault_ratios: Tuple[float, ...] = (0.0, 0.02, 0.05, 0.08, 0.12, 0.15)
    samples: int = 100
    tp_sizes: Tuple[int, ...] = (8, 32)
    architectures: Tuple[str, ...] = DEFAULT_COST_ARCHITECTURES
    gpus_per_node: int = 4
    gpu_unit_cost: float = GPU_UNIT_COST
    seed: int = 0

    def models(self):
        return [make_model(a, self.num_nodes, self.gpus_per_node)
                for a in self.architectures]

    def boms(self) -> List[ArchBOM]:
        return [bom_for(a) for a in self.architectures]

    def scenario(self, ratio_index: int) -> ScenarioSpec:
        """The scenario-engine spec of one fault-ratio row."""
        return ScenarioSpec(
            num_nodes=self.num_nodes,
            snapshots=CounterIIDSnapshots(self.fault_ratios[ratio_index],
                                          samples=self.samples,
                                          seed=self.seed + ratio_index),
            tp_sizes=self.tp_sizes,
            architectures=self.architectures,
            gpus_per_node=self.gpus_per_node)


@dataclasses.dataclass
class CostResult:
    """Dense dollar grids of one cost sweep.

    Grid axes are ``(fault_ratio R, architecture A, snapshot S, TP T)`` for
    the per-snapshot quantities; ``total_gpus`` is ``(A, T)`` because
    TP-granular models round the modeled cluster to whole groups.
    """

    spec: CostSpec
    names: List[str]           # architecture names, grid axis 1
    fault_ratios: np.ndarray   # (R,), grid axis 0
    tp_sizes: np.ndarray       # (T,), grid axis 3
    total_gpus: np.ndarray     # (A, T) int64
    faulty_gpus: np.ndarray    # (R, A, S, T) int64
    placed_gpus: np.ndarray    # (R, A, S, T) int64
    cost_usd: np.ndarray       # (R, A, S, T) float64, §6.5 aggregate cost
    backend: str = "numpy"     # engine that produced the waste grids

    @property
    def num_snapshots(self) -> int:
        return self.placed_gpus.shape[2]

    @property
    def stranded_gpus(self) -> np.ndarray:
        """``N_wasted + N_faulty`` per cell -- the §6.5 stranded-capital
        count, ``(R, A, S, T)`` int64."""
        return self.total_gpus[None, :, None, :] - self.placed_gpus

    @property
    def mean_cost_usd(self) -> np.ndarray:
        """Snapshot-mean aggregate cost, ``(R, A, T)`` float64."""
        return self.cost_usd.mean(axis=2)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def tp_index(self, tp: int) -> int:
        return int(np.nonzero(self.tp_sizes == tp)[0][0])

    def ratio_index(self, ratio: float) -> int:
        return int(np.nonzero(np.isclose(self.fault_ratios, ratio))[0][0])


def cost_grid(total_gpus: np.ndarray, placed_gpus: np.ndarray,
              boms: Sequence[ArchBOM], *,
              gpu_unit_cost: float = GPU_UNIT_COST) -> np.ndarray:
    """§6.5 aggregate cost over an ``(A, S, T)`` placed-GPU grid, float64.

    The single affine dollar map shared by every consumer (snapshot sweeps
    here, churn timelines in :mod:`repro_torch.cost.bridge`): architecture
    ``a``'s cell cost is ``gpu_unit_cost * (total[a] - placed) +
    per_gpu_cost[a] * total[a]``.  ``total_gpus`` is the engine's ``(A,
    T)`` grid, ``boms`` one :class:`~repro_torch.core.cost_model.ArchBOM`
    per architecture row.  Eager float64 NumPy on the host, in the
    operation order of the scalar
    :func:`~repro_torch.core.cost_model.aggregate_cost` (multiply, then
    add): a fused multiply-add would round once where the scalar formula
    rounds twice, so the result is bit-for-bit the per-snapshot reference.
    """
    total_gpus = np.asarray(total_gpus, dtype=np.int64)
    placed_gpus = np.asarray(placed_gpus, dtype=np.int64)
    if len(boms) != total_gpus.shape[0]:
        raise ValueError(f"{len(boms)} BOMs for {total_gpus.shape[0]} "
                         "architecture rows")
    per_gpu = np.array([b.per_gpu_cost for b in boms], dtype=np.float64)
    interconnect = per_gpu[:, None] * total_gpus.astype(np.float64)  # (A, T)
    stranded = total_gpus[:, None, :] - placed_gpus                  # (A, S, T)
    return (np.float64(gpu_unit_cost) * stranded.astype(np.float64)
            + interconnect[:, None, :])


def run_cost_sweep(spec: CostSpec, *, backend: str = "auto",
                   chunk_snapshots: int = 1024,
                   device="cuda") -> CostResult:
    """Evaluate the full ``(R, A, S, T)`` cost grid through the batched engine.

    One :func:`repro_torch.sim.run_sweep` per fault-ratio row (model
    instances shared across rows; the torch backend on ``device``, which
    is ``cuda`` unless the caller passes ``"cpu"`` and raises without a
    card), then the shared dollar map -- the waste grids and therefore the
    cost grids are bit-for-bit identical across backends.
    """
    models = spec.models()
    boms = spec.boms()
    faulty, placed = [], []
    total = None
    chosen = backend
    with obs.span("cost.run_cost_sweep", ratios=len(spec.fault_ratios),
                  architectures=len(models)):
        for ri in range(len(spec.fault_ratios)):
            with obs.span("cost.ratio_row",
                          fault_ratio=float(spec.fault_ratios[ri])):
                res = run_sweep(spec.scenario(ri), models=models,
                                backend=backend,
                                chunk_snapshots=chunk_snapshots,
                                device=device)
            total, chosen = res.total_gpus, res.backend
            faulty.append(res.faulty_gpus)
            placed.append(res.placed_gpus)
        shape = (0, len(models), 0, len(spec.tp_sizes))
        faulty = np.stack(faulty) if faulty else np.zeros(shape, np.int64)
        placed = np.stack(placed) if placed else np.zeros(shape, np.int64)
        if total is None:
            total = np.zeros((len(models), len(spec.tp_sizes)), np.int64)
            chosen = "numpy"
        with obs.span("cost.cost_grid", rows=placed.shape[0]):
            cost = np.stack([cost_grid(total, placed[ri], boms,
                                       gpu_unit_cost=spec.gpu_unit_cost)
                             for ri in range(placed.shape[0])]) \
                if placed.shape[0] else np.zeros(shape, np.float64)
    return CostResult(spec, [m.name for m in models],
                      np.asarray(spec.fault_ratios, dtype=np.float64),
                      np.asarray(spec.tp_sizes, dtype=np.int64),
                      total, faulty, placed, cost, backend=chosen)


def run_cost_sweep_scalar(spec: CostSpec, *,
                          max_samples: Optional[int] = None) -> CostResult:
    """Reference implementation: scalar ``evaluate`` + ``aggregate_cost``
    per ``(ratio, architecture, snapshot, TP)`` cell.

    Exists for equivalence testing; ``max_samples`` clips the snapshot
    axis so a caller can time a subset (the grids still compare
    bit-for-bit on the shared rows).
    """
    models = spec.models()
    boms = spec.boms()
    samples = spec.samples if max_samples is None \
        else min(spec.samples, max_samples)
    a_count, t_count = len(models), len(spec.tp_sizes)
    r_count = len(spec.fault_ratios)
    total = np.zeros((a_count, t_count), dtype=np.int64)
    faulty = np.zeros((r_count, a_count, samples, t_count), dtype=np.int64)
    placed = np.zeros((r_count, a_count, samples, t_count), dtype=np.int64)
    cost = np.zeros((r_count, a_count, samples, t_count), dtype=np.float64)
    for ri in range(r_count):
        masks = spec.scenario(ri).snapshots.masks(spec.num_nodes)[:samples]
        for ai, (model, bom) in enumerate(zip(models, boms)):
            clipped = masks[:, :model.num_nodes]
            for si in range(samples):
                faults = set(np.nonzero(clipped[si])[0].tolist())
                for ti, tp in enumerate(spec.tp_sizes):
                    r = model.evaluate(faults, int(tp))
                    total[ai, ti] = r.total_gpus
                    faulty[ri, ai, si, ti] = r.faulty_gpus
                    placed[ri, ai, si, ti] = r.placed_gpus
                    cost[ri, ai, si, ti] = aggregate_cost(
                        bom, r.total_gpus, r.wasted_gpus, r.faulty_gpus,
                        spec.gpu_unit_cost)
    return CostResult(dataclasses.replace(spec, samples=samples),
                      [m.name for m in models],
                      np.asarray(spec.fault_ratios, dtype=np.float64),
                      np.asarray(spec.tp_sizes, dtype=np.int64),
                      total, faulty, placed, cost)


__all__ = ["CostResult", "CostSpec", "DEFAULT_COST_ARCHITECTURES",
           "cost_grid", "run_cost_sweep", "run_cost_sweep_scalar"]
