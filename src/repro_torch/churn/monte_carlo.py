"""Monte-Carlo churn: many independent trace realizations, one batched pass.

A :class:`ChurnSpec` is the declarative seed of a cluster-lifetime
experiment (Appendix-A trace statistics + the sweep grid); realization
``r`` regenerates bit-identically from ``seed + r``.  The Monte-Carlo
layer concatenates every realization's per-interval occupancy masks along
the scenario engine's snapshot axis and evaluates the whole ensemble in
one ``evaluate_masks`` call -- on the torch backend that means thousands
of 348-day traces stream through the card's kernels, bit-for-bit equal to
the scalar event-by-event replay (``chip_smoke.py`` reads the throughput
on the H100).  For
ensembles too large to concatenate, ``engine="streamed"`` re-chunks the
realizations through ``evaluate_mask_stream`` in bounded memory with the
same bit-for-bit grids (``tests/test_torch_churn.py``).

The counterpart of ``repro.churn.monte_carlo``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import obs
from ..core.trace import FaultTrace, generate_trace, to_4gpu_trace
from ..obs.progress import Progress
from ..sim.engine import evaluate_mask_stream, evaluate_masks
from ..sim.scenario import DEFAULT_ARCHITECTURES, make_model
from .replay import replay_trace
from .timeline import ChurnTimeline


@dataclasses.dataclass(frozen=True)
class ChurnSpec:
    """One cluster-lifetime experiment: trace statistics x sweep grid."""

    trace_nodes: int                 # 8-GPU nodes fed to the Appendix-A generator
    horizon_h: float = 348 * 24.0
    convert_4gpu: bool = True        # Appendix-A Bayes split to 4-GPU nodes
    tp_sizes: Tuple[int, ...] = (32,)
    architectures: Tuple[str, ...] = DEFAULT_ARCHITECTURES
    gpus_per_node: int = 4
    mean_repair_h: float = 8.0
    seed: int = 0

    @property
    def num_nodes(self) -> int:
        return self.trace_nodes * 2 if self.convert_4gpu else self.trace_nodes

    def trace(self, realization: int = 0) -> FaultTrace:
        """Trace realization ``r`` (deterministic in ``seed + r``)."""
        s = self.seed + realization
        tr = generate_trace(self.trace_nodes, horizon_h=self.horizon_h,
                            mean_repair_h=self.mean_repair_h, seed=s)
        return to_4gpu_trace(tr, seed=s) if self.convert_4gpu else tr

    def models(self):
        return [make_model(a, self.num_nodes, self.gpus_per_node)
                for a in self.architectures]


@dataclasses.dataclass
class ChurnEnsemble:
    """Per-realization timelines of one Monte-Carlo churn run."""

    spec: ChurnSpec
    timelines: List[ChurnTimeline]
    backend: str

    @property
    def num_traces(self) -> int:
        return len(self.timelines)

    def _empty_grid(self) -> np.ndarray:
        return np.zeros((0, len(self.spec.architectures),
                         len(self.spec.tp_sizes)))

    def integrated_waste(self) -> np.ndarray:
        """Time-integrated waste ratio per realization, ``(R, A, T)``."""
        if not self.timelines:
            return self._empty_grid()
        return np.stack([tl.integrated_waste_ratio() for tl in self.timelines])

    def placed_share(self) -> np.ndarray:
        """Goodput share of total GPU-hours per realization, ``(R, A, T)``."""
        if not self.timelines:
            return self._empty_grid()
        return np.stack([tl.placed_share() for tl in self.timelines])

    def summary_table(self) -> List[Dict]:
        """Per (architecture, TP): waste/goodput stats across realizations."""
        if not self.timelines:
            return []
        waste = self.integrated_waste()
        share = self.placed_share()
        rows = []
        tl0 = self.timelines[0]
        for ai, name in enumerate(tl0.names):
            for ti, tp in enumerate(tl0.tp_sizes):
                w = waste[:, ai, ti]
                rows.append({
                    "architecture": name, "tp_size": int(tp),
                    "traces": self.num_traces,
                    "mean_waste": float(w.mean()),
                    "p99_waste": float(np.percentile(w, 99)),
                    "mean_placed_share": float(share[:, ai, ti].mean()),
                })
        return rows


def monte_carlo_replay(spec: ChurnSpec,
                       traces: Union[int, Sequence[FaultTrace]], *,
                       engine: str = "batched", backend: str = "auto",
                       chunk_snapshots: int = 4096,
                       progress: Optional[Callable[[Progress], None]] = None,
                       device="cuda") -> ChurnEnsemble:
    """Replay ``traces`` realizations of ``spec`` into a :class:`ChurnEnsemble`.

    ``traces`` is a count (realizations ``0..traces-1`` are generated) or a
    pre-generated sequence of :class:`FaultTrace` (``chip_smoke.py`` passes
    one so engine timing excludes trace generation).  ``engine="batched"``
    evaluates ALL realizations' interval masks in a single scenario-engine
    pass; ``engine="streamed"`` produces bit-identical timelines but feeds
    the masks through ``evaluate_mask_stream`` one realization at a time
    (re-chunked across realization boundaries), bounding peak memory at
    ~one evaluation block for arbitrarily large ensembles;
    ``engine="scalar"`` loops the event-by-event reference replay.
    ``device`` is where the torch backend runs.

    ``progress`` (``engine="streamed"`` only) is forwarded to
    ``evaluate_mask_stream`` -- one :class:`repro_torch.obs.Progress` per
    evaluated block; the default publishes ``sim.stream.*`` telemetry
    gauges (blocks done, snapshots/sec, ETA).
    """
    if isinstance(traces, int):
        realizations = [spec.trace(r) for r in range(traces)]
    else:
        realizations = list(traces)

    if engine == "scalar":
        tls = [replay_trace(tr, tp_sizes=spec.tp_sizes,
                            architectures=spec.architectures,
                            gpus_per_node=spec.gpus_per_node, engine="scalar")
               for tr in realizations]
        return ChurnEnsemble(spec, tls, "scalar")
    if engine not in ("batched", "streamed"):
        raise ValueError(f"unknown engine {engine!r} (batched|streamed|scalar)")

    models = spec.models()
    names = [m.name for m in models]
    tps = np.asarray(spec.tp_sizes, dtype=np.int64)
    with obs.span("churn.monte_carlo_replay", engine=engine,
                  realizations=len(realizations)):
        edges_list = [tr.interval_edges() for tr in realizations]
        if engine == "streamed":
            chunks = (tr.fault_masks(e)
                      for tr, e in zip(realizations, edges_list))
            total, faulty, placed, chosen = evaluate_mask_stream(
                models, spec.tp_sizes, chunks,
                int(sum(len(e) for e in edges_list)),
                chunk_snapshots=chunk_snapshots, backend=backend,
                progress=progress, device=device)
        else:
            if realizations:
                masks = np.concatenate([tr.fault_masks(e) for tr, e
                                        in zip(realizations, edges_list)])
            else:
                masks = np.zeros((0, spec.num_nodes), dtype=bool)
            total, faulty, placed, chosen = evaluate_masks(
                models, spec.tp_sizes, masks,
                chunk_snapshots=chunk_snapshots, backend=backend,
                device=device)

    tls = []
    lo = 0
    for tr, edges in zip(realizations, edges_list):
        hi = lo + len(edges)
        tls.append(ChurnTimeline(tr.horizon_h, edges, list(names), tps,
                                 total.copy(), faulty[:, lo:hi].copy(),
                                 placed[:, lo:hi].copy(), backend=chosen))
        lo = hi
    return ChurnEnsemble(spec, tls, chosen)


__all__ = ["ChurnEnsemble", "ChurnSpec", "monte_carlo_replay"]
